"""The port's ``generate`` and ``generate_stream`` against the JAX
``GenerationEngine.generate`` under a sliding window, on the CPU in fp32.

The model and the 59-slot prompt are ``test_torch_slice.py``'s ``tiny``
pair (``tiny_debug(num_towers=2)``, the same seed and weights). With a
window smaller than the prompt, every decode step must retire the cache
slots at or below ``write_index - window`` before it attends, as the JAX
``fori_loop`` body does; 24 greedy tokens then agree exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cambrian_tpu.constants import IMAGE_TOKEN_INDEX
from cambrian_tpu.data.packing import prepare_multimodal_data
from cambrian_tpu.infer.engine import GenerationConfig as JGenConfig
from cambrian_tpu.infer.engine import GenerationEngine as JEngine
from cambrian_tpu.models.cambrian import CambrianLM as JCambrianLM
from cambrian_tpu.models.config import tiny_debug
from cambrian_tpu.models.encoders.base import build_vision_tower_aux_list
from cambrian_tpu_torch.checkpoint.from_jax import state_dict_from_jax
from cambrian_tpu_torch.infer.engine import GenerationConfig
from cambrian_tpu_torch.models.builder import CambrianForInference
from cambrian_tpu_torch.models.config import CambrianConfig

NEW_TOKENS = 24


def _perturb(tree, rng, scale):
    return jax.tree.map(
        lambda x: np.asarray(x) + scale * rng.standard_normal(x.shape).astype(np.float32),
        tree)


@pytest.fixture(scope="module", params=[None, 24, 12], ids=lambda w: f"window{w}")
def window_pair(request):
    cfg = tiny_debug(num_towers=2).replace(sliding_window=request.param)
    rng = np.random.default_rng(0)
    towers = build_vision_tower_aux_list(cfg.mm_vision_tower_aux_list,
                                         cfg.mm_vision_tower_aux_token_len_list)
    ids = rng.integers(5, cfg.vocab_size, (1, 40)).astype(np.int64)
    ids[0, cfg.image_position] = IMAGE_TOKEN_INDEX
    pids, _, pmask, ppos, aux_masks = prepare_multimodal_data(
        ids, ids.copy(), np.ones_like(ids, bool), [(640, 360)], cfg.image_token_len,
        cfg.mm_vision_tower_aux_token_len_list, cfg.tokenizer_model_max_length)
    assert pids.shape[1] == 59
    assert request.param is None or request.param < pids.shape[1]
    images = [rng.standard_normal((1, 3, t.image_size, t.image_size), dtype=np.float32)
              for t in towers]
    tower_params = [_perturb(t.init(jax.random.PRNGKey(i + 1)), rng, 0.05)
                    for i, t in enumerate(towers)]
    feats = [t.apply(tp, jnp.asarray(px)) for t, tp, px in zip(towers, tower_params, images)]
    jmasks = [jnp.asarray(m) for m in aux_masks]
    model = JCambrianLM(cfg, tuple(t.hidden_size for t in towers))
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(pids), jnp.asarray(pmask),
                        jnp.asarray(ppos), feats, jmasks)
    params = {"params": _perturb(params["params"], rng, 0.02)}

    jeng = JEngine(model, params, towers, max_len=cfg.tokenizer_model_max_length + 64,
                   cache_dtype=jnp.float32)
    want = jeng.generate(pids, pmask, ppos, feats, jmasks,
                         JGenConfig(max_new_tokens=NEW_TOKENS, eos_token_id=None))

    sd = state_dict_from_jax(params, prefix="lm.")
    for i, tp in enumerate(tower_params):
        sd.update(state_dict_from_jax(tp, prefix=f"towers.{i}.module."))
    port = CambrianForInference.from_state_dict(CambrianConfig.from_dict(cfg.to_dict()), sd,
                                                dtype=torch.float32, cache_dtype=torch.float32)
    assert port.config.sliding_window == request.param
    eng = port.engine
    return dict(eng=eng, feats=eng.encode_images(images), pids=pids, pmask=pmask, ppos=ppos,
                aux_masks=aux_masks, want=np.asarray(want),
                want_lengths=np.asarray(jeng.last_lengths))


def test_generate_matches_jax(window_pair):
    p = window_pair
    eng = p["eng"]
    got = eng.generate(p["pids"], p["pmask"], p["ppos"], p["feats"], p["aux_masks"],
                       GenerationConfig(max_new_tokens=NEW_TOKENS, eos_token_id=None))
    assert got.shape == (1, NEW_TOKENS)
    np.testing.assert_array_equal(got, p["want"])
    np.testing.assert_array_equal(eng.last_lengths, p["want_lengths"])


@pytest.mark.parametrize("chunk", [1, 8])
def test_generate_stream_matches_jax(window_pair, chunk):
    p = window_pair
    eng = p["eng"]
    *_, got = eng.generate_stream(
        p["pids"], p["pmask"], p["ppos"], p["feats"], p["aux_masks"],
        GenerationConfig(max_new_tokens=NEW_TOKENS, eos_token_id=None, stream_chunk=chunk))
    assert got.shape == (1, NEW_TOKENS)
    np.testing.assert_array_equal(got, p["want"])
