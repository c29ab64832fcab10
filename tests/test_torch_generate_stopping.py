"""The port's ``generate(..., stopping=...)`` and ``generate(...,
on_device=False)`` against the JAX ``GenerationEngine.generate`` given the
same arguments, on the CPU in fp32.

With a ``stopping`` callable, or with ``on_device=False``, both engines run
the call through their ``generate_stream`` and return its last yield. The
model and the 59-slot prompt are ``test_torch_engine_window.py``'s (no
window): ``tiny_debug(num_towers=2)``, weights carried across by
``checkpoint/from_jax.py``. Tokens must be identical and ``last_lengths``
equal. The stopping callables: one that fires after a fixed count of
tokens, one that fires on a token taken from inside the greedy output, and
``KeywordsStoppingCriteria`` (each package's own) on a stand-in tokenizer.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cambrian_tpu import mm_utils as jax_mm_utils
from cambrian_tpu.constants import IMAGE_TOKEN_INDEX
from cambrian_tpu.data.packing import prepare_multimodal_data
from cambrian_tpu.infer.engine import GenerationConfig as JGenConfig
from cambrian_tpu.infer.engine import GenerationEngine as JEngine
from cambrian_tpu.models.cambrian import CambrianLM as JCambrianLM
from cambrian_tpu.models.config import tiny_debug
from cambrian_tpu.models.encoders.base import build_vision_tower_aux_list
from cambrian_tpu_torch import mm_utils
from cambrian_tpu_torch.checkpoint.from_jax import state_dict_from_jax
from cambrian_tpu_torch.infer.engine import GenerationConfig
from cambrian_tpu_torch.models.builder import CambrianForInference
from cambrian_tpu_torch.models.config import CambrianConfig

NEW_TOKENS = 16


def _perturb(tree, rng, scale):
    return jax.tree.map(
        lambda x: np.asarray(x) + scale * rng.standard_normal(x.shape).astype(np.float32),
        tree)


class StandInTokenizer:
    """Each id is the word ``<id>``: text in, ids out and back."""

    bos_token_id = None

    class _Encoded:
        def __init__(self, ids):
            self.input_ids = ids

    def __call__(self, text):
        return self._Encoded([int(w) for w in text.replace("<", " ").replace(">", " ").split()])

    def batch_decode(self, rows, skip_special_tokens=True):
        return ["".join(f"<{int(t)}>" for t in row) for row in rows]


@pytest.fixture(scope="module")
def pair():
    cfg = tiny_debug(num_towers=2)
    rng = np.random.default_rng(0)
    towers = build_vision_tower_aux_list(cfg.mm_vision_tower_aux_list,
                                         cfg.mm_vision_tower_aux_token_len_list)
    ids = rng.integers(5, cfg.vocab_size, (1, 40)).astype(np.int64)
    ids[0, cfg.image_position] = IMAGE_TOKEN_INDEX
    pids, _, pmask, ppos, aux_masks = prepare_multimodal_data(
        ids, ids.copy(), np.ones_like(ids, bool), [(640, 360)], cfg.image_token_len,
        cfg.mm_vision_tower_aux_token_len_list, cfg.tokenizer_model_max_length)
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

    sd = state_dict_from_jax(params, prefix="lm.")
    for i, tp in enumerate(tower_params):
        sd.update(state_dict_from_jax(tp, prefix=f"towers.{i}.module."))
    port = CambrianForInference.from_state_dict(CambrianConfig.from_dict(cfg.to_dict()), sd,
                                                dtype=torch.float32, cache_dtype=torch.float32)
    eng = port.engine
    p = dict(port=port, eng=eng, jeng=jeng, ids=ids, images=images, jfeats=feats,
             jmasks=jmasks, feats=eng.encode_images(images), pids=pids, pmask=pmask,
             ppos=ppos, aux_masks=aux_masks)
    # the whole greedy output, from which the stopping cases take their tokens
    full = eng.generate(pids, pmask, ppos, p["feats"], aux_masks,
                        GenerationConfig(max_new_tokens=NEW_TOKENS, eos_token_id=None))
    assert full.shape == (1, NEW_TOKENS)
    p["full"] = full
    return p


def _both(p, eos=None, **kw):
    """(port tokens, port lengths, JAX tokens, JAX lengths) of one generate
    call with the same arguments (``stopping`` given as a factory of
    (port callable, JAX callable))."""
    make = kw.pop("stopping", None)
    port_stop, jax_stop = make() if make else (None, None)
    got = p["eng"].generate(p["pids"], p["pmask"], p["ppos"], p["feats"], p["aux_masks"],
                            GenerationConfig(max_new_tokens=NEW_TOKENS, eos_token_id=eos),
                            stopping=port_stop, **kw)
    got_lengths = np.asarray(p["eng"].last_lengths)
    want = p["jeng"].generate(p["pids"], p["pmask"], p["ppos"], p["jfeats"], p["jmasks"],
                              JGenConfig(max_new_tokens=NEW_TOKENS, eos_token_id=eos),
                              stopping=jax_stop, **kw)
    return got, got_lengths, np.asarray(want), np.asarray(p["jeng"].last_lengths)


def _keywords(p):
    """KeywordsStoppingCriteria of each package on the stand-in tokenizer,
    its keyword the text of two tokens from inside the greedy output (the
    criteria read the generated ids, so the prompt part is empty)."""
    tok = StandInTokenizer()
    keyword = tok.batch_decode([p["full"][0, 5:7]])[0]
    prompt = np.zeros((1, 0), np.int64)
    return (mm_utils.KeywordsStoppingCriteria([keyword], tok, prompt),
            jax_mm_utils.KeywordsStoppingCriteria([keyword], tok, prompt))


CASES = {
    # fires mid-generation, after the 7th token
    "count": dict(stopping=lambda: (lambda ids: ids.shape[1] >= 7,) * 2),
    "keywords": dict(stopping=None),
    "on_device_false": dict(on_device=False),
    # an EOS from inside the greedy output: the stream ends at it and trims
    "on_device_false_eos": dict(on_device=False, eos="full"),
    "keywords_on_device_false": dict(stopping=None, on_device=False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_stopping_and_on_device_match_jax(pair, case):
    kw = dict(CASES[case])
    if case.startswith("keywords"):
        kw["stopping"] = lambda: _keywords(pair)
    eos = int(pair["full"][0, 9]) if kw.pop("eos", None) else None
    got, got_lengths, want, want_lengths = _both(pair, eos=eos, **kw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_lengths, want_lengths)
    full = pair["full"][0]
    if case == "count":
        assert got.shape == (1, 7)
    elif case.startswith("keywords"):
        # the keyword is tokens 5 and 6: the call ends with token 6
        assert got.shape == (1, 7) and np.array_equal(got[0, 5:7], full[5:7])
    elif eos is not None:
        stop = int(np.argmax(full == eos))
        assert got.shape == (1, stop) and got_lengths[0] == stop
    else:
        np.testing.assert_array_equal(got[0], full)
    assert pair["eng"].last_timings["decode_steps"] >= got.shape[1] - 1


def test_stopping_passes_through_cambrian_for_inference(pair):
    """``CambrianForInference.generate`` hands its ``stopping`` keyword to the
    engine: the KeywordsStoppingCriteria hook ends the call where the
    engine-level call ends."""
    port_stop, _ = _keywords(pair)
    got = pair["port"].generate(pair["ids"][0], images=pair["images"],
                                image_sizes=[(640, 360)], max_new_tokens=NEW_TOKENS,
                                eos_token_id=None, stopping=port_stop)
    assert got.shape == (1, 7)
    np.testing.assert_array_equal(got[0], pair["full"][0, :7])
    assert "encode_ms" in pair["eng"].last_timings


def test_neither_keeps_the_decode_loop(pair):
    """No ``stopping`` and ``on_device`` left True: the decode loop, whose
    tokens (int64, trimmed by lengths) are the JAX on-device program's."""
    got, got_lengths, want, want_lengths = _both(pair)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_lengths, want_lengths)
    np.testing.assert_array_equal(got, pair["full"])
