"""The port's image -> answer slice against the JAX package's, on the CPU in
fp32: the same tiny Cambrian (two debug towers, SVA, LLaMA decoder) with the
same weights and inputs. ``tiny`` prefill takes the plain-attention branch
(s < 128); ``tiny_long`` has a prompt of more than 128 slots, so decoder
prefill takes the flash-attention branch."""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(__file__))
from util import make_tiny_checkpoint  # noqa: E402

from cambrian_tpu.constants import IMAGE_TOKEN_INDEX  # noqa: E402
from cambrian_tpu.data.packing import prepare_multimodal_data  # noqa: E402
from cambrian_tpu.infer.engine import GenerationConfig as JGenConfig  # noqa: E402
from cambrian_tpu.infer.engine import GenerationEngine as JEngine  # noqa: E402
from cambrian_tpu.models.cambrian import CambrianLM as JCambrianLM  # noqa: E402
from cambrian_tpu.models.config import tiny_debug  # noqa: E402
from cambrian_tpu.models.encoders.base import build_vision_tower_aux_list  # noqa: E402
from cambrian_tpu.models.language.llama import init_kv_cache as j_init_cache  # noqa: E402
from cambrian_tpu_torch.checkpoint.from_jax import state_dict_from_jax  # noqa: E402
from cambrian_tpu_torch.infer.engine import GenerationConfig  # noqa: E402
from cambrian_tpu_torch.models.builder import (  # noqa: E402
    CambrianForInference,
    load_pretrained_model,
)
from cambrian_tpu_torch.models.language.llama import init_kv_cache  # noqa: E402

TOL = 1e-5         # modules, fp32
LOGIT_TOL = 1e-4   # logits after the whole decoder, fp32

CONFIGS = {
    "tiny": (tiny_debug(num_towers=2), 40),
    "tiny_long": (tiny_debug(num_towers=2).replace(tokenizer_model_max_length=192), 140),
}


def _perturb(tree, rng, scale):
    return jax.tree.map(
        lambda x: np.asarray(x) + scale * rng.standard_normal(x.shape).astype(np.float32),
        tree)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def slice_pair(request):
    cfg, seq = CONFIGS[request.param]
    rng = np.random.default_rng(0)
    towers = build_vision_tower_aux_list(cfg.mm_vision_tower_aux_list,
                                         cfg.mm_vision_tower_aux_token_len_list)
    ids = rng.integers(5, cfg.vocab_size, (1, seq)).astype(np.int64)
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

    sd = state_dict_from_jax(params, prefix="lm.")
    for i, tp in enumerate(tower_params):
        sd.update(state_dict_from_jax(tp, prefix=f"towers.{i}.module."))
    port = CambrianForInference.from_state_dict(cfg, sd, dtype=torch.float32,
                                                cache_dtype=torch.float32)
    return dict(cfg=cfg, towers=towers, model=model, params=params, tower_params=tower_params,
                images=images, feats=feats, jmasks=jmasks, pids=pids, pmask=pmask,
                ppos=ppos, aux_masks=aux_masks, port=port)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_encode_and_prepare_vision_match(slice_pair):
    p = slice_pair
    feats = p["port"].engine.encode_images(p["images"])
    for got, want in zip(feats, p["feats"]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    want = p["model"].apply(p["params"], p["feats"], p["jmasks"],
                            method=JCambrianLM.prepare_vision)
    with torch.no_grad():
        got = p["port"].lm.prepare_vision([_t(f) for f in p["feats"]],
                                          [_t(m) for m in p["aux_masks"]])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=TOL, rtol=TOL)
    for g, w in zip(got[1], want[1]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), atol=TOL, rtol=TOL)


def test_prefill_and_decode_logits_match(slice_pair):
    p = slice_pair
    cfg = p["cfg"]
    s = p["pids"].shape[1]
    assert (s >= 128) == (cfg.tokenizer_model_max_length >= 160)   # kernel branch
    k_len = s + 4
    jcache = j_init_cache(cfg, 1, k_len, jnp.float32)
    jlogits, jcache = p["model"].apply(
        p["params"], jnp.asarray(p["pids"]), jnp.asarray(p["pmask"]),
        jnp.asarray(p["ppos"]), jcache, p["feats"], p["jmasks"],
        method=JCambrianLM.prefill)
    lm = p["port"].lm
    cache = init_kv_cache(cfg, 1, k_len, torch.float32)
    with torch.no_grad():
        logits, cache = lm.prefill(_t(p["pids"]), _t(p["pmask"]), _t(p["ppos"]), cache,
                                   [_t(f) for f in p["feats"]],
                                   [_t(m) for m in p["aux_masks"]])
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)

    valid = np.zeros((1, k_len), bool)
    valid[:, :s] = p["pmask"]
    valid[:, s] = True
    tok = np.array([[7]])
    pos = p["ppos"].max(axis=1, keepdims=True) + 1
    jstep, _ = p["model"].apply(p["params"], jnp.asarray(tok), jnp.asarray(pos), jcache,
                                jnp.asarray(valid), jnp.int32(s),
                                method=JCambrianLM.decode_step)
    with torch.no_grad():
        step, _ = lm.decode_step(_t(tok), _t(pos), cache, _t(valid), s)
    np.testing.assert_allclose(step.numpy(), np.asarray(jstep),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_greedy_tokens_identical(slice_pair):
    p = slice_pair
    cfg = p["cfg"]
    jeng = JEngine(p["model"], p["params"], p["towers"],
                   max_len=cfg.tokenizer_model_max_length + 64, cache_dtype=jnp.float32)
    want = jeng.generate(p["pids"], p["pmask"], p["ppos"], p["feats"], p["jmasks"],
                         JGenConfig(max_new_tokens=8, eos_token_id=None))
    eng = p["port"].engine
    feats = eng.encode_images(p["images"])
    got = eng.generate(p["pids"], p["pmask"], p["ppos"], feats, p["aux_masks"],
                       GenerationConfig(max_new_tokens=8, eos_token_id=None))
    assert got.shape == (1, 8)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(eng.last_lengths, np.asarray(jeng.last_lengths))


@pytest.fixture(scope="module")
def tiny_checkpoint(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tiny_ckpt"))
    make_tiny_checkpoint(path)
    return path


def test_load_pretrained_model_matches_jax_loader(tiny_checkpoint):
    from cambrian_tpu.models.builder import load_pretrained_model as j_load

    _, jmodel, jprocs, jctx = j_load(tiny_checkpoint)
    # the debug towers have no upstream snapshot, so no random-weights warning
    tok, model, procs, ctx = load_pretrained_model(tiny_checkpoint, device="cpu",
                                                   dtype=torch.float32)
    assert ctx == jctx and len(procs) == len(jprocs)
    assert tok is not None and tok.eos_token_id is not None
    want = state_dict_from_jax(jax.tree.map(np.asarray, jmodel.params))
    got = model.lm.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, atol=0, rtol=0, msg=k)


def test_text_only_greedy_tokens_identical(tiny_checkpoint):
    from cambrian_tpu.models.builder import load_pretrained_model as j_load

    tok, jmodel, _, _ = j_load(tiny_checkpoint)
    _, model, _, _ = load_pretrained_model(tiny_checkpoint, device="cpu",
                                           dtype=torch.float32)
    ids = np.asarray(tok("hello world what is in this image").input_ids, np.int64)
    want = jmodel.generate(ids, max_new_tokens=8)
    got = model.generate(ids, max_new_tokens=8)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_inference_cli_matches_reference_process(tiny_checkpoint, tmp_path, capsys):
    PIL = pytest.importorskip("PIL.Image")
    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    import inference as j_inference  # the JAX package's CLI at the repository root

    from cambrian_tpu_torch import inference

    image = PIL.new("RGB", (64, 48), (120, 180, 60))
    tok, model, procs, _ = load_pretrained_model(tiny_checkpoint, device="cpu",
                                                 dtype=torch.float32)
    got = inference.process(image, "describe the picture", tok, procs, model.config, "v1")
    want = j_inference.process(image, "describe the picture", tok, procs, model.config, "v1")
    np.testing.assert_array_equal(got[0], want[0])
    for g, w in zip(got[1], want[1]):
        np.testing.assert_array_equal(g, w)
    assert got[2:] == want[2:]

    path = tmp_path / "img.png"
    image.save(path)
    inference.main(["--model_path", tiny_checkpoint, "--image", str(path), "--conv_mode",
                    "v1", "--question", "describe the picture", "--max_new_tokens", "4",
                    "--device", "cpu"])
    ids = model.generate(got[0], images=got[1], image_sizes=got[2], max_new_tokens=4)
    assert 1 <= ids.shape[1] <= 4
    text = tok.batch_decode(ids, skip_special_tokens=True)[0].strip()
    assert capsys.readouterr().out == text + "\n"
