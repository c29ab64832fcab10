"""Phi-3 and the bf16 LM head in the port, against the JAX package on the
CPU in fp32 (``models/language/llama.py``, ``models/cambrian.py``).

A tiny Cambrian-Phi-3 (``tiny_debug`` with ``model_type="phi3"``, the same
seed and weights for both) with plain RoPE, LongRoPE whose factors the
sequence capacity picks (short, long, and a switch: short for a forward over
the prompt, long for the KV cache that ``generate`` sizes past
``original_max_position_embeddings``), linear scaling, and a sliding window
shorter than the prompt: the forward's fp32 logits to 1e-4 (fp32, same math,
sums in another order) and 12 greedy tokens identical to the JAX engine's.

The bf16 head (``lm_head_dtype="bf16"``), untied and tied: fp32 logits,
greedy tokens identical to the fp32 head's and to the JAX bf16 head's, and
logits within bf16 rounding of the fp32 head's (the JAX package's gate,
``tests/test_inference.py::test_bf16_lm_head_greedy_parity``);
``load_pretrained_model(lm_head_bf16=True)`` against the JAX loader.
"""

import math
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
from cambrian_tpu.models.language import llama as jllama  # noqa: E402
from cambrian_tpu_torch.checkpoint.from_jax import state_dict_from_jax  # noqa: E402
from cambrian_tpu_torch.infer.engine import GenerationConfig, GenerationEngine  # noqa: E402
from cambrian_tpu_torch.models.builder import (  # noqa: E402
    CambrianForInference,
    load_pretrained_model,
)
from cambrian_tpu_torch.models.config import CambrianConfig  # noqa: E402
from cambrian_tpu_torch.models.language import llama as tllama  # noqa: E402

LOGIT_TOL = 1e-4
NEW_TOKENS = 12
PROMPT_SLOTS = 59            # 40 ids, the image marker expanded
CACHE_SLOTS = PROMPT_SLOTS + NEW_TOKENS

_FACTORS = np.random.default_rng(9)
SHORT = [float(x) for x in _FACTORS.uniform(1.0, 1.2, 16)]     # head_dim 32 / 2
LONG = [float(x) for x in _FACTORS.uniform(2.0, 4.0, 16)]


def _longrope(orig):
    return dict(original_max_position_embeddings=orig,
                rope_scaling={"type": "longrope", "short_factor": SHORT, "long_factor": LONG})


VARIANTS = {
    "plain": {},
    # capacity 59 (forward) and 71 (cache) both within 96: short factors
    "longrope_short": _longrope(96),
    # both past 48: long factors
    "longrope_long": _longrope(48),
    # the forward's 59 within 64, the cache's 71 past it
    "longrope_switch": _longrope(64),
    "linear": dict(rope_scaling={"type": "linear", "factor": 2.5}),
    "window": dict(sliding_window=24),
}


def _phi3(**kw):
    return tiny_debug(num_towers=2).replace(model_type="phi3", **kw)


def _perturb(tree, rng, scale):
    return jax.tree.map(
        lambda x: np.asarray(x) + scale * rng.standard_normal(x.shape).astype(np.float32),
        tree)


def _build(cfg, seed=0):
    """The JAX model, params and tower features, and the port's model on the
    same weights, with the prompt packed as the model packs it."""
    rng = np.random.default_rng(seed)
    towers = build_vision_tower_aux_list(cfg.mm_vision_tower_aux_list,
                                         cfg.mm_vision_tower_aux_token_len_list)
    ids = rng.integers(5, cfg.vocab_size, (1, 40)).astype(np.int64)
    ids[0, cfg.image_position] = IMAGE_TOKEN_INDEX
    pids, _, pmask, ppos, aux_masks = prepare_multimodal_data(
        ids, ids.copy(), np.ones_like(ids, bool), [(640, 360)], cfg.image_token_len,
        cfg.mm_vision_tower_aux_token_len_list, cfg.tokenizer_model_max_length)
    assert pids.shape[1] == PROMPT_SLOTS
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
    port = CambrianForInference.from_state_dict(CambrianConfig.from_dict(cfg.to_dict()), sd,
                                                dtype=torch.float32, cache_dtype=torch.float32)
    return dict(cfg=cfg, model=model, params=params, feats=feats, jmasks=jmasks, sd=sd,
                inputs=(pids, pmask, ppos), aux_masks=aux_masks, port=port, images=images)


def _jax_generate(p, model=None, params=None):
    jeng = JEngine(model or p["model"], params or p["params"], max_len=512,
                   cache_dtype=jnp.float32)
    return np.asarray(jeng.generate(*p["inputs"], p["feats"], p["jmasks"],
                                    JGenConfig(max_new_tokens=NEW_TOKENS, eos_token_id=None)))


def _port_generate(p, port=None):
    port = port or p["port"]
    eng = GenerationEngine(port.lm, port.towers, max_len=512, cache_dtype=torch.float32)
    feats = eng.encode_images(p["images"])
    out = eng.generate(*p["inputs"], feats, p["aux_masks"],
                       GenerationConfig(max_new_tokens=NEW_TOKENS, eos_token_id=None))
    return out, eng


def _forward(p, port=None):
    """(JAX logits, port logits) of the no-cache forward over the prompt."""
    port = port or p["port"]
    want = np.asarray(p["model"].apply(p["params"], *map(jnp.asarray, p["inputs"]), p["feats"],
                                       p["jmasks"]))
    with torch.no_grad():
        got = port.lm(*[torch.from_numpy(np.asarray(x)) for x in p["inputs"]],
                      [torch.from_numpy(np.asarray(f)) for f in p["feats"]],
                      [torch.from_numpy(np.asarray(m)) for m in p["aux_masks"]])
    return want, got


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def phi3_pair(request):
    return dict(_build(_phi3(**VARIANTS[request.param])), variant=request.param)


def test_phi3_forward_logits_match_jax(phi3_pair):
    want, got = _forward(phi3_pair)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_phi3_generate_matches_jax(phi3_pair):
    want = _jax_generate(phi3_pair)
    got, _ = _port_generate(phi3_pair)
    assert got.shape == (1, NEW_TOKENS)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("capacity", [PROMPT_SLOTS, CACHE_SLOTS, 10_000])
@pytest.mark.parametrize("variant", ["plain", "longrope_short", "longrope_long",
                                     "longrope_switch", "linear"])
def test_rope_scaling_factors_match_jax(variant, capacity):
    """The factors and the rescale each capacity picks, and the cos/sin
    tables built from them, as the JAX package's (fp32)."""
    kw = dict(VARIANTS[variant], max_position_embeddings=1024)
    jcfg, tcfg = _phi3(**kw), CambrianConfig.from_dict(_phi3(**kw).to_dict())
    j_ext, j_ms = jllama.rope_scaling_factors(jcfg, capacity)
    t_ext, t_ms = tllama.rope_scaling_factors(tcfg, capacity)
    assert t_ms == j_ms
    if variant.startswith("longrope"):
        orig = kw["original_max_position_embeddings"]
        assert t_ms == math.sqrt(1 + math.log(1024 / orig) / math.log(orig))
        want = LONG if capacity > orig else SHORT
        np.testing.assert_array_equal(t_ext.numpy(), np.asarray(want, np.float32))
    if j_ext is None:
        assert t_ext is None
    else:
        np.testing.assert_array_equal(t_ext.numpy(), np.asarray(j_ext))
    pos = np.arange(capacity)[None] % 2048
    jc, js = jllama.rope_cos_sin(jnp.asarray(pos), 32, 10000.0, jnp.float32, j_ext, j_ms)
    tc, ts = tllama.rope_cos_sin(torch.from_numpy(pos), 32, 10000.0, torch.float32, t_ext, t_ms)
    # fp32 angles up to 2,047 rad: cos/sin differ by the library's rounding
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-6, rtol=0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=2e-6, rtol=0)


def test_unsupported_rope_scaling_and_families_raise():
    """A rope scaling type the JAX package refuses raises, and so does a
    quantization mode other than int8 / int4; every decoder family the JAX
    package serves (Mistral, Gemma, Cohere, ported since) passes."""
    with pytest.raises(ValueError, match="unsupported rope_scaling"):
        tllama.check_supported(CambrianConfig.from_dict(
            _phi3(rope_scaling={"type": "yarn", "factor": 2.0}).to_dict()))
    with pytest.raises(NotImplementedError, match="not ported"):
        tllama.check_supported(CambrianConfig.from_dict(
            tiny_debug().replace(quantize="int2").to_dict()))
    for family in ("mistral", "gemma", "cohere"):
        tllama.check_supported(CambrianConfig.from_dict(
            tiny_debug().replace(model_type=family).to_dict()))


# -- the bf16 LM head -------------------------------------------------------------

@pytest.fixture(scope="module", params=[False, True], ids=["untied", "tied"])
def head_pair(request):
    return _build(tiny_debug(num_towers=2).replace(tie_word_embeddings=request.param), seed=3)


def _bf16_models(p):
    """The JAX model with its head read as bf16 (untied: stored bf16, as the
    JAX loader stores it), and the port's from the same state dict."""
    cfg16 = p["cfg"].replace(lm_head_dtype="bf16")
    model16 = JCambrianLM(cfg16, tuple(f.shape[-1] for f in p["feats"]))
    params16 = {"params": dict(p["params"]["params"])}
    if "lm_head" in params16["params"]:
        params16["params"]["lm_head"] = jax.tree.map(
            lambda x: jnp.asarray(x, jnp.bfloat16), params16["params"]["lm_head"])
    port16 = CambrianForInference.from_state_dict(CambrianConfig.from_dict(cfg16.to_dict()),
                                                  p["sd"], dtype=torch.float32,
                                                  cache_dtype=torch.float32)
    return cfg16, model16, params16, port16


def test_bf16_head_greedy_parity(head_pair):
    p = head_pair
    cfg16, model16, params16, port16 = _bf16_models(p)
    if not cfg16.tie_word_embeddings:
        assert port16.lm.lm_head.weight.dtype == torch.bfloat16
    tok32, eng32 = _port_generate(p)
    tok16, eng16 = _port_generate(p, port16)
    want16 = _jax_generate(p, model16, params16)
    np.testing.assert_array_equal(tok16, tok32)
    np.testing.assert_array_equal(tok16, want16)
    assert eng16.last_next_logits.dtype == torch.float32


def test_bf16_head_logits(head_pair):
    """fp32 logits. On the same final hidden state h, the port's head gives
    the JAX bf16 head's logits to 1e-5 (fp32 sums of the same bf16-rounded
    products, in another order). End to end, against the fp32 head and
    against the JAX bf16 forward (whose h differs from the port's by fp32
    rounding, which can move h_k's bf16 rounding by one step), within bf16
    rounding of both operands, (2^-7 + 2^-16) sum_k |h_k w_k|, plus the two
    fp32 sums' own rounding (2 K 2^-24 of the same sum) and 1e-4."""
    from cambrian_tpu_torch.models.cambrian import head_logits

    p = head_pair
    cfg16, model16, params16, port16 = _bf16_models(p)
    with torch.no_grad():
        x = [torch.from_numpy(np.asarray(a)) for a in p["inputs"]]
        hidden = port16.lm.hidden_states(
            *x, [torch.from_numpy(np.asarray(f)) for f in p["feats"]],
            [torch.from_numpy(np.asarray(m)) for m in p["aux_masks"]])
        got = head_logits(port16.lm.cfg, port16.lm.head(), hidden)
    want = np.asarray(model16.apply(params16, jnp.asarray(hidden.numpy()),
                                    method=JCambrianLM._logits))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)

    want16 = np.asarray(model16.apply(params16, *map(jnp.asarray, p["inputs"]), p["feats"],
                                      p["jmasks"]))
    _, got16 = _forward(p, port16)
    _, got32 = _forward(p)
    head = p["port"].lm.head().float()
    k = head.shape[1]
    bound = (2 ** -7 + 2 ** -16 + 2 * k * 2 ** -24) * (hidden.abs() @ head.abs().T) + LOGIT_TOL
    assert bool(((got16 - got32).abs() <= bound).all())
    assert bool(((got16 - torch.from_numpy(want16)).abs() <= bound).all())
    assert float((got16 - got32).abs().max()) > 0      # the head did round


def test_load_pretrained_model_lm_head_bf16_matches_jax(tmp_path):
    from cambrian_tpu.models.builder import load_pretrained_model as j_load

    path = str(tmp_path / "ckpt")
    make_tiny_checkpoint(path)
    tok, jmodel, _, _ = j_load(path, lm_head_bf16=True, dtype=jnp.float32)
    _, model, _, _ = load_pretrained_model(path, device="cpu", dtype=torch.float32,
                                           lm_head_bf16=True)
    assert model.config.lm_head_dtype == jmodel.config.lm_head_dtype == "bf16"
    head = model.lm.lm_head.weight
    assert head.dtype == torch.bfloat16
    want = np.asarray(jmodel.params["params"]["lm_head"]["kernel"]).T
    np.testing.assert_array_equal(head.detach().float().numpy(), want.astype(np.float32))
    ids = np.asarray(tok("hello world what is in this image").input_ids, np.int64)
    np.testing.assert_array_equal(model.generate(ids, max_new_tokens=8),
                                  np.asarray(jmodel.generate(ids, max_new_tokens=8)))
