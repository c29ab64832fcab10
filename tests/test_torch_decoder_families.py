"""The other decoder families in the port (Mistral, Gemma, Gemma with
Gemma-2's two softcaps, Cohere, Cohere with qk-norm) against the JAX package
on the CPU in fp32 (``models/language/llama.py``, ``models/cambrian.py``,
``checkpoint/hf_llm.py``).

Their pieces first, on numpy-seeded inputs: tanh GELU against flax's
``nn.gelu(approximate=True)``, the norms (Gemma's ``1 + w`` RMSNorm,
Cohere's bias-free LayerNorm) and Cohere's interleaved rope, each to 1e-5.

Then a tiny Cambrian of each family (``tiny_debug`` with the family's
switches, the same seed and weights for both packages, carried across by
``from_jax``), whose prompt of 131 slots takes the flash route (``s >= 128``)
where the family allows it: the forward's fp32 logits to 1e-4 (same math,
sums in another order), 12 greedy tokens of ``generate`` identical to the
JAX ``GenerationEngine``'s, the ``ContinuousBatchingEngine``'s tokens
identical to the JAX continuous engine's (Gemma and Cohere), and each family
loaded through ``load_pretrained_model`` from an HF-named checkpoint that the
port writes, against the JAX loader on the same directory.

Also pinned: the JAX package's Gemma ``decode_step`` embeds the new token
without the sqrt(hidden) normaliser that its prefill applies, so its decode
logits differ from a full forward over the same sequence; the port keeps
that (ROADMAP queue 3), while LLaMA's agree.
"""

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

from cambrian_tpu.constants import IMAGE_TOKEN_INDEX
from cambrian_tpu.data.packing import prepare_multimodal_data
from cambrian_tpu.infer.continuous import ContinuousBatchingEngine as JCBEngine
from cambrian_tpu.infer.engine import GenerationConfig as JGenConfig
from cambrian_tpu.infer.engine import GenerationEngine as JEngine
from cambrian_tpu.models.cambrian import CambrianLM as JCambrianLM
from cambrian_tpu.models.config import tiny_debug
from cambrian_tpu.models.encoders.base import build_vision_tower_aux_list
from cambrian_tpu.models.language import llama as jllama
from cambrian_tpu_torch.checkpoint.from_jax import state_dict_from_jax
from cambrian_tpu_torch.checkpoint.save import save_pretrained
from cambrian_tpu_torch.infer.continuous import ContinuousBatchingEngine
from cambrian_tpu_torch.infer.engine import GenerationConfig, GenerationEngine
from cambrian_tpu_torch.models.builder import (
    CambrianForInference,
    load_pretrained_model,
    random_state_dict,
)
from cambrian_tpu_torch.models.config import CambrianConfig
from cambrian_tpu_torch.models.language import llama as tllama

TOL = 1e-5
LOGIT_TOL = 1e-4
NEW_TOKENS = 12
PROMPT_IDS = 112                 # the image marker expanded: 131 slots, >= 128
MAX_LEN = 192

VARIANTS = {
    "mistral_window": dict(model_type="mistral", sliding_window=24),
    # head_dim 48 is not hidden / heads, as Gemma-7B's 256 is not 3072 / 16
    "gemma": dict(model_type="gemma", hidden_act="gelu_pytorch_tanh", head_dim=48,
                  tie_word_embeddings=True, rms_norm_eps=1e-6),
    # caps small enough to bite on the tiny model's logits
    "gemma_softcap": dict(model_type="gemma", hidden_act="gelu_pytorch_tanh", head_dim=48,
                          tie_word_embeddings=True, rms_norm_eps=1e-6,
                          attn_logit_softcapping=0.5, final_logit_softcapping=1.0),
    "cohere": dict(model_type="cohere", tie_word_embeddings=True, logit_scale=0.0625),
    "cohere_qk_norm": dict(model_type="cohere", tie_word_embeddings=True, logit_scale=0.0625,
                           use_qk_norm=True),
}


def _cfg(**kw):
    return tiny_debug(num_towers=2).replace(tokenizer_model_max_length=MAX_LEN, **kw)


def _perturb(tree, rng, scale):
    return jax.tree.map(
        lambda x: np.asarray(x) + scale * rng.standard_normal(x.shape).astype(np.float32),
        tree)


def _t(x):
    return torch.from_numpy(np.array(x))


def _build(cfg, seed=0):
    """The JAX model, params and tower features, and the port's model on the
    same weights, with a prompt of PROMPT_IDS ids packed as the model packs
    it."""
    rng = np.random.default_rng(seed)
    towers = build_vision_tower_aux_list(cfg.mm_vision_tower_aux_list,
                                         cfg.mm_vision_tower_aux_token_len_list)
    ids = rng.integers(5, cfg.vocab_size, (1, PROMPT_IDS)).astype(np.int64)
    ids[0, cfg.image_position] = IMAGE_TOKEN_INDEX
    pids, _, pmask, ppos, aux_masks = prepare_multimodal_data(
        ids, ids.copy(), np.ones_like(ids, bool), [(640, 360)], cfg.image_token_len,
        cfg.mm_vision_tower_aux_token_len_list, cfg.tokenizer_model_max_length)
    assert pids.shape[1] >= 128
    images = [rng.standard_normal((1, 3, t.image_size, t.image_size), dtype=np.float32)
              for t in towers]
    tower_params = [_perturb(jax.jit(t.init)(jax.random.PRNGKey(i + 1)), rng, 0.05)
                    for i, t in enumerate(towers)]
    feats = [t.apply(tp, jnp.asarray(px)) for t, tp, px in zip(towers, tower_params, images)]
    jmasks = [jnp.asarray(m) for m in aux_masks]
    model = JCambrianLM(cfg, tuple(t.hidden_size for t in towers))
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(pids), jnp.asarray(pmask),
                                 jnp.asarray(ppos), feats, jmasks)
    params = {"params": _perturb(params["params"], rng, 0.02)}
    sd = state_dict_from_jax(params, prefix="lm.")
    for i, tp in enumerate(tower_params):
        sd.update(state_dict_from_jax(tp, prefix=f"towers.{i}.module."))
    port = CambrianForInference.from_state_dict(CambrianConfig.from_dict(cfg.to_dict()), sd,
                                                dtype=torch.float32, cache_dtype=torch.float32)
    texts = [rng.integers(5, cfg.vocab_size, n).astype(np.int64) for n in (9, 14, 20)]
    return dict(cfg=cfg, model=model, params=params, feats=feats, jmasks=jmasks, sd=sd,
                inputs=(pids, pmask, ppos), aux_masks=aux_masks, port=port, images=images,
                texts=texts)


@functools.lru_cache(maxsize=None)
def _pair(variant):
    """``_build`` of a variant of VARIANTS ("llama": none), once a process."""
    return dict(_build(_cfg(**VARIANTS.get(variant, {}))), variant=variant)


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def family(request):
    return _pair(request.param)


# -- the pieces ----------------------------------------------------------------------

def test_tanh_gelu_matches_flax():
    x = np.random.default_rng(1).standard_normal((4, 257), dtype=np.float32) * 4
    for act, want in (("gelu_pytorch_tanh", nn.gelu(jnp.asarray(x), approximate=True)),
                      ("gelu_tanh", nn.gelu(jnp.asarray(x), approximate=True)),
                      ("gelu", nn.gelu(jnp.asarray(x), approximate=False)),
                      ("silu", nn.silu(jnp.asarray(x)))):
        got = tllama.activation(CambrianConfig(hidden_act=act), torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL,
                                   err_msg=act)


@pytest.mark.parametrize("model_type", ["llama", "gemma", "cohere"])
def test_decoder_norm_matches_jax(model_type):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 48), dtype=np.float32) * 3 + 1
    w = rng.standard_normal(48, dtype=np.float32) * 0.1
    cfg = CambrianConfig(model_type=model_type, hidden_size=48, rms_norm_eps=1e-6)
    jmod = jllama.decoder_norm(cfg, "norm")
    want = jmod.apply({"params": {"weight": jnp.asarray(w)}}, jnp.asarray(x))
    mod = tllama.decoder_norm(cfg)
    assert set(mod.state_dict()) == {"weight"}
    mod.load_state_dict({"weight": torch.from_numpy(w)})
    with torch.no_grad():
        got = mod(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    # a fresh module is the identity scale, as flax initializes it (Gemma's w = 0)
    init = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]["weight"]
    np.testing.assert_array_equal(tllama.decoder_norm(cfg).weight.detach().numpy(),
                                  np.asarray(init))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_interleaved_rope_matches_jax(dtype):
    rng = np.random.default_rng(3)
    pos = np.stack([np.arange(40), np.arange(7, 47)])
    q = rng.standard_normal((2, 40, 4, 32), dtype=np.float32)
    k = rng.standard_normal((2, 40, 2, 32), dtype=np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jc, js = jllama.rope_cos_sin_interleaved(jnp.asarray(pos), 32, 8e6, jd)
    tc, ts = tllama.rope_cos_sin_interleaved(torch.from_numpy(pos), 32, 8e6, td)
    np.testing.assert_allclose(tc.float().numpy(), np.asarray(jc.astype(jnp.float32)),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(ts.float().numpy(), np.asarray(js.astype(jnp.float32)),
                               atol=TOL, rtol=0)
    np.testing.assert_array_equal(
        tllama._rotate_interleaved(torch.from_numpy(q)).numpy(),
        np.asarray(jllama._rotate_interleaved(jnp.asarray(q))))
    jq, jk = jllama.apply_rope_interleaved(jnp.asarray(q, jd), jnp.asarray(k, jd), jc, js)
    tq, tk = tllama.apply_rope_interleaved(torch.from_numpy(q).to(td),
                                           torch.from_numpy(k).to(td), tc, ts)
    assert tq.dtype == td and tk.dtype == td
    # bf16: fp32 products of the same bf16 operands, one rounding at the end
    tol = TOL if dtype == "float32" else 2 ** -7
    for got, want in ((tq, jq), (tk, jk)):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                                   atol=tol, rtol=tol)


def test_check_supported_takes_every_family_switch():
    for kw in VARIANTS.values():
        tllama.check_supported(CambrianConfig.from_dict(_cfg(**kw).to_dict()))
    with pytest.raises(ValueError, match="unsupported rope_scaling"):
        tllama.check_supported(CambrianConfig.from_dict(
            _cfg(model_type="mistral", rope_scaling={"type": "yarn", "factor": 2.0}).to_dict()))


# -- the tiny Cambrian of each family -------------------------------------------------

def _forward(p, port=None):
    """(JAX logits, port logits) of the no-cache forward over the prompt."""
    port = port or p["port"]
    want = np.asarray(p["model"].apply(p["params"], *map(jnp.asarray, p["inputs"]), p["feats"],
                                       p["jmasks"]))
    with torch.no_grad():
        got = port.lm(*[_t(x) for x in p["inputs"]], [_t(f) for f in p["feats"]],
                      [_t(m) for m in p["aux_masks"]])
    return want, got


def test_family_forward_logits_match_jax(family):
    want, got = _forward(family)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_TOL, rtol=LOGIT_TOL)
    cfg = family["cfg"]
    if cfg.final_logit_softcapping is not None:
        assert float(got.abs().max()) <= np.float32(cfg.final_logit_softcapping)


def test_softcaps_change_gemma_logits():
    """Both caps bite at the sizes of the variant: its logits differ from
    the uncapped model's on the same weights (each cap alone too)."""
    p = _pair("gemma_softcap")
    _, capped = _forward(p)
    base = p["cfg"].replace(attn_logit_softcapping=None, final_logit_softcapping=None)
    for cfg in (base, base.replace(attn_logit_softcapping=0.5)):
        other = CambrianForInference.from_state_dict(CambrianConfig.from_dict(cfg.to_dict()),
                                                     p["sd"], dtype=torch.float32,
                                                     cache_dtype=torch.float32)
        _, got = _forward(p, other)
        assert float((got - capped).abs().max()) > 1e-3


def _jax_generate(p):
    jeng = JEngine(p["model"], p["params"], max_len=512, cache_dtype=jnp.float32)
    return np.asarray(jeng.generate(*p["inputs"], p["feats"], p["jmasks"],
                                    JGenConfig(max_new_tokens=NEW_TOKENS, eos_token_id=None)))


def test_family_generate_matches_jax(family):
    want = _jax_generate(family)
    eng = GenerationEngine(family["port"].lm, family["port"].towers, max_len=512,
                           cache_dtype=torch.float32)
    before = tllama.flash_attention.launches
    got = eng.generate(*family["inputs"], eng.encode_images(family["images"]),
                       family["aux_masks"],
                       GenerationConfig(max_new_tokens=NEW_TOKENS, eos_token_id=None))
    assert tllama.flash_attention.launches == before      # CPU tensors: the plain version
    assert got.shape == (1, NEW_TOKENS)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("variant", ["gemma", "cohere_qk_norm"])
def test_continuous_engine_matches_jax(variant):
    """The image request and three text requests on 2 slots, chunks of 4:
    slots retire and are re-admitted mid-run."""
    p = _pair(variant)
    budgets = (10, 6, 9, 12)
    jeng = JCBEngine(p["model"], p["params"], num_slots=2, max_len=MAX_LEN + 32,
                     cache_dtype=jnp.float32)
    jreqs = [jeng.submit(*(x[0] for x in p["inputs"]), p["feats"], p["jmasks"],
                         JGenConfig(max_new_tokens=budgets[0]))]
    jreqs += [jeng.submit(t, np.ones(len(t), bool), np.arange(len(t)), None, None,
                          JGenConfig(max_new_tokens=n)) for t, n in zip(p["texts"], budgets[1:])]
    want = [np.asarray(o).tolist() for o in jeng.run_until_complete(jreqs, chunk=4)]
    eng = ContinuousBatchingEngine(p["port"].lm, num_slots=2, max_len=MAX_LEN + 32,
                                   cache_dtype=torch.float32)
    feats = GenerationEngine(p["port"].lm, p["port"].towers).encode_images(p["images"])
    reqs = [eng.submit(*(x[0] for x in p["inputs"]), feats, p["aux_masks"],
                       GenerationConfig(max_new_tokens=budgets[0]))]
    reqs += [eng.submit(t, np.ones(len(t), bool), np.arange(len(t)), None, None,
                        GenerationConfig(max_new_tokens=n)) for t, n in zip(p["texts"],
                                                                            budgets[1:])]
    got = [np.asarray(o).tolist() for o in eng.run_until_complete(reqs, chunk=4)]
    assert [len(t) for t in got] == list(budgets)
    assert got == want


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_load_pretrained_model_matches_jax_loader(variant, tmp_path):
    """A checkpoint the port writes in HF naming (``save_pretrained``: the
    family's ``model_type``, Cohere's one norm a layer and its qk norms),
    read back by the port's ``load_pretrained_model`` and by the JAX
    package's: the port's weights come back exactly, and both give the same
    greedy tokens on a text prompt."""
    from cambrian_tpu.models.builder import load_pretrained_model as j_load

    cfg = CambrianConfig.from_dict(_cfg(**VARIANTS[variant]).to_dict())
    gen = torch.Generator().manual_seed(7)
    sd = random_state_dict(cfg, gen, 0.05, dtype=torch.float32, device="cpu")
    src = CambrianForInference.from_state_dict(cfg, sd, dtype=torch.float32)
    path = str(tmp_path / variant)
    save_pretrained(src.lm, cfg, path)
    with open(os.path.join(path, "config.json")) as f:
        assert f'"cambrian_{cfg.model_type}"' in f.read()
    _, model, _, _ = load_pretrained_model(path, device="cpu", dtype=torch.float32)
    assert model.config.model_type == cfg.model_type
    want_sd = src.lm.state_dict()
    got_sd = model.lm.state_dict()
    assert set(got_sd) == set(want_sd)
    for k, v in want_sd.items():
        torch.testing.assert_close(got_sd[k], v, atol=0, rtol=0, msg=k)
    if cfg.model_type == "cohere":
        assert not any("post_attention_layernorm" in k for k in got_sd)
        assert any("q_norm" in k for k in got_sd) == cfg.use_qk_norm
    _, jmodel, _, _ = j_load(path, dtype=jnp.float32)
    ids = np.random.default_rng(8).integers(5, cfg.vocab_size, 20)
    np.testing.assert_array_equal(model.generate(ids, max_new_tokens=8, eos_token_id=None),
                                  np.asarray(jmodel.generate(ids, max_new_tokens=8,
                                                             eos_token_id=None)))


# -- the JAX package's Gemma decode, kept ---------------------------------------------

@pytest.mark.parametrize("variant", ["gemma", "llama"])
def test_decode_step_embedding_as_jax(variant):
    """Prefill a text prompt, then one ``decode_step``: the port's decode
    logits equal the JAX package's. Gemma's decode embeds the token without
    the normaliser the prefill applies, so its logits differ from a full
    forward over the prompt and the token; LLaMA's agree with it."""
    p = _pair(variant)
    cfg, model, params, lm = p["cfg"], p["model"], p["params"], p["port"].lm
    n = 16
    ids = np.random.default_rng(11).integers(5, cfg.vocab_size, (1, n + 1)).astype(np.int64)
    mask, pos = np.ones((1, n + 1), bool), np.arange(n + 1)[None]
    cache = jllama.init_kv_cache(cfg, 1, n + 1, jnp.float32)
    _, cache = model.apply(params, jnp.asarray(ids[:, :n]), jnp.asarray(mask[:, :n]),
                           jnp.asarray(pos[:, :n]), cache, method=JCambrianLM.prefill)
    jdec, _ = model.apply(params, jnp.asarray(ids[:, n:]), jnp.asarray(pos[:, n:]), cache,
                          jnp.ones((1, n + 1), bool), jnp.int32(n),
                          method=JCambrianLM.decode_step)
    tcfg = CambrianConfig.from_dict(cfg.to_dict())
    with torch.no_grad():
        tcache = tllama.init_kv_cache(tcfg, 1, n + 1, torch.float32)
        lm.prefill(_t(ids[:, :n]), _t(mask[:, :n]), _t(pos[:, :n]), tcache)
        dec, _ = lm.decode_step(_t(ids[:, n:]), _t(pos[:, n:]), tcache,
                                torch.ones((1, n + 1), dtype=torch.bool), n)
        full = lm(_t(ids), _t(mask), _t(pos))[:, -1]
    np.testing.assert_allclose(dec.numpy(), np.asarray(jdec), atol=LOGIT_TOL, rtol=LOGIT_TOL)
    gap = float((dec - full).abs().max())
    if variant == "gemma":
        assert gap > 1e-2, gap
    else:
        assert gap <= LOGIT_TOL, gap
