"""The port's continuous batching against the JAX package's, on the CPU in
fp32: the decoder's per-row cache writes (``decode_step`` with a vector
``cache_index``, an index past the cache dropped), ``sample_token_per_slot``,
and ``ContinuousBatchingEngine`` against the JAX engine and against the
port's sequential ``generate`` on the same weights: the cases of
``tests/test_continuous_batching.py`` (chunks 1 and 4, slot reuse,
``on_token``, EOS inside a chunk, mixed sampling, a capacity-capped slot),
plus a request with images through the tiny towers and the SVA injection,
int8 and int4, a Phi-3 LongRoPE config whose cache takes the long factors,
and a sliding window run past its end. Greedy tokens must be identical;
logits and cache rows agree to 1e-5."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cambrian_tpu.constants import IMAGE_TOKEN_INDEX
from cambrian_tpu.data.packing import prepare_multimodal_data
from cambrian_tpu.infer.continuous import ContinuousBatchingEngine as JCBEngine
from cambrian_tpu.infer.engine import GenerationConfig as JGenConfig
from cambrian_tpu.infer.engine import sample_token_per_slot as j_sample_per_slot
from cambrian_tpu.models.cambrian import CambrianLM as JCambrianLM
from cambrian_tpu.models.config import tiny_debug
from cambrian_tpu.models.encoders.base import build_vision_tower_aux_list
from cambrian_tpu.ops.quant import quantize_dense_tree
from cambrian_tpu_torch.checkpoint.from_jax import state_dict_from_jax
from cambrian_tpu_torch.infer.continuous import ContinuousBatchingEngine
from cambrian_tpu_torch.infer.engine import GenerationConfig, GenerationEngine
from cambrian_tpu_torch.infer.engine import sample_token_per_slot
from cambrian_tpu_torch.models.builder import CambrianForInference
from cambrian_tpu_torch.models.config import CambrianConfig
from cambrian_tpu_torch.models.language.llama import (
    rope_scaling_factors,
    write_cache_rows,
)

TOL = 1e-5
# three text prompts of different lengths, as in the JAX tests, and three
# of one length for the cases that need no more prefill shapes (each shape
# is one more compile of the JAX engine's prefill)
PROMPT_LENS = (9, 14, 20)
SAME_LEN = 14


def _t(x):
    return torch.from_numpy(np.array(x))


def _perturb(tree, rng, scale):
    return jax.tree.map(
        lambda x: np.asarray(x) + scale * rng.standard_normal(x.shape).astype(np.float32),
        tree)


def _build(cfg, seed=0):
    """The JAX model and params and the port's model on the same weights
    (fp32), the towers' features of one image request, and its packed
    prompt."""
    rng = np.random.default_rng(seed)
    towers = build_vision_tower_aux_list(cfg.mm_vision_tower_aux_list,
                                         cfg.mm_vision_tower_aux_token_len_list)
    ids = rng.integers(5, cfg.vocab_size, (1, 30)).astype(np.int64)
    ids[0, cfg.image_position] = IMAGE_TOKEN_INDEX
    pids, _, pmask, ppos, aux_masks = prepare_multimodal_data(
        ids, ids.copy(), np.ones_like(ids, bool), [(640, 360)], cfg.image_token_len,
        cfg.mm_vision_tower_aux_token_len_list, ids.shape[1] + cfg.image_block_len - 1)
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
    tower_sd = {}
    for i, tp in enumerate(tower_params):
        tower_sd.update(state_dict_from_jax(tp, prefix=f"towers.{i}.module."))
    prompts = [_text_prompt(rng, n, cfg.vocab_size) for n in PROMPT_LENS]
    same = [_text_prompt(rng, SAME_LEN, cfg.vocab_size) for _ in PROMPT_LENS]
    image_request = dict(inputs=(pids[0], pmask[0], ppos[0]), images=images, feats=feats,
                         jmasks=jmasks, aux_masks=aux_masks)
    base = dict(prompts=prompts, same=same, image=image_request, tower_sd=tower_sd,
                tower_hidden_sizes=model.tower_hidden_sizes)
    return _variant(base, cfg, params)


def _variant(base, cfg, params):
    """``base``'s prompts and towers with a JAX model of ``cfg`` on
    ``params`` and the port's model on the same weights."""
    sd = {**state_dict_from_jax(params, prefix="lm."), **base["tower_sd"]}
    port = CambrianForInference.from_state_dict(CambrianConfig.from_dict(cfg.to_dict()), sd,
                                                dtype=torch.float32, cache_dtype=torch.float32)
    return dict(base, cfg=cfg, params=params, port=port,
                model=JCambrianLM(cfg, base["tower_hidden_sizes"]))


def _text_prompt(rng, n, vocab):
    ids = rng.integers(5, vocab, n).astype(np.int64)
    return ids, np.ones(n, bool), np.arange(n)


@pytest.fixture(scope="module")
def pair():
    return _build(tiny_debug(num_towers=2))


def _run_jax(p, requests, num_slots, max_len, chunk):
    """``requests``: (inputs, JAX features or None, JAX masks or None, config
    kwargs) each; the JAX continuous engine's tokens."""
    eng = JCBEngine(p["model"], p["params"], num_slots=num_slots, max_len=max_len,
                    cache_dtype=jnp.float32)
    reqs = [eng.submit(*inputs, feats, masks, JGenConfig(**cfg))
            for inputs, feats, masks, cfg in requests]
    return [np.asarray(o) for o in eng.run_until_complete(reqs, chunk=chunk)]


def _run_port(p, requests, num_slots, max_len, chunk, **engine_kw):
    eng = ContinuousBatchingEngine(p["port"].lm, num_slots=num_slots, max_len=max_len,
                                   cache_dtype=torch.float32, **engine_kw)
    reqs = [eng.submit(*inputs, feats, masks, GenerationConfig(**cfg))
            for inputs, feats, masks, cfg in requests]
    return eng.run_until_complete(reqs, chunk=chunk), reqs, eng


def _text(p, cfg, which=None, key="same"):
    """Text requests: ``p[key]``'s prompts (``which`` of them), each with
    the config kwargs ``cfg``."""
    which = range(len(p[key])) if which is None else which
    return [(p[key][i], None, None, cfg) for i in which]


def _sequential(p, prompt, max_len=256, **cfg):
    eng = GenerationEngine(p["port"].lm, max_len=max_len, cache_dtype=torch.float32)
    ids, mask, pos = (np.asarray(x)[None] for x in prompt)
    return eng.generate(ids, mask, pos, None, None, GenerationConfig(**cfg))[0]


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)


# -- the decoder's per-row cache writes --------------------------------------------

def test_vector_cache_index_matches_jax_and_drops_out_of_range(pair):
    """Three rows at depths 3, 9 and past the cache (16): logits and every
    cache row as JAX gives them; the out-of-range row's cache is untouched."""
    p = pair
    cfg = p["cfg"]
    rng = np.random.default_rng(3)
    b, k_len = 3, 16
    shape = (b, k_len, cfg.num_key_value_heads, cfg.head_dim)
    cache = [(rng.standard_normal(shape).astype(np.float32),
              rng.standard_normal(shape).astype(np.float32))
             for _ in range(cfg.num_hidden_layers)]
    valid = rng.random((b, k_len)) < 0.6
    index = np.array([3, 9, k_len], np.int32)
    valid[0, 3] = valid[1, 9] = True
    tok = rng.integers(5, cfg.vocab_size, (b, 1))
    pos = np.array([[5], [12], [20]])
    jlogits, jcache = p["model"].apply(
        p["params"], jnp.asarray(tok), jnp.asarray(pos),
        tuple((jnp.asarray(k), jnp.asarray(v)) for k, v in cache), jnp.asarray(valid),
        jnp.asarray(index), method=JCambrianLM.decode_step)
    port_cache = tuple((_t(k), _t(v)) for k, v in cache)
    with torch.no_grad():
        logits, out = p["port"].lm.decode_step(_t(tok), _t(pos), port_cache, _t(valid),
                                              _t(index.astype(np.int64)))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=TOL, rtol=TOL)
    for (k, v), (jk, jv), (k0, v0) in zip(out, jcache, cache):
        np.testing.assert_allclose(k.numpy(), np.asarray(jk), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=TOL, rtol=TOL)
        np.testing.assert_array_equal(k[2].numpy(), k0[2])
        np.testing.assert_array_equal(v[2].numpy(), v0[2])
        # only the indexed rows were written
        np.testing.assert_array_equal(np.delete(k[0].numpy(), 3, 0), np.delete(k0[0], 3, 0))
        assert not np.array_equal(k[1, 9].numpy(), k0[1, 9])


def test_vector_cache_index_writes_one_token():
    buf = torch.zeros(2, 4, 3)
    write_cache_rows(buf, torch.ones(2, 3), torch.tensor([1, 4]))
    assert buf[0, 1].eq(1).all() and buf.sum() == 3
    flags = torch.zeros(2, 4, dtype=torch.bool)
    write_cache_rows(flags, torch.tensor([True, True]), torch.tensor([5, 0]))
    assert flags.tolist() == [[False] * 4, [True, False, False, False]]


# -- per-slot sampling ------------------------------------------------------------

def test_sample_token_per_slot_greedy_rows_and_top_p_sets():
    rng = np.random.default_rng(4)
    v = 64
    logits = rng.standard_normal((4, v)).astype(np.float32) * 3
    temps = np.array([0.0, 0.7, 0.0, 1.3], np.float32)
    top_ps = np.array([1.0, 0.5, 0.3, 0.9], np.float32)
    want = np.asarray(j_sample_per_slot(jnp.asarray(logits), jax.random.PRNGKey(0),
                                        jnp.asarray(temps), jnp.asarray(top_ps)))
    g = torch.Generator().manual_seed(0)
    draws = np.stack([sample_token_per_slot(_t(logits), g, _t(temps), _t(top_ps)).numpy()
                      for _ in range(200)])
    for row in (0, 2):
        assert (draws[:, row] == want[row]).all()
        assert want[row] == logits[row].argmax()
    for row in (1, 3):
        scaled = logits[row] / temps[row]
        srt = np.sort(scaled)[::-1]
        probs = np.exp(srt - srt.max())
        cum = np.cumsum(probs / probs.sum())
        cutoff = srt[min(int((cum < top_ps[row]).sum()), v - 1)]
        kept = set(np.flatnonzero(scaled >= cutoff))
        assert set(draws[:, row]) <= kept and len(set(draws[:, row])) > 1
        assert want[row] in kept


# -- the engine against JAX and against the sequential engine ----------------------

@pytest.mark.parametrize("chunk", [1, 4])
def test_continuous_matches_jax_and_sequential(pair, chunk):
    """3 prompts on 2 slots: a slot is re-admitted while the other decodes."""
    cfg = dict(max_new_tokens=7, temperature=0.0)
    want = _run_jax(pair, _text(pair, cfg, key="prompts"), 2, 256, chunk)
    got, reqs, _ = _run_port(pair, _text(pair, cfg, key="prompts"), 2, 256, chunk)
    _assert_same(got, want)
    for out, prompt in zip(got, pair["prompts"]):
        np.testing.assert_array_equal(out, _sequential(pair, prompt, **cfg))
    assert all(r.finished and len(r.tokens) == 7 for r in reqs)


def test_slots_are_reused(pair):
    cfg = dict(max_new_tokens=3, temperature=0.0)
    got, reqs, eng = _run_port(pair, _text(pair, cfg, key="prompts"), 1, 128, 1)
    assert all(len(o) == 3 for o in got) and all(r.finished for r in reqs)
    assert eng.slot_request == [None] and not eng.cache_valid.any()
    for out, prompt in zip(got, pair["prompts"]):
        np.testing.assert_array_equal(out, _sequential(pair, prompt, **cfg))


@pytest.mark.parametrize("chunk", [1, 3])
def test_streaming_callback(pair, chunk):
    eng = ContinuousBatchingEngine(pair["port"].lm, num_slots=2, max_len=128,
                                   cache_dtype=torch.float32)
    seen = []
    req = eng.submit(*pair["prompts"][0], config=GenerationConfig(max_new_tokens=4),
                     on_token=seen.append)
    eng.run_until_complete([req], chunk=chunk)
    assert seen == req.tokens and len(seen) == 4


def test_chunked_eos_mid_chunk(pair):
    """A slot hitting EOS inside a chunk stops exactly there, as in JAX; the
    other slot decodes to its budget."""
    full = _sequential(pair, pair["same"][0], max_new_tokens=8)
    k = next(i for i in range(1, 8) if int(full[i]) not in full[:i].tolist() and i % 4)
    eos = int(full[k])
    requests = [(pair["same"][0], None, None,
                 dict(max_new_tokens=8, temperature=0.0, eos_token_id=eos)),
                (pair["same"][1], None, None, dict(max_new_tokens=6, temperature=0.0))]
    want = _run_jax(pair, requests, 2, 128, 4)
    got, _, _ = _run_port(pair, requests, 2, 128, 4)
    _assert_same(got, want)
    assert len(got[0]) == k + 1 and int(got[0][-1]) == eos and len(got[1]) == 6
    np.testing.assert_array_equal(got[0], full[:k + 1])


def test_chunked_mixed_sampling_configs(pair):
    """The greedy slot is token-exact beside a sampled slot in one chunk."""
    requests = [(pair["prompts"][0], None, None, dict(max_new_tokens=6, temperature=0.0)),
                (pair["prompts"][2], None, None,
                 dict(max_new_tokens=6, temperature=0.9, top_p=0.9, seed=3))]
    got, _, _ = _run_port(pair, requests, 2, 128, 3)
    np.testing.assert_array_equal(got[0], _sequential(pair, pair["prompts"][0],
                                                      max_new_tokens=6))
    assert len(got[1]) == 6 and all(0 <= t < pair["cfg"].vocab_size for t in got[1])


def test_chunked_capacity_capped_slot_does_not_degrade_batch(pair):
    """A slot with 3 cache rows of headroom caps only itself (its writes
    after that are dropped); the other keeps the full chunk, as in JAX."""
    rng = np.random.default_rng(7)
    s1, s2 = 30, 10
    long, short = (_text_prompt(rng, n, pair["cfg"].vocab_size) for n in (s1, s2))
    cfg = dict(max_new_tokens=10, temperature=0.0)
    requests = [(long, None, None, cfg), (short, None, None, cfg)]
    want = _run_jax(pair, requests, 2, s1 + 3, 4)
    got, reqs, _ = _run_port(pair, requests, 2, s1 + 3, 4)
    _assert_same(got, want)
    assert len(got[0]) == 3 and reqs[0].finished and len(got[1]) == 10
    np.testing.assert_array_equal(got[1], _sequential(pair, short, **cfg))


def test_image_request_matches_jax(pair):
    """A request with images (features from the port's towers) beside two
    text requests: the SVA injection runs in the slot's prefill."""
    img = pair["image"]
    port = pair["port"]
    feats = port.engine.encode_images(img["images"])
    for f, jf in zip(feats, img["feats"]):
        np.testing.assert_allclose(f.numpy(), np.asarray(jf), atol=TOL, rtol=TOL)
    cfg = dict(max_new_tokens=6, temperature=0.0)
    jreqs = [(img["inputs"], img["feats"], img["jmasks"], cfg)] + _text(pair, cfg, [0, 1])
    want = _run_jax(pair, jreqs, 2, 256, 4)
    preqs = [(img["inputs"], feats, img["aux_masks"], cfg)] + _text(pair, cfg, [0, 1])
    got, _, _ = _run_port(pair, preqs, 2, 256, 4)
    _assert_same(got, want)
    seq = port.engine.generate(*(np.asarray(x)[None] for x in img["inputs"]), feats,
                               img["aux_masks"], GenerationConfig(**cfg))[0]
    np.testing.assert_array_equal(got[0], seq)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_matches_jax(pair, mode):
    params = {"params": {k: quantize_dense_tree(v, mode=mode) if k.startswith("layers_") else v
                         for k, v in pair["params"]["params"].items()}}
    p = _variant(pair, pair["cfg"].replace(quantize=mode), params)
    cfg = dict(max_new_tokens=6, temperature=0.0)
    want = _run_jax(p, _text(p, cfg), 2, 128, 4)
    got, _, _ = _run_port(p, _text(p, cfg), 2, 128, 4)
    _assert_same(got, want)
    np.testing.assert_array_equal(got[0], _sequential(p, p["same"][0], **cfg))


def test_phi3_longrope_long_factors_match_jax(pair):
    """max_len 96 exceeds original_max_position_embeddings 48: every slot's
    prefill and decode take the long factors, as the JAX engine's cache does."""
    rng = np.random.default_rng(9)
    d2 = pair["cfg"].head_dim // 2
    cfg = pair["cfg"].replace(
        model_type="phi3", original_max_position_embeddings=48,
        rope_scaling={"type": "longrope",
                      "short_factor": rng.uniform(1.0, 1.2, d2).tolist(),
                      "long_factor": rng.uniform(2.0, 4.0, d2).tolist()})
    p = _variant(pair, cfg, pair["params"])
    ext, _ = rope_scaling_factors(p["port"].config, 96)
    assert ext.tolist() == torch.tensor(cfg.rope_scaling["long_factor"]).tolist()
    gen = dict(max_new_tokens=6, temperature=0.0)
    want = _run_jax(p, _text(p, gen), 2, 96, 4)
    got, _, _ = _run_port(p, _text(p, gen), 2, 96, 4)
    _assert_same(got, want)


def test_sliding_window_attends_whole_cache_as_jax(pair):
    """A window of 24 with prompts shorter than it, decoded past it: like the
    JAX continuous engine, the port retires no slot, so its tokens equal
    JAX's and those of the same model without a window."""
    p = _variant(pair, pair["cfg"].replace(sliding_window=24), pair["params"])
    gen = dict(max_new_tokens=12, temperature=0.0)
    want = _run_jax(p, _text(p, gen), 2, 128, 4)
    got, _, _ = _run_port(p, _text(p, gen), 2, 128, 4)
    _assert_same(got, want)
    assert SAME_LEN < 24 < SAME_LEN + 12
    plain, _, _ = _run_port(pair, _text(pair, gen), 2, 128, 4)
    _assert_same(got, plain)


# -- no fallback to the CPU ---------------------------------------------------------

def test_engine_on_cuda_without_a_card_raises(pair, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContinuousBatchingEngine(pair["port"].lm, num_slots=1, max_len=32, device="cuda")
