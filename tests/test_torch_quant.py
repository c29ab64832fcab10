"""The port's weight-only quantization (cambrian_tpu_torch/ops/quant.py)
against the JAX package's, on the CPU in fp32:

- the quantizers give identical bytes and scales;
- the plain versions of kernels K3, K4 and K4b/K4c match the JAX Pallas
  kernels run in interpret mode, and the JAX CPU path ``x @ dequantize_*``;
- the quantized linears match ``QuantDense`` / ``QuantDense4``;
- the tiny quantized Cambrian (int8 and int4, JAX params quantized by
  ``quantize_dense_tree`` and carried across by ``from_jax.py``) gives the
  JAX engine's logits and greedy tokens.

The kernels themselves run only on the card (marker ``cuda``; without JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_quant.py``).
"""

import functools

import numpy as np
import pytest
import torch

from cambrian_tpu_torch.ops import quant

TOL = 1e-5         # plain versions and modules, fp32
LOGIT_TOL = 1e-4   # logits after the whole decoder, fp32


def _t(x):
    return torch.from_numpy(np.array(x))


def _weights(rng, k, n, zero_col=True):
    w = (rng.standard_normal((k, n)) * 0.02).astype(np.float32)
    if zero_col:
        w[:, 3] = 0.0   # absmax 0: scale 1
    return w


# -- quantizers -----------------------------------------------------------------

@pytest.mark.parametrize("k,n", [(64, 48), (256, 96), (4096, 24)])
def test_quantize_int8_bit_identical(k, n):
    import jax.numpy as jnp

    from cambrian_tpu.ops import quant as jquant

    w = _weights(np.random.default_rng(k + n), k, n)
    jq, js = jquant.quantize_int8(jnp.asarray(w))
    q, s = quant.quantize_int8(_t(w))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(quant.dequantize_int8(q, s, torch.float32).numpy(),
                                  np.asarray(jquant.dequantize_int8(jq, js, jnp.float32)))


# K = 256, 512: groups of 128; K = 96, 130: one group spanning K
@pytest.mark.parametrize("k,n", [(256, 96), (512, 40), (96, 32), (130, 24)])
def test_quantize_int4_bit_identical(k, n):
    import jax.numpy as jnp

    from cambrian_tpu.ops import quant as jquant

    w = _weights(np.random.default_rng(k * n), k, n)
    w[:, 5] = np.where(np.arange(k) % 2, 1.0, -1.0)   # every nibble sign, both halves
    jq, js = jquant.quantize_int4(jnp.asarray(w))
    q, s = quant.quantize_int4(_t(w))
    assert q.shape == (k // 2, n) and q.dtype == torch.int8
    assert s.shape == (k // quant.int4_group(k), n)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(quant.dequantize_int4(q, s, torch.float32).numpy(),
                                  np.asarray(jquant.dequantize_int4(jq, js, jnp.float32)))


def test_quantize_int4_refuses_odd_k():
    with pytest.raises(ValueError, match="even K"):
        quant.quantize_int4(torch.ones(7, 4))


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantize_state_dict_matches_quantize_dense_tree(mode):
    """The JAX tree quantized and carried across equals the carried tree
    quantized by the port: integer leaves keep int8, a quantized Dense's
    ``scale`` keeps its name, the bias becomes fp32."""
    import jax.numpy as jnp

    from cambrian_tpu.ops.quant import quantize_dense_tree
    from cambrian_tpu_torch.checkpoint.from_jax import state_dict_from_jax

    rng = np.random.default_rng(3)
    tree = {
        "self_attn": {"q_proj": {"kernel": jnp.asarray(_weights(rng, 256, 64)),
                                 "bias": jnp.asarray(rng.standard_normal(64), jnp.float32)}},
        "mlp": {"down_proj": {"kernel": jnp.asarray(_weights(rng, 128, 256))}},
        "input_layernorm": {"weight": jnp.ones(256)},
        "norm": {"scale": jnp.ones(256)},
    }
    want = state_dict_from_jax(quantize_dense_tree(tree, mode=mode))
    got = quant.quantize_state_dict(state_dict_from_jax(tree), mode=mode)
    kq = "kernel_q4" if mode == "int4" else "kernel_q"
    assert set(got) == set(want) == {
        f"self_attn.q_proj.{kq}", "self_attn.q_proj.scale", "self_attn.q_proj.bias",
        f"mlp.down_proj.{kq}", "mlp.down_proj.scale", "input_layernorm.weight", "norm.weight"}
    assert want[f"mlp.down_proj.{kq}"].dtype == torch.int8
    assert want["mlp.down_proj.scale"].dtype == torch.float32
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        torch.testing.assert_close(got[k], v, atol=0, rtol=0, msg=k)


def test_load_refuses_integer_float_mixups():
    from cambrian_tpu_torch.checkpoint.from_jax import load_state_dict_checked

    lin = quant.QuantLinear(8, 4, bias=False)
    with pytest.raises(TypeError, match="does not load"):
        load_state_dict_checked(lin, {"kernel_q": torch.zeros(8, 4), "scale": torch.ones(4)})
    with pytest.raises(TypeError, match="does not load"):
        load_state_dict_checked(torch.nn.Linear(8, 4, bias=False),
                                {"weight": torch.zeros(4, 8, dtype=torch.int8)})


# -- plain versions against the JAX kernels (interpret mode) ------------------------

K, N, BM, BN, BK = 512, 256, 8, 128, 256


def _inputs(seed, m=BM, k=K, n=N):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, k)) * 0.1).astype(np.float32)
    return x, _weights(rng, k, n, zero_col=False)


def _interpret(kernel, args, in_specs, k_blocks, m, n, **kw):
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    out = pl.pallas_call(
        functools.partial(kernel, k_blocks=k_blocks, **kw),
        grid=(1, n // BN, k_blocks),
        in_specs=in_specs,
        out_specs=pl.BlockSpec((1, m, BN), lambda i, j, kb: (0, i, j)),
        out_shape=jax.ShapeDtypeStruct((1, m, n), jnp.float32),
        scratch_shapes=[pltpu.VMEM((m, BN), jnp.float32)],
        interpret=True,
    )(*args)
    return np.asarray(out[0])


def test_int8_reference_matches_k3_interpret_and_xla_path():
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    from cambrian_tpu.ops import quant as jquant

    x, w = _inputs(0)
    jq, js = jquant.quantize_int8(jnp.asarray(w))
    want = _interpret(
        jquant._q_matmul_kernel,
        (jnp.asarray(x)[None], jq[None], js[None, None]),
        [pl.BlockSpec((1, BM, BK), lambda i, j, kb: (0, i, kb)),
         pl.BlockSpec((1, BK, BN), lambda i, j, kb: (0, kb, j)),
         pl.BlockSpec((1, 1, BN), lambda i, j, kb: (0, 0, j))],
        K // BK, BM, N)
    got = quant.int8_matmul_reference(_t(x), _t(jq), _t(js)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    xla = np.asarray(jnp.asarray(x) @ jquant.dequantize_int8(jq, js, jnp.float32))
    np.testing.assert_allclose(got, xla, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("kernel", ["v3_convert", "v3_via_int8", "v3_magic", "v2", "v1"])
def test_int4_reference_matches_interpret_kernels_and_xla_path(kernel):
    """K4 (v3, each dequant variant) against the partial-sum plain version;
    K4b (v2) and K4c (v1, even/odd split x) against the scale-on-weights one."""
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    from cambrian_tpu.ops import quant as jquant

    x, w = _inputs(1)
    jq, js = jquant.quantize_int4(jnp.asarray(w))
    gpb = BK // jquant.INT4_GROUP
    w_spec = pl.BlockSpec((1, BK // 2, BN), lambda i, j, kb: (0, kb, j))
    s_spec = pl.BlockSpec((1, gpb, BN), lambda i, j, kb: (0, kb, j))
    if kernel == "v1":
        xj = jnp.asarray(x)
        want = _interpret(
            jquant._q4_matmul_kernel, (xj[:, 0::2][None], xj[:, 1::2][None], jq[None], js[None]),
            [pl.BlockSpec((1, BM, BK // 2), lambda i, j, kb: (0, i, kb)),
             pl.BlockSpec((1, BM, BK // 2), lambda i, j, kb: (0, i, kb)), w_spec, s_spec],
            K // BK, BM, N)
    else:
        kern = (jquant._q4_matmul_kernel_v2 if kernel == "v2" else functools.partial(
            jquant._q4_matmul_kernel_v3, dequant=kernel[3:]))
        want = _interpret(
            kern, (jnp.asarray(x)[None], jq[None], js[None]),
            [pl.BlockSpec((1, BM, BK), lambda i, j, kb: (0, i, kb)), w_spec, s_spec],
            K // BK, BM, N, gpb=gpb)
    got = quant.int4_matmul_reference(_t(x), _t(jq), _t(js),
                                      scale_on_weights=kernel in ("v1", "v2")).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    xla = np.asarray(jnp.asarray(x) @ jquant.dequantize_int4(jq, js, jnp.float32))
    np.testing.assert_allclose(got, xla, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("k", [96, 130])
def test_int4_reference_single_group_matches_xla_path(k):
    import jax.numpy as jnp

    from cambrian_tpu.ops import quant as jquant

    x, w = _inputs(2, m=5, k=k, n=40)
    jq, js = jquant.quantize_int4(jnp.asarray(w))
    want = np.asarray(jquant.int4_matmul(jnp.asarray(x), jq, js))   # the JAX CPU path
    for sow in (False, True):
        got = quant.int4_matmul_reference(_t(x), _t(jq), _t(js), scale_on_weights=sow)
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_bf16_scale_on_weights_rounds_the_weights():
    """In bf16 the two int4 modes round differently: scale-on-weights rounds
    the scale and q * scale to bf16 (as the v2 and v1 kernels do)."""
    x, w = _inputs(4, m=3)
    q, s = quant.quantize_int4(_t(w))
    xb = _t(x).bfloat16()
    got = quant.int4_matmul_reference(xb, q, s, scale_on_weights=True)
    w_b = (quant._unpack_int4(q).bfloat16()
           * s.bfloat16().repeat_interleave(quant.INT4_GROUP, 0))
    want = (xb.float() @ w_b.float()).bfloat16()
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert got.dtype == torch.bfloat16


# -- wrappers and modules on the CPU ------------------------------------------------

def test_wrappers_take_the_plain_version_on_cpu(monkeypatch):
    x, w = _inputs(5, m=4)
    q8, s8 = quant.quantize_int8(_t(w))
    q4, s4 = quant.quantize_int4(_t(w))
    xt = _t(x)
    before = (quant.int8_matmul.launches, quant.int4_matmul.launches,
              quant.int4_matmul_scale_on_weights.launches)
    torch.testing.assert_close(quant.int8_matmul(xt, q8, s8),
                               quant.int8_matmul_reference(xt, q8, s8), atol=0, rtol=0)
    torch.testing.assert_close(quant.int4_matmul(xt, q4, s4),
                               quant.int4_matmul_reference(xt, q4, s4), atol=0, rtol=0)
    for switch in ("CAMBRIAN_INT4_V2", "CAMBRIAN_INT4_V1"):
        with monkeypatch.context() as mp:
            mp.setenv(switch, "1")
            xb = xt.bfloat16()
            torch.testing.assert_close(
                quant.int4_matmul(xb, q4, s4),
                quant.int4_matmul_reference(xb, q4, s4, scale_on_weights=True), atol=0, rtol=0)
    after = (quant.int8_matmul.launches, quant.int4_matmul.launches,
             quant.int4_matmul_scale_on_weights.launches)
    assert after == before    # no kernel ran


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("bias", [False, True])
def test_quant_linear_matches_quant_dense(mode, bias):
    import jax.numpy as jnp

    from cambrian_tpu.ops import quant as jquant

    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 3, 256)).astype(np.float32)
    w = _weights(rng, 256, 48)
    b = rng.standard_normal(48).astype(np.float32)
    if mode == "int4":
        q, s = jquant.quantize_int4(jnp.asarray(w))
        jmod, leaves = jquant.QuantDense4(48, use_bias=bias), {"kernel_q4": q, "scale": s}
        mod = quant.QuantLinear4(256, 48, bias=bias, dtype=torch.float32)
    else:
        q, s = jquant.quantize_int8(jnp.asarray(w))
        jmod, leaves = jquant.QuantDense(48, use_bias=bias), {"kernel_q": q, "scale": s}
        mod = quant.QuantLinear(256, 48, bias=bias, dtype=torch.float32)
    if bias:
        leaves["bias"] = jnp.asarray(b)
    want = np.asarray(jmod.apply({"params": leaves}, jnp.asarray(x)))
    mod.load_state_dict({k: _t(v) for k, v in leaves.items()})
    with torch.no_grad():
        got = mod(_t(x))
    assert got.shape == (2, 3, 48)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


# -- the tiny quantized Cambrian --------------------------------------------------

QCONFIGS = ["tiny", "tiny_long"]


@pytest.fixture(scope="module", params=[(c, m) for c in QCONFIGS for m in ("int8", "int4")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def quant_pair(request):
    import jax
    import jax.numpy as jnp

    from cambrian_tpu.constants import IMAGE_TOKEN_INDEX
    from cambrian_tpu.data.packing import prepare_multimodal_data
    from cambrian_tpu.models.cambrian import CambrianLM as JCambrianLM
    from cambrian_tpu.models.config import tiny_debug
    from cambrian_tpu.models.encoders.base import build_vision_tower_aux_list
    from cambrian_tpu.ops.quant import quantize_dense_tree
    from cambrian_tpu_torch.checkpoint.from_jax import state_dict_from_jax
    from cambrian_tpu_torch.models.builder import CambrianForInference
    from cambrian_tpu_torch.models.config import CambrianConfig

    name, mode = request.param
    base = tiny_debug(num_towers=2)
    cfg, seq = (base, 40) if name == "tiny" else (
        base.replace(tokenizer_model_max_length=192), 140)
    cfg = cfg.replace(quantize=mode)
    rng = np.random.default_rng(0)
    towers = build_vision_tower_aux_list(cfg.mm_vision_tower_aux_list,
                                         cfg.mm_vision_tower_aux_token_len_list)
    ids = rng.integers(5, cfg.vocab_size, (1, seq)).astype(np.int64)
    ids[0, cfg.image_position] = IMAGE_TOKEN_INDEX
    pids, _, pmask, ppos, aux_masks = prepare_multimodal_data(
        ids, ids.copy(), np.ones_like(ids, bool), [(640, 360)], cfg.image_token_len,
        cfg.mm_vision_tower_aux_token_len_list, cfg.tokenizer_model_max_length)
    feats = [jnp.asarray(rng.standard_normal((1, t.interp_size, t.hidden_size),
                                             dtype=np.float32)) for t in towers]
    jmasks = [jnp.asarray(m) for m in aux_masks]
    plain = JCambrianLM(cfg.replace(quantize=None), tuple(t.hidden_size for t in towers))
    params = plain.init(jax.random.PRNGKey(0), jnp.asarray(pids), jnp.asarray(pmask),
                        jnp.asarray(ppos), feats, jmasks)["params"]
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.02 * rng.standard_normal(a.shape).astype(np.float32),
        params)
    params = {k: quantize_dense_tree(v, mode=mode) if k.startswith("layers_") else v
              for k, v in params.items()}
    params = {"params": params}
    model = JCambrianLM(cfg, tuple(t.hidden_size for t in towers))

    sd = state_dict_from_jax(params, prefix="lm.")
    port_cfg = CambrianConfig.from_dict(cfg.to_dict())
    tower_sd = {}
    for i, t in enumerate(towers):
        tp = jax.tree.map(np.asarray, t.init(jax.random.PRNGKey(i + 1)))
        tower_sd.update(state_dict_from_jax(tp, prefix=f"towers.{i}.module."))
    port = CambrianForInference.from_state_dict(port_cfg, {**sd, **tower_sd},
                                                dtype=torch.float32, cache_dtype=torch.float32)
    return dict(cfg=cfg, model=model, params=params, towers=towers, feats=feats,
                jmasks=jmasks, pids=pids, pmask=pmask, ppos=ppos, aux_masks=aux_masks,
                port=port, mode=mode)


def test_tiny_quantized_model_holds_quantized_buffers(quant_pair):
    lm = quant_pair["port"].lm
    proj = lm.layers_0.mlp.down_proj
    kq = "kernel_q4" if quant_pair["mode"] == "int4" else "kernel_q"
    assert isinstance(proj, quant.QuantLinear4 if quant_pair["mode"] == "int4"
                      else quant.QuantLinear)
    assert getattr(proj, kq).dtype == torch.int8 and proj.scale.dtype == torch.float32
    assert isinstance(lm.lm_head, torch.nn.Linear)     # the head stays full precision


def test_tiny_quantized_logits_match(quant_pair):
    import jax.numpy as jnp

    from cambrian_tpu.models.cambrian import CambrianLM as JCambrianLM
    from cambrian_tpu.models.language.llama import init_kv_cache as j_init_cache
    from cambrian_tpu_torch.models.language.llama import init_kv_cache

    p = quant_pair
    cfg = p["cfg"]
    s = p["pids"].shape[1]
    k_len = s + 4
    jlogits, jcache = p["model"].apply(
        p["params"], jnp.asarray(p["pids"]), jnp.asarray(p["pmask"]), jnp.asarray(p["ppos"]),
        j_init_cache(cfg, 1, k_len, jnp.float32), p["feats"], p["jmasks"],
        method=JCambrianLM.prefill)
    lm = p["port"].lm
    with torch.no_grad():
        logits, cache = lm.prefill(_t(p["pids"]), _t(p["pmask"]), _t(p["ppos"]),
                                   init_kv_cache(p["port"].config, 1, k_len, torch.float32),
                                   [_t(f) for f in p["feats"]], [_t(m) for m in p["aux_masks"]])
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    valid = np.zeros((1, k_len), bool)
    valid[:, :s] = p["pmask"]
    valid[:, s] = True
    tok, pos = np.array([[7]]), p["ppos"].max(axis=1, keepdims=True) + 1
    jstep, _ = p["model"].apply(p["params"], jnp.asarray(tok), jnp.asarray(pos), jcache,
                                jnp.asarray(valid), jnp.int32(s), method=JCambrianLM.decode_step)
    with torch.no_grad():
        step, _ = lm.decode_step(_t(tok), _t(pos), cache, _t(valid), s)
    np.testing.assert_allclose(step.numpy(), np.asarray(jstep), atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_tiny_quantized_greedy_tokens_identical(quant_pair):
    import jax.numpy as jnp

    from cambrian_tpu.infer.engine import GenerationConfig as JGenConfig
    from cambrian_tpu.infer.engine import GenerationEngine as JEngine
    from cambrian_tpu_torch.infer.engine import GenerationConfig

    p = quant_pair
    cfg = p["cfg"]
    jeng = JEngine(p["model"], p["params"], p["towers"],
                   max_len=cfg.tokenizer_model_max_length + 64, cache_dtype=jnp.float32)
    want = jeng.generate(p["pids"], p["pmask"], p["ppos"], p["feats"], p["jmasks"],
                         JGenConfig(max_new_tokens=8, eos_token_id=None))
    eng = p["port"].engine
    got = eng.generate(p["pids"], p["pmask"], p["ppos"], [_t(f) for f in p["feats"]],
                       p["aux_masks"], GenerationConfig(max_new_tokens=8, eos_token_id=None))
    assert got.shape == (1, 8)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(eng.last_lengths, np.asarray(jeng.last_lengths))


# -- the kernels, on the card -----------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


# (M, K, N): decode (M <= 8) and prefill rows, groups of 128 and one group
# spanning K (also one K % 32 != 0), N a multiple of 8 (8-byte loads) or not.
# The bf16 prefill kernel (wgmma, TMA) takes N % 16 == 0 with 16-byte-aligned
# rows of x; its edges: a full 645-row prefill tile row at the decoder's
# N = 1024 and at the down_proj K, M not a multiple of any tile (200), M = 9
# and 64 (one M tile, part or all of it live), one int4 group spanning a K of
# three tiles (192), and a last tile of 16 columns (N = 1040 in tiles of 64,
# 8208 in tiles of 128). The other shapes, and x off the 16-byte alignment,
# take the mma.sync kernel.
KERNEL_SHAPES = [(1, 4096, 1024), (3, 512, 96), (8, 130, 100), (40, 256, 72),
                 (77, 4096, 1024), (9, 96, 20), (33, 130, 100), (645, 14336, 256),
                 (645, 4096, 1024), (645, 14336, 4096), (200, 4096, 4096), (9, 4096, 1024),
                 (64, 4096, 1024), (65, 192, 256), (100, 256, 1040), (300, 512, 8208)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int8", "int4", "int4_scale_on_weights"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", KERNEL_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("layout", ["contiguous", "strided", "row_stride"])
def test_kernel_matches_plain_on_card(cuda_device, mode, dtype, shape, layout):
    m, k, n = shape
    g = torch.Generator(device=cuda_device).manual_seed(m * k + n)
    w = torch.randn((k, n), generator=g, device=cuda_device) * 0.02
    # made in dtype before it is sliced: .to() of a slice would be contiguous
    x = torch.randn((m, k + 8), generator=g, device=cuda_device).to(dtype)
    # strided: a column slice of a wider buffer, off the 16-byte alignment of
    # vector loads, with a unit stride along K; row_stride: rows of x K + 8
    # elements apart, each starting on a 16-byte boundary when K % 8 == 0
    if layout == "contiguous":
        x = x[:, :k].contiguous()
    else:
        x = x[:, 4:4 + k] if layout == "strided" else x[:, :k]
    if mode == "int8":
        q, s = quant.quantize_int8(w)
        fn, plain = quant.int8_matmul, quant.int8_matmul_reference
    else:
        q, s = quant.quantize_int4(w)
        sow = mode == "int4_scale_on_weights"
        fn = quant.int4_matmul_scale_on_weights if sow else quant.int4_matmul
        plain = functools.partial(quant.int4_matmul_reference, scale_on_weights=sow)
    before = fn.launches
    out = fn(x, q, s)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert out.shape == (m, n) and out.dtype == dtype
    # the plain version in the kernel's dtype: the same roundings of the
    # weights, the product in fp32 with another summation order
    want = plain(x, q, s).float()
    scale = float(want.abs().max())
    # bf16: one rounding of the output (2^-8 relative) either side; fp32: sums
    tol = (2 ** -7 if dtype == torch.bfloat16 else 1e-5) * max(scale, 1.0)
    err = float((out.float() - want).abs().max())
    assert err <= tol, (err, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int8", "int4", "int4_scale_on_weights"])
def test_prefill_dequantizes_every_value_exactly(cuda_device, mode):
    """x is the identity, so the bf16 prefill kernel returns the dequantized
    weights, which hold every int8 value (every packed int4 byte), with
    scales of 1: the result must be exact."""
    k = n = 256
    rng = np.random.default_rng(0)
    x = torch.eye(k, device=cuda_device).to(torch.bfloat16)
    if mode == "int8":
        # each column a permutation of -128 .. 127
        q = np.stack([rng.permutation(256) - 128 for _ in range(n)], axis=1)
        q = torch.from_numpy(q.astype(np.int8)).to(cuda_device)
        out = quant.int8_matmul(x, q, torch.ones(n, device=cuda_device))
        want = q.float()
    else:
        # each pair of columns holds every byte: column j a permutation of
        # the 128 bytes whose top bit is j % 2
        b = np.stack([rng.permutation(128) + 128 * (j % 2) for j in range(n)], axis=1)
        q = torch.from_numpy(b.astype(np.uint8).view(np.int8)).to(cuda_device)
        fn = (quant.int4_matmul if mode == "int4" else quant.int4_matmul_scale_on_weights)
        out = fn(x, q, torch.ones((1, n), device=cuda_device))
        want = quant._unpack_int4(q).float()
    torch.cuda.synchronize()
    assert torch.equal(out.float(), want)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda_device):
    w = torch.randn((64, 32), device=cuda_device)
    q, s = quant.quantize_int8(w)
    with pytest.raises(ValueError, match="unit stride"):
        quant.int8_matmul(torch.randn((64, 4), device=cuda_device).T, q, s)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        quant.int8_matmul(torch.randn((2, 64), device=cuda_device).half(), q, s)
    with pytest.raises(ValueError, match="x must be"):
        quant.int8_matmul(torch.randn((2, 63), device=cuda_device), q, s)
