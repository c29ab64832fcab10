"""Kernels K5-K8 of the port (SVA windowed attention, fused LayerNorm,
depthwise 7x7 conv, fused GELU MLP) against the JAX package's, on the CPU:

- each plain version against the JAX function (the Pallas kernels run in
  interpret mode, as the JAX package's own tests run them), forward and,
  where JAX has a ``custom_vjp``, gradients through it;
- the tiny Cambrian's (and a tiny ConvNeXt's) own activations at the drop-in
  sites that ``chip_smoke.py`` hooks: each plain version gives the main
  path's output there.

Inputs are made with numpy from a seed. The kernels themselves run only on
the card (marker ``cuda``; without JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_vision_kernels.py``).
"""

import os
import sys

import numpy as np
import pytest
import torch

from cambrian_tpu_torch.ops import dwconv, fused_mlp, norms, sva_attention

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5          # fp32: the same math in another order
BF16_REL = 2 ** -7  # bf16: the output's rounding (2^-8 relative) on either side


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, rel):
    """|got - want| <= rel * max(1, |want|max), elementwise, in fp32."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    tol = rel * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, (err, tol)


# -- K5: SVA windowed cross-attention --------------------------------------------

def _sva_inputs(seed, b, q, w, h, d, mask_kind):
    rng = np.random.default_rng(seed)
    qa = rng.standard_normal((b, q, h, d)).astype(np.float32)
    ka = rng.standard_normal((b, q, w, h, d)).astype(np.float32)
    va = rng.standard_normal((b, q, w, h, d)).astype(np.float32)
    mask = None
    if mask_kind == "3d":
        mask = rng.random((b, q, w)) > 0.3
        mask[:, :, 0] = True
    elif mask_kind == "4d":
        mask = rng.random((b, q, h, w)) > 0.3
    elif mask_kind == "dead":
        mask = rng.random((b, q, w)) > 0.3
        mask[:, ::7] = False            # every 7th query sees no key: uniform weights
    return qa, ka, va, mask


# (Q, W, D, mask): Q >= 64 and not a multiple of 64, W not a multiple of 16,
# D 64 and 72; a 4-D mask goes to the JAX einsum path (the same math in fp32).
# Dead windows (all keys masked) with W a multiple of 16: the JAX kernel pads
# W to a multiple of 16 with masked keys and zero values, so its uniform
# weights over a dead window also cover the padding (see the next test).
SVA_CASES = [(128, 22, 64, "3d"), (150, 19, 72, "none"), (96, 16, 64, "dead"),
             (70, 19, 72, "4d"), (64, 9, 64, "3d")]


@pytest.mark.parametrize("case", SVA_CASES, ids=lambda c: "-".join(map(str, c)))
def test_sva_reference_matches_jax_kernel(case):
    import jax.numpy as jnp

    from cambrian_tpu.ops.sva_attention import fused_windowed_cross_attention as jfused

    n_q, w, d, kind = case
    qa, ka, va, mask = _sva_inputs(n_q + w, 2, n_q, w, 3, d, kind)
    want = jfused(jnp.asarray(qa), jnp.asarray(ka), jnp.asarray(va),
                  None if mask is None else jnp.asarray(mask), block_q=64, interpret=True)
    got = sva_attention.fused_windowed_cross_attention(
        _t(qa), _t(ka), _t(va), None if mask is None else _t(mask))
    assert got.dtype == torch.float32 and got.shape == (2, n_q, 3, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_sva_reference_bf16_keeps_fp32_probabilities():
    """In bf16 the plain version follows the TPU kernel (PV on fp32
    probabilities, one cast), not the einsum path (probabilities rounded to
    bf16 first)."""
    import jax.numpy as jnp

    from cambrian_tpu.ops.sva_attention import fused_windowed_cross_attention as jfused

    qa, ka, va, mask = _sva_inputs(5, 1, 128, 19, 4, 64, "3d")
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (qa, ka, va))
    want = np.asarray(jfused(jq, jk, jv, jnp.asarray(mask), block_q=64, interpret=True),
                      np.float32)
    tq, tk, tv = (_t(np.asarray(a, np.float32)).bfloat16() for a in (jq, jk, jv))
    got = sva_attention.fused_windowed_cross_attention(tq, tk, tv, _t(mask))
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), want, BF16_REL)


def test_sva_dead_window_is_mean_of_v():
    """A dead window gets uniform weights over its W keys, the mean of V, as
    in the JAX einsum path. (The JAX kernel, for W not a multiple of 16,
    averages over its zero-padded window instead: W / (W + pad) of the mean.)"""
    import jax.numpy as jnp

    from cambrian_tpu.ops.attention import windowed_cross_attention as jeinsum

    qa, ka, va, mask = _sva_inputs(9, 1, 64, 13, 2, 64, "dead")
    got = sva_attention.fused_windowed_cross_attention(_t(qa), _t(ka), _t(va), _t(mask))
    np.testing.assert_allclose(got[0, ::7].numpy(), va[0, ::7].mean(1), atol=TOL, rtol=TOL)
    want = jeinsum(jnp.asarray(qa), jnp.asarray(ka), jnp.asarray(va), jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("kind", ["3d", "none"])
def test_sva_gradients_match_jax_custom_vjp(kind):
    import jax
    import jax.numpy as jnp

    from cambrian_tpu.ops.sva_attention import fused_windowed_cross_attention as jfused

    qa, ka, va, mask = _sva_inputs(13, 2, 72, 21, 2, 64, kind)
    ga = np.random.default_rng(14).standard_normal((2, 72, 2, 64)).astype(np.float32)
    jm = None if mask is None else jnp.asarray(mask)
    _, vjp = jax.vjp(lambda a, b_, c: jfused(a, b_, c, jm, block_q=64, interpret=True),
                     jnp.asarray(qa), jnp.asarray(ka), jnp.asarray(va))
    want = vjp(jnp.asarray(ga))
    ts = [_t(a).requires_grad_(True) for a in (qa, ka, va)]
    out = sva_attention.fused_windowed_cross_attention(*ts, None if mask is None else _t(mask))
    got = torch.autograd.grad(out, ts, _t(ga))
    for g, w_ in zip(got, want):
        _close(g.numpy(), np.asarray(w_), TOL)


# -- K6: the fused LayerNorm -------------------------------------------------------

# widths a multiple of 128 go through the JAX kernel in interpret mode, the
# others (72, 100) through its layer_norm path
@pytest.mark.parametrize("rows,cols", [(64, 128), (300, 256), (7, 384), (33, 72), (20, 100)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_reference_matches_jax(rows, cols, dtype):
    import jax.numpy as jnp

    from cambrian_tpu.ops.norms import fused_layer_norm as jfused

    rng = np.random.default_rng(rows * cols)
    xa = (rng.standard_normal((rows, cols)) * 3 + 1).astype(np.float32)
    wa = rng.standard_normal(cols).astype(np.float32)
    ba = rng.standard_normal(cols).astype(np.float32)
    jx = jnp.asarray(xa, jnp.dtype(dtype))
    want = np.asarray(jfused(jx, jnp.asarray(wa), jnp.asarray(ba), 1e-6, interpret=True),
                      np.float32)
    tx = _t(np.asarray(jx, np.float32)).to(getattr(torch, dtype))
    got = norms.fused_layer_norm(tx, _t(wa), _t(ba), 1e-6)
    assert got.dtype == tx.dtype
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    else:
        _close(got.float().numpy(), want, BF16_REL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_gradients_match_jax_custom_vjp(dtype):
    import jax
    import jax.numpy as jnp

    from cambrian_tpu.ops.norms import fused_layer_norm as jfused

    rng = np.random.default_rng(21)
    xa = rng.standard_normal((48, 256)).astype(np.float32)
    wa = (rng.standard_normal(256) + 1).astype(np.float32)
    ba = rng.standard_normal(256).astype(np.float32)
    ga = rng.standard_normal((48, 256)).astype(np.float32)
    jx = jnp.asarray(xa, jnp.dtype(dtype))
    _, vjp = jax.vjp(lambda x, w, b: jfused(x, w, b, 1e-5, interpret=True),
                     jx, jnp.asarray(wa), jnp.asarray(ba))
    want = vjp(jnp.asarray(ga, jnp.dtype(dtype)))
    tx = _t(np.asarray(jx, np.float32)).to(getattr(torch, dtype)).requires_grad_(True)
    tw, tb = _t(wa).requires_grad_(True), _t(ba).requires_grad_(True)
    out = norms.fused_layer_norm(tx, tw, tb, 1e-5)
    got = torch.autograd.grad(out, (tx, tw, tb), _t(ga).to(tx.dtype))
    assert got[0].dtype == tx.dtype and got[1].dtype == got[2].dtype == torch.float32
    rel = TOL if dtype == "float32" else BF16_REL
    for g, w_ in zip(got, want):
        _close(g.float().numpy(), np.asarray(w_, np.float32), rel)


def test_fused_layer_norm_module_loads_jax_params():
    """A JAX ``FusedLayerNorm`` param tree loads through ``from_jax.py`` into
    the port's module (the same state dict as ``LayerNorm``'s) and gives the
    same output."""
    import jax
    import jax.numpy as jnp

    from cambrian_tpu.ops.norms import FusedLayerNorm as JFusedLayerNorm
    from cambrian_tpu_torch.checkpoint.from_jax import load_jax_params

    rng = np.random.default_rng(3)
    xa = rng.standard_normal((2, 10, 128)).astype(np.float32)
    jmod = JFusedLayerNorm(epsilon=1e-6, dtype=jnp.float32)
    params = jmod.init(jax.random.PRNGKey(1), jnp.asarray(xa))
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(np.float32), params)
    want = np.asarray(jmod.apply(params, jnp.asarray(xa)))
    mod = load_jax_params(norms.FusedLayerNorm(128, eps=1e-6, dtype=torch.float32), params)
    assert set(mod.state_dict()) == set(norms.LayerNorm(128).state_dict())
    assert mod.weight.dtype == mod.bias.dtype == torch.float32
    with torch.no_grad():
        got = mod(_t(xa))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


# -- K7: the depthwise 7x7 conv ----------------------------------------------------

# H not a multiple of 8, C 128 and 96, bf16 x with fp32 weights
@pytest.mark.parametrize("shape,dtype", [((2, 12, 10, 128), "float32"),
                                         ((1, 13, 16, 96), "float32"),
                                         ((2, 12, 12, 96), "bfloat16")],
                         ids=["12x10x128", "13x16x96", "12x12x96-bf16"])
def test_dwconv_reference_matches_jax_kernel(shape, dtype):
    import jax.numpy as jnp

    from cambrian_tpu.ops.dwconv import depthwise_conv7x7 as jdwconv

    rng = np.random.default_rng(sum(shape))
    xa = rng.standard_normal(shape).astype(np.float32)
    wa = rng.standard_normal((7, 7, shape[-1])).astype(np.float32)
    ba = rng.standard_normal(shape[-1]).astype(np.float32)
    jx = jnp.asarray(xa, jnp.dtype(dtype))
    want = np.asarray(jdwconv(jx, jnp.asarray(wa), jnp.asarray(ba), interpret=True), np.float32)
    tx = _t(np.asarray(jx, np.float32)).to(getattr(torch, dtype))
    got = dwconv.depthwise_conv7x7(tx, _t(wa), _t(ba))
    assert got.dtype == tx.dtype and got.shape == shape
    _close(got.float().numpy(), want, TOL if dtype == "float32" else BF16_REL)


def test_dwconv_gradients_match_jax_custom_vjp():
    import jax
    import jax.numpy as jnp

    from cambrian_tpu.ops.dwconv import _dwconv_bwd
    from cambrian_tpu.ops.dwconv import depthwise_conv7x7 as jdwconv

    rng = np.random.default_rng(31)
    xa = rng.standard_normal((2, 9, 11, 96)).astype(np.float32)
    wa = rng.standard_normal((7, 7, 96)).astype(np.float32)
    ba = rng.standard_normal(96).astype(np.float32)
    ga = rng.standard_normal((2, 9, 11, 96)).astype(np.float32)
    _, vjp = jax.vjp(lambda x, w, b: jdwconv(x, w, b, interpret=True),
                     jnp.asarray(xa), jnp.asarray(wa), jnp.asarray(ba))
    want = vjp(jnp.asarray(ga))
    direct = _dwconv_bwd(True, (jnp.asarray(xa), jnp.asarray(wa)), jnp.asarray(ga))
    ts = [_t(a).requires_grad_(True) for a in (xa, wa, ba)]
    got = torch.autograd.grad(dwconv.depthwise_conv7x7(*ts), ts, _t(ga))
    for g, w_, d_ in zip(got, want, direct):
        _close(g.numpy(), np.asarray(w_), TOL)
        _close(g.numpy(), np.asarray(d_), TOL)


# -- K8: the fused MLP -------------------------------------------------------------

def _mlp_inputs(seed, m, c, h, c2, bias):
    rng = np.random.default_rng(seed)
    xa = rng.standard_normal((m, c)).astype(np.float32)
    w1 = (rng.standard_normal((c, h)) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((h, c2)) * 0.1).astype(np.float32)
    b1 = (rng.standard_normal(h) * 0.1).astype(np.float32) if bias else None
    b2 = (rng.standard_normal(c2) * 0.1).astype(np.float32) if bias else None
    return xa, w1, b1, w2, b2


@pytest.mark.parametrize("m", [64, 300])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
def test_fused_mlp_reference_matches_jax_fp32(m, bias):
    """fp32, where the TPU kernel's roundings and the off-TPU fallback's
    coincide; the A&S erf is within 1.5e-7 of the exact one."""
    import jax.numpy as jnp

    from cambrian_tpu.ops.fused_mlp import fused_mlp as jfused

    arrays = _mlp_inputs(m, m, 48, 192, 40, bias)
    want = jfused(*(None if a is None else jnp.asarray(a) for a in arrays))
    got = fused_mlp.fused_mlp(*(None if a is None else _t(a) for a in arrays))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
def test_fused_mlp_reference_matches_pallas_kernel_body_bf16(bias):
    """The TPU kernel body ``_fused_mlp_kernel`` through a ``pallas_call`` in
    interpret mode (grid over 2 row blocks x 3 hidden blocks), in bf16: the
    plain version rounds h to bf16 between the products where the kernel
    does, so only the fp32 summation order differs."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    from cambrian_tpu.ops.fused_mlp import _fused_mlp_kernel

    m, c, h, c2, bm, bn = 64, 32, 192, 48, 32, 64
    xa, w1, b1, w2, b2 = _mlp_inputs(7, m, c, h, c2, True)
    if not bias:
        b1, b2 = np.zeros(h, np.float32), np.zeros(c2, np.float32)
    jx, jw1, jw2 = (jnp.asarray(a, jnp.bfloat16) for a in (xa, w1, w2))
    out = pl.pallas_call(
        _fused_mlp_kernel,
        grid=(m // bm, h // bn),
        in_specs=[pl.BlockSpec((1, bm, c), lambda i, j: (0, i, 0)),
                  pl.BlockSpec((1, c, bn), lambda i, j: (0, 0, j)),
                  pl.BlockSpec((1, 1, bn), lambda i, j: (0, 0, j)),
                  pl.BlockSpec((1, bn, c2), lambda i, j: (0, j, 0)),
                  pl.BlockSpec((1, 1, c2), lambda i, j: (0, 0, 0))],
        out_specs=pl.BlockSpec((1, bm, c2), lambda i, j: (0, i, 0)),
        out_shape=jax.ShapeDtypeStruct((1, m, c2), jnp.bfloat16),
        scratch_shapes=[pltpu.VMEM((bm, c2), jnp.float32)],
        interpret=True,
    )(jx[None], jw1[None], jnp.asarray(b1)[None, None], jw2[None], jnp.asarray(b2)[None, None])
    want = np.asarray(out[0], np.float32)
    tx, tw1, tw2 = (_t(np.asarray(a, np.float32)).bfloat16() for a in (jx, jw1, jw2))
    got = fused_mlp.fused_mlp(tx, tw1, _t(b1) if bias else None, tw2, _t(b2) if bias else None)
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), want, BF16_REL)
    # without the rounding of h the result moves by more than the bf16 output
    # rounding: the check above sees where h is rounded
    h32 = fused_mlp.gelu_as(tx.float() @ tw1.float() + _t(b1))
    unrounded = (h32 @ tw2.float() + _t(b2)).numpy()
    assert np.abs(unrounded - got.float().numpy()).max() > 0


def test_wrappers_take_the_plain_versions_on_cpu():
    rng = np.random.default_rng(2)
    x = _t(rng.standard_normal((3, 9, 64)).astype(np.float32))
    before = (norms.fused_layer_norm.launches, dwconv.depthwise_conv7x7.launches,
              sva_attention.fused_windowed_cross_attention.launches, fused_mlp.fused_mlp.launches)
    w, b = torch.ones(64), torch.zeros(64)
    torch.testing.assert_close(norms.fused_layer_norm(x, w, b),
                               norms.fused_layer_norm_reference(x, w, b), atol=0, rtol=0)
    xi = x.reshape(1, 3, 9, 64)
    wc = torch.ones(7, 7, 64)
    torch.testing.assert_close(dwconv.depthwise_conv7x7(xi, wc, b),
                               dwconv.depthwise_conv7x7_reference(xi, wc, b), atol=0, rtol=0)
    w1 = torch.ones(64, 8)
    w2 = torch.ones(8, 5)
    torch.testing.assert_close(fused_mlp.fused_mlp(x[0], w1, None, w2, None),
                               fused_mlp.fused_mlp_reference(x[0], w1, None, w2, None),
                               atol=0, rtol=0)
    after = (norms.fused_layer_norm.launches, dwconv.depthwise_conv7x7.launches,
             sva_attention.fused_windowed_cross_attention.launches,
             fused_mlp.fused_mlp.launches)
    assert after == before    # no kernel ran
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        fused_mlp.fused_mlp(x[0].to("meta"), w1, None, w2, None)


# -- the drop-in sites of the tiny models (the chip phase's hooks) ------------------

def _chip_smoke():
    sys.path.insert(0, REPO)
    import chip_smoke

    return chip_smoke


@pytest.fixture(scope="module")
def tiny_sites():
    """The sites of one tiny Cambrian request and of a tiny ConvNeXt tower,
    captured with ``chip_smoke.capture_sites`` (fp32, CPU)."""
    from cambrian_tpu_torch import IMAGE_TOKEN_INDEX, tiny_debug
    from cambrian_tpu_torch.models.builder import CambrianForInference, random_state_dict
    from cambrian_tpu_torch.models.encoders.convnext import ConvNeXtTokens, tiny_convnext

    cs = _chip_smoke()
    cfg = tiny_debug(num_towers=2)
    sd = random_state_dict(cfg, torch.Generator().manual_seed(0), 0.05, dtype=torch.float32,
                           device="cpu")
    model = CambrianForInference.from_state_dict(cfg, sd, torch.float32,
                                                 cache_dtype=torch.float32)
    rng = np.random.default_rng(0)
    ids = rng.integers(5, cfg.vocab_size, 40)
    ids[cfg.image_position] = IMAGE_TOKEN_INDEX
    images = [rng.standard_normal((1, 3, t.image_size, t.image_size)).astype(np.float32)
              for t in model.towers]
    sites = cs.capture_sites(torch, [model.lm, *model.towers], lambda: model.generate(
        ids, images=images, image_sizes=[(640, 360)], max_new_tokens=2, eos_token_id=None))
    tower = ConvNeXtTokens(tiny_convnext(48), interp_side=4)
    with torch.no_grad():
        for p in tower.parameters():
            p.copy_(torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32) * 0.1))
    pixels = torch.from_numpy(rng.standard_normal((1, 3, 48, 48)).astype(np.float32))
    conv_sites = cs.capture_sites(torch, [tower], lambda: tower(pixels))
    for kind, found in conv_sites.items():
        sites[kind].update(found)
    return sites


def test_tiny_sites_cover_every_kernel(tiny_sites):
    counts = {kind: sum(s["count"] for s in found.values()) for kind, found in tiny_sites.items()}
    # SVA attention: the connector's 2 layers and 2 in-decoder injections;
    # the tiny ConvNeXt has 1 + 1 + 2 + 1 blocks
    assert counts["fused_windowed_cross_attention"] == 4
    assert counts["depthwise_conv7x7"] == 5
    assert sum(s["count"] for k, s in tiny_sites["fused_mlp"].items() if k[0] == "convnext") == 5
    assert any(k[0] == "sva_mlp" for k in tiny_sites["fused_mlp"])
    assert counts["fused_layer_norm"] > 0


def test_plain_versions_reproduce_the_main_path_at_its_sites(tiny_sites):
    """Each plain version, on the inputs the main path gave one of its ops,
    gives that op's output (fp32, 1e-5)."""
    cs = _chip_smoke()
    n = 0
    for kind, found in tiny_sites.items():
        for key, site in found.items():
            got = cs.plain_at_site(torch, kind, site)
            np.testing.assert_allclose(got.numpy(), site["out"].numpy(), atol=TOL, rtol=TOL,
                                       err_msg=f"{kind} {key}")
            n += 1
    assert n >= 6


# -- the kernels, on the card -------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _rel(dtype):
    return BF16_REL if dtype == torch.bfloat16 else 1e-4


def _held(out, want, dtype):
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    tol = _rel(dtype) * max(1.0, float(want.abs().max()))
    err = float((out.float() - want.float()).abs().max())
    assert err <= tol, (err, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("rows,cols", [(1, 72), (300, 100), (577, 1024), (4096, 1536)])
def test_layer_norm_kernel_matches_plain_on_card(cuda_device, dtype, rows, cols):
    g = torch.Generator(device=cuda_device).manual_seed(rows + cols)
    x = (torch.randn((rows, cols), generator=g, device=cuda_device) * 3 + 1).to(dtype)
    w = torch.randn(cols, generator=g, device=cuda_device)
    b = torch.randn(cols, generator=g, device=cuda_device)
    before = norms.fused_layer_norm.launches
    out = norms.fused_layer_norm(x, w, b, 1e-6)
    assert norms.fused_layer_norm.launches == before + 1 and out.dtype == dtype
    _held(out, norms.fused_layer_norm_reference(x.float(), w, b, 1e-6), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", [(1, 13, 11, 96), (2, 32, 32, 384), (1, 9, 40, 3072),
                                   # ConvNeXt-XXL's four stages at 1024 px
                                   (1, 256, 256, 384), (1, 128, 128, 768), (1, 64, 64, 1536),
                                   (1, 32, 32, 3072),
                                   # positions of 180 / 360 bytes: no tensor map
                                   (1, 13, 11, 90)],
                         ids=lambda s: "x".join(map(str, s)))
def test_dwconv_kernel_matches_plain_on_card(cuda_device, dtype, shape):
    g = torch.Generator(device=cuda_device).manual_seed(sum(shape))
    x = torch.randn(shape, generator=g, device=cuda_device).to(dtype)
    w = torch.randn((7, 7, shape[-1]), generator=g, device=cuda_device) * 0.2
    b = torch.randn(shape[-1], generator=g, device=cuda_device)
    before = dwconv.depthwise_conv7x7.launches
    routes = dict(dwconv.depthwise_conv7x7.function_launches)
    out = dwconv.depthwise_conv7x7(x, w, b)
    assert dwconv.depthwise_conv7x7.launches == before + 1 and out.dtype == dtype
    want = dwconv.DW_OLD if shape[-1] == 90 else dwconv.DW_TMA
    assert dwconv.depthwise_conv7x7.function_launches[want] == routes.get(want, 0) + 1
    _held(out, dwconv.depthwise_conv7x7_reference(x.float(), w, b), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("case", [(1, 576, 19, 16, 64, "3d"), (2, 70, 64, 3, 72, "4d"),
                                  (1, 33, 5, 2, 128, "none"), (2, 64, 19, 4, 64, "dead"),
                                  # the 8B site at the training batch
                                  (8, 576, 19, 16, 64, "3d"),
                                  # k and v as [B, Q, W, H, D] views of [B, Q, H, W, D]
                                  # storage: no tensor map, the first port's kernel
                                  (1, 576, 19, 16, 64, "3d", "strided")],
                         ids=lambda c: "-".join(map(str, c)))
def test_sva_kernel_matches_plain_on_card(cuda_device, dtype, case):
    b, n_q, w, h, d, kind, *layout = case
    qa, ka, va, mask = _sva_inputs(w + d, b, n_q, w, h, d, kind)
    q, k, v = (_t(a).to(cuda_device, dtype) for a in (qa, ka, va))
    if layout:
        k, v = (t.transpose(2, 3).contiguous().transpose(2, 3) for t in (k, v))
    m = None if mask is None else _t(mask).to(cuda_device)
    fn = sva_attention.fused_windowed_cross_attention
    before, routes = fn.launches, dict(fn.function_launches)
    out = fn(q, k, v, m)
    assert fn.launches == before + 1
    want = sva_attention.SVA_OLD if layout else sva_attention.SVA_TMA
    assert fn.function_launches[want] == routes.get(want, 0) + 1
    _held(out, sva_attention.fused_windowed_cross_attention_reference(
        q.float(), k.float(), v.float(), m), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("case", [(300, 48, 192, 40, True), (1024, 384, 1536, 384, True),
                                  (576, 1024, 1024, 4096, False), (77, 100, 36, 3, True)],
                         ids=lambda c: "-".join(map(str, c)))
def test_fused_mlp_kernel_matches_plain_on_card(cuda_device, dtype, case):
    m, c, h, c2, bias = case
    xa, w1, b1, w2, b2 = _mlp_inputs(m + c, m, c, h, c2, bias)
    x, tw1, tw2 = (_t(a).to(cuda_device, dtype) for a in (xa, w1, w2))
    tb1, tb2 = (None if a is None else _t(a).to(cuda_device) for a in (b1, b2))
    before = fused_mlp.fused_mlp.launches
    out = fused_mlp.fused_mlp(x, tw1, tb1, tw2, tb2)
    assert fused_mlp.fused_mlp.launches == before + 1 and out.shape == (m, c2)
    _held(out, fused_mlp.fused_mlp_reference(x.float(), tw1.float(), tb1, tw2.float(), tb2)
          if dtype == torch.float32 else fused_mlp.fused_mlp_reference(x, tw1, tb1, tw2, tb2),
          dtype)


@pytest.mark.cuda
def test_fused_mlp_refuses_grad_on_card(cuda_device):
    x = torch.randn((8, 16), device=cuda_device, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        fused_mlp.fused_mlp(x, torch.randn((16, 32), device=cuda_device), None,
                            torch.randn((32, 16), device=cuda_device), None)


@pytest.mark.cuda
def test_backwards_match_plain_on_card(cuda_device):
    """K5, K6, K7 through their autograd Functions on the card against the
    plain backward on the fp32-upcast inputs."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    dt = torch.bfloat16

    def grads(fn, inputs, cot):
        leaves = [t.detach().requires_grad_(True) for t in inputs]
        return torch.autograd.grad(fn(*leaves), leaves, cot)

    x = torch.randn((64, 768), generator=g, device=cuda_device).to(dt)
    w, b = torch.randn(768, generator=g, device=cuda_device), torch.randn(768, device=cuda_device)
    cot = torch.randn((64, 768), generator=g, device=cuda_device).to(dt)
    got = grads(lambda *t: norms.fused_layer_norm(*t, 1e-6), (x, w, b), cot)
    want = norms.fused_layer_norm_bwd_reference(x.float(), w, cot.float(), 1e-6)
    for a, e in zip(got, want):
        _held(a, e, dt)

    x = torch.randn((1, 16, 16, 384), generator=g, device=cuda_device).to(dt)
    wc = torch.randn((7, 7, 384), generator=g, device=cuda_device) * 0.2
    cot = torch.randn((1, 16, 16, 384), generator=g, device=cuda_device).to(dt)
    got = grads(dwconv.depthwise_conv7x7, (x, wc, b[:384]), cot)
    want = dwconv.depthwise_conv7x7_bwd_reference(x.float(), wc, cot.float())
    for a, e in zip(got, want):
        _held(a, e, dt)

    qa, ka, va, mask = _sva_inputs(1, 1, 64, 19, 4, 64, "3d")
    q, k, v = (_t(a).to(cuda_device, dt) for a in (qa, ka, va))
    m = _t(mask).to(cuda_device)
    cot = torch.randn((1, 64, 4, 64), generator=g, device=cuda_device).to(dt)
    got = grads(lambda *t: sva_attention.fused_windowed_cross_attention(*t, m), (q, k, v), cot)
    want = sva_attention.fused_windowed_cross_attention_bwd_reference(
        q.float(), k.float(), v.float(), m, cot.float())
    for a, e in zip(got, want):
        _held(a, e, dt)
