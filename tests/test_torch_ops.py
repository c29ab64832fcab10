"""Parity of the port's plain ops and SVA modules (cambrian_tpu_torch/ops,
models/sva.py) with the JAX package's, on the CPU in fp32, on the same
numpy inputs."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cambrian_tpu.models import cambrian as jcambrian
from cambrian_tpu.models import sva as jsva
from cambrian_tpu.ops import activations as jact
from cambrian_tpu.ops import attention as jattn
from cambrian_tpu.ops import norms as jnorms
from cambrian_tpu.ops import resize as jresize
from cambrian_tpu_torch.checkpoint.from_jax import load_jax_params
from cambrian_tpu_torch.models import cambrian as tcambrian
from cambrian_tpu_torch.models import sva as tsva
from cambrian_tpu_torch.ops import activations as tact
from cambrian_tpu_torch.ops import attention as tattn
from cambrian_tpu_torch.ops import norms as tnorms
from cambrian_tpu_torch.ops import resize as tresize

TOL = 1e-5  # fp32, same math; summation order and erf evaluation differ


def _rand(*shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=tol)


def test_norms():
    x, w, b = _rand(3, 5, 64, seed=1, scale=3.0), _rand(64, seed=2), _rand(64, seed=3)
    t = [torch.from_numpy(a) for a in (x, w, b)]
    _close(tnorms.rms_norm(t[0], t[1], 1e-5), jnorms.rms_norm(x, w, 1e-5))
    _close(tnorms.layer_norm(*t, 1e-6), jnorms.layer_norm(x, w, b, 1e-6))
    _close(tnorms.layer_norm(*t, 1e-6), jnorms.layer_norm_stream(x, w, b, 1e-6))


def test_gelu_exact():
    x = _rand(4096, seed=4, scale=4.0)
    _close(tact.gelu_exact(torch.from_numpy(x)), jact.gelu_exact(jnp.asarray(x)))


@pytest.mark.parametrize("sizes", [(27, 24), (8, 24), (256, 96), (4, 4)])
def test_resize_bilinear(sizes):
    n_in, n_out = sizes
    x = _rand(2, n_in, n_in, 3, seed=n_in)
    _close(tresize.resize_bilinear(torch.from_numpy(x), n_out, n_out),
           jresize.resize_bilinear(jnp.asarray(x), n_out, n_out))


def test_interpolate_tokens():
    x = _rand(2, 729, 16, seed=5)     # SigLIP's 27x27 grid -> 24x24
    _close(tresize.interpolate_tokens(torch.from_numpy(x), 576),
           jresize.interpolate_tokens(jnp.asarray(x), 576))


@pytest.mark.parametrize("logit_cap", [None, 30.0])
def test_dot_product_attention(logit_cap):
    q, k, v = _rand(2, 6, 3, 16, seed=6), _rand(2, 9, 3, 16, seed=7), _rand(2, 9, 3, 16, seed=8)
    mask = np.random.default_rng(9).random((2, 1, 6, 9)) > 0.3
    mask[1, 0, 2] = False           # a fully masked row: uniform weights
    got = tattn.dot_product_attention(*(torch.from_numpy(a) for a in (q, k, v, mask)),
                                      logit_cap=logit_cap)
    want = jattn.dot_product_attention(q, k, v, jnp.asarray(mask), logit_cap=logit_cap)
    _close(got, want)
    np.testing.assert_allclose(got[1, 2].numpy(), v[1].mean(0), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("mask_rank", [3, 4])
def test_windowed_cross_attention(mask_rank):
    q, k, v = _rand(2, 4, 2, 8, seed=10), _rand(2, 4, 5, 2, 8, seed=11), _rand(2, 4, 5, 2, 8, seed=12)
    shape = (2, 4, 5) if mask_rank == 3 else (2, 4, 2, 5)
    mask = np.random.default_rng(13).random(shape) > 0.4
    got = tattn.windowed_cross_attention(*(torch.from_numpy(a) for a in (q, k, v, mask)))
    _close(got, jattn.windowed_cross_attention(q, k, v, jnp.asarray(mask)))


def test_window_helpers():
    feats = _rand(2, 64, 3, seed=14)
    _close(tcambrian.window_features(torch.from_numpy(feats), 4),
           jcambrian.window_features(jnp.asarray(feats), 4))
    flat = np.random.default_rng(15).random((2, 64)) > 0.7
    flat[0, :16] = False
    got = tcambrian.window_mask(torch.from_numpy(flat), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jcambrian.window_mask(jnp.asarray(flat), 4)))
    np.testing.assert_array_equal(
        tcambrian.unwindow_mask(got, 4).numpy(),
        np.asarray(jcambrian.unwindow_mask(jnp.asarray(got.numpy()), 4)))


def _perturbed_init(module, *args):
    params = module.init(jax.random.PRNGKey(0), *args)["params"]
    rng = np.random.default_rng(16)
    return jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(x.shape).astype(np.float32),
        params)


@pytest.mark.parametrize("layer_type", ["joint", "sep"])
def test_vision_token_sampler(layer_type):
    # three towers: windows 2x2, 1x1 and 2x2 around a 3x3 query grid
    q_dim, vh, kv_sizes = 24, 16, [2, 1, 2]
    queries, ctx = _rand(2, 9, q_dim, seed=17), _rand(2, 9, vh, seed=18)
    kvs = [_rand(2, 9, s * s, vh, seed=19 + i) for i, s in enumerate(kv_sizes)]
    masks = [np.random.default_rng(30 + i).random((2, 9, s * s)) > 0.3
             for i, s in enumerate(kv_sizes)]
    for m in masks:
        m[m.sum(-1) == 0] = True
    jmod = jsva.VisionTokenSampler(q_dim=q_dim, kv_size_list=kv_sizes,
                                   vision_hidden_size=vh, num_of_layers=2,
                                   layer_type=layer_type)
    jargs = (jnp.asarray(queries), jnp.asarray(ctx), [jnp.asarray(k) for k in kvs],
             [jnp.asarray(m) for m in masks])
    params = _perturbed_init(jmod, *jargs)
    want = jmod.apply({"params": params}, *jargs)
    port = load_jax_params(tsva.VisionTokenSampler(q_dim, vh, kv_sizes, vh, 2, layer_type),
                           params)
    with torch.no_grad():
        got = port(torch.from_numpy(queries), torch.from_numpy(ctx),
                   [torch.from_numpy(k) for k in kvs], [torch.from_numpy(m) for m in masks])
    _close(got, want)


def test_sincos_tables_are_shared_math():
    np.testing.assert_array_equal(tsva.get_2d_sincos_pos_embed(16, 4, cls_token=True),
                                  jsva.get_2d_sincos_pos_embed(16, 4, cls_token=True))


def test_sample_token_greedy_and_top_p():
    from cambrian_tpu.infer.engine import sample_token as j_sample
    from cambrian_tpu_torch.infer.engine import sample_token

    logits = _rand(3, 50, seed=40, scale=3.0)
    t = torch.from_numpy(logits)
    np.testing.assert_array_equal(sample_token(t, None, 0.0, 1.0).numpy(),
                                  np.asarray(j_sample(jnp.asarray(logits), None, 0.0, 1.0)))
    # top-p keeps the smallest set with cumulative probability >= top_p, as
    # in the JAX package: every sample must fall inside that set
    temp, top_p = 0.7, 0.6
    scaled = logits / temp
    srt = -np.sort(-scaled, axis=-1)
    cum = np.cumsum(np.exp(srt - srt[:, :1]) / np.exp(srt - srt[:, :1]).sum(-1, keepdims=True), -1)
    cutoff = np.take_along_axis(srt, (cum < top_p).sum(-1, keepdims=True), -1)
    g = torch.Generator().manual_seed(0)
    draws = torch.stack([sample_token(t, g, temp, top_p) for _ in range(200)], 1).numpy()
    for row in range(3):
        allowed = set(np.nonzero(scaled[row] >= cutoff[row])[0])
        assert set(draws[row]) <= allowed and len(set(draws[row])) >= 1
    g2 = torch.Generator().manual_seed(0)
    again = torch.stack([sample_token(t, g2, temp, top_p) for _ in range(200)], 1).numpy()
    np.testing.assert_array_equal(draws, again)   # seeded: reproducible
