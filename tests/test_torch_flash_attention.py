"""Parity of the port's flash attention (cambrian_tpu_torch/ops/flash_attention.py)
with the JAX package's: the plain version against the Pallas kernel in
interpret mode and against ``_xla_reference``, on the CPU in fp32; the plain
row statistic (the log-sum-exp K1 writes for the backward) against numpy;
and the CUDA kernel against the plain versions on the card (marker ``cuda``).

JAX is imported inside the helpers, so that on a machine with a card and no
JAX ``python -m pytest --noconftest -m cuda tests/test_torch_flash_attention.py``
runs the kernel cases alone.
"""

import numpy as np
import pytest
import torch

from cambrian_tpu_torch.ops.flash_attention import (
    MAX_HEAD_DIM,
    _check_inputs,
    _flash_fwd,
    flash_attention,
    flash_attention_bwd,
    flash_attention_lse_reference,
    flash_attention_reference,
)

TOL = 1e-5  # fp32 on the CPU: same math, summation order differs


def _inputs(b, s_q, s_k, h, kvh, d, seed, valid_len=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s_q, h, d), dtype=np.float32)
    k = rng.standard_normal((b, s_k, kvh, d), dtype=np.float32)
    v = rng.standard_normal((b, s_k, kvh, d), dtype=np.float32)
    lens = valid_len if valid_len is not None else [s_k] * b
    valid = np.arange(s_k)[None, :] < np.asarray(lens)[:, None]
    return q, k, v, valid


def _jax_outputs(q, k, v, valid, causal, window, q_offset):
    """(Pallas kernel in interpret mode, _xla_reference) on [B, S, H, D]."""
    import jax.numpy as jnp

    from cambrian_tpu.ops.flash_attention import _flash_fwd_impl, _xla_reference

    b, s_q, h, d = q.shape
    s_k, kvh = k.shape[1], k.shape[2]
    k = np.repeat(k, h // kvh, axis=2)   # the JAX decoder repeats kv heads
    v = np.repeat(v, h // kvh, axis=2)

    def flat(x):
        return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * h, x.shape[1], d))

    vf = jnp.asarray(np.repeat(valid, h, axis=0))
    args = (flat(q), flat(k), flat(v), vf, d ** -0.5, causal, window, q_offset)
    kern = _flash_fwd_impl(*args, block_q=128, interpret=True)
    ref = _xla_reference(*args)

    def unflat(x):
        return np.asarray(x).reshape(b, h, s_q, d).transpose(0, 2, 1, 3)

    return unflat(kern), unflat(ref)


CASES = {
    # name: (b, s_q, s_k, h, kvh, d, valid_len, causal, window, q_offset)
    "full": (2, 130, 130, 2, 2, 64, None, False, None, 0),
    "key_padding": (2, 64, 128, 2, 2, 64, [97, 128], False, None, 0),
    "causal_offset": (2, 8, 128, 2, 2, 64, [128, 100], True, None, 120),
    "sliding_window": (1, 96, 96, 2, 2, 32, None, True, 16, 0),
    "sq_ne_sk_prefill": (2, 100, 132, 2, 2, 32, [90, 100], True, None, 0),
    "gqa": (2, 70, 70, 4, 2, 32, [70, 50], True, None, 0),
    "head_dim_72": (1, 80, 80, 2, 2, 72, None, False, None, 0),
    # Gemma-7B's head_dim (the JAX kernel pads D to a multiple of 128), and
    # 192 (one and a half of its 128-lane blocks)
    "d256_causal": (1, 130, 130, 2, 2, 256, None, True, None, 0),
    "d256_window_padded": (2, 100, 140, 2, 1, 256, [140, 97], True, 24, 40),
    "d192_padded": (2, 70, 96, 2, 2, 192, [96, 60], False, None, 0),
    "d192_window": (1, 96, 96, 2, 2, 192, None, True, 16, 0),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_jax(name):
    b, s_q, s_k, h, kvh, d, lens, causal, window, q_offset = CASES[name]
    q, k, v, valid = _inputs(b, s_q, s_k, h, kvh, d, seed=len(name), valid_len=lens)
    got = flash_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(valid), causal=causal, sliding_window=window,
        q_offset=q_offset).numpy()
    kern, ref = _jax_outputs(q, k, v, valid, causal, window, q_offset)
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, kern, atol=TOL, rtol=TOL)


def test_fully_masked_rows_are_zero():
    # batch 1 has no valid key; in batch 0 the causal rows before the first
    # valid key (keys 0..9 invalid) have none either
    b, s, h, d = 2, 40, 2, 16
    q, k, v, _ = _inputs(b, s, s, h, h, d, seed=7)
    valid = np.ones((b, s), bool)
    valid[0, :10] = False
    valid[1] = False
    got = flash_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(valid), causal=True).numpy()
    assert np.isfinite(got).all()
    assert (got[1] == 0).all() and (got[0, :10] == 0).all()
    assert np.abs(got[0, 10:]).max() > 0
    kern, ref = _jax_outputs(q, k, v, valid, True, None, 0)
    np.testing.assert_allclose(got, kern, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)


def _numpy_lse(q, k, valid, causal, window, q_offset):
    """log-sum-exp of each row's live logits in float64; +inf where no key
    is live. A key masked twice (invalid and outside the causal window) is
    as dead as one masked once."""
    b, s_q, h, d = q.shape
    s_k, kvh = k.shape[1], k.shape[2]
    k = np.repeat(k, h // kvh, axis=2).astype(np.float64)
    logits = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), k) * d ** -0.5
    q_pos = q_offset + np.arange(s_q)[:, None]
    k_pos = np.arange(s_k)[None, :]
    live = np.broadcast_to(valid[:, None, None, :], logits.shape).copy()
    if causal:
        live &= k_pos <= q_pos
    if window is not None:
        live &= (q_pos - k_pos) < window
    out = np.full((b, h, s_q), np.inf)
    for idx in np.ndindex(b, h, s_q):
        x = logits[idx][live[idx]]
        if x.size:
            out[idx] = x.max() + np.log(np.exp(x - x.max()).sum())
    return out


LSE_CASES = dict(CASES, dead_rows=(2, 40, 40, 2, 2, 16, [40, 0], True, None, 0))


@pytest.mark.parametrize("name", sorted(LSE_CASES))
def test_plain_row_statistic_matches_numpy(name):
    b, s_q, s_k, h, kvh, d, lens, causal, window, q_offset = LSE_CASES[name]
    q, k, _, valid = _inputs(b, s_q, s_k, h, kvh, d, seed=len(name) + 2, valid_len=lens)
    if name == "dead_rows":
        # batch 0: keys 0..9 invalid, so causal rows 0..9 see none, and each
        # row's keys past it are masked twice; batch 1: no valid key
        valid[0, :10] = False
    got = flash_attention_lse_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(valid), causal=causal,
        sliding_window=window, q_offset=q_offset)
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, h, s_q)
    want = _numpy_lse(q, k, valid, causal, window, q_offset)
    np.testing.assert_array_equal(np.isinf(got.numpy()), np.isinf(want))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    if name == "dead_rows":
        assert np.isposinf(got[1].numpy()).all() and np.isposinf(got[0, :, :10].numpy()).all()
        assert np.isfinite(got[0, :, 10:].numpy()).all()


def test_head_dim_limits():
    """The card's limits, checked before any launch: the forward (K1) and
    the backward (K2) take head_dim up to 256 and raise above it; on the CPU
    the plain versions take any D."""
    assert MAX_HEAD_DIM == 256
    for d in (136, 192, 256):
        q, k, v, valid = (torch.from_numpy(x) for x in _inputs(1, 3, 3, 2, 1, d, seed=d))
        _check_inputs("flash_attention", q, k, v, valid)
        _check_inputs("flash_attention_bwd", q, k, v, valid)
    q, k, v, valid = (torch.from_numpy(x) for x in _inputs(1, 3, 3, 2, 1, 264, seed=1))
    for what in ("flash_attention", "flash_attention_bwd"):
        with pytest.raises(ValueError, match=f"{what} takes head_dim <= 256"):
            _check_inputs(what, q, k, v, valid)
    got = flash_attention(q, k, v, valid, causal=True)
    torch.testing.assert_close(got, flash_attention_reference(q, k, v, valid, True),
                               atol=0, rtol=0)


def test_wrapper_routes_cpu_tensors_to_plain():
    q, k, v, valid = _inputs(1, 20, 24, 4, 2, 8, seed=3, valid_len=[21])
    args = [torch.from_numpy(x) for x in (q, k, v, valid)]
    before = flash_attention.launches
    got = flash_attention(*args, causal=True, q_offset=4)
    assert flash_attention.launches == before
    ref = flash_attention_reference(*args, causal=True, q_offset=4)
    torch.testing.assert_close(got, ref, atol=0, rtol=0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


# (b, s_q, s_k, h, kvh, d, causal, window, q_offset, key mask): "pad" has
# dead causal rows at the start and padding at the end, "hole" a key tile
# (keys 64..127) with no valid key in the middle
KERNEL_CASES = {
    "siglip": (1, 729, 729, 16, 16, 72, False, None, 0, None),
    "clip": (1, 577, 577, 16, 16, 64, False, None, 0, None),
    "dinov2": (1, 730, 730, 24, 24, 64, False, None, 0, None),
    "prefill_gqa": (1, 640, 672, 32, 8, 128, True, None, 0, "pad"),
    "window_offset": (2, 100, 180, 4, 2, 48, True, 33, 50, "pad"),
    "dead_key_tile": (2, 300, 300, 4, 2, 64, True, None, 0, "hole"),
    "ragged_q": (3, 70, 200, 4, 4, 40, False, None, 0, "pad"),
    "d72_window": (2, 150, 150, 4, 2, 72, True, 40, 0, "hole"),
    "d96": (2, 130, 130, 4, 2, 96, True, None, 0, None),
    "d24_offset": (2, 40, 100, 2, 1, 24, True, None, 60, "pad"),
    # the encoder-study towers: ViT-H/14 at 224 (D = 80 fills fwd_bf16_kernel<80>),
    # ViT-g/16 (D = 88, padded inside <96>), SD-2.1's first down block
    # (4,096 queries, 5 heads), and D = 80 / 88 under masks and a batch
    "vit_h_d80": (8, 257, 257, 16, 16, 80, False, None, 0, None),
    "vit_g_d88": (8, 196, 196, 16, 16, 88, False, None, 0, None),
    "sd21_4096": (1, 4096, 4096, 5, 5, 64, False, None, 0, None),
    "d80_window": (2, 150, 150, 4, 2, 80, True, 40, 0, "pad"),
    "d88_hole": (2, 300, 300, 4, 2, 88, True, None, 0, "hole"),
    # Gemma-7B's prefill (D = 256, 16 heads, a 645-slot prompt in a cache of
    # 32 more), D = 256 under a window, a hole and q_offset, and the widths
    # between 128 and 256 (m64n128k16 and a narrower product for P V)
    "gemma_prefill": (1, 645, 677, 16, 16, 256, True, None, 0, "pad"),
    "d256_window_hole": (2, 150, 150, 4, 2, 256, True, 40, 0, "hole"),
    "d256_offset": (2, 40, 100, 2, 1, 256, True, None, 60, "pad"),
    "d192": (2, 130, 130, 4, 2, 192, True, None, 0, None),
    "d136_pad": (2, 70, 200, 4, 4, 136, False, None, 0, "pad"),
    "d200_window": (1, 200, 200, 4, 2, 200, True, 64, 0, None),
}


def _card_inputs(device, dtype, b, s_q, s_k, h, kvh, d, mask):
    g = torch.Generator(device=device).manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=device).to(dtype)

    q, k, v = rand(b, s_q, h, d), rand(b, s_k, kvh, d), rand(b, s_k, kvh, d)
    valid = torch.ones((b, s_k), dtype=torch.bool, device=device)
    if mask == "pad":
        valid[:, : s_k // 7] = False     # dead causal rows at the start
        valid[:, -s_k // 5:] = False     # padding at the end
    elif mask == "hole":
        valid[:, 64:128] = False         # a whole key tile with no valid key
    return q, k, v, valid


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(KERNEL_CASES))
def test_kernel_matches_plain_on_card(cuda_device, name, dtype):
    b, s_q, s_k, h, kvh, d, causal, window, q_offset, mask = KERNEL_CASES[name]
    q, k, v, valid = _card_inputs(cuda_device, getattr(torch, dtype), b, s_q, s_k, h, kvh, d,
                                  mask)
    dt = q.dtype
    before = flash_attention.launches
    got = flash_attention(q, k, v, valid, causal, window, q_offset)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref = flash_attention_reference(q.float(), k.float(), v.float(), valid,
                                    causal, window, q_offset)
    assert torch.isfinite(got).all()
    # fp32: same math in another summation order; bf16: output rounding of
    # unit-variance inputs
    tol = 1e-4 if dt == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), ref, atol=tol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(KERNEL_CASES))
def test_row_statistic_matches_plain_on_card(cuda_device, name, dtype):
    """The log-sum-exp K1 writes for the backward: +inf on the rows with no
    live key, elsewhere the plain statistic of the same (upcast) inputs to
    fp32 summation order (|lse| < 20 here)."""
    b, s_q, s_k, h, kvh, d, causal, window, q_offset, mask = KERNEL_CASES[name]
    q, k, v, valid = _card_inputs(cuda_device, getattr(torch, dtype), b, s_q, s_k, h, kvh, d,
                                  mask)
    out, lse = _flash_fwd(q, k, v, valid, causal, window, q_offset, d ** -0.5, with_lse=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, flash_attention(q, k, v, valid, causal, window, q_offset),
                               atol=0, rtol=0)
    ref = flash_attention_lse_reference(q.float(), k.float(), valid, causal, window, q_offset)
    assert lse.dtype == torch.float32 and lse.shape == ref.shape
    assert torch.equal(torch.isinf(lse), torch.isinf(ref)) and (lse[torch.isinf(lse)] > 0).all()
    live = torch.isfinite(ref)
    torch.testing.assert_close(lse[live], ref[live], atol=1e-4, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("rule", ["head_dim", "base", "stride"])
def test_bf16_tma_layout_rules_raise(cuda_device, rule):
    """The bf16 kernels read q/k/v through TMA: a call they cannot take
    raises ValueError naming the rule, and launches nothing."""
    b, s, h, d = 1, 100, 2, 64
    if rule == "head_dim":
        d = 36
    q, k, v, _ = _card_inputs(cuda_device, torch.bfloat16, b, s, s, h, h, d, None)
    if rule == "base":   # one element into a wider buffer: 2-byte aligned
        q = torch.zeros((b, s, h, d + 8), dtype=q.dtype, device=cuda_device)[..., 1:d + 1]
    elif rule == "stride":   # rows h * d + 4 elements apart
        q = torch.zeros((b, s, h * d + 4), dtype=q.dtype, device=cuda_device)[
            ..., : h * d].unflatten(-1, (h, d))
    before = flash_attention.launches
    with pytest.raises(ValueError, match="TMA"):
        flash_attention(q, k, v)
    assert flash_attention.launches == before


@pytest.mark.cuda
def test_head_dim_256_forward_launches_and_backward_raises_on_card(cuda_device):
    """K1 and K2 launch at D = 256 in both dtypes, K2 given K1's statistic
    and held against its plain version; at D = 264 both raise before any
    launch (no fallback)."""
    from cambrian_tpu_torch.ops.flash_attention import flash_attention_bwd_reference

    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, valid = _card_inputs(cuda_device, dtype, 1, 130, 130, 2, 2, 256, "pad")
        before = flash_attention.launches
        out = flash_attention(q, k, v, valid, True)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 1 and torch.isfinite(out).all()
        _, lse = _flash_fwd(q, k, v, valid, True, None, 0, 256 ** -0.5, with_lse=True)
        do = torch.randn(out.shape, generator=torch.Generator(device=cuda_device).manual_seed(1),
                         device=cuda_device).to(dtype)
        before = flash_attention_bwd.launches
        got = flash_attention_bwd(q, k, v, valid, out, do, True, lse=lse)
        torch.cuda.synchronize()
        assert flash_attention_bwd.launches == before + 1
        want = flash_attention_bwd_reference(q.float(), k.float(), v.float(), valid,
                                             out.float(), do.float(), True)
        # fp32: the same math in another summation order; bf16: the
        # outputs' rounding of values up to |ref|max (K2's rule on the card)
        rel = 2 ** -7 if dtype == torch.bfloat16 else 1e-4
        for x, ref in zip(got, want):
            assert x.dtype == dtype and torch.isfinite(x).all()
            tol = rel * max(1.0, float(ref.abs().max()))
            torch.testing.assert_close(x.float(), ref, atol=tol, rtol=0)
        wide = [torch.zeros((*t.shape[:-1], 264), dtype=dtype, device=cuda_device)
                for t in (q, k, v)]
        for fn, args in ((flash_attention, wide), (flash_attention_bwd, wide + [
                None, torch.zeros_like(wide[0]), torch.zeros_like(wide[0])])):
            before = fn.launches
            with pytest.raises(ValueError, match="head_dim <= 256"):
                fn(*args)
            assert fn.launches == before
