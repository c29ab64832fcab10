"""Parity of the port's flash attention (cambrian_tpu_torch/ops/flash_attention.py)
with the JAX package's: the plain version against the Pallas kernel in
interpret mode and against ``_xla_reference``, on the CPU in fp32; and the
CUDA kernel against the plain version on the card (marker ``cuda``).

JAX is imported inside the helpers, so that on a machine with a card and no
JAX ``python -m pytest --noconftest -m cuda tests/test_torch_flash_attention.py``
runs the kernel cases alone.
"""

import numpy as np
import pytest
import torch

from cambrian_tpu_torch.ops.flash_attention import (
    flash_attention,
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


# (b, s_q, s_k, h, kvh, d, causal, window, q_offset, with_padding)
KERNEL_CASES = {
    "siglip": (1, 729, 729, 16, 16, 72, False, None, 0, False),
    "clip": (1, 577, 577, 16, 16, 64, False, None, 0, False),
    "dinov2": (1, 730, 730, 24, 24, 64, False, None, 0, False),
    "prefill_gqa": (1, 640, 672, 32, 8, 128, True, None, 0, True),
    "window_offset": (2, 100, 180, 4, 2, 48, True, 33, 50, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(KERNEL_CASES))
def test_kernel_matches_plain_on_card(cuda_device, name, dtype):
    b, s_q, s_k, h, kvh, d, causal, window, q_offset, pad = KERNEL_CASES[name]
    g = torch.Generator(device=cuda_device).manual_seed(0)
    dt = getattr(torch, dtype)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=cuda_device).to(dt)

    q, k, v = rand(b, s_q, h, d), rand(b, s_k, kvh, d), rand(b, s_k, kvh, d)
    valid = torch.ones((b, s_k), dtype=torch.bool, device=cuda_device)
    if pad:
        valid[:, : s_k // 7] = False     # dead causal rows at the start
        valid[:, -s_k // 5:] = False     # padding at the end
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
