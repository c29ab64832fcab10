"""Fused masked attention, forward and backward: kernels K1 and K2 of the port.

``flash_attention`` launches the hand-written CUDA kernel in
``csrc/flash_attention.cu`` (K1) for CUDA tensors, through
``FlashAttentionFunction``, whose backward launches the kernel in
``csrc/flash_attention_bwd.cu`` (K2); the two replace the TPU kernels
``_attn_kernel`` and ``_attn_bwd_kernel`` of
``cambrian_tpu/ops/flash_attention.py`` and its ``jax.custom_vjp``. CPU
tensors go to the plain PyTorch version, ``flash_attention_reference`` (the
semantics of that module's ``_xla_reference``), and autograd differentiates
it, as JAX differentiates ``_xla_reference`` off the TPU.
``flash_attention_bwd_reference`` is K2's plain version, and
``flash_attention_lse_reference`` the plain version of the row statistic that
K1 writes for K2 (the log-sum-exp of each row's masked logits).

On the card, bf16 takes the tensor-core kernels (wgmma on TMA-fed tiles),
which round the probabilities P (forward and backward) and dS (backward) to
bf16 before their products, as the TPU forward rounds P; fp32 takes the SIMT
kernels, exact to fp32 rounding.

The kernels are compiled with ``nvcc`` for sm_90a on first use
(``ops/cuda_build.py``) and loaded with ctypes. Nothing is compiled or
loaded at import time.
"""

import ctypes
import functools
from typing import Optional

import torch

from . import cuda_build
from .attention import NEG_INF

# K1 and K2 take head dimensions up to Gemma-7B's 256 on the card
MAX_HEAD_DIM = 256


def flash_attention_reference(q, k, v, key_valid=None, causal=False,
                              sliding_window=None, q_offset=0, scale=None):
    """Plain PyTorch attention with the kernel's mask semantics.

    q [B, Sq, H, D], k/v [B, Sk, KVH, D] (H a multiple of KVH), key_valid
    [B, Sk] bool. Logits and softmax in fp32; a row with no surviving key is
    0. Returns [B, Sq, H, D] in q.dtype.
    """
    b, s_q, h, d = q.shape
    s_k, kvh = k.shape[1], k.shape[2]
    if scale is None:
        scale = d ** -0.5
    if kvh != h:
        k = k.repeat_interleave(h // kvh, dim=2)
        v = v.repeat_interleave(h // kvh, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = _mask(key_valid, b, s_q, s_k, causal, sliding_window, q_offset, q.device)
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    probs = torch.where(mask, probs, 0.0)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype), v.to(q.dtype))


def _mask(key_valid, b, s_q, s_k, causal, sliding_window, q_offset, device):
    """[B, 1, Sq, Sk] bool: key validity and the causal / window predicates."""
    if key_valid is None:
        mask = torch.ones((b, 1, 1, s_k), dtype=torch.bool, device=device)
    else:
        mask = key_valid.to(device=device, dtype=torch.bool)[:, None, None, :]
    if causal or sliding_window is not None:
        q_pos = q_offset + torch.arange(s_q, device=device)[:, None]
        k_pos = torch.arange(s_k, device=device)[None, :]
        if causal:
            mask = mask & (k_pos <= q_pos)
        if sliding_window is not None:
            mask = mask & ((q_pos - k_pos) < sliding_window)
    return mask


def flash_attention_lse_reference(q, k, key_valid=None, causal=False, sliding_window=None,
                                  q_offset=0, scale=None):
    """Plain PyTorch version of K1's row statistic: the log-sum-exp over each
    row's live keys of the logits (q . k) * scale, fp32 [B, H, Sq]; +inf for a
    row with no live key, so that ``exp(x - lse)`` is 0 throughout it."""
    b, s_q, h, d = q.shape
    s_k, kvh = k.shape[1], k.shape[2]
    if scale is None:
        scale = d ** -0.5
    if kvh != h:
        k = k.repeat_interleave(h // kvh, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = _mask(key_valid, b, s_q, s_k, causal, sliding_window, q_offset, q.device)
    lse = torch.logsumexp(torch.where(mask, logits, -torch.inf), dim=-1)
    return torch.where(mask.any(-1), lse, torch.inf)


def flash_attention_bwd_reference(q, k, v, key_valid, o, do, causal=False,
                                  sliding_window=None, q_offset=0, scale=None, lse=None):
    """Plain PyTorch version of K2, the math of the TPU kernel
    ``_attn_bwd_kernel``: fp32 probabilities recomputed from a whole-row
    maximum and sum (denominator floored at 1e-30, masked entries 0), or,
    given the forward's row statistic ``lse`` [B, H, Sq], ``exp(x - lse)``
    with masked entries 0; ``delta = rowsum(do * o)``,
    ``ds = p * (do . v - delta) * scale``, ``dq = ds k``, ``dk = ds^T q``,
    ``dv = p^T do``. With GQA a kv head's ``dk``/``dv`` sum its group of
    query heads in fp32. Shapes as ``flash_attention_reference``; returns
    (dq, dk, dv) in the input dtype.
    """
    b, s_q, h, d = q.shape
    s_k, kvh = k.shape[1], k.shape[2]
    group = h // kvh
    if scale is None:
        scale = d ** -0.5
    q32, o32, do32 = q.float(), o.float(), do.float()
    k32 = k.float().repeat_interleave(group, dim=2)
    v32 = v.float().repeat_interleave(group, dim=2)
    mask = _mask(key_valid, b, s_q, s_k, causal, sliding_window, q_offset, q.device)
    logits = torch.einsum("bqhd,bkhd->bhqk", q32, k32) * scale
    if lse is None:
        logits = torch.where(mask, logits, NEG_INF)
        probs = torch.exp(logits - logits.amax(-1, keepdim=True))
        probs = torch.where(mask, probs, 0.0)
        probs = probs / probs.sum(-1, keepdim=True).clamp_min(1e-30)
    else:
        probs = torch.where(mask, torch.exp(logits - lse.float()[..., None]), 0.0)
    delta = (do32 * o32).sum(-1).permute(0, 2, 1)[..., None]      # [B, H, Sq, 1]
    dp = torch.einsum("bqhd,bkhd->bhqk", do32, v32)
    ds = probs * (dp - delta) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k32)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q32)
    dv = torch.einsum("bhqk,bqhd->bkhd", probs, do32)
    if group > 1:
        dk = dk.reshape(b, s_k, kvh, group, d).sum(3)
        dv = dv.reshape(b, s_k, kvh, group, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    i64, i32, ptr = ctypes.c_int64, ctypes.c_int, ctypes.c_void_p
    return cuda_build.load("flash_attention", {
        "cambrian_flash_attention_fwd": [i32] + [ptr] * 6 + [i64] * 12 + [i32] * 6
                                        + [ctypes.c_float, i32, i32, i32, ptr]})


@functools.lru_cache(maxsize=None)
def _bwd_library() -> ctypes.CDLL:
    i64, i32, ptr = ctypes.c_int64, ctypes.c_int, ctypes.c_void_p
    return cuda_build.load("flash_attention_bwd", {
        "cambrian_flash_attention_bwd": [i32] + [ptr] * 11 + [i64] * 24 + [i32] * 6
                                        + [ctypes.c_float, i32, i32, i32, ptr]})


def _strides(*tensors):
    return [s for t in tensors for s in (t.stride(0), t.stride(1), t.stride(2))]


def _check_inputs(what, q, k, v, key_valid):
    b, s_q, h, d = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v must be [B, Sk, KVH, D] matching q {tuple(q.shape)}, "
                         f"got {tuple(k.shape)} and {tuple(v.shape)}")
    if h % k.shape[2] != 0:
        raise ValueError(f"{h} heads are not a multiple of {k.shape[2]} kv heads")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"kernel takes float32 or bfloat16 q/k/v of one dtype, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"{what} takes head_dim <= {MAX_HEAD_DIM} on the card, got {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have a unit stride on head_dim")
    if key_valid is not None and tuple(key_valid.shape) != (b, k.shape[1]):
        raise ValueError(f"key_valid must be [B, Sk] = {(b, k.shape[1])}, "
                         f"got {tuple(key_valid.shape)}")


def _check_tma(what, d, **tensors):
    """The bf16 kernels read their [B, S, heads, D] operands through TMA
    tensor maps: a row is a multiple of 16 bytes, and every base address and
    stride (of a dimension longer than 1) a multiple of 16 bytes."""
    if d % 8 != 0:
        raise ValueError(f"{what} in bfloat16 takes head_dim a multiple of 8 "
                         f"(16-byte rows for TMA), got {d}")
    for name, t in tensors.items():
        if t.data_ptr() % 16 != 0:
            raise ValueError(f"{what} in bfloat16: {name}'s base address must be 16-byte "
                             f"aligned for TMA")
        for dim in range(3):
            if t.shape[dim] > 1 and t.stride(dim) % 8 != 0:
                raise ValueError(f"{what} in bfloat16: {name}'s stride {t.stride(dim)} on "
                                 f"dimension {dim} must be a multiple of 8 elements (16 "
                                 f"bytes) for TMA")


def _refuse_dtensors(what, *tensors):
    """A DTensor (a sharded model's parameter or activation) must never
    reach the kernels' wrappers: on the CPU it would take the plain path
    quietly, and the kernels read local storage. The sharded model hands
    them each rank's local heads as plain tensors (parallel/sharding.py)."""
    for t in tensors:
        if hasattr(t, "placements"):
            raise TypeError(f"{what} takes plain tensors, got a DTensor "
                            f"({type(t).__name__} with placements {t.placements})")


def _card_args(what, q, k, v, key_valid, sliding_window, scale):
    """Check the inputs of a kernel call on the card; returns the key
    validity as contiguous bool (or None) and the scale as a float."""
    if q.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda, not {q.device}")
    _check_inputs(what, q, k, v, key_valid)
    if q.dtype == torch.bfloat16:
        _check_tma(what, q.shape[-1], q=q, k=k, v=v)
    if sliding_window is not None and sliding_window < 1:
        raise ValueError(f"sliding_window must be >= 1, got {sliding_window}")
    valid = None
    if key_valid is not None:
        valid = key_valid.to(device=q.device, dtype=torch.bool).contiguous()
    return valid, float(q.shape[-1] ** -0.5 if scale is None else scale)


def flash_attention(
    q: torch.Tensor,                          # [B, Sq, H, D]
    k: torch.Tensor,                          # [B, Sk, KVH, D]
    v: torch.Tensor,                          # [B, Sk, KVH, D]
    key_valid: Optional[torch.Tensor] = None,  # [B, Sk] bool
    causal: bool = False,
    sliding_window: Optional[int] = None,
    q_offset: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Masked attention in BQHD layout with GQA read in place.

    CPU tensors go to ``flash_attention_reference``, at any head_dim. CUDA
    tensors of head_dim <= ``MAX_HEAD_DIM`` (256) launch K1
    through ``FlashAttentionFunction`` (``flash_attention.launches`` counts
    the launches; its backward launches K2) or raise; there is no fallback to
    the plain version on the card.
    """
    _refuse_dtensors("flash_attention", q, k, v, key_valid)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, key_valid, causal,
                                         sliding_window, q_offset, scale)
    valid, scale = _card_args("flash_attention", q, k, v, key_valid, sliding_window, scale)
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))):
        # no backward will run (serving): no autograd node, no row statistic
        return _flash_fwd(q, k, v, valid, causal, sliding_window, q_offset, scale)[0]
    return FlashAttentionFunction.apply(q, k, v, valid, causal, sliding_window, q_offset, scale)


def _flash_fwd(q, k, v, valid, causal, sliding_window, q_offset, scale, with_lse=False):
    """Launch K1 on checked CUDA inputs; ``valid`` is None or contiguous bool.
    Returns the output and, with ``with_lse``, the row statistic (fp32
    [B, H, Sq] log-sum-exp, +inf for a row with no live key), else None."""
    b, s_q, h, d = q.shape
    s_k, kvh = k.shape[1], k.shape[2]
    out = torch.empty((b, s_q, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device) if with_lse else None
    lib = _library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    flash_attention.launches += 1
    err = lib.cambrian_flash_attention_fwd(
        cuda_build.dtype_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if valid is None else valid.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        *_strides(q, k, v, out), b, h, kvh, s_q, s_k, d, scale, int(bool(causal)),
        -1 if sliding_window is None else int(sliding_window), int(q_offset), stream)
    cuda_build.check_launch(lib, err, "flash_attention")
    return out, lse


class FlashAttentionFunction(torch.autograd.Function):
    """K1 forward, K2 backward (the JAX package's ``custom_vjp`` around
    ``_flash``). Saves ``(q, k, v, key_valid, out)``, the residuals of JAX
    ``_flash_fwd``, and the row statistic K1 wrote, which K2 reads instead
    of recomputing the row maximum and sum. ``flash_attention`` takes it only
    when a backward can run."""

    @staticmethod
    def forward(ctx, q, k, v, valid, causal, sliding_window, q_offset, scale):
        out, lse = _flash_fwd(q, k, v, valid, causal, sliding_window, q_offset, scale,
                              with_lse=True)
        ctx.save_for_backward(q, k, v, valid, out, lse)
        ctx.options = (causal, sliding_window, q_offset, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, valid, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, valid, out, dout.contiguous(), *ctx.options,
                                         lse=lse)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_bwd(
    q: torch.Tensor,                          # [B, Sq, H, D]
    k: torch.Tensor,                          # [B, Sk, KVH, D]
    v: torch.Tensor,                          # [B, Sk, KVH, D]
    key_valid: Optional[torch.Tensor],        # [B, Sk] bool
    o: torch.Tensor,                          # [B, Sq, H, D], the forward's output
    do: torch.Tensor,                         # [B, Sq, H, D], its cotangent
    causal: bool = False,
    sliding_window: Optional[int] = None,
    q_offset: int = 0,
    scale: Optional[float] = None,
    lse: Optional[torch.Tensor] = None,        # [B, H, Sq] fp32, K1's row statistic
):
    """(dq, dk, dv) of ``flash_attention``. CPU tensors go to
    ``flash_attention_bwd_reference``; CUDA tensors of head_dim <=
    ``MAX_HEAD_DIM`` (256) launch K2 (three kernels behind one call, four
    above head_dim 128, counted once in ``flash_attention_bwd.launches``);
    others raise. ``lse`` is the row statistic the forward wrote (what
    ``FlashAttentionFunction`` saves); without it, one K1 launch (counted in
    ``flash_attention.launches``) writes it first."""
    _refuse_dtensors("flash_attention_bwd", q, k, v, key_valid, o, do, lse)
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, key_valid, o, do, causal,
                                             sliding_window, q_offset, scale, lse)
    valid, scale = _card_args("flash_attention_bwd", q, k, v, key_valid, sliding_window, scale)
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q: {tuple(t.shape)} {t.dtype} {t.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have a unit stride on head_dim")
    if q.dtype == torch.bfloat16:
        _check_tma("flash_attention_bwd", q.shape[-1], do=do)
    b, s_q, h, d = q.shape
    s_k, kvh = k.shape[1], k.shape[2]
    if lse is None:
        _, lse = _flash_fwd(q, k, v, valid, causal, sliding_window, q_offset, scale,
                            with_lse=True)
    elif (tuple(lse.shape) != (b, h, s_q) or lse.dtype != torch.float32
          or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"lse must be contiguous float32 [B, H, Sq] = {(b, h, s_q)} on "
                         f"{q.device}, got {lse.dtype} {tuple(lse.shape)} on {lse.device}")
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty((b, s_k, kvh, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, s_k, kvh, d), dtype=v.dtype, device=q.device)
    delta = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
    lib = _bwd_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    flash_attention_bwd.launches += 1
    err = lib.cambrian_flash_attention_bwd(
        cuda_build.dtype_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if valid is None else valid.data_ptr(), o.data_ptr(), do.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        *_strides(q, k, v, o, do, dq, dk, dv), b, h, kvh, s_q, s_k, d, scale,
        int(bool(causal)), -1 if sliding_window is None else int(sliding_window),
        int(q_offset), stream)
    cuda_build.check_launch(lib, err, "flash_attention_bwd")
    return dq, dk, dv


flash_attention.launches = 0
flash_attention_bwd.launches = 0
