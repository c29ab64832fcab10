"""SVA windowed cross-attention (cambrian_tpu/ops/sva_attention.py): kernel K5
of the port.

``fused_windowed_cross_attention`` launches the hand-written CUDA kernel of
``csrc/sva_attention.cu`` for CUDA tensors; it replaces the TPU kernel
``_kernel`` (reached through ``_fused_impl``). CPU tensors take its plain
version, ``fused_windowed_cross_attention_reference``. The gradient is
``WindowedAttentionFunction``, the JAX ``custom_vjp``'s math
(``_fused_bwd``) in plain PyTorch on either device.

The kernel takes what the JAX wrapper sent to the einsum path instead (a
[B, Q, H, W] mask, fewer than 64 queries): those were rules of the TPU's
memory and tiling. It takes windows of up to ``MAX_WINDOW`` keys and head
dims up to ``MAX_HEAD_DIM``. The port's SVA keeps calling
``ops.attention.windowed_cross_attention``; nothing on its path calls this
kernel. Nothing is compiled or loaded at import time.
"""

import ctypes
import functools
from typing import Optional

import torch

from . import cuda_build
from .attention import NEG_INF

MAX_WINDOW = 64
MAX_HEAD_DIM = 128


def _mask_bqhw(mask: torch.Tensor) -> torch.Tensor:
    mask = mask.to(torch.bool)
    return mask[:, :, None, :] if mask.dim() == 3 else mask


def _probs(q, k, mask, scale):
    """fp32 [B, Q, H, W] probabilities, masked logits at NEG_INF."""
    logits = torch.einsum("bqhd,bqwhd->bqhw", q.float(), k.float()) * scale
    if mask is not None:
        logits = torch.where(_mask_bqhw(mask), logits, NEG_INF)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    return p / p.sum(-1, keepdim=True)


def fused_windowed_cross_attention_reference(q, k, v, mask=None, scale=None):
    """K5's arithmetic in plain PyTorch, which is the TPU kernel's
    (``sva_attention.py:47-54``) and not the einsum path's of
    ``ops/attention.py``: the logits and the softmax in fp32, masked logits
    at the finite ``NEG_INF`` (a fully masked window gets uniform weights),
    and the PV product in fp32 on the fp32 probabilities, cast once to
    q.dtype. (``windowed_cross_attention`` rounds the probabilities to the
    input dtype before PV.) q [B, Q, H, D], k/v [B, Q, W, H, D], mask bool
    [B, Q, W] or [B, Q, H, W]."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    p = _probs(q, k, mask, scale)
    return torch.einsum("bqhw,bqwhd->bqhd", p, v.float()).to(q.dtype)


def fused_windowed_cross_attention_bwd_reference(q, k, v, mask, g, scale=None):
    """(dq, dk, dv) for the cotangent ``g``, the math of the JAX package's
    ``_fused_bwd``: the fp32 probabilities recomputed, the softmax gradient
    in fp32, each gradient cast to its input's dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    p = _probs(q, k, mask, scale)
    g32 = g.float()
    dp = torch.einsum("bqhd,bqwhd->bqhw", g32, v.float())
    dv = torch.einsum("bqhw,bqhd->bqwhd", p, g32).to(v.dtype)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = (torch.einsum("bqhw,bqwhd->bqhd", ds, k.float()) * scale).to(q.dtype)
    dk = (torch.einsum("bqhw,bqhd->bqwhd", ds, q.float()) * scale).to(k.dtype)
    return dq, dk, dv


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    ptr, i32, strides = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int64)
    return cuda_build.load("sva_attention", {
        "cambrian_sva_attention": [i32, ptr, ptr, ptr, ptr, ptr] + [strides] * 5
                                  + [i32] * 5 + [ctypes.c_float, ptr]})


def _int64s(*values):
    return (ctypes.c_int64 * len(values))(*values)


def _sva_kernel(q, k, v, mask, scale):
    """Launch K5 on CUDA inputs (counted in
    ``fused_windowed_cross_attention.launches``)."""
    if q.dim() != 4 or k.dim() != 5:
        raise ValueError(f"q must be [B, Q, H, D] and k/v [B, Q, W, H, D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    b, n_q, h, d = q.shape
    w = k.shape[2]
    if k.shape != v.shape or k.shape[:2] != (b, n_q) or k.shape[3:] != (h, d):
        raise ValueError(f"k/v must be [{b}, {n_q}, W, {h}, {d}], got {tuple(k.shape)} "
                         f"and {tuple(v.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16) or not k.dtype == v.dtype == q.dtype:
        raise TypeError(f"the kernel takes float32 or bfloat16 q/k/v of one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not 1 <= w <= MAX_WINDOW or d > MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes 1..{MAX_WINDOW} keys a window and head_dim <= "
                         f"{MAX_HEAD_DIM}, got W={w}, D={d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have a unit stride on head_dim")
    m_ptr, m_strides = None, _int64s(0, 0, 0, 0)
    if mask is not None:
        if mask.device != q.device:
            raise ValueError(f"mask on {mask.device}, q on {q.device}")
        mask = mask.to(torch.bool)
        if mask.dim() == 3 and mask.shape == (b, n_q, w):
            m_strides = _int64s(mask.stride(0), mask.stride(1), 0, mask.stride(2))
        elif mask.dim() == 4 and mask.shape == (b, n_q, h, w):
            m_strides = _int64s(*mask.stride())
        else:
            raise ValueError(f"mask must be [{b}, {n_q}, {w}] or [{b}, {n_q}, {h}, {w}], "
                             f"got {tuple(mask.shape)}")
        m_ptr = mask.data_ptr()
    out = torch.empty((b, n_q, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = _library()
    fused_windowed_cross_attention.launches += 1
    err = lib.cambrian_sva_attention(
        cuda_build.dtype_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(), m_ptr,
        out.data_ptr(), _int64s(*q.stride()[:3]), _int64s(*k.stride()[:4]),
        _int64s(*v.stride()[:4]), m_strides, _int64s(*out.stride()[:3]), b, n_q, h, w, d,
        float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check_launch(lib, err, "sva_attention")
    return out


class WindowedAttentionFunction(torch.autograd.Function):
    """K5 forward (the plain version on the CPU); the backward is
    ``fused_windowed_cross_attention_bwd_reference``, the JAX
    ``custom_vjp``'s math. The mask takes no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, mask, scale):
        ctx.save_for_backward(q, k, v, mask)
        ctx.scale = scale
        if cuda_build.on_cpu(q, "fused_windowed_cross_attention"):
            return fused_windowed_cross_attention_reference(q, k, v, mask, scale)
        return _sva_kernel(q, k, v, mask, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask = ctx.saved_tensors
        dq, dk, dv = fused_windowed_cross_attention_bwd_reference(q, k, v, mask, g, ctx.scale)
        return dq, dk, dv, None, None


def fused_windowed_cross_attention(
    q: torch.Tensor,                       # [B, Q, H, D]
    k: torch.Tensor,                       # [B, Q, W, H, D]
    v: torch.Tensor,                       # [B, Q, W, H, D]
    mask: Optional[torch.Tensor] = None,   # bool [B, Q, W] or [B, Q, H, W]
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Each query attends over its own window of W keys; returns [B, Q, H, D]
    in q.dtype. Kernel K5 for CUDA tensors, the plain version for CPU
    tensors; differentiable in q, k and v."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return WindowedAttentionFunction.apply(q, k, v, mask, float(scale))


fused_windowed_cross_attention.launches = 0
