"""Plain attention ops (cambrian_tpu/ops/attention.py).

Logits and softmax run in fp32 whatever the input dtype. Masked logits take
the finite ``NEG_INF``, not ``-inf``, so a row with every key masked gets
uniform weights, as in the JAX package (the flash kernel zeroes such rows
instead; see ops/flash_attention.py).

Layout: BQHD — batch, sequence, heads, head_dim.
"""

from typing import Optional

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def _softmax_fp32(logits: torch.Tensor) -> torch.Tensor:
    probs = torch.exp(logits - logits.amax(-1, keepdim=True))
    return probs / probs.sum(-1, keepdim=True)


def dot_product_attention(
    q: torch.Tensor,                       # [B, Q, H, D]
    k: torch.Tensor,                       # [B, K, H, D]
    v: torch.Tensor,                       # [B, K, H, D]
    mask: Optional[torch.Tensor] = None,   # bool, broadcastable to [B, H, Q, K]
    scale: Optional[float] = None,
    logit_cap: Optional[float] = None,
) -> torch.Tensor:
    """Masked scaled dot-product attention; returns [B, Q, H, D] in q.dtype.
    ``logit_cap`` squashes logits to cap*tanh(logits/cap) before masking."""
    dtype = q.dtype
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if logit_cap is not None:
        logits = logit_cap * torch.tanh(logits / logit_cap)
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    probs = _softmax_fp32(logits)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(dtype), v.to(dtype))


def windowed_cross_attention(
    q: torch.Tensor,                       # [B, Q, H, D]
    k: torch.Tensor,                       # [B, Q, W, H, D]
    v: torch.Tensor,                       # [B, Q, W, H, D]
    mask: Optional[torch.Tensor] = None,   # bool [B, Q, W] or [B, Q, H, W]
    scale: Optional[float] = None,
) -> torch.Tensor:
    """SVA attention: each of Q queries attends over its own W-token window.
    Returns [B, Q, H, D] in q.dtype."""
    dtype = q.dtype
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bqwhd->bqhw", q.float(), k.float()) * scale
    if mask is not None:
        if mask.dim() == 3:
            mask = mask[:, :, None, :]
        logits = torch.where(mask, logits, NEG_INF)
    probs = _softmax_fp32(logits)
    return torch.einsum("bqhw,bqwhd->bqhd", probs.to(dtype), v.to(dtype))
