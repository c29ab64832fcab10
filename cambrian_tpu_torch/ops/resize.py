"""Bilinear grid resize with ``align_corners=False`` semantics in fp32
(cambrian_tpu/ops/resize.py).

The resize runs as two fp32 products against per-axis interpolation
matrices, so the numbers match the JAX package's ``jax.image.resize`` (which
is the same linear map) rather than ``F.interpolate``'s own kernel.
"""

import numpy as np
import torch


def _resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] fp32 matrix of bilinear resize along one axis, without
    antialiasing: half-pixel sample centres, a triangle kernel, weights
    renormalised where taps fall outside the input. Computed in fp32 step
    by step as ``jax.image.resize`` computes it, so that downsampling
    factors that are not exact in binary (256 -> 96) give the same weights."""
    f32 = np.float32
    inv_scale = f32(1.0) / f32(out_size / in_size)
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    dist = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None])
    w = np.maximum(f32(0.0), f32(1.0) - dist)                      # [in, out]
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).T.astype(f32)


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Resize the spatial dims of ``x`` [..., H, W, C] (the JAX package's
    NHWC layout) to [..., out_h, out_w, C], in fp32, returned in x.dtype."""
    h, w = x.shape[-3], x.shape[-2]
    wh = torch.from_numpy(_resize_matrix(h, out_h)).to(x.device)
    ww = torch.from_numpy(_resize_matrix(w, out_w)).to(x.device)
    y = torch.einsum("hH,...Hwc->...hwc", wh, x.float())
    y = torch.einsum("wW,...hWc->...hwc", ww, y)
    return y.to(x.dtype)


def interpolate_tokens(tokens: torch.Tensor, target_len: int) -> torch.Tensor:
    """Resample a square token grid [..., N, C] to [..., target_len, C] with
    the fp32 bilinear resize."""
    n = tokens.shape[-2]
    side = int(n ** 0.5)
    if side * side != n:
        raise ValueError(f"token count {n} is not a square grid")
    target_side = int(target_len ** 0.5)
    if target_side * target_side != target_len:
        raise ValueError(f"target {target_len} is not a square grid")
    if side == target_side:
        return tokens
    grid = tokens.reshape(tokens.shape[:-2] + (side, side, tokens.shape[-1]))
    grid = resize_bilinear(grid, target_side, target_side)
    return grid.reshape(tokens.shape[:-2] + (target_len, tokens.shape[-1]))
