"""Normalization ops with fp32 statistics (cambrian_tpu/ops/norms.py).

Both helpers reduce in fp32 and cast back to the input dtype. The modules
keep their weights in fp32 whatever the compute dtype, as the JAX package's
fp32 master parameters do.

``fused_layer_norm`` / ``FusedLayerNorm`` are kernel K6 of the port: for
CUDA tensors they launch the hand-written kernel of ``csrc/layer_norm.cu``,
which replaces the TPU kernel ``_ln_kernel`` (reached through
``_ln_pallas``); CPU tensors take its plain version,
``fused_layer_norm_reference``. The gradient is ``FusedLayerNormFunction``,
the JAX ``custom_vjp``'s fp32 math (``_fused_ln_bwd``) in plain PyTorch on
either device, as the JAX package has no backward kernel either. Nothing is
compiled or loaded at import time.
"""

import ctypes
import functools
from typing import Optional

import torch
from torch import nn

from . import cuda_build


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm with fp32 accumulation: y = x / rms(x) * weight."""
    x32 = x.float()
    variance = x32.square().mean(-1, keepdim=True)
    y = x32 * torch.reciprocal(torch.sqrt(variance + eps))
    return (y * weight.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis with fp32 statistics and affine."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    y = (x32 - mean) * torch.reciprocal(torch.sqrt(var + eps))
    return (y * weight.float() + bias.float()).to(x.dtype)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis; fp32 ``weight``/``bias`` (flax
    ``scale``/``bias``)."""

    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


class RMSNorm(nn.Module):
    """RMSNorm with an fp32 ``weight`` (cambrian_tpu/models/language/llama.py:45)."""

    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps)


# -- K6: the fused LayerNorm ----------------------------------------------------

def fused_layer_norm_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                               eps: float = 1e-5) -> torch.Tensor:
    """K6's arithmetic in plain PyTorch (the TPU kernel ``_ln_kernel``): fp32
    mean, fp32 variance of the centred row, ``rsqrt``, the affine in fp32,
    one cast to x.dtype."""
    x32 = x.float()
    xc = x32 - x32.mean(-1, keepdim=True)
    y = xc * torch.rsqrt(xc.square().mean(-1, keepdim=True) + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def fused_layer_norm_bwd_reference(x: torch.Tensor, weight: torch.Tensor, g: torch.Tensor,
                                   eps: float = 1e-5):
    """(dx, dw, db) of ``fused_layer_norm`` for the cotangent ``g``, the fp32
    math of the JAX package's ``_fused_ln_bwd``: the statistics recomputed
    from ``x``, dx in x.dtype, dw and db summed over every row in fp32 and
    cast to weight.dtype."""
    c = x.shape[-1]
    x32 = x.reshape(-1, c).float()
    g32 = g.reshape(-1, c).float()
    xc = x32 - x32.mean(-1, keepdim=True)
    inv = torch.rsqrt(xc.square().mean(-1, keepdim=True) + eps)
    xhat = xc * inv
    gw = g32 * weight.float()
    m1 = gw.mean(-1, keepdim=True)
    m2 = (gw * xhat).mean(-1, keepdim=True)
    dx = (inv * (gw - m1 - xhat * m2)).to(x.dtype).reshape(x.shape)
    return dx, (g32 * xhat).sum(0).to(weight.dtype), g32.sum(0).to(weight.dtype)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    return cuda_build.load("layer_norm", {
        "cambrian_layer_norm": [i32, ptr, ptr, ptr, ptr, i32, i32, ctypes.c_float, ptr]})


def _ln_kernel(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """Launch K6 on CUDA inputs (counted in ``fused_layer_norm.launches``)."""
    c = x.shape[-1]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the kernel takes bfloat16 or float32 x, got {x.dtype}")
    if weight.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"weight and bias must be [{c}], got {tuple(weight.shape)}, "
                         f"{tuple(bias.shape)}")
    for name, t in (("weight", weight), ("bias", bias)):
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    x2 = x.reshape(-1, c).contiguous()
    out = torch.empty_like(x2)
    if x2.shape[0] == 0:
        return out.reshape(x.shape)
    w32 = weight.detach().float().contiguous()
    b32 = bias.detach().float().contiguous()
    lib = _library()
    fused_layer_norm.launches += 1
    err = lib.cambrian_layer_norm(cuda_build.dtype_code(x), x2.data_ptr(), w32.data_ptr(),
                                  b32.data_ptr(), out.data_ptr(), x2.shape[0], c, float(eps),
                                  torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check_launch(lib, err, "layer_norm")
    return out.reshape(x.shape)


class FusedLayerNormFunction(torch.autograd.Function):
    """K6 forward (the plain version on the CPU); the backward is
    ``fused_layer_norm_bwd_reference``, the JAX ``custom_vjp``'s math, which
    recomputes the statistics from the saved input."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        if cuda_build.on_cpu(x, "fused_layer_norm"):
            return fused_layer_norm_reference(x, weight, bias, eps)
        return _ln_kernel(x, weight, bias, eps)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        return (*fused_layer_norm_bwd_reference(x, weight, g, ctx.eps), None)


def fused_layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis in one pass over x: kernel K6 for CUDA
    tensors (any width), the plain version for CPU tensors. Differentiable
    through ``FusedLayerNormFunction``."""
    return FusedLayerNormFunction.apply(x, weight, bias, eps)


fused_layer_norm.launches = 0


class FusedLayerNorm(nn.Module):
    """``LayerNorm`` through kernel K6 (the JAX ``FusedLayerNorm``): the same
    fp32 ``weight``/``bias`` (flax ``scale``/``bias``), so a state dict loads
    into either; ``dtype`` casts the input first, as the flax module does."""

    def __init__(self, dim: int, eps: float = 1e-5, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is not None:
            x = x.to(self.dtype)
        return fused_layer_norm(x, self.weight, self.bias, self.eps)
