"""Normalization ops with fp32 statistics (cambrian_tpu/ops/norms.py:23-41).

Both helpers reduce in fp32 and cast back to the input dtype. The modules
keep their weights in fp32 whatever the compute dtype, as the JAX package's
fp32 master parameters do.
"""

import torch
from torch import nn


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
