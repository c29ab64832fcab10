"""Exact GELU (cambrian_tpu/ops/activations.py).

The JAX package evaluates erf with the Abramowitz-Stegun rational form,
within 5e-7 of the exact erf; PyTorch's exact GELU is within the parity
tolerance of that, so the port uses it directly.
"""

import torch
import torch.nn.functional as F


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """GELU(x) = x/2 * (1 + erf(x/sqrt(2))), computed in fp32."""
    return F.gelu(x.float()).to(x.dtype)
