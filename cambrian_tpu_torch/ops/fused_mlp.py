"""Fused two-layer GELU MLP, out = gelu(x @ W1 + b1) @ W2 + b2
(cambrian_tpu/ops/fused_mlp.py): kernel K8 of the port.

``fused_mlp`` launches the hand-written CUDA kernel of ``csrc/fused_mlp.cu``
for CUDA tensors; it replaces the TPU kernel ``_fused_mlp_kernel`` and, like
it, never writes the [M, H] hidden to device memory. CPU tensors take its
plain version, ``fused_mlp_reference``, which follows the TPU kernel's
roundings rather than the JAX off-TPU fallback's. The JAX function has no
``custom_vjp`` and the kernel has no backward: on the card, an input that
requires grad while grad is enabled raises. The port's ConvNeXt and SVA keep
their ``nn.Linear`` pairs; nothing on their path calls this kernel. Nothing
is compiled or loaded at import time.
"""

import ctypes
import functools
from typing import Optional

import torch

from . import cuda_build



def gelu_as(x: torch.Tensor) -> torch.Tensor:
    """GELU in x's dtype with the Abramowitz-Stegun 7.1.26 erf that the TPU
    kernel (and K8) uses, within 1.5e-7 of the exact erf."""
    p = 0.3275911
    a1, a2, a3, a4, a5 = 0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429
    z = x * 0.7071067811865476
    az = z.abs()
    t = 1.0 / (1.0 + p * az)
    poly = t * (a1 + t * (a2 + t * (a3 + t * (a4 + t * a5))))
    erf = torch.sign(z) * (1.0 - poly * torch.exp(-az * az))
    return 0.5 * x * (1.0 + erf)


def fused_mlp_reference(x: torch.Tensor, w1: torch.Tensor, b1: Optional[torch.Tensor],
                        w2: torch.Tensor, b2: Optional[torch.Tensor]) -> torch.Tensor:
    """K8's arithmetic in plain PyTorch, the TPU kernel's: x @ W1 in fp32, b1
    added in fp32, GELU (A&S erf) in fp32, **h rounded to x.dtype**, h @ W2
    in fp32, b2 added in fp32, one cast to x.dtype. (The JAX off-TPU
    fallback rounds after each product and adds the biases in x.dtype.)"""
    h = x.float() @ w1.float()
    if b1 is not None:
        h = h + b1.float()
    h = gelu_as(h).to(x.dtype)
    out = h.float() @ w2.float()
    if b2 is not None:
        out = out + b2.float()
    return out.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    return cuda_build.load("fused_mlp", {
        "cambrian_fused_mlp": [i32, ptr, ctypes.c_int64, ptr, ptr, ptr, ptr, ptr]
                              + [i32] * 4 + [ptr]})


def fused_mlp(x: torch.Tensor, w1: torch.Tensor, b1: Optional[torch.Tensor],
              w2: torch.Tensor, b2: Optional[torch.Tensor]) -> torch.Tensor:
    """x [M, C] -> gelu(x @ w1 [C, H] + b1) @ w2 [H, C2] + b2, in x.dtype;
    b1 [H] and b2 [C2] may be None. Kernel K8 for CUDA tensors (weights in
    x's dtype; ``w1.t()`` and ``w2.t()`` of nn.Linear weights are read in
    place), the plain version for CPU tensors."""
    if cuda_build.on_cpu(x, "fused_mlp"):
        return fused_mlp_reference(x, w1, b1, w2, b2)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, w1, b1, w2, b2)):
        raise RuntimeError("fused_mlp has no backward on the card (the JAX package's has "
                           "none either); call it under torch.no_grad()")
    if x.dim() != 2 or w1.dim() != 2 or w2.dim() != 2:
        raise ValueError(f"x, w1, w2 must be 2-D, got {tuple(x.shape)}, {tuple(w1.shape)}, "
                         f"{tuple(w2.shape)}")
    m, c = x.shape
    hdim, c2 = w1.shape[1], w2.shape[1]
    if w1.shape[0] != c or w2.shape[0] != hdim:
        raise ValueError(f"w1 must be [{c}, H] and w2 [H, C2], got {tuple(w1.shape)}, "
                         f"{tuple(w2.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16) or w1.dtype != x.dtype or w2.dtype != x.dtype:
        raise TypeError(f"the kernel takes bfloat16 or float32 x with weights of its dtype, "
                        f"got {x.dtype}, {w1.dtype}, {w2.dtype}")
    biases = []
    for name, t, n in (("b1", b1, hdim), ("b2", b2, c2)):
        if t is not None and t.shape != (n,):
            raise ValueError(f"{name} must be [{n}], got {tuple(t.shape)}")
        biases.append(None if t is None else t.float().contiguous())
    for name, t in (("w1", w1), ("w2", w2), ("b1", b1), ("b2", b2)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    if c > 1 and x.stride(1) != 1:
        raise ValueError(f"x must have a unit stride along C, got strides {x.stride()}")
    out = torch.empty((m, c2), dtype=x.dtype, device=x.device)
    if m == 0:
        return out
    # nn.Linear's layout, [H, C] and [C2, H]: no copy for the .t() of its weight
    w1t, w2t = w1.t().contiguous(), w2.t().contiguous()
    lib = _library()
    fused_mlp.launches += 1
    err = lib.cambrian_fused_mlp(
        cuda_build.dtype_code(x), x.data_ptr(), x.stride(0) if m > 1 else c, w1t.data_ptr(),
        None if biases[0] is None else biases[0].data_ptr(), w2t.data_ptr(),
        None if biases[1] is None else biases[1].data_ptr(), out.data_ptr(), m, c, hdim, c2,
        torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check_launch(lib, err, "fused_mlp")
    return out


fused_mlp.launches = 0
