"""Depthwise 7x7 convolution in the NHWC layout (cambrian_tpu/ops/dwconv.py):
kernel K7 of the port.

``depthwise_conv7x7`` launches the hand-written CUDA kernel of
``csrc/dwconv.cu`` for CUDA tensors; it replaces the TPU kernel ``_kernel``
(reached through ``_dwconv_fwd_impl``). CPU tensors take its plain version,
``depthwise_conv7x7_reference``. The gradient is ``DepthwiseConv7x7Function``,
the JAX ``custom_vjp``'s math (``_dwconv_bwd``) in plain PyTorch on either
device. Layouts are the JAX package's: x [B, H, W, C], w [7, 7, C], bias
[C]; an ``nn.Conv2d(C, C, 7, groups=C)`` weight [C, 1, 7, 7] is
``weight[:, 0].permute(1, 2, 0)``. The port's ConvNeXt keeps its cuDNN
``nn.Conv2d``; nothing on its path calls this kernel. Nothing is compiled
or loaded at import time.
"""

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import cuda_build

K = 7
PAD = 3


def _taps(x: torch.Tensor):
    """(dy, dx, the [B, H, W, C] window of the zero-padded fp32 x at that tap)."""
    h, wd = x.shape[1], x.shape[2]
    xp = F.pad(x.float(), (0, 0, PAD, PAD, PAD, PAD))
    for dy in range(K):
        for dx in range(K):
            yield dy, dx, xp[:, dy:dy + h, dx:dx + wd, :]


def depthwise_conv7x7_reference(x: torch.Tensor, w: torch.Tensor,
                                bias: torch.Tensor) -> torch.Tensor:
    """K7's arithmetic in plain PyTorch: SAME padding, stride 1, the 49 taps
    summed in fp32 in the kernel's order (dy outer, dx inner), the bias
    added in fp32, one cast to x.dtype."""
    w32 = w.float()
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for dy, dx, window in _taps(x):
        acc = acc + window * w32[dy, dx]
    return (acc + bias.float()).to(x.dtype)


def depthwise_conv7x7_bwd_reference(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor):
    """(dx, dw, db) of ``depthwise_conv7x7`` for the cotangent ``g``, the
    math of the JAX package's ``_dwconv_bwd``: dx is the correlation of g
    with the flipped kernel (in x.dtype); dw and db are sums over batch and
    space in fp32 (in w.dtype)."""
    g32 = g.float()
    w32 = w.float()
    dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for dy, dxx, window in _taps(g32):
        dx = dx + window * w32[K - 1 - dy, K - 1 - dxx]
    dw = torch.stack([(window * g32).sum((0, 1, 2)) for _, _, window in _taps(x)])
    return (dx.to(x.dtype), dw.reshape(K, K, -1).to(w.dtype),
            g32.sum((0, 1, 2)).to(w.dtype))


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    return cuda_build.load("dwconv", {
        "cambrian_dwconv7x7": [i32, ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr]})


def _dwconv_kernel(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Launch K7 on CUDA inputs (counted in ``depthwise_conv7x7.launches``)."""
    if x.dim() != 4:
        raise ValueError(f"x must be [B, H, W, C], got {tuple(x.shape)}")
    b, h, wd, c = x.shape
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the kernel takes bfloat16 or float32 x, got {x.dtype}")
    if w.shape != (K, K, c) or bias.shape != (c,):
        raise ValueError(f"w must be [7, 7, {c}] and bias [{c}], got {tuple(w.shape)}, "
                         f"{tuple(bias.shape)}")
    for name, t in (("w", w), ("bias", bias)):
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    xc = x.contiguous()
    out = torch.empty_like(xc)
    if xc.numel() == 0:
        return out
    w32 = w.detach().float().contiguous()
    b32 = bias.detach().float().contiguous()
    lib = _library()
    depthwise_conv7x7.launches += 1
    err = lib.cambrian_dwconv7x7(cuda_build.dtype_code(x), xc.data_ptr(), w32.data_ptr(),
                                 b32.data_ptr(), out.data_ptr(), b, h, wd, c,
                                 torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check_launch(lib, err, "dwconv7x7")
    return out


class DepthwiseConv7x7Function(torch.autograd.Function):
    """K7 forward (the plain version on the CPU); the backward is
    ``depthwise_conv7x7_bwd_reference``, the JAX ``custom_vjp``'s math."""

    @staticmethod
    def forward(ctx, x, w, bias):
        ctx.save_for_backward(x, w)
        ctx.bias_dtype = bias.dtype
        if cuda_build.on_cpu(x, "depthwise_conv7x7"):
            return depthwise_conv7x7_reference(x, w, bias)
        return _dwconv_kernel(x, w, bias)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw, db = depthwise_conv7x7_bwd_reference(x, w, g)
        return dx, dw, db.to(ctx.bias_dtype)


def depthwise_conv7x7(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """x [B, H, W, C], w [7, 7, C], bias [C] -> [B, H, W, C] in x.dtype,
    SAME padding, stride 1, fp32 accumulation: kernel K7 for CUDA tensors,
    the plain version for CPU tensors. Differentiable."""
    return DepthwiseConv7x7Function.apply(x, w, bias)


depthwise_conv7x7.launches = 0
