"""Normalization ops with fp32 statistics (cambrian_tpu/ops/norms.py).

Both helpers reduce in fp32 and cast back to the input dtype. The modules
keep their weights in fp32 whatever the compute dtype, as the JAX package's
fp32 master parameters do.

``fused_layer_norm`` / ``FusedLayerNorm`` are kernel K6 of the port: for
CUDA tensors they launch a hand-written kernel of ``csrc/layer_norm.cu``,
which replaces the TPU kernel ``_ln_kernel`` (reached through
``_ln_pallas``): the register-resident 16-byte row pass
``layer_norm_vec_kernel`` or, for operands it cannot take, the scalar
``layer_norm_kernel``, as ``_ln_plan`` decides before the launch; CPU
tensors take its plain version,
``fused_layer_norm_reference``. The gradient is ``FusedLayerNormFunction``,
the JAX ``custom_vjp``'s fp32 math (``_fused_ln_bwd``) in plain PyTorch on
either device, as the JAX package has no backward kernel either. Nothing is
compiled or loaded at import time.
"""

import ctypes
import functools
from typing import Callable, NamedTuple, Optional

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
    """RMSNorm with an fp32 ``weight`` (cambrian_tpu/models/language/llama.py:45).
    ``weight_offset`` is added to the stored weight before it scales: Gemma
    stores ``w`` and scales by ``1 + w`` (the weight then starts at 0)."""

    def __init__(self, dim: int, eps: float = 1e-5, device=None, weight_offset: float = 0.0):
        super().__init__()
        self.eps = eps
        self.weight_offset = weight_offset
        init = torch.zeros if weight_offset else torch.ones
        self.weight = nn.Parameter(init(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight + self.weight_offset if self.weight_offset else self.weight
        return rms_norm(x, w, self.eps)


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


# -- K6's plan --------------------------------------------------------------------

# the vector kernel's instantiated shapes, (lanes a row, 16-byte chunks a
# lane): the pairs _ln_plan can give, as csrc/layer_norm.cu LN_VEC_INSTANCES
# lists them
LN_INSTANCES = ((4, 1), (4, 3), (4, 5), (4, 9), (8, 1), (8, 3), (8, 5), (16, 1), (16, 3),
                (32, 1), (32, 2), (32, 3), (32, 4), (32, 5), (32, 6), (32, 8), (32, 9),
                (32, 12), (32, 16))
LN_LANES = tuple(sorted({lanes for lanes, _ in LN_INSTANCES}, reverse=True))
LN_CHUNKS = tuple(sorted({chunks for _, chunks in LN_INSTANCES}))
# rows of at least this many chunks take a whole warp: a sub-warp's longer
# share a lane is latency the 576-1,024-row sites pay in full
LN_WARP_CHUNKS = 64
# above this many row groups (a warp's rows at a time), blocks of
# LN_WARPS_LARGE warps stride over the rows; at or under it, each warp takes
# one group, in blocks of one warp, or two where that still gives every SM
# at least two blocks
LN_SMALL_GROUPS = 2048
LN_WARPS_LARGE = 4
_LN_SCALAR_WARPS = 8     # layer_norm_kernel: a warp a row, 8 warps a block


class LnPlan(NamedTuple):
    """A launch of K6. ``function`` is ``layer_norm_vec_kernel`` (``lanes``
    lanes a row, each holding ``chunks`` 16-byte chunks of it; blocks of
    ``warps`` warps, ``blocks`` of them striding over the row groups) or
    ``layer_norm_kernel`` (a warp a row, 8 warps a block)."""
    function: str
    lanes: int
    chunks: int
    warps: int
    blocks: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _ln_chunks_a_lane(chunks: int, lanes: int) -> Optional[int]:
    """The fewest chunks a lane instantiated for ``lanes`` that cover a row
    of ``chunks``."""
    return next((c for la, c in LN_INSTANCES if la == lanes and c * lanes >= chunks), None)


def _ln_lanes(chunks: int) -> int:
    """Lanes a row: a whole warp for a row of LN_WARP_CHUNKS chunks or more;
    else the most lanes that split the row's chunks exactly into an
    instantiated count; else a whole warp (at least 32 chunks) or the fewest
    of 4, 8, 16 that give each lane at most one chunk."""
    if chunks >= LN_WARP_CHUNKS:
        return 32
    exact = [lanes for lanes in LN_LANES
             if chunks % lanes == 0 and (lanes, chunks // lanes) in LN_INSTANCES]
    if exact:
        return exact[0]
    return 32 if chunks >= 32 else max(4, 1 << (chunks - 1).bit_length())


def _ln_plan(rows: int, cols: int, dtype: torch.dtype, aligned: bool, sms: int,
             occupancy: Callable[[int, int, int], int], lanes: Optional[int] = None,
             warps: Optional[int] = None) -> LnPlan:
    """How K6 runs ``rows`` rows of ``cols``: the vector kernel for a width
    of whole 16-byte chunks (8 bf16 or 4 fp32) at 16-byte-aligned operands
    (``aligned``), up to 32 lanes of 16 chunks; else the scalar kernel.
    ``occupancy(lanes, chunks, warps)`` is the blocks of that shape an SM
    holds at once: the grid never exceeds what the card's ``sms`` hold, so
    no block waits for another to finish (this rule is the plan's alone).
    ``lanes`` and ``warps`` force those choices (the sweep's settings); lanes
    with no instance that covers the row give the scalar kernel."""
    per = 8 if dtype == torch.bfloat16 else 4
    scalar = LnPlan("layer_norm_kernel", 32, 0, _LN_SCALAR_WARPS, _cdiv(rows, _LN_SCALAR_WARPS))
    if not aligned or cols % per or dtype not in (torch.bfloat16, torch.float32):
        return scalar
    chunks = cols // per
    lanes = lanes or _ln_lanes(chunks)
    vpl = _ln_chunks_a_lane(chunks, lanes)
    if vpl is None:
        return scalar
    groups = _cdiv(rows, 32 // lanes)
    if warps is None:
        warps = (LN_WARPS_LARGE if groups > LN_SMALL_GROUPS
                 else 2 if groups >= 4 * sms else 1)
    blocks = min(_cdiv(groups, warps), occupancy(lanes, vpl, warps) * sms)
    return LnPlan("layer_norm_vec_kernel", lanes, vpl, warps, blocks)


# -- K6 -------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return cuda_build.load("layer_norm", {
        "cambrian_layer_norm": [i32, ptr, ptr, ptr, ptr, i32, i32, f32, ptr],
        "cambrian_layer_norm_vec": [i32, ptr, ptr, ptr, ptr, i32, i32, f32] + [i32] * 4 + [ptr],
        "cambrian_layer_norm_vec_occupancy": [i32] * 4 + [ctypes.POINTER(i32)]})


@functools.lru_cache(maxsize=None)
def _occupancy(device: torch.device, dtype_code: int, lanes: int, chunks: int,
               warps: int) -> int:
    lib = _library()
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = lib.cambrian_layer_norm_vec_occupancy(dtype_code, lanes, chunks, warps,
                                                    ctypes.byref(blocks))
    cuda_build.check_launch(lib, err, "layer_norm occupancy")
    return blocks.value


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _ln_kernel(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
               lanes: Optional[int] = None, warps: Optional[int] = None) -> torch.Tensor:
    """Launch the K6 kernel function ``_ln_plan`` names on CUDA inputs
    (counted in ``fused_layer_norm.launches`` and, by function, in
    ``fused_layer_norm.function_launches``). ``lanes`` and ``warps`` force
    the plan's."""
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
    code = cuda_build.dtype_code(x)
    ptrs = (x2.data_ptr(), w32.data_ptr(), b32.data_ptr(), out.data_ptr())
    plan = _ln_plan(x2.shape[0], c, x.dtype, all(p % 16 == 0 for p in ptrs), _sms(x.device),
                    functools.partial(_occupancy, x.device, code), lanes, warps)
    lib = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    fused_layer_norm.launches += 1
    counts = fused_layer_norm.function_launches
    counts[plan.function] = counts.get(plan.function, 0) + 1
    if plan.function == "layer_norm_vec_kernel":
        err = lib.cambrian_layer_norm_vec(code, *ptrs, x2.shape[0], c, float(eps), plan.lanes,
                                          plan.chunks, plan.warps, plan.blocks, stream)
    else:
        err = lib.cambrian_layer_norm(code, *ptrs, x2.shape[0], c, float(eps), stream)
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
fused_layer_norm.function_launches = {}   # by kernel function: the plan's route


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
