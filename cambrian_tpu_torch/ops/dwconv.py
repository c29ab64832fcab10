"""Depthwise 7x7 convolution in the NHWC layout (cambrian_tpu/ops/dwconv.py):
kernel K7 of the port.

``depthwise_conv7x7`` launches a hand-written CUDA kernel of
``csrc/dwconv.cu`` for CUDA tensors, which replaces the TPU kernel
``_kernel`` (reached through ``_dwconv_fwd_impl``): the persistent,
TMA-fed ``dwconv7x7_tma_kernel`` or, for operands a tensor map cannot
address, the first port's ``dwconv7x7_kernel``, as ``_dw_plan`` decides
before the launch. w and bias are read in place (bf16 or fp32, any
strides). CPU tensors take its plain version,
``depthwise_conv7x7_reference``. The gradient is ``DepthwiseConv7x7Function``,
the JAX ``custom_vjp``'s math (``_dwconv_bwd``) in plain PyTorch on either
device. Layouts are the JAX package's: x [B, H, W, C], w [7, 7, C], bias
[C]; an ``nn.Conv2d(C, C, 7, groups=C)`` weight [C, 1, 7, 7] is
``weight[:, 0].permute(1, 2, 0)``. The port's ConvNeXt keeps its
``nn.Conv2d`` (on the card, PyTorch's own depthwise kernel for its bf16
NCHW input); nothing on its path calls this kernel. Nothing is compiled or
loaded at import time.
"""

import ctypes
import functools
from typing import Callable, NamedTuple, Optional, Tuple, Union

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


# -- K7's plan -----------------------------------------------------------------

DW_TMA = "dwconv7x7_tma_kernel"        # the TMA-fed persistent kernel
DW_OLD = "dwconv7x7_kernel"            # the first port's kernel, for the rest
DW_CHANNELS = 32                       # channels a tile, a lane each
# the TMA kernel's register blocks, (output rows, output columns) a thread:
# the pairs _dw_plan can give, as csrc/dwconv.cu DW_TMA_INSTANCES lists them.
# One: 4 x 4 (its tile loop, 1,172 SASS instructions in bf16, runs at ~93%
# of the SM's issue rate) matched or beat 4 x 8 (2,085, 75% FFMA, ~83%: its
# loop outgrows the instruction cache), 2 x 8, 3 x 8 and 4 x 6 at the four
# ConvNeXt sites (scripts/dwconv_sweep.py, scripts/dwconv_phases.py)
DW_INSTANCES = ((4, 4),)
# warps a block along a tile's (rows, columns): 4 or 8 warps
DW_WARPS = ((2, 4), (4, 2), (1, 8), (8, 1), (2, 2), (1, 4), (4, 1))
DW_STAGES = (2, 3)
# fewer warps than this on an SM leave the FFMA latency exposed: the cost
# model scales their work up by the shortfall
DW_BUSY_WARPS = 8
# the first port's kernel: a block of 8 warps, a warp an output row of 16
# columns, grid (W / 16, H / 8, B x channel slices)
_OLD_ROWS, _OLD_COLS = 8, 16


class DwPlan(NamedTuple):
    """A launch of K7. ``function`` is ``dwconv7x7_tma_kernel`` (a thread a
    channel and ``rows`` x ``cols`` outputs; blocks of ``warps_h`` x
    ``warps_w`` warps, so a tile of ``tile_h`` x ``tile_w`` outputs x 32
    channels; ``stages`` boxes in flight; ``blocks`` persistent blocks over
    ``tiles`` tiles) or ``dwconv7x7_kernel`` (8 x 16 x 32 output tiles, a
    block each: 1 x 16 outputs a thread, 8 x 1 warps, one stage)."""
    function: str
    rows: int
    cols: int
    warps_h: int
    warps_w: int
    stages: int
    blocks: int
    tiles: int

    @property
    def tile_h(self) -> int:
        return self.rows * self.warps_h

    @property
    def tile_w(self) -> int:
        return self.cols * self.warps_w


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _dw_tiles(b: int, h: int, w: int, c: int, tile_h: int, tile_w: int) -> int:
    return _cdiv(c, DW_CHANNELS) * b * _cdiv(h, tile_h) * _cdiv(w, tile_w)


def _dw_old_plan(b: int, h: int, w: int, c: int) -> DwPlan:
    """The first port's kernel: a block a tile, as many as there are tiles."""
    tiles = _dw_tiles(b, h, w, c, _OLD_ROWS, _OLD_COLS)
    return DwPlan(DW_OLD, 1, _OLD_COLS, _OLD_ROWS, 1, 1, tiles, tiles)


def _dw_cost(tiles: int, blocks: int, sms: int, rows: int, cols: int, warps: int,
             elem: int) -> int:
    """Warp instructions of the busiest SM (a model): its blocks times the
    longest run of tiles a block takes times a tile's instructions (49 FFMA
    and ~5 of epilogue an output, a read of each staged value and, in bf16,
    its widening), scaled up where the SM holds fewer than DW_BUSY_WARPS
    warps."""
    on_sm = _cdiv(blocks, sms)
    per_tile = warps * (rows * cols * 54 + (rows + 6) * (cols + 6) * (2 if elem == 2 else 1))
    busy = max(1.0, DW_BUSY_WARPS / (on_sm * warps))
    return int(on_sm * _cdiv(tiles, blocks) * per_tile * busy)


def _dw_plan(b: int, h: int, w: int, c: int, dtype: torch.dtype, strides: Tuple[int, ...],
             aligned: bool, sms: int, occupancy: Callable[..., int],
             warps_h: Optional[int] = None, warps_w: Optional[int] = None,
             stages: Optional[int] = None, blocks: Optional[int] = None) -> DwPlan:
    """How K7 runs x [b, h, w, c] of ``dtype`` with element ``strides``:
    the TMA kernel where a tensor map can address x (contiguous, its base
    16-byte ``aligned``, c x the element size a multiple of 16 bytes), else
    the first port's kernel. For the TMA kernel, of the register blocks
    DW_INSTANCES and the block shapes DW_WARPS, the one ``_dw_cost`` rates
    cheapest (ties: more warps a block, then fewer staged values an output;
    ``scripts/dwconv_sweep.py`` measured 8 warps ahead of 4 at every site);
    ``stages`` the most of DW_STAGES that keep the SM's blocks and do not
    exceed a block's tiles; ``blocks`` as many as the card's ``sms`` hold at once
    (``occupancy(rows, cols, warps, tile_h, tile_w, stages)`` blocks an SM;
    this rule is the plan's alone), at most one a tile. ``warps_h`` ..
    ``blocks`` force those choices (the sweep's settings); a forced shape
    not in DW_WARPS, or whose blocks do not fit an SM, gives the first
    port's kernel."""
    elem = 2 if dtype == torch.bfloat16 else 4
    contiguous = tuple(strides) == (h * w * c, w * c, c, 1)
    old = _dw_old_plan(b, h, w, c)
    if (dtype not in (torch.bfloat16, torch.float32) or not contiguous or not aligned
            or (c * elem) % 16):
        return old
    warp_shapes = [(wh, ww) for wh, ww in DW_WARPS
                   if (warps_h is None or wh == warps_h) and (warps_w is None or ww == warps_w)]
    best = None
    for r, cw in DW_INSTANCES:
        for wh, ww in warp_shapes:
            th, tw = r * wh, cw * ww
            tiles = _dw_tiles(b, h, w, c, th, tw)
            fits = occupancy(r, cw, wh * ww, th, tw, stages or DW_STAGES[0])
            if fits < 1:
                continue
            grid = blocks or min(tiles, fits * sms)
            cost = _dw_cost(tiles, grid, sms, r, cw, wh * ww, elem)
            halo = (th + 6) * (tw + 6) / (th * tw)     # staged values an output
            key = (cost, -wh * ww, halo)
            if best is None or key < best[0]:
                best = (key, r, cw, wh, ww, tiles, fits, grid)
    if best is None:
        return old
    _, r, cw, wh, ww, tiles, fits, grid = best
    if stages is None:
        per_block = _cdiv(tiles, grid)
        stages = max([s for s in DW_STAGES if s == DW_STAGES[0] or (
            s <= per_block and occupancy(r, cw, wh * ww, r * wh, cw * ww, s) >= fits)])
    return DwPlan(DW_TMA, r, cw, wh, ww, stages, min(grid, tiles), tiles)


# -- K7 -------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    operands = [i32, ptr, i32, ptr, i64, i64, i64, i32, ptr, i64, ptr, i32, i32, i32, i32]
    return cuda_build.load("dwconv", {
        "cambrian_dwconv7x7": operands + [ptr],
        "cambrian_dwconv7x7_tma": operands + [i32] * 6 + [ptr],
        "cambrian_dwconv7x7_tma_occupancy": [i32] * 7 + [ctypes.POINTER(i32)]})


@functools.lru_cache(maxsize=None)
def _occupancy(device: torch.device, dtype_code: int, rows: int, cols: int, warps: int,
               tile_h: int, tile_w: int, stages: int) -> int:
    lib = _library()
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = lib.cambrian_dwconv7x7_tma_occupancy(dtype_code, rows, cols, warps, tile_h,
                                                   tile_w, stages, ctypes.byref(blocks))
    cuda_build.check_launch(lib, err, "dwconv7x7 occupancy")
    return blocks.value


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _param(t: torch.Tensor) -> torch.Tensor:
    """w or bias as the kernel reads it: bf16 or fp32 as it is, in place;
    another dtype as an fp32 copy."""
    t = t.detach()
    return t if t.dtype in (torch.bfloat16, torch.float32) else t.float()


def _dwconv_kernel(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                   _route: Union[None, str, DwPlan] = None) -> torch.Tensor:
    """Launch the K7 kernel function ``_dw_plan`` names on CUDA inputs
    (counted in ``depthwise_conv7x7.launches`` and, by function, in
    ``depthwise_conv7x7.function_launches``). w and bias are read in place,
    in their own strides and dtype. ``_route`` forces a route: ``DW_OLD``,
    or a ``DwPlan`` launched as it is (the sweep's and the tests' settings)."""
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
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return out
    code = cuda_build.dtype_code(x)
    if isinstance(_route, DwPlan):
        plan = _route
    elif _route == DW_OLD:
        plan = _dw_old_plan(b, h, wd, c)
    else:
        plan = _dw_plan(b, h, wd, c, x.dtype, x.stride(), x.data_ptr() % 16 == 0,
                        _sms(x.device), functools.partial(_occupancy, x.device, code))
    xk = x if plan.function == DW_TMA else x.contiguous()
    wk, bk = _param(w), _param(bias)
    operands = (code, xk.data_ptr(), cuda_build.dtype_code(wk), wk.data_ptr(), *wk.stride(),
                cuda_build.dtype_code(bk), bk.data_ptr(), bk.stride(0), out.data_ptr(), b, h, wd,
                c)
    lib = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    depthwise_conv7x7.launches += 1
    counts = depthwise_conv7x7.function_launches
    counts[plan.function] = counts.get(plan.function, 0) + 1
    if plan.function == DW_TMA:
        err = lib.cambrian_dwconv7x7_tma(*operands, plan.rows, plan.cols, plan.warps_h,
                                         plan.warps_w, plan.stages, plan.blocks, stream)
    else:
        err = lib.cambrian_dwconv7x7(*operands, stream)
    cuda_build.check_launch(lib, err, plan.function)
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
depthwise_conv7x7.function_launches = {}   # by kernel function: the plan's route
