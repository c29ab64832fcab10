"""SVA windowed cross-attention (cambrian_tpu/ops/sva_attention.py): kernel K5
of the port.

``fused_windowed_cross_attention`` launches a hand-written CUDA kernel of
``csrc/sva_attention.cu`` for CUDA tensors, which replaces the TPU kernel
``_kernel`` (reached through ``_fused_impl``): the persistent, TMA-fed
``sva_attention_tma_kernel`` or, for operands a tensor map cannot address,
the first port's ``sva_attention_kernel``, as ``_sva_plan`` decides before
the launch. q, k, v and the mask are read in place. CPU tensors take its
plain version, ``fused_windowed_cross_attention_reference``. The gradient is
``WindowedAttentionFunction``, the JAX ``custom_vjp``'s math (``_fused_bwd``)
in plain PyTorch on either device.

The kernels take what the JAX wrapper sent to the einsum path instead (a
[B, Q, H, W] mask, fewer than 64 queries): those were rules of the TPU's
memory and tiling. They take windows of up to ``MAX_WINDOW`` keys and head
dims up to ``MAX_HEAD_DIM``. The port's SVA keeps calling
``ops.attention.windowed_cross_attention``; nothing on its path calls this
kernel. Nothing is compiled or loaded at import time.
"""

import ctypes
import functools
from typing import Callable, NamedTuple, Optional, Sequence, Tuple, Union

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


# -- K5's plan -------------------------------------------------------------------

SVA_TMA = "sva_attention_tma_kernel"   # the TMA-fed persistent kernel
SVA_OLD = "sva_attention_kernel"       # the first port's kernel, for the rest
# the TMA kernel's lane groups, lanes a key row: a row's 16-byte pieces,
# rounded up to a power of two of at least 8 (so each quarter warp reads 128
# contiguous bytes of one row: no bank conflict), a lane each
SVA_LANES = (8, 16, 32)
# its window classes, the longest window each takes: a class sizes the
# logits a lane keeps in registers and the passes the kernel unrolls
SVA_WINDOWS = (32, 64)
# the (lanes, window class) pairs _sva_plan can give, as csrc/sva_attention.cu
# SVA_TMA_INSTANCES lists them; a dtype of `elem` bytes is built at those of
# at most 8 elem lanes (a row of D <= 128: bf16 16 pieces, fp32 32)
SVA_INSTANCES = tuple((lanes, window) for lanes in SVA_LANES for window in SVA_WINDOWS)
SVA_STAGES = (2, 3, 4)
SVA_MAX_HEADS = 8          # heads a unit: a compute warp each, and a producer warp
SVA_BOX = 256              # TMA's limit on a box side: heads x D columns
SVA_SHARE = 1.06           # the busiest SM's units over the mean, at most
SVA_IN_FLIGHT = 32 << 10   # bytes an SM keeps in flight while it computes, at least
_OLD_WARPS = 4             # the first port's kernel: a warp a (b, q, h), 4 a block


class SvaPlan(NamedTuple):
    """A launch of K5. ``function`` is ``sva_attention_tma_kernel`` (units of
    one query and ``heads`` heads, ``lanes`` lanes a key row, the window
    class ``window``, ``stages`` ring stages, ``blocks`` persistent blocks,
    ``blocks_per_sm`` of them resident an SM, over ``units`` units;
    ``share``: the busiest SM's units over the mean, where each SM holds its
    blocks and each block the largest share; ``in_flight``: the bytes an SM
    keeps in flight while it computes) or ``sva_attention_kernel`` (a warp a
    (b, q, h), 4 a block; ``share`` and ``in_flight`` 0: it has no ring and
    no persistent grid)."""
    function: str
    lanes: int
    window: int
    heads: int
    stages: int
    blocks_per_sm: int
    blocks: int
    units: int
    share: float
    in_flight: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _check_window(w: int, d: int) -> None:
    if not 1 <= w <= MAX_WINDOW or d > MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes 1..{MAX_WINDOW} keys a window and head_dim <= "
                         f"{MAX_HEAD_DIM}, got W={w}, D={d}")


def _row_stride(sizes: Sequence[int], strides: Sequence[int], row: int) -> Optional[int]:
    """The one stride (elements) between consecutive rows of ``row``
    elements when the axes ``sizes`` (at ``strides``) are flattened into
    rows, or None where no single stride walks them (axes of size 1 take
    any stride; all of them of size 1: ``row``)."""
    r, span = None, 1
    for n, st in reversed(list(zip(sizes, strides))):
        if n != 1:
            if r is None:
                r = st
            elif st != r * span:
                return None
        span *= n
    return row if r is None else r


def _tma_rows(b: int, n_q: int, h: int, w: int, d: int, elem: int,
              strides: Sequence[Sequence[int]]) -> Optional[Tuple[int, int, int]]:
    """The row strides (elements) of q [b, n_q, h, d] viewed as [b n_q, h d]
    and of k and v [b, n_q, w, h, d] as [b n_q w, h d], as the TMA kernel's
    tensor maps take them: q dense along (h, d) and k, v along (w, h, d)
    (a window one block of w h d), each row a multiple of 16 bytes and at
    least h d elements. None where one of them is not."""
    rows = []
    for t_strides, outer in zip(strides, ((b, n_q), (b, n_q, w), (b, n_q, w))):
        t_strides = tuple(t_strides)
        if t_strides[-1] != 1 or (h > 1 and t_strides[-2] != d):
            return None
        r = _row_stride(outer, t_strides[:len(outer)], h * d)
        if r is None or r < h * d or (r * elem) % 16 or (len(outer) == 3 and r != h * d):
            return None
        rows.append(r)
    return tuple(rows)


def _sva_old_plan(b: int, n_q: int, h: int, w: int, d: int) -> SvaPlan:
    """The first port's kernel: a warp a (b, q, h), blocks of 4 warps."""
    _check_window(w, d)
    items = b * n_q * h
    return SvaPlan(SVA_OLD, 32, MAX_WINDOW, 1, 1, 0, _cdiv(items, _OLD_WARPS), items, 0.0, 0)


def sva_smem_bytes(heads: int, w: int, d: int, elem: int, stages: int) -> int:
    """The TMA kernel's dynamic shared memory a block, as csrc
    tma_layout lays it out: a 128-byte head (the barriers), then ``stages``
    stages of a unit's q, K and V boxes, each at a 128-byte boundary."""
    def r128(n):
        return -(-n // 128) * 128

    return 128 + stages * (r128(heads * d * elem) + 2 * r128(w * heads * d * elem))


def _sva_unit_bytes(heads: int, w: int, d: int, elem: int) -> int:
    """A unit's bytes: its q box and its K and V boxes."""
    return (1 + 2 * w) * heads * d * elem


def _sva_share(units: int, blocks: int, blocks_per_sm: int, sms: int) -> float:
    """The busiest SM's units over the mean: its resident blocks (at most
    ``blocks_per_sm``, at most the grid spread over the SMs) each with the
    largest block's share."""
    on_sm = min(blocks_per_sm, _cdiv(blocks, sms))
    return on_sm * _cdiv(units, blocks) / (units / sms)


def _sva_plan(b: int, n_q: int, h: int, w: int, d: int, dtype: torch.dtype,
              strides: Sequence[Sequence[int]], aligned: bool, sms: int,
              occupancy: Callable[..., int], heads: Optional[int] = None,
              stages: Optional[int] = None, blocks_per_sm: Optional[int] = None) -> SvaPlan:
    """How K5 runs q [b, n_q, h, d] and k, v [b, n_q, w, h, d] of ``dtype``
    with element ``strides`` (q's, k's, v's): the TMA kernel where its
    tensor maps can address them (``_tma_rows``; the bases 16-byte
    ``aligned``; d x the element size a multiple of 16 bytes), else the
    first port's kernel. W > MAX_WINDOW or D > MAX_HEAD_DIM raises on either.

    For the TMA kernel: ``lanes`` the row's 16-byte pieces rounded up to a
    power of two of at least 8 (fp32 at D = 72: 18 pieces, 32 lanes, 14 of
    them idle); ``window`` the smallest of SVA_WINDOWS that holds w. Of the
    units of one query and G heads (G divides h, G <= 8, G d <= 256), the
    stages SVA_STAGES and the blocks an SM holds (``occupancy(lanes, window,
    G, w, d, stages)``, this rule the plan's alone), the one whose busiest
    SM takes the smallest share of units above the mean (any share up to
    SVA_SHARE counts as even), then that keeps at least SVA_IN_FLIGHT bytes
    in flight an SM, then the most heads a unit (the largest boxes), then
    the most blocks an SM (the most warps to overlap the units' compute
    with), then the fewest stages (``scripts/sva_sweep.py``: 2 stages ahead
    of 3 and 4 at equal blocks). The grid is blocks_per_sm x sms, at most a
    block a unit. ``heads``, ``stages`` and ``blocks_per_sm`` force those
    choices (the sweep's settings); forced settings that fit no SM give the
    first port's kernel."""
    old = _sva_old_plan(b, n_q, h, w, d)
    elem = {torch.bfloat16: 2, torch.float32: 4}.get(dtype)
    if elem is None or (d * elem) % 16 or not aligned:
        return old
    if _tma_rows(b, n_q, h, w, d, elem, strides) is None:
        return old
    lanes = max(SVA_LANES[0], 1 << (d * elem // 16 - 1).bit_length())
    window = min(c for c in SVA_WINDOWS if c >= w)
    best = None
    for g in range(min(h, SVA_MAX_HEADS), 0, -1):
        if h % g or g * d > SVA_BOX or (heads is not None and g != heads):
            continue
        units = b * n_q * (h // g)
        unit_bytes = _sva_unit_bytes(g, w, d, elem)
        for s in SVA_STAGES if stages is None else (stages,):
            fits = occupancy(lanes, window, g, w, d, s)
            for bps in range(fits, 0, -1) if blocks_per_sm is None else (blocks_per_sm,):
                if bps > fits:
                    continue
                grid = min(units, bps * sms)
                share = _sva_share(units, grid, bps, sms)
                per_block = _cdiv(units, grid)
                flight = min(bps, _cdiv(grid, sms)) * min(s - 1, per_block) * unit_bytes
                key = (max(share, SVA_SHARE), flight < SVA_IN_FLIGHT, -g, -bps, s)
                if best is None or key < best[0]:
                    best = (key, SvaPlan(SVA_TMA, lanes, window, g, s, bps, grid, units, share,
                                         flight))
    return old if best is None else best[1]


# -- K5 -----------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    strides, f32 = ctypes.POINTER(ctypes.c_int64), ctypes.c_float
    return cuda_build.load("sva_attention", {
        "cambrian_sva_attention": [i32, ptr, ptr, ptr, ptr, ptr] + [strides] * 5
                                  + [i32] * 5 + [f32, ptr],
        "cambrian_sva_attention_tma": [i32, ptr, ptr, ptr, ptr, ptr, i64, i64, i64, strides]
                                      + [i32] * 5 + [f32] + [i32] * 5 + [ptr],
        "cambrian_sva_attention_tma_occupancy": [i32] * 7 + [ctypes.POINTER(i32)]})


@functools.lru_cache(maxsize=None)
def _occupancy(device: torch.device, dtype_code: int, lanes: int, window: int, heads: int,
               w: int, d: int, stages: int) -> int:
    lib = _library()
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = lib.cambrian_sva_attention_tma_occupancy(dtype_code, lanes, window, heads, w, d,
                                                       stages, ctypes.byref(blocks))
    cuda_build.check_launch(lib, err, "sva_attention occupancy")
    return blocks.value


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _int64s(*values):
    return (ctypes.c_int64 * len(values))(*values)


def _sva_kernel(q, k, v, mask, scale, _route: Union[None, str, SvaPlan] = None):
    """Launch the K5 kernel function ``_sva_plan`` names on CUDA inputs
    (counted in ``fused_windowed_cross_attention.launches`` and, by function,
    in ``fused_windowed_cross_attention.function_launches``). q, k, v and
    the mask are read in place. ``_route`` forces a route: ``SVA_OLD``, or an
    ``SvaPlan`` launched as it is (the sweep's and the tests' settings)."""
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
    _check_window(w, d)
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
    code = cuda_build.dtype_code(q)
    strides = (q.stride(), k.stride(), v.stride())
    if isinstance(_route, SvaPlan):
        plan = _route
    elif _route == SVA_OLD:
        plan = _sva_old_plan(b, n_q, h, w, d)
    else:
        plan = _sva_plan(b, n_q, h, w, d, q.dtype, strides,
                         all(t.data_ptr() % 16 == 0 for t in (q, k, v)), _sms(q.device),
                         functools.partial(_occupancy, q.device, code))
    lib = _library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    fused_windowed_cross_attention.launches += 1
    counts = fused_windowed_cross_attention.function_launches
    counts[plan.function] = counts.get(plan.function, 0) + 1
    if plan.function == SVA_TMA:
        rows = _tma_rows(b, n_q, h, w, d, q.element_size(), strides) or (0, 0, 0)
        err = lib.cambrian_sva_attention_tma(
            code, q.data_ptr(), k.data_ptr(), v.data_ptr(), m_ptr, out.data_ptr(), *rows,
            m_strides, b, n_q, h, w, d, float(scale), plan.lanes, plan.window, plan.heads,
            plan.stages, plan.blocks, stream)
    else:
        err = lib.cambrian_sva_attention(
            code, q.data_ptr(), k.data_ptr(), v.data_ptr(), m_ptr, out.data_ptr(),
            _int64s(*q.stride()[:3]), _int64s(*k.stride()[:4]), _int64s(*v.stride()[:4]),
            m_strides, _int64s(*out.stride()[:3]), b, n_q, h, w, d, float(scale), stream)
    cuda_build.check_launch(lib, err, plan.function)
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
fused_windowed_cross_attention.function_launches = {}   # by kernel function: the plan's route
