"""Weight-only int8/int4 quantization and dequant-matmuls (cambrian_tpu/ops/quant.py):
kernels K3, K4 and K4b/K4c of the port.

Storage layout, byte for byte the JAX package's:

- int8: ``kernel_q`` int8 [K, N] with per-output-channel fp32 ``scale`` [N];
- int4: ``kernel_q4`` int8 [K/2, N], rows (2r, 2r+1) packed into byte r as its
  low and high nibble, with K-groupwise fp32 ``scale`` [K/group, N].

``int8_matmul``, ``int4_matmul`` and ``int4_matmul_scale_on_weights`` launch
the hand-written CUDA kernels of ``csrc/quant_matmul.cu`` for CUDA tensors
(each wrapper counts its launches in ``.launches``) and use the plain PyTorch
versions for CPU tensors; on the card there is no fallback. ``int4_matmul``
hands over to ``int4_matmul_scale_on_weights`` under ``CAMBRIAN_INT4_V2=1``
or ``CAMBRIAN_INT4_V1=1``, the JAX package's switches for those kernels.
A bf16 decode call of K3, K4 or K4b/K4c runs ``gemv_m1_kernel`` (M = 1)
or ``gemv_m8_kernel`` (M = 2..8, the continuous-batching decode) under the
launch shape ``_gemv_plan`` gives it, where its operands allow; every other
call at M <= 8 runs the first port's ``gemv_kernel``. Nothing is compiled or
loaded at import time.
"""

import ctypes
import functools
import os
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from . import cuda_build

INT4_GROUP = 128  # unpacked K rows per scale

# the decoder GEMMs; embeddings and the LM head stay full precision
DECODER_QUANT_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj",
                         "gate_proj", "up_proj", "down_proj")

_MODE_INT8, _MODE_INT4, _MODE_INT4_SCALE_ON_WEIGHTS = 0, 1, 2
_MODES = (_MODE_INT8, _MODE_INT4, _MODE_INT4_SCALE_ON_WEIGHTS)
_KERNEL_TILE_K = 32   # the kernel's K tile: int4 groups are a multiple of it, or K

# The bf16 M = 1 decode GEMV (gemv_m1_kernel of csrc/quant_matmul.cu); these
# must match its constants (kM1Loads, kM1MaxWarps, kM1SmemBytes).
H100_SMS = 132
GEMV_LOADS = 8                  # 16-byte loads of a lane's batch
GEMV_MAX_WARPS = 8
GEMV_WARPS = 4                  # warps a block the plan gives at most
GEMV_BLOCKS_PER_SM = 2          # blocks an SM the plan aims for
GEMV_SMEM_BYTES = 48 << 10      # x and scales of a block's rows (fp32) and its sums
GEMV_MIN_BLOCK_BYTES = 32 << 10  # a block streams at least this much where it can
GEMV_SLABS = (128, 64)          # stored bytes of a row a cluster owns
# mode 2's slab: its m16n8k16 products take 8 lanes' 16 columns a row
GEMV_MMA_SLAB = 128
GEMV_CLUSTERS = (2, 4, 8)
# The bf16 M = 2..8 decode GEMV (gemv_m8_kernel); these must match
# kM8BatchBytes and kM8SmemBytes. Its rows of x, zero-padded to one of
# GEMV_M8_ROWS, take M of an m16n8k16 product's 8 columns.
GEMV_M8_BATCH_BYTES = 128       # weight bytes a lane loads a batch (8 x 16 or 16 x 8)
GEMV_M8_SMEM_BYTES = 96 << 10   # x, scales and sums; above 48 KB the kernel opts in
GEMV_M8_ROWS = (2, 4, 8)


# -- quantizers ---------------------------------------------------------------

def quantize_int8(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[K, N] float -> (int8 values [K, N], fp32 scales [N]), symmetric per
    output channel."""
    w32 = w.float()
    absmax = w32.abs().amax(0)
    scale = torch.where(absmax > 0, absmax / 127.0, 1.0)
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    # a transposed ``w`` would give transposed strides; the kernel reads rows
    return q.contiguous(), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def int4_group(k: int, group: int = INT4_GROUP) -> int:
    """Effective scale group for a K dim: the default when it divides K, else
    one group spanning K."""
    return group if k % group == 0 else k


def quantize_int4(w: torch.Tensor, group: int = INT4_GROUP) -> Tuple[torch.Tensor, torch.Tensor]:
    """[K, N] float -> (packed int8 [K/2, N], fp32 scales [K/group, N]):
    symmetric K-groupwise quantization to [-8, 7]; rows (2r, 2r+1) share
    byte r as (low, high) nibbles."""
    k, n = w.shape
    group = int4_group(k, group)
    if k % 2 or k % group:
        raise ValueError(f"int4 quantization needs an even K divisible by its group, "
                         f"got K={k}, group={group}")
    w32 = w.float().reshape(k // group, group, n)
    absmax = w32.abs().amax(1)
    scale = torch.where(absmax > 0, absmax / 7.0, 1.0)
    q = torch.clamp(torch.round(w32 / scale[:, None, :]), -8, 7).to(torch.int32).reshape(k, n)
    # in int32 the packed value lies in [-128, 127], so the cast to int8 is exact
    packed = (q[0::2] & 0xF) | (q[1::2] << 4)
    return packed.to(torch.int8).contiguous(), scale.contiguous()


def _unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """[K/2, N] packed -> [K, N] int32 values in [-8, 7]."""
    k2, n = packed.shape
    b = packed.to(torch.int32)
    low = ((b & 0xF) ^ 8) - 8       # sign-extended low nibble
    high = b >> 4                   # arithmetic shift: the high nibble, signed
    return torch.stack([low, high], dim=1).reshape(2 * k2, n)


def dequantize_int4(packed: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse of quantize_int4 -> [K, N] dtype."""
    q = _unpack_int4(packed)
    k, n = q.shape
    g = scale.shape[0]
    deq = q.reshape(g, k // g, n).float() * scale[:, None, :]
    return deq.reshape(k, n).to(dtype)


def quantize_state_dict(sd: Dict[str, torch.Tensor], targets: Sequence[str] = DECODER_QUANT_TARGETS,
                        mode: str = "int8") -> Dict[str, torch.Tensor]:
    """The port's ``quantize_dense_tree``: every ``{...}.{target}.weight``
    [N, K] (nn.Linear layout) becomes ``kernel_q`` int8 [K, N] and ``scale``
    fp32 [N], or ``kernel_q4``/``scale`` for ``mode="int4"``; its bias
    becomes fp32. Returns a new dict; other entries are kept as they are."""
    if mode not in ("int8", "int4"):
        raise ValueError(f"mode must be int8 or int4, got {mode!r}")
    out = {}
    for key, value in sd.items():
        head, _, leaf = key.rpartition(".")
        site = head.rpartition(".")[2]
        if site in targets and leaf == "weight" and value.dim() == 2:
            if mode == "int4":
                out[f"{head}.kernel_q4"], out[f"{head}.scale"] = quantize_int4(value.T)
            else:
                out[f"{head}.kernel_q"], out[f"{head}.scale"] = quantize_int8(value.T)
        elif site in targets and leaf == "bias":
            out[key] = value.float()
        else:
            out[key] = value
    return out


# -- plain versions -------------------------------------------------------------

def int8_matmul_reference(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """K3's arithmetic in plain PyTorch: x times the int8 values with an fp32
    accumulator, the per-column scale on the accumulator, cast to x.dtype."""
    return ((x.float() @ w_q.float()) * scale).to(x.dtype)


def int4_matmul_reference(x: torch.Tensor, w_q4: torch.Tensor, scale: torch.Tensor,
                          scale_on_weights: bool = False) -> torch.Tensor:
    """K4's arithmetic in plain PyTorch: per scale group, an fp32 partial sum
    of x times the int4 values, scaled and summed; cast to x.dtype. With
    ``scale_on_weights`` (K4b/K4c) the weights are dequantized in x.dtype
    first (the scale and q * scale each rounded to x.dtype) and multiplied
    with one fp32 accumulation over K."""
    q = _unpack_int4(w_q4)
    k, n = q.shape
    g = scale.shape[0]
    if scale_on_weights:
        w = q.to(x.dtype) * scale.to(x.dtype).repeat_interleave(k // g, dim=0)
        return (x.float() @ w.float()).to(x.dtype)
    xg = x.float().reshape(-1, g, k // g).transpose(0, 1)         # [G, M, group]
    parts = torch.bmm(xg, q.float().reshape(g, k // g, n))        # [G, M, N]
    return (parts * scale[:, None, :]).sum(0).to(x.dtype)


# -- the decode GEMV's plan -----------------------------------------------------

class GemvPlan(NamedTuple):
    """A launch of ``gemv_m1_kernel`` (M = 1) or ``gemv_m8_kernel`` (M =
    2..8). Each cluster of ``cluster`` blocks owns
    a slab of ``slab`` stored bytes of every weight row (int8: that many
    columns; packed int4: as many columns of two K rows each). Its blocks
    split the stored rows in rank order, ``rows_per_block`` each, and a
    block's ``warps`` warps split those, ``rows_per_warp`` each; the last
    block's share ends at the last row."""
    slab: int
    cluster: int
    warps: int
    rows_per_block: int
    rows_per_warp: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _gemv_unit(mode: int, k: int, group: int, slab: int) -> int:
    """Stored rows that every split of K keeps whole: one batch of a warp's
    loads (int8); a scale group's packed rows (int4), or 64 of them (128 K
    rows) where one group spans K."""
    if mode == _MODE_INT8:
        return GEMV_LOADS * 32 // (slab // 16)
    return 64 if group == k else group // 2


def _gemv_rows(m: int) -> int:
    """The rows of x a GEMV instance is built for: 1 (gemv_m1_kernel), or M
    rounded up to one of GEMV_M8_ROWS (gemv_m8_kernel's MT)."""
    return 1 if m == 1 else next(r for r in GEMV_M8_ROWS if r >= m)


def _gemv_function(m: int) -> str:
    return "gemv_m1_kernel" if m == 1 else "gemv_m8_kernel"


def _route_function(plan: Optional[GemvPlan], m: int) -> str:
    """The kernel function a call of M = ``m`` under ``plan`` (a GemvPlan or
    None) launches, as ``function_launches`` counts it."""
    if plan is not None:
        return _gemv_function(m)
    return "gemv_kernel" if m <= GEMV_M8_ROWS[-1] else "gemm"


def _gemv_takes(mode: int, dtype: torch.dtype, m: int, n: int, k: int, group: int,
                ptrs: Sequence[int], ldx: Optional[int] = None) -> bool:
    """The operands gemv_m1_kernel (M = 1) and gemv_m8_kernel (M = 2..8)
    take: bf16 x, int8 or int4 (either scaling), N a multiple of a lane's 16
    columns, K of whole 16-byte runs of x, 16-byte-aligned x, weights and
    scales, at M > 1 rows of x ``ldx`` (default K) elements apart, a
    multiple of 8 (every row 16-byte aligned), and for int4 a scale group of
    a multiple of 128 K rows, or one group over a K of a multiple of 128."""
    if dtype != torch.bfloat16 or not 1 <= m <= GEMV_M8_ROWS[-1] or mode not in _MODES:
        return False
    if n % 16 or k % 8 or any(p % 16 for p in ptrs):
        return False
    if m > 1 and (k if ldx is None else ldx) % 8:
        return False
    return mode == _MODE_INT8 or group % 128 == 0 or (group == k and k % 128 == 0)


def _gemv_m8_smem(mode: int, k: int, group: int, plan: GemvPlan, mt: int) -> int:
    """gemv_m8_kernel's shared memory (bytes; m8_smem_bytes in the source):
    MT rows of the block's x as bf16 pairs, each row padded to a stride of 4
    (mod 32) words so that the B fragments' loads hit distinct banks; the
    slab's rows of scales (int8: one; int4: the block's groups); the sums of
    the block's columns, MT rows from every warp."""
    words = plan.rows_per_block * (1 if mode == _MODE_INT8 else 2) // 2
    stride = words + (36 - words % 32) % 32
    groups = 1 if mode == _MODE_INT8 or group == k else 2 * plan.rows_per_block // group
    return 4 * (mt * stride + groups * plan.slab + plan.warps * mt * plan.slab)


def _gemv_fits(mode: int, n: int, k: int, group: int, plan: GemvPlan, m: int = 1) -> bool:
    """Whether the kernel for M = ``m`` takes the launch shape (the C side
    refuses the same): splits on whole units, no block without rows, and x,
    the scales and the sums within the kernel's shared memory."""
    slab, cluster, warps, rows_per_block, rows_per_warp = plan
    if slab not in GEMV_SLABS or cluster not in GEMV_CLUSTERS:
        return False
    if m == 1 and mode == _MODE_INT4_SCALE_ON_WEIGHTS and slab != GEMV_MMA_SLAB:
        return False
    rows = k if mode == _MODE_INT8 else k // 2
    unit = _gemv_unit(mode, k, group, slab)
    if not (1 <= warps <= GEMV_MAX_WARPS and rows_per_warp > 0
            and unit % (GEMV_LOADS * 32 // (slab // 16)) == 0
            and rows_per_warp % unit == 0
            and rows_per_block == warps * rows_per_warp
            and (cluster - 1) * rows_per_block < rows <= cluster * rows_per_block):
        return False
    if m > 1:
        return _gemv_m8_smem(mode, k, group, plan, _gemv_rows(m)) <= GEMV_M8_SMEM_BYTES
    # x of the block's rows, the slab's rows of scales (int8: one; int4: the
    # block's groups), and the sums of the block's columns
    if mode == _MODE_INT8:
        floats = rows_per_block + (1 + warps) * slab
    else:
        groups = 1 if group == k else 2 * rows_per_block // group
        floats = 2 * rows_per_block + (groups + warps) * slab
    return 4 * floats <= GEMV_SMEM_BYTES


def _gemv_split(mode: int, n: int, k: int, group: int, slab: int, cluster: int,
                warps: Optional[int] = None, m: int = 1) -> Optional[GemvPlan]:
    """K split over ``cluster`` blocks and then over at most ``warps``
    (GEMV_WARPS) warps a block, in whole units, as evenly as the units
    allow; None if the kernel would not take it."""
    rows = k if mode == _MODE_INT8 else k // 2
    unit = _gemv_unit(mode, k, group, slab)
    per_block = _cdiv(_cdiv(rows, unit), cluster)
    per_warp = _cdiv(per_block, warps or GEMV_WARPS)
    n_warps = _cdiv(per_block, per_warp)
    plan = GemvPlan(slab, cluster, n_warps, n_warps * per_warp * unit, per_warp * unit)
    return plan if _gemv_fits(mode, n, k, group, plan, m) else None


@functools.lru_cache(maxsize=None)
def _gemv_shape(mode: int, n: int, k: int, group: int, sms: int, slab: Optional[int] = None,
                cluster: Optional[int] = None, warps: Optional[int] = None,
                m: int = 1) -> Optional[GemvPlan]:
    """The launch shape for an [N, K] weight and ``m`` rows of x (the M = 2..8
    kernel's shared memory counts them, rounded up to its MT) on a card of
    ``sms`` SMs, so
    that every SM gets GEMV_BLOCKS_PER_SM blocks of GEMV_WARPS warps where N
    and K allow. Slabs of 128 bytes, or 64 where 128-byte slabs in clusters
    of 8 would give fewer blocks (mode 2 at M = 1: always 128). The smallest cluster that gives that many
    blocks (8 at most), halved while a block would stream less than
    GEMV_MIN_BLOCK_BYTES and every SM would still get a block, and again
    while the split would leave a block without rows; larger where a
    block's x and scales would not fit its shared memory. ``slab``,
    ``cluster`` and ``warps`` force those choices."""
    rows = k if mode == _MODE_INT8 else k // 2
    blocks = GEMV_BLOCKS_PER_SM * sms
    if slab is None and mode == _MODE_INT4_SCALE_ON_WEIGHTS and m == 1:
        slab = GEMV_MMA_SLAB
    if slab is None:
        slab = 128 if _cdiv(n, 128) * GEMV_CLUSTERS[-1] >= blocks else 64
    if cluster is not None:
        return _gemv_split(mode, n, k, group, slab, cluster, warps, m)
    slabs = _cdiv(n, slab)
    most = next((c for c in GEMV_CLUSTERS if slabs * c >= blocks), GEMV_CLUSTERS[-1])
    while (most > GEMV_CLUSTERS[0] and rows * slab < most * GEMV_MIN_BLOCK_BYTES
           and slabs * (most // 2) >= sms):
        most //= 2
    order = [c for c in reversed(GEMV_CLUSTERS) if c <= most]
    for c in order + [c for c in GEMV_CLUSTERS if c > most]:
        plan = _gemv_split(mode, n, k, group, slab, c, warps, m)
        if plan is not None:
            return plan
    return None


def _gemv_plan(mode: int, dtype: torch.dtype, m: int, n: int, k: int, group: int, x_ptr: int,
               w_ptr: int, sms: int = H100_SMS, s_ptr: int = 0, slab: Optional[int] = None,
               cluster: Optional[int] = None, warps: Optional[int] = None,
               ldx: Optional[int] = None) -> Optional[GemvPlan]:
    """How a call with x [m, k] (at x_ptr, rows ``ldx`` elements apart, by
    default k), weights at w_ptr and scales at s_ptr runs: a GemvPlan of
    gemv_m1_kernel (m = 1) or gemv_m8_kernel (m = 2..8), or None for the
    first port's gemv_kernel (M <= 8) and the GEMMs (M > 8). ``slab``,
    ``cluster`` and ``warps`` force those choices (the sweep's settings);
    None where the kernel would not take them."""
    if not _gemv_takes(mode, dtype, m, n, k, group, (x_ptr, w_ptr, s_ptr), ldx):
        return None
    return _gemv_shape(mode, n, k, group, sms, slab, cluster, warps, _gemv_rows(m))


def _gemv_route(route, mode: int, dtype: torch.dtype, m: int, n: int, k: int, group: int,
                ptrs: Sequence[int], sms: int, ldx: Optional[int] = None) -> Optional[GemvPlan]:
    """The plan a call launches. ``route`` None takes ``_gemv_plan``'s;
    "gemv_kernel" forces the first port's kernel (for M <= 8; None); a
    GemvPlan forces that plan (of gemv_m1_kernel at M = 1, gemv_m8_kernel at
    M = 2..8), which raises here for operands the kernel does not take and
    on the card, from the C side, for a launch shape it refuses."""
    if route is None:
        return _gemv_plan(mode, dtype, m, n, k, group, *ptrs[:2], sms, ptrs[2], ldx=ldx)
    if route == "gemv_kernel":
        if m > 8:
            raise ValueError(f"gemv_kernel runs M <= 8, got M = {m}")
        return None
    if not isinstance(route, GemvPlan):
        raise ValueError(f"_route must be None, 'gemv_kernel' or a GemvPlan, got {route!r}")
    if not _gemv_takes(mode, dtype, m, n, k, group, ptrs, ldx):
        raise ValueError(f"{_gemv_function(m) if m <= 8 else 'no GEMV'} does not take mode "
                         f"{mode}, {dtype}, M={m}, N={n}, K={k}, ldx {ldx}, group {group} at "
                         f"{[p % 16 for p in ptrs]} past 16 bytes")
    return route


# -- kernels ------------------------------------------------------------------

_I64, _I32, _PTR = ctypes.c_int64, ctypes.c_int, ctypes.c_void_p
# the C entries of csrc/quant_matmul.cu and their argument types
C_ENTRIES = {
    "cambrian_quant_matmul": [_I32, _I32, _PTR, _I64, _PTR, _PTR, _PTR, _I32, _I32, _I32, _I32,
                              _PTR],
    "cambrian_quant_gemv_m1": [_I32, _PTR, _PTR, _PTR, _PTR] + [_I32] * 8 + [_PTR],
    "cambrian_quant_gemv_m8": [_I32, _PTR, _I64, _PTR, _PTR, _PTR] + [_I32] * 9 + [_PTR],
}


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    return cuda_build.load("quant_matmul", C_ENTRIES)


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch(wrapper, mode: int, x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
            k: int, n: int, group: int, route=None) -> torch.Tensor:
    """Check what the kernel takes, allocate the output, launch on the
    current stream (counted in ``wrapper.launches`` and, by route, in
    ``wrapper.function_launches``: ``gemv_m1_kernel``, ``gemv_m8_kernel``,
    ``gemv_kernel`` (M <= 8) or ``gemm`` (M > 8, the GEMM kernels)); raise
    on anything the kernel refuses. ``route`` is ``_gemv_route``'s."""
    if x.dim() != 2 or x.shape[1] != k:
        raise ValueError(f"x must be [M, {k}], got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the kernel takes bfloat16 or float32 x, got {x.dtype}")
    if w.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"weights must be int8 and scales float32, got {w.dtype}, {scale.dtype}")
    for name, t in (("weights", w), ("scale", scale)):
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    m = x.shape[0]
    if k > 1 and x.stride(1) != 1:
        raise ValueError(f"x must have a unit stride along K, got strides {x.stride()}")
    if m == 0:
        return torch.empty((0, n), dtype=x.dtype, device=x.device)
    ldx = x.stride(0) if m > 1 else k
    plan = _gemv_route(route, mode, x.dtype, m, n, k, group,
                       (x.data_ptr(), w.data_ptr(), scale.data_ptr()), _sms(x.device), ldx)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    lib = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    wrapper.launches += 1
    function = _route_function(plan, m)
    wrapper.function_launches[function] = wrapper.function_launches.get(function, 0) + 1
    if plan is not None and m == 1:
        err = lib.cambrian_quant_gemv_m1(mode, x.data_ptr(), w.data_ptr(), scale.data_ptr(),
                                         out.data_ptr(), n, k, group, *plan, stream)
    elif plan is not None:
        err = lib.cambrian_quant_gemv_m8(mode, x.data_ptr(), ldx, w.data_ptr(),
                                         scale.data_ptr(), out.data_ptr(), m, n, k, group,
                                         *plan, stream)
    else:
        err = lib.cambrian_quant_matmul(mode, cuda_build.dtype_code(x), x.data_ptr(), ldx,
                                        w.data_ptr(), scale.data_ptr(), out.data_ptr(),
                                        m, n, k, group, stream)
    cuda_build.check_launch(lib, err, "quant matmul")
    return out


def _int4_shapes(x: torch.Tensor, w_q4: torch.Tensor, scale: torch.Tensor) -> Tuple[int, int, int]:
    k2, n = w_q4.shape
    k = 2 * k2
    if scale.dim() != 2 or scale.shape[1] != n or k % scale.shape[0]:
        raise ValueError(f"scale must be [K/group, {n}] for K={k}, got {tuple(scale.shape)}")
    group = k // scale.shape[0]
    if group != k and group % _KERNEL_TILE_K:
        raise ValueError(f"int4 group {group} must be K or a multiple of {_KERNEL_TILE_K}")
    return k, n, group


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor, *,
                _route=None) -> torch.Tensor:
    """x [M, K] (bf16/fp32) @ dequant(w_q int8 [K, N], scale fp32 [N]) ->
    [M, N] in x.dtype. Kernel K3 on the card. ``_route`` forces a decode
    GEMV (``_gemv_route``), for timing one against the other."""
    if cuda_build.on_cpu(x, "int8_matmul"):
        return int8_matmul_reference(x, w_q, scale)
    k, n = w_q.shape
    if scale.shape != (n,):
        raise ValueError(f"scale must be [{n}], got {tuple(scale.shape)}")
    return _launch(int8_matmul, _MODE_INT8, x, w_q, scale, k, n, 1, _route)


def int4_matmul_scale_on_weights(x: torch.Tensor, w_q4: torch.Tensor,
                                 scale: torch.Tensor, *, _route=None) -> torch.Tensor:
    """The int4 product with the scale applied to the weights in x.dtype
    (kernel K4b/K4c on the card)."""
    if cuda_build.on_cpu(x, "int4_matmul_scale_on_weights"):
        return int4_matmul_reference(x, w_q4, scale, scale_on_weights=True)
    k, n, group = _int4_shapes(x, w_q4, scale)
    return _launch(int4_matmul_scale_on_weights, _MODE_INT4_SCALE_ON_WEIGHTS, x, w_q4, scale,
                   k, n, group, _route)


def _scale_on_weights_selected() -> bool:
    return "1" in (os.environ.get("CAMBRIAN_INT4_V2"), os.environ.get("CAMBRIAN_INT4_V1"))


def int4_matmul(x: torch.Tensor, w_q4: torch.Tensor, scale: torch.Tensor, *,
                _route=None) -> torch.Tensor:
    """x [M, K] (bf16/fp32) @ dequant(w_q4 packed [K/2, N], scale [K/group, N])
    -> [M, N] in x.dtype, with the scale on fp32 partial sums (kernel K4 on
    the card); ``CAMBRIAN_INT4_V2=1`` or ``CAMBRIAN_INT4_V1=1`` selects
    ``int4_matmul_scale_on_weights``. ``_route`` as in ``int8_matmul``."""
    if _scale_on_weights_selected():
        return int4_matmul_scale_on_weights(x, w_q4, scale, _route=_route)
    if cuda_build.on_cpu(x, "int4_matmul"):
        return int4_matmul_reference(x, w_q4, scale)
    k, n, group = _int4_shapes(x, w_q4, scale)
    return _launch(int4_matmul, _MODE_INT4, x, w_q4, scale, k, n, group, _route)


int8_matmul.launches = 0
int4_matmul.launches = 0
int4_matmul_scale_on_weights.launches = 0
int8_matmul.function_launches = {}
int4_matmul.function_launches = {}
int4_matmul_scale_on_weights.function_launches = {}


# -- modules ------------------------------------------------------------------

class _QuantLinearBase(nn.Module):
    """Shared forward of the quantized linears: activations outside
    bf16/fp32 are cast to ``dtype`` (as the JAX modules do), the bias is fp32
    and added in the output dtype."""

    def __init__(self, out_features: int, bias: bool, dtype, device):
        super().__init__()
        self.out_features = out_features
        self.dtype = dtype
        if bias:
            self.bias = nn.Parameter(torch.zeros(out_features, dtype=torch.float32,
                                                 device=device))
        else:
            self.register_parameter("bias", None)

    def _matmul(self, x2: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = x.shape
        x2 = x.reshape(-1, shape[-1])
        if x2.dtype not in (torch.bfloat16, torch.float32):
            x2 = x2.to(self.dtype)
        if x2.stride(-1) != 1:    # the kernels read rows of x with a unit stride
            x2 = x2.contiguous()
        y = self._matmul(x2)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y.reshape(*shape[:-1], self.out_features)


class QuantLinear(_QuantLinearBase):
    """Linear over int8 weights with per-output-channel fp32 scales (the
    ``load_8bit`` path; JAX ``QuantDense``). Buffers: ``kernel_q`` int8
    [K, N], ``scale`` fp32 [N]; optional fp32 ``bias``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype=torch.bfloat16, device=None):
        super().__init__(out_features, bias, dtype, device)
        self.register_buffer("kernel_q", torch.zeros((in_features, out_features),
                                                     dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.ones(out_features, dtype=torch.float32,
                                                 device=device))

    def _matmul(self, x2):
        return int8_matmul(x2, self.kernel_q, self.scale)


class QuantLinear4(_QuantLinearBase):
    """Linear over nibble-packed int4 weights with K-groupwise fp32 scales
    (the ``load_4bit`` path; JAX ``QuantDense4``). Buffers: ``kernel_q4``
    int8 [K/2, N], ``scale`` fp32 [K/group, N]; optional fp32 ``bias``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype=torch.bfloat16, device=None, group: int = INT4_GROUP):
        super().__init__(out_features, bias, dtype, device)
        group = int4_group(in_features, group)
        self.register_buffer("kernel_q4", torch.zeros((in_features // 2, out_features),
                                                      dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.ones((in_features // group, out_features),
                                                 dtype=torch.float32, device=device))

    def _matmul(self, x2):
        return int4_matmul(x2, self.kernel_q4, self.scale)
