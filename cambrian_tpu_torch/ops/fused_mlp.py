"""Fused two-layer GELU MLP, out = gelu(x @ W1 + b1) @ W2 + b2
(cambrian_tpu/ops/fused_mlp.py): kernel K8 of the port.

``fused_mlp`` launches the hand-written CUDA kernels of ``csrc/fused_mlp.cu``
for CUDA tensors; they replace the TPU kernel ``_fused_mlp_kernel``. The TPU
kernel keeps the [M, H] hidden on chip; no store on a Hopper SM holds a
useful slab of it, but the 50 MB L2 does. So bf16 operands that TMA can
address take two wgmma GEMMs, *up* (x @ W1 + b1, GELU, rounded to bf16) and
*down* (h @ W2 + b2), over chunks of M whose bf16 hidden fits
``HIDDEN_CHUNK_BYTES``: the hidden passes through one scratch of that size,
allocated here and reused for every chunk, so that it stays in L2 between
the two launches. ``_plan`` picks the route, the chunk and the output tiles'
widths. Other bf16 operands take the first port's ``mma.sync`` kernel,
which recomputes the hidden per block; fp32 takes its SIMT version. CPU
tensors take the plain version, ``fused_mlp_reference``, which follows the
TPU kernel's roundings rather than the JAX off-TPU fallback's. The JAX
function has no ``custom_vjp`` and the kernels have no backward: on the
card, an input that requires grad while grad is enabled raises. The port's
ConvNeXt and SVA keep their ``nn.Linear`` pairs; nothing on their path calls
this kernel. Nothing is compiled or loaded at import time.
"""

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence

import torch

from . import cuda_build

# The bf16 hidden of one chunk of rows, meant to stay in the H100's 50 MB L2
# between the up and the down GEMM. Chosen on the card from 16-40 MiB with
# scripts/fused_mlp_sweep.py: less splits the ConvNeXt stage-3/4 sites into
# more, narrower launches; more gains nothing.
HIDDEN_CHUNK_BYTES = 24 << 20
TILE_ROWS = 128                   # rows of a wgmma output tile
TILE_COLS = (256, 192, 128, 64)   # the output tile widths the kernels are built for
H100_SMS = 132


class Plan(NamedTuple):
    """How ``fused_mlp`` runs one call on the card. ``route``: "wgmma" (the
    up/down GEMMs), "mma_sync" (bf16 operands TMA cannot address) or "simt"
    (fp32). For "wgmma": ``chunk_rows`` rows of x per up/down pair (all of M,
    or a multiple of TILE_ROWS), ``chunks`` pairs, and the up and down output
    tiles' widths."""
    route: str
    chunk_rows: int
    chunks: int
    bn_up: int
    bn_down: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _tile_cols(m: int, n: int, sms: int) -> int:
    """The output tile width whose waves cost least: with one 128 x BN tile
    an SM at a time, ceil(tiles / sms) waves of BN columns each; ties go to
    the wider tile (fewer loads of A a column)."""
    tiles = {bn: _cdiv(m, TILE_ROWS) * _cdiv(n, bn) for bn in TILE_COLS}
    return min(TILE_COLS, key=lambda bn: (_cdiv(tiles[bn], sms) * bn, -bn))


def _plan(m: int, c: int, h: int, c2: int, ldx: int, ptrs: Sequence[int] = (0, 0, 0),
          dtype: torch.dtype = torch.bfloat16, sms: int = H100_SMS,
          budget: int = HIDDEN_CHUNK_BYTES) -> Plan:
    """The route, chunking and tiles of a call with x [m, c] (row stride
    ldx, at ptrs[0]), W1^T [h, c] and W2^T [c2, h] (at ptrs[1], ptrs[2]):
    fp32 takes the SIMT kernel and bf16 operands TMA cannot address the
    mma.sync kernel, each in one launch. TMA needs 16-byte rows and bases:
    C, H, C2 and ldx multiples of 8 bf16, and x, W1^T and W2^T 16-byte
    aligned. Otherwise the chunk is all of m if its bf16 hidden fits
    ``budget``, else the fewest chunks of at most budget / (2 h) rows,
    balanced and rounded up to TILE_ROWS."""
    if dtype == torch.float32:
        return Plan("simt", m, 1, 0, 0)
    if any(n % 8 for n in (c, h, c2, ldx)) or any(p % 16 for p in ptrs):
        return Plan("mma_sync", m, 1, 0, 0)
    if m * h * 2 <= budget:
        rows = m
    else:
        most = max(TILE_ROWS, budget // (2 * h) // TILE_ROWS * TILE_ROWS)
        rows = _cdiv(_cdiv(m, _cdiv(m, most)), TILE_ROWS) * TILE_ROWS
    return Plan("wgmma", rows, _cdiv(m, rows), _tile_cols(rows, h, sms), _tile_cols(rows, c2, sms))


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
                              + [i32] * 4 + [ptr],
        "cambrian_fused_mlp_wgmma": [ptr, ctypes.c_int64, ptr, ptr, ptr, ptr, ptr, ptr]
                                    + [i32] * 7 + [ptr]})


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
    ldx = x.stride(0) if m > 1 else c
    plan = _plan(m, c, hdim, c2, ldx, (x.data_ptr(), w1t.data_ptr(), w2t.data_ptr()), x.dtype,
                 torch.cuda.get_device_properties(x.device).multi_processor_count)
    b1p, b2p = (None if b is None else b.data_ptr() for b in biases)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = _library()
    fused_mlp.launches += 1
    if plan.route == "wgmma":
        hidden = torch.empty((plan.chunk_rows, hdim), dtype=x.dtype, device=x.device)
        err = lib.cambrian_fused_mlp_wgmma(
            x.data_ptr(), ldx, w1t.data_ptr(), b1p, w2t.data_ptr(), b2p, out.data_ptr(),
            hidden.data_ptr(), m, c, hdim, c2, plan.chunk_rows, plan.bn_up, plan.bn_down, stream)
    else:
        err = lib.cambrian_fused_mlp(
            cuda_build.dtype_code(x), x.data_ptr(), ldx, w1t.data_ptr(), b1p, w2t.data_ptr(),
            b2p, out.data_ptr(), m, c, hdim, c2, stream)
    cuda_build.check_launch(lib, err, "fused_mlp")
    return out


fused_mlp.launches = 0
