"""Work of single kernels: (operations, bytes) of one call."""

from typing import Sequence, Tuple

BF16 = 2
FP32 = 4


def causal_pairs(lengths: Sequence[int]) -> int:
    """(query, key) pairs a causal attention needs over sequences of these
    valid lengths."""
    return sum(n * (n + 1) // 2 for n in lengths)


def attention_fwd(pairs: int, heads: int, head_dim: int, q_rows: int, kv_rows: int,
                  kv_heads: int, elem: int = BF16) -> Tuple[float, float]:
    """Flash-attention forward (K1): QK^T and PV over ``pairs`` (query, key)
    pairs a head; reads q [q_rows, heads, D], k and v [kv_rows, kv_heads, D]
    once, writes o like q and the fp32 row statistic."""
    ops = 4.0 * pairs * heads * head_dim
    io = (2 * q_rows * heads * head_dim + 2 * kv_rows * kv_heads * head_dim) * elem \
        + q_rows * heads * FP32
    return ops, float(io)


def attention_bwd(pairs: int, heads: int, head_dim: int, rows: int, kv_heads: int,
                  elem: int = BF16) -> Tuple[float, float]:
    """Flash-attention backward (K2): the five products (QK^T again, dV, dP,
    dQ, dK) over the pairs; reads q, k, v, o, dO and the row statistic once,
    writes dq, dk and dv once."""
    ops = 10.0 * pairs * heads * head_dim
    q_like = rows * heads * head_dim * elem
    kv_like = rows * kv_heads * head_dim * elem
    io = 3 * q_like + 2 * kv_like + rows * heads * FP32 + q_like + 2 * kv_like
    return ops, float(io)


def quant_gemv(m: int, k: int, n: int, weight_bits: int = 8, group: int = 0,
               elem: int = BF16) -> Tuple[float, float]:
    """A weight-only quantized product x [m, k] @ W [k, n] (K3 at 8 bits, K4
    at 4): the packed weights, their fp32 scales (one a column, or one a
    column a group of ``group`` rows), x and the output, once each."""
    ops = 2.0 * m * k * n
    scales = n * (k // group if group else 1) * FP32
    io = k * n * weight_bits // 8 + scales + m * k * elem + m * n * elem
    return ops, float(io)


def roofline_seconds(ops: float, io: float, peak_ops: float, peak_bytes: float) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(ops / peak_ops, io / peak_bytes)
