"""What the per-layer metric readers share: device time under spans, the
work of the spans in the traced window, and shares of peaks. A reader that
finds nothing to read returns None."""

from typing import Iterable, Optional

from ..work import kernels, model


def device_ms_per_span(ctx, kind: str, pattern: Optional[str] = None) -> Optional[float]:
    """Mean device ms of the kernels launched under each ``kind`` span that
    launched any."""
    per = ctx.trace.kernels_under([kind], pattern)
    if not per:
        return None
    return sum(d for ks in per.values() for _, d in ks) / len(per) / 1e6


def idle_share(ctx) -> Optional[float]:
    if ctx.trace.window_ns <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_ns / ctx.trace.window_ns)


def _logged(ctx, kind: str):
    for name, _, _ in ctx.trace.spans_of(kind):
        n = ctx.trace.index(name)
        if n is not None and n in ctx.log.get(kind, {}):
            yield ctx.log[kind][n]


def serving_flops(ctx) -> float:
    """Model FLOPs of the serving work in the traced window: each encode,
    each prefill (its last slot's logits), each decode token of an active
    slot at its cache depth."""
    cfg = ctx.cfg
    total = sum(model.towers(cfg, w["images"]) for w in _logged(ctx, "encode"))
    total += sum(model.prefill(cfg, w["slots"]) for w in _logged(ctx, "prefill"))
    for w in _logged(ctx, "decode_chunk"):
        for depth, due in w["slots"]:
            total += sum(model.decode_token(cfg, depth + j) for j in range(due))
    return total


def train_flops(ctx) -> float:
    cfg = ctx.cfg
    return sum(model.train_batch(cfg, w["lengths"], w["labelled"])
               for w in _logged(ctx, "train_step"))


def mfu(ctx, flops: float) -> Optional[float]:
    if flops <= 0 or ctx.trace.window_ns <= 0:
        return None
    return 100.0 * flops / (ctx.trace.window_ns / 1e9 * ctx.peaks["bf16_flops"])


def roofline(ctx, kinds: Iterable[str], pattern: str, bound_of) -> Optional[float]:
    """100 x the least time the work of each span could take (``bound_of``
    its logged work, seconds) over the device time of the kernels matching
    ``pattern`` launched under it, summed over the spans that launched
    any."""
    kinds = list(kinds)
    per = ctx.trace.kernels_under(kinds, pattern)
    if not per:
        return None
    spent = bound = 0.0
    for span, ks in per.items():
        kind = span.split("#")[0][len("bench."):]
        n = ctx.trace.index(span)
        work = ctx.log.get(kind, {}).get(n)
        if work is None:
            continue
        bound += bound_of(kind, work)
        spent += sum(d for _, d in ks) / 1e9
    return 100.0 * bound / spent if spent > 0 else None


def seconds(ctx, ops: float, io: float) -> float:
    return kernels.roofline_seconds(ops, io, ctx.peaks["bf16_flops"], ctx.peaks["hbm_bytes_per_s"])
