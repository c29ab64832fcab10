"""The numbers that decide ``correct``, each beside its limit."""

import statistics
from typing import Dict, Iterable, Optional, Tuple

import torch


def check(value: float, limit: float) -> Dict:
    return {"value": float(value), "limit": float(limit), "ok": bool(value <= limit)}


def leaf_gap(program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor],
             names: Iterable[str]) -> Tuple[float, Optional[str]]:
    """The worst leaf's gap between the program's norm and the reference's,
    over the reference's norm of that leaf or of the median leaf, whichever
    is larger."""
    names = list(names)
    ref = {n: float(reference[n].double().norm()) for n in names}
    prog = {n: float(program[n].double().norm()) for n in names}
    median = statistics.median(ref.values())
    worst, at = 0.0, None
    for n in names:
        gap = abs(prog[n] - ref[n]) / max(ref[n], median, 1e-30)
        if gap > worst:
            worst, at = gap, n
    return worst, at


def moving_leaves(ref_grads: Dict[str, torch.Tensor], share: float = 1e-3):
    """The leaves whose first reference gradient is at least ``share`` of
    the median leaf's: the others are nought to rounding and move under
    Adam by round-off alone."""
    norms = {n: float(g.double().norm()) for n, g in ref_grads.items()}
    median = statistics.median(norms.values())
    return sorted(n for n, v in norms.items() if v >= share * median)
