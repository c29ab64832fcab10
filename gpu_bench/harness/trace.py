"""The traced run's reduction: device kernels from ``torch.profiler``, each
tied to the benchmark span (``bench.<kind>#<index>``) open on the host when
it was launched, the device's busy time, and the idle gaps by what the host
was doing.

A kernel is tied to its launch through the profiler's correlation: the
CUDA runtime or driver call that launched it (``cudaLaunchKernel``,
``cuLaunchKernelEx``, ...) carries the kernel's own ``correlation_id``, and
the call's start time falls inside the benchmark spans open then. Where no
such call was recorded, the op its ``linked_correlation_id`` names stands in.
The two ids are of different series that overlap as numbers, so each is
looked up among its own kind of host event only. The traced window is the
``bench.trace_window`` span.
"""

import bisect
import re
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

WINDOW = "bench.trace_window"
# a host event that is a call of the CUDA runtime or driver API
API = re.compile(r"^cu(da)?[A-Z]")


def _kind(span_name: str) -> str:
    """``bench.prefill#12`` -> ``prefill``."""
    return span_name.split("#")[0][len("bench."):]


def _short(name: str, width: int = 96) -> str:
    return re.sub(r"\s+", " ", name)[:width]


class Trace:
    def __init__(self, events):
        api_start: Dict[int, int] = {}     # runtime/driver calls by correlation id
        op_span: Dict[int, Tuple[int, int]] = {}   # other host ops by their correlation id
        spans: List[Tuple[str, int, int]] = []
        device: List[Tuple[str, int, int, int, int]] = []
        self.host_ops: List[Tuple[int, int, str]] = []
        for e in events:
            kind = str(e.device_type())
            name = e.name()
            start, dur = e.start_ns(), e.duration_ns()
            if kind.endswith("CPU"):
                if API.match(name):
                    api_start[e.correlation_id()] = start
                else:
                    op_span[e.correlation_id()] = (start, start + dur)
                if name.startswith("bench."):
                    spans.append((name, start, start + dur))
                elif not API.match(name) and dur > 0:
                    self.host_ops.append((start, start + dur, name))
            elif kind.endswith("CUDA") and not name.startswith("bench."):
                # (the device-side ranges of the benchmark's own spans are
                # not work: they span the kernels launched inside them)
                device.append((name, start, dur, e.correlation_id(), e.linked_correlation_id()))
        windows = [s for s in spans if s[0] == WINDOW]
        if windows:
            self.start, self.end = windows[0][1], windows[-1][2]
        elif spans:
            self.start, self.end = min(s[1] for s in spans), max(s[2] for s in spans)
        else:
            self.start = self.end = 0
        self.spans = sorted((s for s in spans if s[0] != WINDOW), key=lambda s: s[1])
        self.host_ops.sort()
        # spans of one kind never nest, so each kind's are searched by start
        self._kinds: Dict[str, Tuple[List[int], List[Tuple[str, int, int]]]] = {}
        for span in self.spans:
            starts, members = self._kinds.setdefault(_kind(span[0]), ([], []))
            starts.append(span[1])
            members.append(span)
        self.device = []      # (name, start, dur, launch time or None)
        # kernels whose launch call lies outside the op they are linked to:
        # a check of the reading, printed with the run's trace summary
        self.outside = 0
        for name, start, dur, corr, linked in device:
            if start + dur <= self.start or start >= self.end:
                continue
            launch, op = api_start.get(corr), op_span.get(linked)
            if launch is not None and op is not None and not op[0] <= launch <= op[1]:
                self.outside += 1
            self.device.append((name, start, dur, op[0] if launch is None and op else launch))
        self.device.sort(key=lambda d: d[1])
        self.unlinked = sum(1 for d in self.device if d[3] is None)

    # -- spans ---------------------------------------------------------------

    def spans_of(self, kind: str) -> List[Tuple[str, int, int]]:
        """Spans ``bench.<kind>#...`` (or ``bench.<kind>``), in start order."""
        return list(self._kinds.get(kind, ([], []))[1])

    @staticmethod
    def index(span_name: str) -> Optional[int]:
        _, _, tail = span_name.partition("#")
        return int(tail) if tail.isdigit() else None

    def innermost(self, t: int, kinds=None) -> Optional[str]:
        """The innermost benchmark span (of one of ``kinds``) open at host
        time ``t``."""
        best = None
        for kind in (kinds if kinds is not None else self._kinds):
            if kind not in self._kinds:
                continue
            starts, members = self._kinds[kind]
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and members[i][1] <= t < members[i][2]:
                if best is None or members[i][1] > best[1]:
                    best = members[i]
        return best[0] if best else None

    def kernels_under(self, kinds, pattern: Optional[str] = None) -> Dict[str, List[Tuple[str, int]]]:
        """{span name: [(kernel name, ns)]} of the kernels launched inside a
        span of one of ``kinds`` (the innermost such span), optionally only
        kernels whose name matches ``pattern``."""
        rx = re.compile(pattern) if pattern else None
        out: Dict[str, List[Tuple[str, int]]] = defaultdict(list)
        for name, _, dur, launch in self.device:
            if launch is None or (rx and not rx.search(name)):
                continue
            span = self.innermost(launch, kinds)
            if span is not None:
                out[span].append((name, dur))
        return dict(out)

    # -- the device --------------------------------------------------------------

    def _busy_intervals(self) -> List[Tuple[int, int]]:
        merged: List[List[int]] = []
        for _, start, dur, _ in self.device:
            s, e = max(start, self.start), min(start + dur, self.end)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def window_ns(self) -> int:
        return self.end - self.start

    @property
    def busy_ns(self) -> int:
        return sum(e - s for s, e in self._busy_intervals())

    def top_ops(self, n: int = 10) -> List[List]:
        total: Dict[str, int] = defaultdict(int)
        for name, _, dur, _ in self.device:
            total[_short(name)] += dur
        top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v / 1e9] for k, v in top]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The idle time of the window by what the host was doing when the
        gap began: the innermost benchmark span and the host op running."""
        starts = [op[0] for op in self.host_ops]
        by: Dict[str, int] = defaultdict(int)
        edges = [self.start] + [t for iv in self._busy_intervals() for t in iv] + [self.end]
        for s, e in zip(edges[0::2], edges[1::2]):
            if e <= s:
                continue
            span = self.innermost(s) or "no_span"
            i = bisect.bisect_right(starts, s) - 1
            op = "no_host_op"
            for j in range(i, max(-1, i - 64), -1):
                if self.host_ops[j][0] <= s < self.host_ops[j][1]:
                    op = self.host_ops[j][2]
                    break
            by[f"{span.split('#')[0]}:{_short(op, 48)}"] += e - s
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v / 1e9] for k, v in top]


def read(prof) -> Trace:
    return Trace(prof.profiler.kineto_results.events())
