"""Tracing / profiling (cambrian_tpu/profiling.py) on ``torch.profiler``.

- :func:`trace` — context manager around ``torch.profiler.profile`` (the
  host's activity, and the card's where the build has CUDA) writing a
  TensorBoard-readable trace into ``log_dir``.
- :func:`annotate` — ``torch.profiler.record_function``, so that a phase
  shows up as a named span on the trace's timeline.
- :class:`PhaseTimer` — wall-clock accounting of the pipeline phases
  (preprocess / tower encode / SVA / decode / optimizer).
- :func:`start_server` — the JAX package's on-demand profiling endpoint
  has no counterpart here: it raises ``NotImplementedError``.
"""

import contextlib
import json
import time
from collections import defaultdict
from typing import Dict


def start_server(port: int = 9999):
    raise NotImplementedError(
        "start_server: torch.profiler has no on-demand profiling server "
        "(jax.profiler.start_server's counterpart needs a profiling daemon); "
        "wrap the work to profile in profiling.trace(log_dir) instead")


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the body (CPU, and CUDA where available) and write its trace
    (``*.pt.trace.json``) into ``log_dir`` when the body ends."""
    from torch.profiler import (
        ProfilerActivity,
        profile,
        supported_activities,
        tensorboard_trace_handler,
    )

    activities = [a for a in (ProfilerActivity.CPU, ProfilerActivity.CUDA)
                  if a in supported_activities()]
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


@contextlib.contextmanager
def annotate(name: str):
    from torch.profiler import record_function

    with record_function(name):
        yield


class PhaseTimer:
    """Accumulates wall-clock per named phase; blocking is the caller's job
    (on the card, ``torch.cuda.synchronize()`` before a phase ends)."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - start
            self.counts[name] += 1

    def summary(self) -> Dict[str, dict]:
        return {
            name: {
                "total_s": round(self.totals[name], 4),
                "count": self.counts[name],
                "mean_ms": round(1000 * self.totals[name] / max(self.counts[name], 1), 3),
            }
            for name in sorted(self.totals)
        }

    def report(self) -> str:
        return json.dumps(self.summary(), indent=2)

    def reset(self):
        self.totals.clear()
        self.counts.clear()
