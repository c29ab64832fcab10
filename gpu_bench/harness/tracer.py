"""``torch.profiler`` over a fixed stretch of the window (``--trace 1``),
and the per-layer metrics read from it by the readers in
``gpu_bench/metrics/<metric name>.py``."""

import importlib.util
import time
from types import SimpleNamespace
from typing import Dict, Optional

import torch

from . import common
from . import trace as trace_mod

METRICS = common.BENCH / "metrics"


class Tracer:
    """``step(i)`` before the i-th unit of the window (a chunk or a step)
    starts the profiler at the first call and stops it at ``limit`` units,
    or at ``step(None)``. Off, it does nothing. Stopping the profiler costs
    host time in the window (``stall`` seconds): a driver whose window is
    counted in time moves its clock by it, so that a traced run does the
    same work as an untraced one. ``finish()`` reduces the trace once the
    window has closed."""

    def __init__(self, enabled: bool, limit: Optional[int] = None):
        self.enabled, self.limit = enabled, limit
        self.prof = self._span = None
        self.stopped = False
        self.stall = 0.0
        self.trace: Optional[trace_mod.Trace] = None

    def step(self, i: Optional[int]) -> None:
        if not self.enabled or self.stopped:
            return
        if self.prof is None:
            if i is None:
                return
            from torch.profiler import ProfilerActivity, profile, record_function

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.__enter__()
            self._span = record_function(trace_mod.WINDOW)
            self._span.__enter__()
            return
        if i is None or (self.limit is not None and i >= self.limit):
            t0 = time.perf_counter()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self._span.__exit__(None, None, None)
            self.prof.__exit__(None, None, None)
            self.stopped = True
            self.stall = time.perf_counter() - t0

    def finish(self) -> Optional[trace_mod.Trace]:
        if self.prof is not None and self.stopped and self.trace is None:
            self.trace = trace_mod.read(self.prof)
            self.prof = None
        return self.trace


def _reader(name: str):
    path = METRICS / f"{name}.py"
    module = "gpu_bench_metric_" + "".join(c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def per_layer(entries, tr: trace_mod.Trace, log: Dict, cfg_file: Dict, traffic: Dict) -> Dict:
    """Each per-layer metric its reader finds something for, by name; a
    reader that finds nothing returns None and the metric is left out."""
    ctx = SimpleNamespace(trace=tr, log=log, cfg=cfg_file, traffic=traffic, peaks=common.PEAKS)
    out = {}
    for m in entries:
        value = _reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def device_fields(tr: trace_mod.Trace) -> Dict:
    return {"busy_s": tr.busy_ns / 1e9, "window_s": tr.window_ns / 1e9}


def breakdown(tr: trace_mod.Trace) -> Dict:
    return {"device_ops": tr.top_ops(10), "idle_gaps": tr.idle_gaps(10)}
