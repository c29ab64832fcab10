"""The port's ``profiling.py`` (``torch.profiler``) against the JAX
package's on the CPU: ``PhaseTimer`` gives the same summaries and report
over the same phases on the same clock; ``trace`` with ``annotate`` spans
writes a TensorBoard-readable trace naming the spans; ``start_server``,
which has no ``torch.profiler`` counterpart, raises."""

import glob
import json
import os
import time

import pytest
import torch

from cambrian_tpu import profiling as jprofiling
from cambrian_tpu_torch import profiling


def _phases(timer):
    for name in ("preprocess", "tower", "tower", "sva", "decode", "tower", "decode"):
        with timer.phase(name):
            pass
    with pytest.raises(RuntimeError):
        with timer.phase("optimizer"):      # a phase that raises still counts
            raise RuntimeError("step failed")


def test_phase_timer_matches_jax(monkeypatch):
    summaries = []
    for timer in (jprofiling.PhaseTimer(), profiling.PhaseTimer()):
        ticks = iter(0.0123 * k * k for k in range(100))
        monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
        _phases(timer)
        summaries.append((timer.summary(), timer.report()))
        timer.reset()
        assert timer.summary() == {} and timer.report() == "{}"
    assert summaries[1] == summaries[0]
    assert summaries[1][0]["tower"]["count"] == 3 and summaries[1][0]["optimizer"]["count"] == 1
    assert json.loads(summaries[1][1]) == summaries[1][0]


def test_trace_writes_spans(tmp_path):
    logdir = str(tmp_path / "trace")
    with profiling.trace(logdir):
        with profiling.annotate("eval_encode"):
            x = torch.ones((32, 32)) @ torch.ones((32, 32))
        with profiling.annotate("eval_generate"):
            (x @ x).sum()
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"eval_encode", "eval_generate", "aten::mm"} <= names


def test_start_server_is_not_available():
    with pytest.raises(NotImplementedError, match="profiling.trace"):
        profiling.start_server(9999)
