"""The result line a run prints last, with the keys a result carries, for each
kind of cell (the tiny cells on the CPU), and the refusal to run without a
card."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell", ["tiny-batch", "tiny-train"])
@pytest.mark.parametrize("trace", ["0", "1"])
def test_last_line_has_the_result_keys(run_tiny, cell, trace):
    line, err = run_tiny("--workload", cell, "--seed", "2147483711", "--seconds", "1",
                         "--trace", trace)
    assert list(line)[:5] == KEYS
    assert list(line)[-1] == "checks"
    assert line["correct"] is True
    assert line["attempted"] > 0 and line["failed"] == 0
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace == "1":
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(k.endswith((".batch", ".train")) for k in line["metrics"])
    else:
        assert "setup_s" in line["metrics"]
        assert len(line["metrics"]) == 2
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    # the compared numbers, each beside its limit, last on standard error too
    tail = [ln for ln in err.strip().splitlines() if ln.startswith("check ")]
    assert len(tail) == len(line["checks"])
    assert err.strip().splitlines()[-1].startswith("check ")


def test_no_card_no_result():
    """Without a card the run exits non-zero and prints no result line."""
    env_code = ("import sys; sys.argv = ['run.py', '--workload', 'c34b-int8-batch', '--seed', "
                "'1', '--seconds', '1', '--trace', '0']; import runpy; "
                "runpy.run_path('gpu_bench/run.py', run_name='__main__')")
    proc = subprocess.run([sys.executable, "-c", env_code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300, env={"CUDA_VISIBLE_DEVICES": "",
                                                       "PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0
    assert not any(line.startswith("{") for line in proc.stdout.splitlines())


def test_benchmark_file_names_and_units():
    import re

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    metrics = bench["end_to_end"] + bench["per_layer"]
    for m in metrics:
        assert name.match(m["name"]) and unit.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    cells = {w["name"]: w for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert (ROOT / "gpu_bench" / "metrics" / f"{m['name']}.py").exists()
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", cells)
    for w in cells.values():
        assert w["chips"] == 1
        assert (ROOT / "gpu_bench" / "traffic" / f"{w['traffic']}.json").exists()
        assert (ROOT / "gpu_bench" / "limits" / f"{w['name']}.json").exists()
