"""Shared helpers of the benchmark's CPU tests: the tiny cells of
``tests/data/bench.json`` run through the whole harness on the CPU."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def run_tiny(capsys):
    """Run a tiny cell on the CPU; returns (result line, standard error)."""
    from gpu_bench import run

    def go(*argv):
        run.main(list(argv), bench_file=DATA / "bench.json", data_dir=DATA, device="cpu")
        out, err = capsys.readouterr()
        return json.loads(out.strip().splitlines()[-1]), err

    return go
