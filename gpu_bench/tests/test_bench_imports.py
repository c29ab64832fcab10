"""What a run loads: nothing of JAX or of the JAX package (top-level names
compared whole: the port's name begins with the JAX package's), and a
reference that takes nothing of the program."""

import ast
import subprocess
import sys

from conftest import DATA, ROOT

REFERENCE = ROOT / "gpu_bench" / "reference"
FORBIDDEN = {"jax", "jaxlib", "flax", "cambrian_tpu"}


def _top_level_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_a_run_loads_no_jax():
    """A whole tiny run of each kind in a fresh process, then its modules."""
    code = f"""
import sys, json
sys.path.insert(0, {str(ROOT)!r})
from gpu_bench import run
for cell in ("tiny-batch", "tiny-train"):
    run.main(["--workload", cell, "--seed", "9", "--seconds", "0.5", "--trace", "1"],
             bench_file={str(DATA / 'bench.json')!r}, data_dir={str(DATA)!r}, device="cpu")
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    loaded = set(__import__("json").loads(proc.stdout.strip().splitlines()[-1]))
    assert "cambrian_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    for path in REFERENCE.glob("*.py"):
        names = set(_top_level_imports(path))
        assert not names & (FORBIDDEN | {"cambrian_tpu_torch", "gpu_bench"}), path
    code = f"""
import sys, json
sys.path.insert(0, {str(ROOT)!r})
import gpu_bench.reference.cambrian, gpu_bench.reference.serve, gpu_bench.reference.train
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    loaded = set(__import__("json").loads(proc.stdout.strip().splitlines()[-1]))
    assert not loaded & (FORBIDDEN | {"cambrian_tpu_torch"})


def test_the_harness_reads_no_old_benchmark():
    """The benchmark neither imports nor reads the JAX package's benchmark
    scripts and records."""
    old = ("bench.py", "bench_decode.py", "scripts/bench", "BASELINE.json", "BENCH_r0",
           "MULTICHIP_r0", "PERF_NOTES")
    for path in (ROOT / "gpu_bench").rglob("*.py"):
        if "tests" in path.parts:
            continue
        text = path.read_text()
        assert not any(o in text for o in old), path
