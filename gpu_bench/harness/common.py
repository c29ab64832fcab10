"""What every cell's run shares: the cell's files, the build and kernel
caches at fixed paths inside the checkout, the card, the check that nothing
of JAX was loaded, and the result line."""

import json
import os
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "cambrian_tpu")
PEAKS = json.loads((BENCH / "peaks.json").read_text())


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout, so
    that only a checkout's first run builds or compiles. The program builds
    its CUDA libraries under ``build/cambrian_tpu_torch`` itself."""
    cache = ROOT / "build" / "gpu_bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(cache / sub)
    # a library that would load JAX by itself (transformers) is kept from it
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_cell(name: str, bench_file: Optional[Path] = None,
              data_dir: Optional[Path] = None) -> Dict:
    """The cell's entry, configuration, traffic mix and limits, by the names
    in BENCHMARK.json (``data_dir``: where the traffic and limits files are,
    ``gpu_bench`` by default)."""
    bench = json.loads(Path(bench_file or ROOT / "BENCHMARK.json").read_text())
    data = Path(data_dir or BENCH)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[cell["config"]]
    return {
        "cell": cell,
        "config": json.loads((ROOT / entry["file"]).read_text()),
        "traffic": json.loads((data / "traffic" / f"{cell['traffic']}.json").read_text()),
        "limits": json.loads((data / "limits" / f"{name}.json").read_text()),
        "end_to_end": [m for m in bench["end_to_end"]
                       if name in m.get("workloads", [name])],
        "per_layer": [m for m in bench["per_layer"] if name in m.get("workloads", [name])],
    }


def require_cards(count: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the benchmark measures the card and prints no result")
    if torch.cuda.device_count() < count:
        raise SystemExit(f"the cell needs {count} cards, {torch.cuda.device_count()} present")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def forbidden_modules() -> List[str]:
    """Modules loaded in this process whose top-level name is JAX's, its
    libraries' or the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def emit(correct: bool, attempted: int, failed: int, metrics: Dict[str, Dict], device: Dict,
         checks: Dict[str, Dict], breakdown: Optional[Dict] = None) -> None:
    """The compared numbers beside their limits as the last lines of
    standard error, then the result as the last line of standard output,
    the checks under the last key."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr, flush=True)
    line = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
            "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {k: {"value": v["value"], "limit": v["limit"]} for k, v in checks.items()}
    sys.stdout.flush()
    print(json.dumps(line), flush=True)
