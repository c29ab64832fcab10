"""Result tabulation — reference eval/scripts/tabulate.py:14-60: merge
experiment CSVs into a long table plus a model x benchmark pivot on each
benchmark's primary metric, in the published benchmark order.
"""

import argparse
import csv
import glob
import os
from collections import defaultdict
from typing import Dict, List

from .base import BENCHMARKS

# fixed column order (reference tabulate.py:14-33)
BENCHMARK_ORDER = [
    "mme", "gqa", "scienceqa", "textvqa", "pope", "mmbench_en", "mmbench_cn",
    "seed", "mmvet", "mmmu", "mathvista", "ai2d", "chartqa", "docvqa",
    "infovqa", "stvqa", "ocrbench", "mmstar", "realworldqa", "synthdog",
    "qbench", "blink", "mmvp", "vstar", "vizwiz", "ade", "coco", "omni",
]


def read_rows(csv_files: List[str]) -> List[dict]:
    rows = []
    for path in csv_files:
        with open(path) as f:
            rows.extend(csv.DictReader(f))
    return rows


def pivot(rows: List[dict]) -> Dict[str, Dict[str, float]]:
    """model_id -> benchmark -> primary-metric value (latest run wins)."""
    table: Dict[str, Dict[str, float]] = defaultdict(dict)
    for row in sorted(rows, key=lambda r: r.get("time", "")):
        bench = row["benchmark"]
        primary = BENCHMARKS[bench].primary_metric if bench in BENCHMARKS \
            else "accuracy"
        if row["metric"] == primary:
            table[row["model_id"]][bench] = float(row["value"])
    return table


def write_pivot(table: Dict[str, Dict[str, float]], out_csv: str):
    benches = [b for b in BENCHMARK_ORDER if any(b in v for v in table.values())]
    extra = sorted({b for v in table.values() for b in v} - set(benches))
    cols = benches + extra
    with open(out_csv, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["model_id"] + cols)
        for model_id in sorted(table):
            writer.writerow(
                [model_id] + [table[model_id].get(b, "") for b in cols]
            )


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--experiment_csv", nargs="+", default=["experiments.csv"])
    parser.add_argument("--out_long", default="all_experiments.csv")
    parser.add_argument("--out_pivot", default="experiments_pivot.csv")
    args = parser.parse_args()

    files = []
    for pattern in args.experiment_csv:
        files.extend(glob.glob(pattern))
    rows = read_rows(files)

    with open(args.out_long, "w", newline="") as f:
        if rows:
            writer = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            writer.writeheader()
            writer.writerows(rows)

    write_pivot(pivot(rows), args.out_pivot)
    print(f"wrote {args.out_long} and {args.out_pivot} ({len(rows)} rows)")


if __name__ == "__main__":
    main()
