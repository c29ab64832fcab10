"""Benchmark scoring — the shared ``*_test.py`` (reference
eval/eval/mmmu/mmmu_test.py:10-19,53+): parse an answers JSONL, compute the
benchmark's metrics, append one row to a shared experiments CSV keyed on
(model_id, time) for tabulate.py to pivot.
"""

import argparse
import csv
import json
import os
import time
from typing import Dict, List, Optional

from .base import BENCHMARKS

CSV_FIELDS = ["model_id", "benchmark", "time", "metric", "value", "notes"]


def load_answers(answers_file: str) -> List[dict]:
    rows = []
    with open(answers_file) as f:
        for line in f:
            if line.strip():
                rows.append(json.loads(line))
    return rows


def score_answers(benchmark_name: str, answers_file: str) -> Dict[str, float]:
    benchmark = BENCHMARKS[benchmark_name]
    return benchmark.score(load_answers(answers_file))


def write_submission(benchmark_name: str, answers_file: str, model_id: str,
                     submission_dir: Optional[str] = None) -> Optional[str]:
    """Emit the benchmark's official external-grader artifact (e.g.
    ``{model}_mmvet_submission.json`` for the MM-Vet GPT-4 portal — reference
    eval/eval/mmvet/mmvet_test.py:35-38). Returns the path, or None when the
    benchmark has no submission format."""
    benchmark = BENCHMARKS[benchmark_name]
    if benchmark.submission is None:
        return None
    obj = benchmark.submission(load_answers(answers_file))
    out_dir = submission_dir or os.path.dirname(os.path.abspath(answers_file))
    os.makedirs(out_dir, exist_ok=True)
    safe_model = model_id.replace("/", "_")
    path = os.path.join(out_dir,
                        f"{safe_model}_{benchmark_name}_submission.json")
    with open(path, "w") as f:
        json.dump(obj, f, indent=2)
    return path


def append_experiment_row(csv_file: str, model_id: str, benchmark_name: str,
                          metrics: Dict[str, float], timestamp: Optional[str] = None):
    benchmark = BENCHMARKS[benchmark_name]
    timestamp = timestamp or time.strftime("%Y-%m-%d %H:%M:%S")
    exists = os.path.exists(csv_file)
    os.makedirs(os.path.dirname(os.path.abspath(csv_file)), exist_ok=True)
    with open(csv_file, "a", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=CSV_FIELDS)
        if not exists:
            writer.writeheader()
        for metric, value in metrics.items():
            writer.writerow({
                "model_id": model_id, "benchmark": benchmark_name,
                "time": timestamp, "metric": metric,
                "value": round(float(value), 6), "notes": benchmark.notes,
            })


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--benchmark", required=True, choices=sorted(BENCHMARKS))
    parser.add_argument("--answers_file", required=True)
    parser.add_argument("--model_id", required=True)
    parser.add_argument("--experiment_csv", default="experiments.csv")
    parser.add_argument("--submission_dir", default=None,
                        help="where official grader artifacts land "
                             "(default: next to the answers file)")
    args = parser.parse_args()

    metrics = score_answers(args.benchmark, args.answers_file)
    append_experiment_row(args.experiment_csv, args.model_id, args.benchmark,
                          metrics)
    sub = write_submission(args.benchmark, args.answers_file, args.model_id,
                           args.submission_dir)
    if sub:
        print(json.dumps({"submission_file": sub}))
    print(json.dumps({"benchmark": args.benchmark, **metrics}))


if __name__ == "__main__":
    main()
