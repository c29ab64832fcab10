"""The port's eval harness (``cambrian_tpu_torch/eval``) against the JAX
package's, on the CPU: the benchmark registry, every fixture record's
prompt, every scorer's metrics on right, wrong and messy predictions, the
files ``write_submission``, ``append_experiment_row`` and ``write_pivot``
write (and those of the two CLIs), byte for byte; ``run_benchmark`` end to
end on a tiny checkpoint in fp32, whose greedy answers file must equal the
JAX runner's byte for byte; and one run of
``python -m cambrian_tpu_torch.eval.runner --device cpu`` (through
``runpy``)."""

import json
import os
import runpy
import sys
import time
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(__file__))
from util import make_tiny_checkpoint  # noqa: E402

from cambrian_tpu.eval import BENCHMARKS as JBENCHMARKS  # noqa: E402
from cambrian_tpu.eval import runner as jrunner  # noqa: E402
from cambrian_tpu.eval import score as jscore  # noqa: E402
from cambrian_tpu.eval import tabulate as jtabulate  # noqa: E402
from cambrian_tpu.models import builder as jbuilder  # noqa: E402
from cambrian_tpu_torch.checkpoint.from_jax import state_dict_from_jax  # noqa: E402
from cambrian_tpu_torch.eval import BENCHMARKS  # noqa: E402
from cambrian_tpu_torch.eval import runner, score, tabulate  # noqa: E402
from cambrian_tpu_torch.models import builder as tbuilder  # noqa: E402

PIL = pytest.importorskip("PIL.Image")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "eval", "records.json")
STAMP = "2026-01-01 00:00:00"


def _records(name):
    """The fixture's records, ``<IMAGE>`` as a small PIL image (as
    ``test_eval_fixtures.py`` loads them)."""
    with open(FIXTURES) as f:
        table = json.load(f)
    out = []
    for rec in table[name]:
        rec = dict(rec)
        for k, v in rec.items():
            if v == "<IMAGE>":
                rec[k] = PIL.new("RGB", (32, 32), (200, 20, 20))
            elif v == ["<IMAGE>"]:
                rec[k] = [PIL.new("RGB", (32, 32), (200, 20, 20))]
        out.append(rec)
    return out


def _fn_name(fn):
    return None if fn is None else fn.__name__


def test_registries_are_equal():
    assert sorted(BENCHMARKS) == sorted(JBENCHMARKS)
    for name, b in BENCHMARKS.items():
        j = JBENCHMARKS[name]
        assert (b.name, b.dataset, b.split, b.config, tuple(b.metric_names), b.primary_metric,
                b.notes) == (j.name, j.dataset, j.split, j.config, tuple(j.metric_names),
                             j.primary_metric, j.notes), name
        assert _fn_name(b.score) == _fn_name(j.score), name
        assert _fn_name(b.submission) == _fn_name(j.submission), name


def _prompt(bench, record):
    try:
        return bench.build_prompt(dict(record))
    except KeyError as e:            # strict field resolution: both raise alike
        return ("KeyError", str(e))


@pytest.mark.parametrize("name", sorted(JBENCHMARKS))
def test_prompts_equal_jax(name):
    for record in _records(name):
        assert _prompt(BENCHMARKS[name], record) == _prompt(JBENCHMARKS[name], record)


def _rows(name):
    """Answer rows on every fixture record: the gold answer, wrong ones and
    messy shapes of it."""
    rows = []
    for record in _records(name):
        prompt = BENCHMARKS[name].build_prompt(dict(record))
        gold = str(prompt.get("answer"))
        base = {k: v for k, v in prompt.items() if k != "image"}
        for pred in (gold, f"The answer is ({gold}).", f" {gold.lower()}.", "zzz unrelated",
                     "", "Yes", "(b)", "12.5"):
            rows.append({**base, "prediction": pred, "question_id": len(rows)})
    return rows


@pytest.mark.parametrize("name", sorted(JBENCHMARKS))
def test_scoring_and_tabulation_equal_jax(name, tmp_path):
    rows = _rows(name)
    assert BENCHMARKS[name].score(rows) == JBENCHMARKS[name].score(rows)
    answers = tmp_path / "answers.jsonl"
    with open(answers, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    files = {}
    for label, sc, tab in (("jax", jscore, jtabulate), ("port", score, tabulate)):
        out = tmp_path / label
        metrics = sc.score_answers(name, str(answers))
        sub = sc.write_submission(name, str(answers), "org/tiny-model", str(out))
        sc.append_experiment_row(str(out / "experiments.csv"), "org/tiny-model", name,
                                 metrics, timestamp=STAMP)
        sc.append_experiment_row(str(out / "experiments.csv"), "other-model", name,
                                 {k: v / 2 for k, v in metrics.items()}, timestamp=STAMP)
        tab.write_pivot(tab.pivot(tab.read_rows([str(out / "experiments.csv")])),
                        str(out / "pivot.csv"))
        files[label] = (metrics, sub and os.path.basename(sub),
                        {p: (out / p).read_bytes() for p in sorted(os.listdir(out))})
    assert files["port"] == files["jax"]
    assert (files["port"][1] is not None) == (BENCHMARKS[name].submission is not None)


def test_score_and_tabulate_clis_equal_jax(tmp_path, monkeypatch, capsys):
    """Both packages' ``score`` and ``tabulate`` CLIs over two benchmarks
    write the same files and print the same lines."""
    monkeypatch.setattr(time, "strftime", lambda fmt, *a: STAMP)
    printed = {}
    for label, sc, tab in (("jax", jscore, jtabulate), ("port", score, tabulate)):
        out = tmp_path / label
        out.mkdir()
        monkeypatch.chdir(out)
        for name in ("mmvet", "pope"):
            answers = out / f"{name}.jsonl"
            answers.write_text("".join(json.dumps(r) + "\n" for r in _rows(name)))
            monkeypatch.setattr(sys, "argv", ["score", "--benchmark", name, "--answers_file",
                                              str(answers), "--model_id", "tiny"])
            sc.main()
        monkeypatch.setattr(sys, "argv", ["tabulate"])
        tab.main()
        printed[label] = capsys.readouterr().out.replace(str(out), "<dir>")
    got = {p: (tmp_path / "port" / p).read_bytes() for p in os.listdir(tmp_path / "port")}
    want = {p: (tmp_path / "jax" / p).read_bytes() for p in os.listdir(tmp_path / "jax")}
    assert got == want and "tiny_mmvet_submission.json" in got
    assert printed["port"] == printed["jax"]


# -- run_benchmark end to end ------------------------------------------------

@pytest.fixture(scope="module")
def eval_setup(tmp_path_factory):
    datasets = pytest.importorskip("datasets")
    d = tmp_path_factory.mktemp("torch_evalrun")
    ckpt = str(d / "ckpt")
    make_tiny_checkpoint(ckpt)
    colors = [(220, 10, 10), (10, 200, 30), (20, 20, 230), (240, 240, 20)]
    records = [{"question": f"What color is square {i}?", "choices": ["red", "green", "blue"],
                "answer": "A", "image": PIL.new("RGB", (48 + 8 * i, 40), colors[i])}
               for i in range(4)]
    ds_path = str(d / "cvbench_like")
    datasets.Dataset.from_list(records).save_to_disk(ds_path)
    return d, ckpt, ds_path


def test_run_benchmark_answers_equal_jax(eval_setup, monkeypatch):
    """Greedy answers of the two runners on the same checkpoint and tower
    weights (the JAX loader's, handed to the port's loader): the same
    answers file, byte for byte."""
    d, ckpt, ds_path = eval_setup
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jbundle = jbuilder.load_pretrained_model(ckpt, dtype=jnp.float32)
        towers = {t.name: tp for t, tp in zip(jbundle[1].towers, jbundle[1].tower_params)}
        monkeypatch.setattr(tbuilder, "load_tower_params", lambda t, g=None, device=None:
                            state_dict_from_jax(jax.tree.map(np.asarray, towers[t.name]),
                                                prefix="module."))
        bundle = tbuilder.load_pretrained_model(ckpt, device="cpu", dtype=torch.float32)
    out = {}
    for label, run, b in (("jax", jrunner.run_benchmark, jbundle),
                          ("port", runner.run_benchmark, bundle)):
        path = str(d / label / "ade.jsonl")
        run("ade", b, "llama_3", path, dataset_path=ds_path, num_chunks=2, chunk_idx=0,
            max_new_tokens=4)
        with open(path, "rb") as f:
            out[label] = f.read()
    rows = [json.loads(line) for line in out["port"].splitlines()]
    assert len(rows) == 2 and all(r["answer"] == "A" and r["prediction"] for r in rows)
    assert out["port"] == out["jax"]


def test_runner_cli_on_cpu(eval_setup, tmp_path, monkeypatch):
    """``python -m cambrian_tpu_torch.eval.runner --device cpu``, run in this
    process through ``runpy`` (a fresh interpreter spends ~12 s importing
    ``transformers.AutoTokenizer`` alone)."""
    d, ckpt, ds_path = eval_setup
    answers = tmp_path / "answers.jsonl"
    monkeypatch.setattr(sys, "argv", [
        "runner", "--device", "cpu", "--benchmark", "ade", "--model_path", ckpt,
        "--answers_file", str(answers), "--dataset_path", ds_path, "--limit", "1",
        "--max_new_tokens", "3"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")       # the tiny towers' random weights
        runpy.run_module("cambrian_tpu_torch.eval.runner", run_name="__main__")
    rows = [json.loads(line) for line in answers.read_text().splitlines()]
    assert len(rows) == 1 and rows[0]["benchmark"] == "ade" and rows[0]["question_id"] == 0
    assert rows[0]["answer"] == "A" and set(rows[0]) >= {"prompt", "prediction", "choices"}
    assert 0.0 <= score.score_answers("ade", str(answers))["accuracy"] <= 1.0
