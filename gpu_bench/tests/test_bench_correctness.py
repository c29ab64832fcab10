"""``correct`` comes out false for the lower-precision control and for each
fault a cell can have, with the timed path broken underneath and the rest
of a run as it is: a token altered where it is produced; a training step
that leaves the state unchanged; half of the batch left out, the mean
taken over the rest. The tiny cells' limits (``tests/data/limits``) are set
from their own readings, as the cells' are. The control at the cells' own
size needs the card."""

import json
import subprocess
import sys

import pytest
import torch

from conftest import ROOT

SEEDS = ("2147483713", "31")


@pytest.mark.parametrize("seed", SEEDS)
def test_sound_runs_are_correct(run_tiny, seed):
    for cell in ("tiny-batch", "tiny-train"):
        line, _ = run_tiny("--workload", cell, "--seed", seed, "--seconds", "1")
        assert line["correct"] is True, (cell, line["checks"])


@pytest.mark.parametrize("seed", SEEDS)
def test_the_int4_control_fails(run_tiny, seed):
    line, _ = run_tiny("--workload", "tiny-batch", "--seed", seed, "--seconds", "1",
                       "--control", "1")
    assert line["correct"] is False


@pytest.mark.parametrize("seed", SEEDS)
def test_the_fp8_training_control_fails(run_tiny, seed):
    line, _ = run_tiny("--workload", "tiny-train", "--seed", seed, "--seconds", "1",
                       "--control", "1")
    assert line["correct"] is False


def test_an_altered_token_fails(run_tiny, monkeypatch):
    from cambrian_tpu_torch.infer.continuous import ContinuousBatchingEngine

    decode = ContinuousBatchingEngine._decode_chunk

    def altered(self, *args, **kwargs):
        toks = decode(self, *args, **kwargs).clone()
        second = toks[:, 1]          # each slot's second token of the chunk
        toks[:, 1] = torch.where(second >= 0, (second + 1) % self.model.cfg.vocab_size, second)
        return toks

    monkeypatch.setattr(ContinuousBatchingEngine, "_decode_chunk", altered)
    line, _ = run_tiny("--workload", "tiny-batch", "--seed", "41", "--seconds", "1")
    assert line["correct"] is False


def test_a_step_that_leaves_the_state_unchanged_fails(run_tiny, monkeypatch):
    from cambrian_tpu_torch.train.optimizer import GroupedAdamW

    def unchanged(self, grads):
        self.count += 1

    monkeypatch.setattr(GroupedAdamW, "_update", unchanged)
    line, _ = run_tiny("--workload", "tiny-train", "--seed", "43", "--seconds", "1")
    assert line["correct"] is False
    assert line["checks"]["change_gap"]["value"] > line["checks"]["change_gap"]["limit"]


def test_half_the_batch_left_out_fails(run_tiny, monkeypatch):
    from cambrian_tpu_torch.models.cambrian import CambrianLM

    loss = CambrianLM.supervised_loss

    def half(self, input_ids, attention_mask, position_ids, labels, aux_features_list=None,
             aux_masks_list=None, count=None):
        h = input_ids.shape[0] // 2
        return loss(self, input_ids[:h], attention_mask[:h], position_ids[:h], labels[:h],
                    [f[:h] for f in aux_features_list],
                    None if aux_masks_list is None else [m[:h] for m in aux_masks_list])

    monkeypatch.setattr(CambrianLM, "supervised_loss", half)
    line, _ = run_tiny("--workload", "tiny-train", "--seed", "47", "--seconds", "1")
    assert line["correct"] is False
    assert line["checks"]["grad_gap"]["value"] > line["checks"]["grad_gap"]["limit"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell,flags", [
    ("c34b-int8-batch", ["--control", "1"]),
    ("phi3-stage1-train", ["--control", "1"]),
    ("phi3-stage1-train", ["--fault", "half-batch"]),
])
def test_the_control_and_the_half_batch_fail_at_the_cells_own_size(cell, flags):
    """On the card: the cell run with the precision one step below its
    configuration's (int4 for int8 serving, fp8 weights for bf16
    training), and the training reference that takes half of each batch in
    the program's place, are not correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs the cell at its own size")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    proc = subprocess.run([sys.executable, "gpu_bench/run.py", "--workload", cell, "--seed",
                           "2147483729", "--seconds", str(bench["run_seconds"]), "--trace", "0",
                           *flags], cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"] is False
