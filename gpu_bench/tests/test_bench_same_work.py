"""The seed changes the contents of the work, never its amount: two seeds
give every cell the same prompt lengths, budgets and valid tokens."""

import json

import numpy as np
import torch

from conftest import ROOT

from gpu_bench.harness import common, serve, train

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SEEDS = (3, 2**31 + 17)


def _cells(kind):
    for w in BENCH["workloads"]:
        cell = common.load_cell(w["name"])
        if (cell["traffic"]["kind"] == "train") == (kind == "train"):
            yield cell


def test_serving_requests_keep_their_shapes_across_seeds():
    for cell in _cells("serve"):
        cfg, traffic = cell["config"], cell["traffic"]
        for n in range(12):
            a, b = (serve.request_inputs(cfg, traffic, s, n, "cpu") for s in SEEDS)
            assert a["ids"].shape == b["ids"].shape
            assert (a["question"], a["budget"]) == (b["question"], b["budget"])
            assert [p.shape for p in a["pixels"]] == [p.shape for p in b["pixels"]]
            assert not np.array_equal(a["ids"], b["ids"])
            assert not torch.equal(a["pixels"][0], b["pixels"][0])
            assert int((a["ids"] == cfg["image_marker"]).sum()) == 1


def test_every_traffic_file_names_its_sources():
    """Each mix's lengths come from published statistics, named in the file
    with what was assumed to turn them into tokens."""
    for w in BENCH["workloads"]:
        traffic = common.load_cell(w["name"])["traffic"]
        assert traffic["sources"] and all(traffic["sources"].values())
        assert traffic["assumed"]


def test_training_steps_hold_the_same_valid_tokens_across_seeds():
    for cell in _cells("train"):
        cfg, job = cell["config"], cell["traffic"]
        collate = train.collator(cfg, job)
        runs = []
        for seed in SEEDS:
            samples = train.Samples(cfg, job, seed)
            batches = train.first_batches(samples, job, 3)
            valid = [int(collate([samples[i] for i in b])["attention_mask"].sum()) for b in batches]
            runs.append((batches, valid, samples.modality_lengths))
        assert runs[0] == runs[1]
        a, b = (train.Samples(cfg, job, s)[5] for s in SEEDS)
        assert a["input_ids"].shape == b["input_ids"].shape
        assert not np.array_equal(a["input_ids"], b["input_ids"])
