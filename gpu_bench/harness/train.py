"""The training cell: stage-1 connector training through
``CambrianTrainer.train()``, its fetch pool and prefetch thread, on samples
made with numpy from the seed (no tokenizer, no image files).

Each sample is a prefix of ``image_position`` tokens, the image marker and a
caption whose length comes from the job's fixed cycle; the prefix and the
marker are unlabelled. The trainer's data order comes from the job's own
data seed, so every run's steps hold the same lengths: the seed draws the
weights, the token ids and the pixels only.

The benchmark wraps the trainer's step function at run time: the first
``warmup_steps`` steps are set-up (the first three are the ones the
reference follows), the window then runs whole steps until ``--seconds``
have passed, and the data stream ends there. The trainer's checkpoint
writes (at ``save_steps``, past the window, and at the end) are left out,
so that a run writes nothing to disk.
"""

import itertools
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from . import clocks, program

IGNORE = -100


class Samples:
    """Pre-tokenized stage-1 samples, made when the fetch pool asks."""

    def __init__(self, cfg_file: Dict, job: Dict, seed: int):
        self.cfg_file, self.job, self.seed = cfg_file, job, int(seed)
        self.prefix = cfg_file["model"]["image_position"]
        caps = job["caption_tokens"]
        self.captions = [caps[i % len(caps)] for i in range(job["samples"])]
        # the sampler's lengths: positive, every sample has an image
        self.modality_lengths = [self.prefix + 1 + c for c in self.captions]

    def __len__(self):
        return len(self.captions)

    def __getitem__(self, i: int) -> Dict:
        lo, hi = self.cfg_file["token_ids"]
        rng = np.random.default_rng([self.seed, int(i)])
        ids = rng.integers(lo, hi, self.prefix + 1 + self.captions[i]).astype(np.int64)
        ids[0] = self.cfg_file["model"]["bos_token_id"]
        ids[self.prefix] = self.cfg_file["image_marker"]
        labels = ids.copy()
        labels[:self.prefix + 1] = IGNORE
        images = [rng.standard_normal((3, t["image_size"], t["image_size"]), dtype=np.float32)
                  for t in self.cfg_file["towers"]]
        side = self.cfg_file["towers"][0]["image_size"]
        return {"index": int(i), "input_ids": ids, "labels": labels, "image_aux_list": images,
                "image_size": (side, side)}


class _Tokenizer:
    """What the collator reads of a tokenizer."""

    def __init__(self, job: Dict, pad: int):
        self.model_max_length = job["seq_len"]
        self.pad_token_id = pad
        self.padding_side = "right"


def arguments(job: Dict, out_dir: str, device: str):
    from cambrian_tpu_torch.train.trainer import TrainingArguments

    return TrainingArguments(
        output_dir=out_dir, tune_mm_mlp_adapter=True, bf16=True, num_train_epochs=1,
        per_device_train_batch_size=job["batch"], gradient_accumulation_steps=1,
        max_steps=job["total_steps"], learning_rate=job["learning_rate"],
        mm_vision_sampler_lr=job["lr_groups"]["vision_sampler"],
        weight_decay=job["weight_decay"], warmup_ratio=job["warmup_ratio"],
        lr_scheduler_type="cosine", adam_b1=job["adam_b1"], adam_b2=job["adam_b2"],
        adam_eps=job["adam_eps"], max_grad_norm=job["max_grad_norm"], logging_steps=1,
        save_steps=10 ** 9, group_by_modality_length=True, seed=job["data_seed"],
        dataloader_num_workers=job["fetch_workers"], device=device)


def collator(cfg_file: Dict, job: Dict):
    from cambrian_tpu_torch.data.dataset import DataCollatorForSupervisedDataset

    m = cfg_file["model"]
    return DataCollatorForSupervisedDataset(
        tokenizer=_Tokenizer(job, cfg_file["pad_token_id"]), image_token_len=m["image_token_len"],
        image_aux_token_len_list=list(m["mm_vision_tower_aux_token_len_list"]),
        image_position=m["image_position"])


def first_batches(samples: Samples, job: Dict, count: int) -> List[List[int]]:
    """The sample indices of the job's first batches, in the trainer's
    data order (its length-grouped sampler under the job's data seed)."""
    from cambrian_tpu_torch.data.dataset import LengthGroupedSampler

    order = list(LengthGroupedSampler(job["batch"], 1, samples.modality_lengths,
                                      generator=np.random.default_rng(job["data_seed"]),
                                      group_by_modality=True))
    return [order[i * job["batch"]:(i + 1) * job["batch"]] for i in range(count)]


def run(cfg_file: Dict, job: Dict, seed: int, seconds: float, device, tracer,
        out_dir: str) -> Dict:
    """Build the model and the trainer, train, and return the window's
    steps and tokens with what the reference needs: the first steps'
    losses, the first clipped gradient and the change after the followed
    steps, all read from the optimizer's state."""
    from cambrian_tpu_torch.train.trainer import CambrianTrainer

    model = program.build(cfg_file, seed, device)
    samples = Samples(cfg_file, job, seed)
    collate = collator(cfg_file, job)
    batches: List[Dict] = []

    def logged_collate(instances):
        batch = collate(instances)
        batches.append({"indices": [int(x["index"]) for x in instances],
                        "valid": int(batch["attention_mask"].sum()),
                        "lengths": [int(v) for v in batch["attention_mask"].sum(1)],
                        "labelled": int((batch["labels"][:, 1:] != IGNORE).sum())})
        return batch

    trainer = CambrianTrainer(model=model.lm, towers=model.towers,
                              args=arguments(job, out_dir, str(device)), train_dataset=samples,
                              data_collator=logged_collate)
    trainer._save_checkpoint = lambda state, step: None
    follow = job["followed_steps"]
    warm = job["warmup_steps"]
    rec = {"losses": [], "start": None, "grads": None, "after": None, "t0": None,
           "t1": None, "window_steps": 0, "stopped": False}
    counter = itertools.count()
    b1 = job["adam_b1"]
    last = {}

    def masters(state):
        """The fp32 masters, kept on the host so that the window's peak
        memory is the program's alone."""
        return {f"lm.{n}": st["master"].detach().to("cpu", copy=True)
                for n, st in state.optimizer.state.items()}

    def wrap(step_fn):
        from torch.profiler import record_function

        def step(state, batch):
            i = next(counter)
            now = watch.mark()
            if rec["stopped"]:
                return state, last["metrics"]
            if i == 0:
                rec["start"] = masters(state)
            if i == 1:
                rec["grads"] = {f"lm.{n}": st["mu"].detach().float().cpu() / (1 - b1)
                                for n, st in state.optimizer.state.items()}
            if i == follow:
                rec["after"] = masters(state)
            if i == warm:
                rec["t0"] = now
            if i > warm and now - rec["t0"] - tracer.stall >= seconds:
                rec["t1"], rec["window_steps"], rec["stopped"] = now, i - warm, True
                tracer.step(None)
                return state, last["metrics"]
            if i >= warm:
                tracer.step(i - warm)
            rec.setdefault("marks", []).append(now)
            with record_function(f"bench.train_step#{i}"):
                state, metrics = step_fn(state, batch)
            if i < follow:
                rec["losses"].append(metrics["loss"])
            last["metrics"] = metrics
            return state, metrics
        return step

    prepare = trainer.prepare

    def prepared(accumulate=1):
        state, step_fn = prepare(accumulate)
        return state, wrap(step_fn)

    trainer.prepare = prepared
    index_stream = trainer._index_stream

    def stream(epochs):
        for idx in index_stream(epochs):
            if rec["stopped"]:
                return
            yield idx

    trainer._index_stream = stream
    watch = clocks.Watch(device)
    with watch:
        trainer.train()
    if not rec["stopped"]:
        raise RuntimeError("the job's samples ran out before the window closed")
    marks = rec["marks"] + [rec["t1"]]
    print(f"steps: {rec['window_steps']} in the window; ms a warm-up step "
          f"{[round(1e3 * (b - a), 1) for a, b in zip(marks[:warm], marks[1:warm + 1])]}",
          file=sys.stderr, flush=True)
    watch.report(marks[warm:], "step")
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    window = batches[warm:warm + rec["window_steps"]]
    log = {"train_step": {warm + k: b for k, b in enumerate(window)}}
    out = {
        "steps": rec["window_steps"], "seconds": rec["t1"] - rec["t0"] - tracer.stall,
        "t0": rec["t0"],
        "tokens": sum(b["valid"] for b in window),
        "losses": [float(x) for x in rec["losses"]],
        "grads": rec["grads"], "start": rec["start"], "after": rec["after"],
        "batches": [b["indices"] for b in batches[:follow]], "log": log,
        "peak": torch.cuda.max_memory_allocated() if torch.cuda.is_available() else 0,
    }
    del trainer, model
    return out
