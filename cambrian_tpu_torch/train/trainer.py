"""Training loop (cambrian_tpu/train/trainer.py).

- modality/length-grouped batch order (data/dataset.py::LengthGroupedSampler);
- per-group learning rates and freeze policies (train/optimizer.py);
- a threaded per-sample fetch pool and a prefetch thread that collates and
  pins the next batches while the card steps; the main thread copies each
  batch to the card ``non_blocking``;
- ``total_steps`` counted in optimizer steps under gradient accumulation;
- periodic checkpoints of the trainable parameters (their fp32 masters),
  the optimizer state, the RNG and the step, with ``torch.save`` (the JAX
  package uses Orbax), and resume from the newest;
- ``NanInfAlert`` halts the run on a non-finite loss;
- ``save_model`` writes the HF-layout export (checkpoint/save.py);
- LoRA (``lora_enable``, train/lora.py): adapters made at init from the seed
  or read from ``lora_weight_path``, the base left in its dtype, the adapters
  and their optimizer state in the checkpoints; at the end
  ``lora_adapters.safetensors`` in ``output_dir`` and the adapters merged
  into the model, so ``save_model`` exports it as a full finetune.

One device: the mesh arguments are accepted, and anything but one device
raises until multi-GPU training is ported (ROADMAP item 11).
"""

import concurrent.futures
import glob
import json
import logging
import os
import queue
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from ..checkpoint import safetensors_io
from ..data.dataset import LengthGroupedSampler
from .lora import init_lora_params, lora_from_state_dict, lora_state_dict, merge_lora
from .optimizer import TrainConfig, _schedule, cast_frozen_params
from .train_step import (
    TrainState,
    init_lora_train_state,
    init_train_state,
    make_lora_train_step,
    make_train_step,
    named_parameters,
)

logger = logging.getLogger(__name__)


@dataclass
class TrainingArguments(TrainConfig):
    """The JAX package's flag surface (the reference's TrainingArguments plus
    mesh controls), and the device to train on."""

    output_dir: str = "./checkpoints"
    num_train_epochs: float = 1.0
    max_steps: int = -1
    per_device_train_batch_size: int = 8
    gradient_accumulation_steps: int = 1
    logging_steps: int = 10
    save_steps: int = 500
    save_total_limit: int = 2
    seed: int = 42
    group_by_modality_length: bool = True
    bf16: bool = True
    dataloader_num_workers: int = 4
    # mesh: one device until ROADMAP item 11
    mesh_data: int = 1
    mesh_fsdp: int = -1
    mesh_model: int = 1
    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    # resume
    train_continue: bool = False
    resume_from_checkpoint: Optional[str] = None
    report_to: str = "none"
    run_name: Optional[str] = None
    # LoRA (train/lora.py)
    lora_enable: bool = False
    lora_r: int = 16
    lora_alpha: int = 32
    lora_dropout: float = 0.0
    lora_bias: str = "none"
    lora_weight_path: Optional[str] = None
    gcs_output_dir: Optional[str] = None
    device: str = "cuda"


class NanInfAlert(RuntimeError):
    """Raised to halt training on a non-finite loss."""


class _Prefetcher:
    """Background thread building batches ahead of the loop."""

    def __init__(self, make_batch: Callable[[], Any], depth: int = 2):
        self._queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self._make = make_batch
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            try:
                item = self._make()
            except StopIteration:
                self._queue.put(None)
                return
            except Exception as e:  # surfaced in the loop, not lost in the thread
                self._queue.put(e)
                return
            self._queue.put(item)

    def __next__(self):
        item = self._queue.get()
        if item is None:
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        return item

    def stop(self):
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=60)


def _check_one_device(args: TrainingArguments) -> None:
    sizes = {"mesh_data": args.mesh_data, "mesh_fsdp": args.mesh_fsdp,
             "mesh_model": args.mesh_model, "num_processes": args.num_processes or 1}
    many = {k: v for k, v in sizes.items() if v not in (-1, 1)}
    if many:
        raise NotImplementedError(
            f"training runs on one device until multi-GPU is ported (ROADMAP item 11); "
            f"got {many}")


def _pin(x):
    if isinstance(x, list):
        return [_pin(v) for v in x]
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.pin_memory() if torch.cuda.is_available() else t


def _to_device(x, device):
    if isinstance(x, list):
        return [_to_device(v, device) for v in x]
    return x.to(device, non_blocking=True)


class CambrianTrainer:
    def __init__(self, model, towers, args: TrainingArguments, train_dataset, data_collator):
        _check_one_device(args)
        self.model = model
        self.towers = list(towers)
        self.args = args
        self.train_dataset = train_dataset
        self.data_collator = data_collator
        self.device = model.image_newline.device
        self.dp_size = 1
        self.global_batch_size = args.per_device_train_batch_size * self.dp_size
        self.step_seconds: List[float] = []    # wall time of each optimizer step
        self._final_state: Optional[TrainState] = None
        self.adapters = None                   # the LoRA adapters, under lora_enable

    # -- checkpointing ------------------------------------------------------

    @property
    def checkpoint_dir(self) -> str:
        return os.path.abspath(os.path.join(self.args.output_dir, "checkpoints"))

    def _checkpoints(self) -> List[str]:
        return sorted(glob.glob(os.path.join(self.checkpoint_dir, "step_*.pt")))

    def _save_checkpoint(self, state: TrainState, step: int):
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        rng = {"cpu": torch.get_rng_state()}
        if self.device.type == "cuda":
            rng["cuda"] = torch.cuda.get_rng_state(self.device)
        path = os.path.join(self.checkpoint_dir, f"step_{step:09d}.pt")
        ckpt = {"step": step, "micro_step": state.step,
                "optimizer": state.optimizer.state_dict(), "rng": rng}
        if self.adapters is not None:   # the frozen adapters too, which no optimizer holds
            ckpt["lora"] = lora_state_dict(self.adapters)
        torch.save(ckpt, path + ".tmp")
        os.replace(path + ".tmp", path)
        for old in self._checkpoints()[:-max(1, self.args.save_total_limit)]:
            os.remove(old)

    def _restore_checkpoint(self, state: TrainState) -> int:
        found = self._checkpoints()
        if not found:
            return 0
        ckpt = torch.load(found[-1], map_location=self.device, weights_only=True)
        if self.adapters is not None:
            saved = lora_from_state_dict(ckpt["lora"], self.device)
            with torch.no_grad():
                for key, adapter in self.adapters.items():
                    for part, t in adapter.items():
                        t.copy_(saved[key][part])
        state.optimizer.load_state_dict(ckpt["optimizer"])
        state.step = int(ckpt["micro_step"])
        torch.set_rng_state(ckpt["rng"]["cpu"].cpu())
        if "cuda" in ckpt["rng"] and self.device.type == "cuda":
            torch.cuda.set_rng_state(ckpt["rng"]["cuda"].cpu(), self.device)
        logger.info("resumed from checkpoint step %d", ckpt["step"])
        return int(ckpt["step"])

    def save_model(self, output_dir: Optional[str] = None):
        """Final HF-format export of the model (not the towers)."""
        from ..checkpoint.save import save_pretrained

        save_pretrained(self.model, self.model.cfg, output_dir or self.args.output_dir)

    # -- batching -----------------------------------------------------------

    def _index_stream(self, epochs: int):
        rng = np.random.default_rng(self.args.seed)
        for _ in range(max(1, epochs)):
            if self.args.group_by_modality_length:
                sampler = LengthGroupedSampler(
                    self.args.per_device_train_batch_size, self.dp_size,
                    self.train_dataset.modality_lengths,
                    generator=rng, group_by_modality=True,
                )
                order = list(iter(sampler))
            else:
                order = rng.permutation(len(self.train_dataset)).tolist()
            for i in range(0, len(order) - self.global_batch_size + 1, self.global_batch_size):
                yield order[i:i + self.global_batch_size]

    # -- the loop -----------------------------------------------------------

    def train(self, resume_from_checkpoint: Optional[bool] = None):
        args = self.args
        # total_steps counts OPTIMIZER steps: the schedule advances once per
        # k micro-batches, and one epoch holds dataset // (batch * k) of them
        accum = max(1, args.gradient_accumulation_steps)
        steps_per_epoch = max(1, len(self.train_dataset) // (self.global_batch_size * accum))
        total_steps = (args.max_steps if args.max_steps > 0
                       else int(steps_per_epoch * args.num_train_epochs))
        args.total_steps = total_steps

        if args.lora_enable:
            # the adapters train; the base stays in its dtype, frozen
            if args.lora_weight_path:
                self.adapters = lora_from_state_dict(
                    safetensors_io.load_file(args.lora_weight_path), self.device)
            else:
                g = torch.Generator(device=self.device).manual_seed(args.seed)
                self.adapters = init_lora_params(self.model, args.lora_r, g)
            state = init_lora_train_state(self.adapters, args, accumulate=accum)
            step_fn = make_lora_train_step(self.model, self.towers, self.adapters,
                                           args.lora_alpha, args.lora_r)
        else:
            if args.bf16:
                # frozen groups never update: store them in bf16 (norms exempt)
                frozen = named_parameters(self.model, self.towers, args.unfreeze_mm_vision_tower)
                cast_frozen_params(frozen, args)
            state = init_train_state(self.model, self.towers, args, accumulate=accum)
            step_fn = make_train_step(self.model, self.towers,
                                      train_towers=args.unfreeze_mm_vision_tower)
        torch.manual_seed(args.seed)
        start_step = 0
        if resume_from_checkpoint or args.train_continue:
            start_step = self._restore_checkpoint(state)

        index_iter = self._index_stream(int(np.ceil(args.num_train_epochs)))
        zero_supervision_batches = 0
        n_workers = max(1, args.dataloader_num_workers)
        fetch_pool = (concurrent.futures.ThreadPoolExecutor(n_workers)
                      if n_workers > 1 else None)
        pending: "queue.Queue" = queue.Queue()

        def submit_next():
            """Dispatch the next batch's per-sample fetches, so that they run
            while the previous batch is collated and stepped."""
            try:
                idx = next(index_iter)
            except StopIteration:
                pending.put(None)
                return
            pending.put([fetch_pool.submit(self.train_dataset.__getitem__, i) for i in idx])

        if fetch_pool is not None:
            submit_next()

        def make_batch():
            nonlocal zero_supervision_batches
            if fetch_pool is not None:
                futures = pending.get()
                if futures is None:
                    raise StopIteration
                submit_next()
                instances = [f.result() for f in futures]
            else:
                instances = [self.train_dataset[i] for i in next(index_iter)]
            batch = self.data_collator(instances)
            # a batch whose labels are all IGNORE_INDEX trains on nothing but
            # reports loss 0.0: truncated prompts or a tokenizer mismatch
            if (batch["labels"] != -100).sum() == 0:
                zero_supervision_batches += 1
                if zero_supervision_batches <= 3 or zero_supervision_batches % 100 == 0:
                    logger.warning(
                        "batch has ZERO supervised tokens (%d so far): check "
                        "model_max_length vs prompt length and the tokenizer's "
                        "template special tokens", zero_supervision_batches)
            return {k: _pin(v) for k, v in batch.items()}

        prefetcher = _Prefetcher(make_batch)
        history = []
        t0 = time.time()
        try:
            for step in range(start_step, total_steps):
                t_step = time.perf_counter()
                for _ in range(accum):
                    try:
                        host = next(prefetcher)
                    except StopIteration:
                        logger.info("data exhausted at step %d", step)
                        self._save_checkpoint(state, step)
                        self._final_state = state
                        return history
                    batch = {k: _to_device(v, self.device) for k, v in host.items()}
                    state, metrics = step_fn(state, batch)

                if (step + 1) % args.logging_steps == 0 or step == start_step:
                    loss = float(metrics["loss"])
                    if not np.isfinite(loss):
                        self._save_checkpoint(state, step)
                        raise NanInfAlert(f"non-finite loss {loss} at step {step}")
                    sps = (step + 1 - start_step) / max(time.time() - t0, 1e-9)
                    entry = {"step": step + 1, "loss": loss,
                             "grad_norm": float(metrics["grad_norm"]),
                             # base-group LR at this optimizer step
                             "lr": float(_schedule(args.learning_rate, args)(step)),
                             "steps_per_sec": round(sps, 4),
                             "samples_per_sec": round(sps * self.global_batch_size, 2)}
                    history.append(entry)
                    logger.info("train %s", json.dumps(entry))
                self.step_seconds.append(time.perf_counter() - t_step)

                if (step + 1) % args.save_steps == 0:
                    self._save_checkpoint(state, step + 1)
        finally:
            prefetcher.stop()
            if fetch_pool is not None:
                fetch_pool.shutdown(wait=False, cancel_futures=True)

        self._save_checkpoint(state, total_steps)
        if self.adapters is not None:
            # the adapters' file, and the merged weights for save_model
            os.makedirs(args.output_dir, exist_ok=True)
            safetensors_io.save_file(lora_state_dict(self.adapters),
                                     os.path.join(args.output_dir, "lora_adapters.safetensors"))
            merge_lora(self.model, self.adapters, args.lora_alpha, args.lora_r)
        self._final_state = state
        return history
