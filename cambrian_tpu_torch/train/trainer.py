"""Training loop (cambrian_tpu/train/trainer.py).

- modality/length-grouped batch order (data/dataset.py::LengthGroupedSampler);
- per-group learning rates and freeze policies (train/optimizer.py);
- a threaded per-sample fetch pool and a prefetch thread that collates and
  pins the next batches while the card steps; the main thread copies each
  batch to the card ``non_blocking``;
- ``total_steps`` counted in optimizer steps under gradient accumulation;
- periodic checkpoints with ``torch.distributed.checkpoint`` (DCP), one
  format for one rank and for many: every parameter (frozen ones included,
  as the JAX package's Orbax ``params``; under LoRA the adapters), the
  optimizer state (the fp32 masters and moments), the RNG and the step, in
  ``checkpoints/step_N/``; a checkpoint saved under one mesh restores under
  another, and ``checkpoint/consolidate.py`` turns one into an HF
  checkpoint; resume from the newest;
- ``NanInfAlert`` halts the run on a non-finite loss;
- ``save_model`` writes the HF-layout export (checkpoint/save.py);
- LoRA (``lora_enable``, train/lora.py): adapters made at init from the seed
  or read from ``lora_weight_path``, the base left in its dtype, the adapters
  and their optimizer state in the checkpoints; at the end
  ``lora_adapters.safetensors`` in ``output_dir`` and the adapters merged
  into the model, so ``save_model`` exports it as a full finetune.

Across GPUs: under an initialised process group
(``parallel.distributed.initialize_distributed``) the trainer builds the
(data, fsdp, model) mesh of ``mesh_data`` / ``mesh_fsdp`` / ``mesh_model``,
lays the model and towers out on it (``parallel.sharding.shard_model``),
steps on ``per_device_train_batch_size`` x (data x fsdp) samples at a time,
each rank on its rows (``put_global_batch``), and logs and exports from the
main process. Without a process group every axis must resolve to one
device, and the unsharded path runs. LoRA runs on the mesh too: the frozen
base laid out as above, the adapters and their optimizer state laid out
like their linears' weights (``lora.distribute_adapters``), saved in the
checkpoints as DTensors (so they restore under another mesh), and the
adapters' file written once, by the main process, from whole tensors.
"""

import concurrent.futures
import json
import logging
import os
import queue
import shutil
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, List, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp

from ..checkpoint import safetensors_io
from ..checkpoint.consolidate import checkpoint_dirs
from ..data.dataset import LengthGroupedSampler
from ..parallel.distributed import dp_coordinate, is_main_process, put_global_batch
from ..parallel.mesh import MeshConfig, create_mesh
from ..parallel.sharding import shard_model
from .lora import (
    distribute_adapters,
    flat_adapters,
    init_lora_params,
    lora_from_state_dict,
    lora_state_dict,
    merge_lora,
)
from .optimizer import TrainConfig, _schedule, cast_frozen_params
from .train_step import (
    TrainState,
    apply_freeze,
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
    # mesh (parallel/mesh.py): -1 absorbs the devices the others leave
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


def _pin(x):
    if isinstance(x, list):
        return [_pin(v) for v in x]
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.pin_memory() if torch.cuda.is_available() else t


class CambrianTrainer:
    def __init__(self, model, towers, args: TrainingArguments, train_dataset, data_collator):
        self.model = model
        self.towers = list(towers)
        self.args = args
        self.train_dataset = train_dataset
        self.data_collator = data_collator
        self.device = model.image_newline.device
        mesh_config = MeshConfig(args.mesh_data, args.mesh_fsdp, args.mesh_model)
        self.mesh = None
        if dist.is_initialized():
            self.mesh = create_mesh(mesh_config, self.device.type)
        else:
            mesh_config.resolve(1)          # one process: every axis must be 1
        self.dp_size = dp_coordinate(self.mesh)[1]
        self.global_batch_size = args.per_device_train_batch_size * self.dp_size
        self.step_seconds: List[float] = []    # wall time of each optimizer step
        self.saves: List[dict] = []            # each checkpoint's step, bytes and seconds
        self._final_state: Optional[TrainState] = None
        self.adapters = None                   # the LoRA adapters, under lora_enable

    # -- checkpointing ------------------------------------------------------

    @property
    def checkpoint_dir(self) -> str:
        return os.path.abspath(os.path.join(self.args.output_dir, "checkpoints"))

    def _checkpoints(self) -> List[str]:
        return checkpoint_dirs(self.checkpoint_dir)

    def _checkpoint_state(self, state: TrainState, step: int = 0) -> dict:
        """The checkpoint's tree over the live tensors (DTensors under a
        mesh): DCP saves it, and loads into it in place."""
        rng = {"cpu": torch.get_rng_state()}
        if self.device.type == "cuda":
            rng["cuda"] = torch.cuda.get_rng_state(self.device)
        ckpt = {"step": step, "micro_step": state.step,
                "optimizer": state.optimizer.state_dict(), "rng": rng}
        if self.adapters is not None:
            # LoRA trains the adapters alone (the frozen ones too, which no
            # optimizer holds); the base comes from the model's checkpoint,
            # as the JAX package's LoRA state holds the adapters alone; alpha
            # for consolidate's merge
            ckpt["lora"] = {k: t.detach() for k, t in flat_adapters(self.adapters).items()}
            ckpt["lora_alpha"] = self.args.lora_alpha
        else:
            named = named_parameters(self.model, self.towers, self.args.unfreeze_mm_vision_tower)
            ckpt["model"] = {n: p.detach() for n, p in named.items()}
        return ckpt

    def _barrier(self):
        if dist.is_initialized():
            dist.barrier()

    def _save_checkpoint(self, state: TrainState, step: int):
        path = os.path.join(self.checkpoint_dir, f"step_{step:09d}")
        t0 = time.perf_counter()
        if is_main_process():
            os.makedirs(self.checkpoint_dir, exist_ok=True)
            shutil.rmtree(path, ignore_errors=True)
        self._barrier()
        # a writer thread a core: one thread leaves an 8B checkpoint (20 GB)
        # at about 0.6 GB/s
        writer = dcp.FileSystemWriter(path, thread_count=min(8, os.cpu_count() or 1))
        dcp.save(self._checkpoint_state(state, step), storage_writer=writer)
        self._barrier()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        n_bytes = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
        self.saves.append({"step": step, "bytes": n_bytes,
                           "seconds": time.perf_counter() - t0})
        if is_main_process():
            for old in self._checkpoints()[:-max(1, self.args.save_total_limit)]:
                shutil.rmtree(old)
        self._barrier()

    def _restore_checkpoint(self, state: TrainState) -> int:
        found = self._checkpoints()
        if not found:
            return 0
        ckpt = self._checkpoint_state(state)
        with torch.no_grad():
            dcp.load(ckpt, checkpoint_id=found[-1])
        state.optimizer.load_state_dict(ckpt["optimizer"])
        state.step = int(ckpt["micro_step"])
        torch.set_rng_state(ckpt["rng"]["cpu"])
        if "cuda" in ckpt["rng"]:
            torch.cuda.set_rng_state(ckpt["rng"]["cuda"].cpu(), self.device)
        logger.info("resumed from checkpoint step %d", ckpt["step"])
        return int(ckpt["step"])

    def save_model(self, output_dir: Optional[str] = None):
        """Final HF-format export of the model (not the towers), written by
        the main process; a sharded model is gathered first (every rank
        takes part)."""
        from ..checkpoint.save import save_pretrained

        model = self.model
        if self.mesh is not None:
            from ..checkpoint.from_jax import load_state_dict_checked
            from ..models.builder import build_modules

            full = {n: t.full_tensor() if hasattr(t, "placements") else t
                    for n, t in model.state_dict().items()}
            if not is_main_process():
                return
            with torch.device("meta"):
                model, _ = build_modules(self.model.cfg, self.model.dtype)
            load_state_dict_checked(model, full, assign=True)
        if is_main_process():
            save_pretrained(model, model.cfg, output_dir or self.args.output_dir)

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

    def prepare(self, accumulate: int = 1):
        """The train state and step function: the LoRA adapters and their
        optimizer, or the frozen groups stored in bf16 (under ``bf16``), the
        model and towers sharded on the mesh, and the optimizer over the
        trainable parameters. ``train()`` calls it; a caller that feeds its
        own batches (each rank's rows, ``put_global_batch``) may too."""
        args, accum = self.args, max(1, accumulate)
        if args.lora_enable:
            # the adapters train; the base stays in its dtype, frozen (and
            # sharded on the mesh, as serving shards it)
            if self.mesh is not None:
                for module in [self.model, *self.towers]:
                    module.requires_grad_(False)
                shard_model(self.model, self.towers, self.mesh)
            if args.lora_weight_path:
                self.adapters = lora_from_state_dict(
                    safetensors_io.load_file(args.lora_weight_path), self.device)
            else:
                # the same draw on every rank
                g = torch.Generator(device=self.device).manual_seed(args.seed)
                self.adapters = init_lora_params(self.model, args.lora_r, g)
            if self.mesh is not None:
                self.adapters = distribute_adapters(self.adapters, self.model, self.mesh)
            state = init_lora_train_state(self.adapters, args, accumulate=accum)
            step_fn = make_lora_train_step(self.model, self.towers, self.adapters,
                                           args.lora_alpha, args.lora_r, mesh=self.mesh)
        else:
            if args.bf16:
                # frozen groups never update: store them in bf16 (norms exempt)
                frozen = named_parameters(self.model, self.towers, args.unfreeze_mm_vision_tower)
                cast_frozen_params(frozen, args)
            if self.mesh is not None:
                # the freeze first: FSDP2 takes requires_grad as it shards
                apply_freeze(self.model, self.towers, args)
                shard_model(self.model, self.towers, self.mesh)
            state = init_train_state(self.model, self.towers, args, accumulate=accum)
            step_fn = make_train_step(self.model, self.towers,
                                      train_towers=args.unfreeze_mm_vision_tower,
                                      mesh=self.mesh)
        return state, step_fn

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
        state, step_fn = self.prepare(accum)
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
                    batch = put_global_batch(host, self.mesh, self.device)
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
                    if is_main_process():
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
            # the adapters' file (whole tensors, gathered by every rank and
            # written by the main process), and the merged weights for
            # save_model
            whole = lora_state_dict(self.adapters)
            if is_main_process():
                os.makedirs(args.output_dir, exist_ok=True)
                safetensors_io.save_file(
                    whole, os.path.join(args.output_dir, "lora_adapters.safetensors"))
            self._barrier()
            merge_lora(self.model, self.adapters, args.lora_alpha, args.lora_r)
        self._final_state = state
        return history
