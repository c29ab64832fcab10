"""Training step (cambrian_tpu/train/train_step.py).

One step takes a micro-batch on the model's device: the vision towers encode
the images (under ``torch.no_grad()`` unless they train), the model computes
the shifted cross-entropy (chunked under ``cfg.loss_chunk``, so the fp32
[B, S, V] logits never exist), autograd differentiates the trainable
parameters only (the freeze policy is ``requires_grad``; frozen weights
collect no ``.grad``), and the optimizer steps, or accumulates under
gradient accumulation (``optax.MultiSteps`` semantics, train/optimizer.py).

``make_lora_train_step`` trains LoRA adapters (train/lora.py) instead: the
base model is frozen and merged with the adapters inside the loss, the tower
features are detached, and only the adapters get gradients. Under a mesh
the adapters are DTensors (``lora.distribute_adapters``): each rank's
gradient of its part is summed over (data, fsdp), and also over model where
every model rank holds the whole factor but computes with its slice of the
linear (``lora.model_partial``); the loss is normalised as below.

Under a (data, fsdp, model) mesh (``parallel/``), the model and towers laid
out by ``parallel.sharding.shard_model``, each rank steps on its rows of the
global batch. The loss's normaliser is global, as in the JAX package
(``cambrian_tpu/models/cambrian.py:620``): each rank divides its summed
token loss by the valid tokens of the whole batch (the count summed over
data and fsdp), FSDP2 sums the gradients (divide factor 1), and the logged
loss is the sum of the ranks' shares. A mean of per-rank means would differ
whenever ranks hold different counts. The vocab-parallel embedding and head
are in no FSDP2 unit: each rank's gradient of its slab is summed here over
data (and over fsdp too where V does not divide and the tensor is whole on
every rank: ``VocabParallel.sum_grad``). ``batch_shardings`` and
``state_shardings`` give the layouts, as JAX's do.
"""

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Sequence

import torch
from torch import nn

from ..models.cambrian import CambrianLM, valid_token_count
from ..parallel.distributed import dp_all_reduce
from ..parallel.mesh import axis_sizes
from ..parallel.sharding import batch_sharding, spec_of, vocab_params
from .lora import Adapters, flat_adapters, lora_layout, lora_merged, model_partial
from .optimizer import (
    GroupedAdamW,
    TrainConfig,
    build_optimizer,
    global_norm,
    label_params,
    local,
)


@dataclass
class TrainState:
    step: int                   # micro-batches taken, as the JAX TrainState counts
    optimizer: GroupedAdamW


def named_parameters(model: CambrianLM, towers: Sequence[nn.Module] = (),
                     train_towers: bool = False) -> Dict[str, nn.Parameter]:
    """The model's parameters by name, and the towers' as
    ``vision_towers.{i}.*`` when they train."""
    named = dict(model.named_parameters())
    if train_towers:
        for i, t in enumerate(towers):
            named.update({f"vision_towers.{i}.{k}": p for k, p in t.named_parameters()})
    return named


def apply_freeze(model: CambrianLM, towers: Sequence[nn.Module], config: TrainConfig) -> None:
    """``requires_grad`` per the freeze policy; towers that do not train
    never require grad."""
    train_towers = config.unfreeze_mm_vision_tower
    named = named_parameters(model, towers, train_towers)
    for name, label in label_params(named, config).items():
        named[name].requires_grad_(label != "frozen")
    if not train_towers:
        for t in towers:
            t.requires_grad_(False)


def init_train_state(model: CambrianLM, towers: Sequence[nn.Module], config: TrainConfig,
                     accumulate: int = 1) -> TrainState:
    apply_freeze(model, towers, config)
    named = named_parameters(model, towers, config.unfreeze_mm_vision_tower)
    optimizer, _ = build_optimizer(named, config, accumulate)
    return TrainState(step=0, optimizer=optimizer)


def batch_shardings(mesh=None, num_towers: int = 0) -> Dict:
    """The spec of each batch entry: rows over (data, fsdp)
    (``parallel.distributed.put_global_batch`` places them)."""
    per_tower = {"images": 4, "aux_masks": 3}
    out = {k: batch_sharding(mesh, 2) for k in ("input_ids", "labels", "attention_mask",
                                                 "position_ids")}
    out.update({k: [batch_sharding(mesh, nd)] * num_towers for k, nd in per_tower.items()})
    return out


def state_shardings(state: TrainState, mesh=None) -> Dict[str, Dict[str, tuple]]:
    """{name: {leaf: spec}} of the optimizer's state: the master, mu, nu
    (and accumulator) of a parameter lie as the parameter does."""
    return {name: {leaf: spec_of(state.optimizer.params[name]) for leaf in st}
            for name, st in state.optimizer.state.items()}


def _supervised_loss(model: CambrianLM, batch: Mapping, aux_features, mesh=None):
    """Shifted CE over the batch, honoring ``cfg.loss_chunk``; under a mesh,
    this rank's summed token loss over the global batch's valid tokens."""
    count = None
    if mesh is not None:
        count = dp_all_reduce(valid_token_count(batch["labels"]), mesh)
    return model.supervised_loss(batch["input_ids"], batch["attention_mask"],
                                 batch["position_ids"], batch["labels"], aux_features,
                                 batch.get("aux_masks"), count)


def make_train_step(model: CambrianLM, towers: Optional[Sequence[nn.Module]] = None,
                    train_towers: bool = False, freeze: Optional[TrainConfig] = None,
                    mesh=None):
    """Returns ``step(state, batch) -> (state, metrics)`` with metrics
    ``loss``, ``grad_norm`` (of this micro-batch's trainable gradients) and
    ``step``, as device tensors and an int.

    ``batch``: input_ids, labels, attention_mask, position_ids, images (per
    tower, NCHW), aux_masks (per tower), tensors on the model's device: the
    rank's rows under ``mesh`` (the model sharded on it first; see the module
    docstring). ``freeze``: when given, the freeze policy is applied to
    ``requires_grad`` first."""
    if freeze is not None:
        apply_freeze(model, towers or (), freeze)

    def encode(images):
        if towers is None or images is None:
            return None
        if train_towers:
            return [t(px) for t, px in zip(towers, images)]
        with torch.no_grad():
            return [t(px) for t, px in zip(towers, images)]

    def step(state: TrainState, batch: Mapping):
        params = state.optimizer.params
        for p in params.values():
            p.grad = None
        loss = _supervised_loss(model, batch, encode(batch.get("images")), mesh)
        loss.backward()
        if model.vocab_layout is not None:
            for p in vocab_params(model):
                if p.grad is not None:
                    model.vocab_layout.sum_grad(p.grad)
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in params.items()}
        grad_norm = global_norm(grads.values())
        state.optimizer.step(grads)
        for p in params.values():
            p.grad = None
        state.step += 1
        loss = dp_all_reduce(loss.detach(), mesh)
        return state, {"loss": loss, "grad_norm": grad_norm, "step": state.step}

    return step


def init_lora_train_state(adapters: Adapters, config: TrainConfig,
                          accumulate: int = 1) -> TrainState:
    """The optimizer over the adapter tree, its leaves labelled by the
    JAX package's paths (train/optimizer.py): frozen adapters never move, and
    their gradients count in the clip's norm, as in the JAX LoRA step."""
    optimizer, _ = build_optimizer(flat_adapters(adapters), config, accumulate,
                                   frozen_in_norm=True)
    return TrainState(step=0, optimizer=optimizer)


def make_lora_train_step(model: CambrianLM, towers: Optional[Sequence[nn.Module]],
                         adapters: Adapters, alpha: float, rank: int, mesh=None):
    """Returns ``step(state, batch) -> (state, metrics)`` over the adapters
    of ``state`` (``init_lora_train_state``), as ``make_train_step`` does.
    The base model and the towers are frozen (no parameter of theirs
    requires grad); each targeted linear merges its weight with its adapters
    inside its forward (``lora_merged``), so under remat the merged weights
    stay transient. ``grad_norm`` is over every adapter's gradient. Under
    ``mesh`` (the model sharded on it, the adapters distributed) the batch
    is the rank's rows, as in ``make_train_step``."""
    import torch.distributed as dist

    model.requires_grad_(False)
    for t in towers or ():
        t.requires_grad_(False)
    leaves = flat_adapters(adapters)
    layout = lora_layout(model)
    # the leaves whose gradients are partial sums over the model axis
    partial = {f"{key}/{part}" for key in adapters for part in ("a", "b")
               if model_partial(layout.get(key), part)}
    model_group = (mesh.get_group("model") if mesh is not None
                   and axis_sizes(mesh)["model"] > 1 else None)

    def step(state: TrainState, batch: Mapping):
        names = list(state.optimizer.params) + list(state.optimizer.norm_only)
        feats = None
        if towers is not None and batch.get("images") is not None:
            with torch.no_grad():
                feats = [t(px) for t, px in zip(towers, batch["images"])]
        # the backward too runs merged: remat recomputes each layer's forward
        with lora_merged(model, adapters, alpha, rank):
            loss = _supervised_loss(model, batch, feats, mesh)
            grads = dict(zip(names, torch.autograd.grad(loss, [leaves[n] for n in names])))
        if mesh is not None:
            for name, g in grads.items():
                dp_all_reduce(local(g), mesh)
                if model_group is not None and name in partial:
                    dist.all_reduce(local(g), group=model_group)
        grad_norm = global_norm(grads.values())
        state.optimizer.step(grads)
        state.step += 1
        loss = dp_all_reduce(loss.detach(), mesh)
        return state, {"loss": loss, "grad_norm": grad_norm, "step": state.step}

    return step
