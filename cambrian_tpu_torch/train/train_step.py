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
features are detached, and only the adapters get gradients.
"""

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Sequence

import torch
from torch import nn

from ..models.cambrian import (
    CambrianLM,
    chunked_cross_entropy,
    cross_entropy_loss,
    extract_head,
    head_logits,
)
from .lora import Adapters, flat_adapters, lora_merged
from .optimizer import GroupedAdamW, TrainConfig, build_optimizer, global_norm, label_params


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


def _supervised_loss(model: CambrianLM, batch: Mapping, aux_features) -> torch.Tensor:
    """Shifted CE over the batch, honoring ``cfg.loss_chunk``."""
    chunk = model.cfg.loss_chunk
    args = (batch["input_ids"], batch["attention_mask"], batch["position_ids"], aux_features,
            batch.get("aux_masks"))
    if chunk:
        cfg = model.cfg
        return chunked_cross_entropy(model.hidden_states(*args), batch["labels"],
                                     lambda hd, hc: head_logits(cfg, hd, hc), chunk,
                                     extract_head(cfg, model))
    return cross_entropy_loss(model(*args), batch["labels"])


def make_train_step(model: CambrianLM, towers: Optional[Sequence[nn.Module]] = None,
                    train_towers: bool = False, freeze: Optional[TrainConfig] = None):
    """Returns ``step(state, batch) -> (state, metrics)`` with metrics
    ``loss``, ``grad_norm`` (of this micro-batch's trainable gradients) and
    ``step``, as device tensors and an int.

    ``batch``: input_ids, labels, attention_mask, position_ids, images (per
    tower, NCHW), aux_masks (per tower), tensors on the model's device.
    ``freeze``: when given, the freeze policy is applied to ``requires_grad``
    first."""
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
        loss = _supervised_loss(model, batch, encode(batch.get("images")))
        loss.backward()
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in params.items()}
        grad_norm = global_norm(grads.values())
        state.optimizer.step(grads)
        for p in params.values():
            p.grad = None
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": grad_norm, "step": state.step}

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
                         adapters: Adapters, alpha: float, rank: int):
    """Returns ``step(state, batch) -> (state, metrics)`` over the adapters
    of ``state`` (``init_lora_train_state``), as ``make_train_step`` does.
    The base model and the towers are frozen (no parameter of theirs
    requires grad); each targeted linear merges its weight with its adapters
    inside its forward (``lora_merged``), so under remat the merged weights
    stay transient. ``grad_norm`` is over every adapter's gradient."""
    model.requires_grad_(False)
    for t in towers or ():
        t.requires_grad_(False)
    leaves = flat_adapters(adapters)

    def step(state: TrainState, batch: Mapping):
        names = list(state.optimizer.params) + list(state.optimizer.norm_only)
        feats = None
        if towers is not None and batch.get("images") is not None:
            with torch.no_grad():
                feats = [t(px) for t, px in zip(towers, batch["images"])]
        # the backward too runs merged: remat recomputes each layer's forward
        with lora_merged(model, adapters, alpha, rank):
            loss = _supervised_loss(model, batch, feats)
            grads = dict(zip(names, torch.autograd.grad(loss, [leaves[n] for n in names])))
        grad_norm = global_norm(grads.values())
        state.optimizer.step(grads)
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": grad_norm, "step": state.step}

    return step
