"""Optimizer with the JAX package's parameter groups
(cambrian_tpu/train/optimizer.py): separate learning rates for the projector
group, the vision-sampler group, the decoder ("base") and, when unfrozen, the
vision towers, on top of AdamW with no weight decay on tensors of fewer than
two dimensions.

Freeze policies:
- ``tune_mm_mlp_adapter`` (stage-1 pretraining): only mm_projector /
  vision_sampler* / vision_query / image_newline / pos_embed train;
- ``freeze_backbone``: the decoder is frozen, the connector trains;
- the vision towers train only under ``unfreeze_mm_vision_tower``.

Groups are found by parameter name, over the port's flax-mirroring names
(``mm_projector_aux_0.fc1.weight``, ``layers_3.mlp.up_proj.weight``; tower
parameters are named ``vision_towers.{i}.*``). A frozen parameter gets
``requires_grad_(False)`` and no optimizer state.

``GroupedAdamW`` is the update of the JAX package's optax chain
``clip_by_global_norm -> multi_transform({group: adamw(schedule)})``, step
for step: the global norm over the trainable gradients, Adam moments with
bias correction and ``eps`` outside the square root, the first moment
optionally stored in bf16 (the update uses it before it is rounded; b1
times the old moment is computed in bf16, as optax's weakly typed product
is), decay decoupled and scaled by the learning rate, the schedule read at
the count before the step. ``torch.optim.AdamW`` has no bf16-moment option. With
``accumulate = k`` it is ``optax.MultiSteps``: the running mean of k
micro-batch gradients, one update per k.

LoRA (train/lora.py) trains an adapter tree, labelled by the same rules under
the JAX package's paths of its leaves (``params/layers_0/mlp/up_proj/kernel/a``):
no path holds a connector key but the SVA samplers', so under
``tune_mm_mlp_adapter`` the decoder's adapters are "frozen" and never move.
The JAX LoRA step differentiates every adapter and clips by the norm of all
their gradients, frozen ones included (its ``set_to_zero`` comes after the
clip); ``frozen_in_norm`` gives that: frozen entries keep requiring grad, their
gradients count in the clip's norm, and they are never updated.

Trainable parameters stored in a lower precision than fp32 (a model built in
bf16) keep an fp32 master copy here, updated in fp32 and rounded into the
parameter after each step: the JAX package keeps fp32 parameters and casts
them to bf16 at use, which gives the same forward.

A sharded model's parameters are DTensors (``parallel/sharding.py``): the
masters, the bf16 ``mu`` and ``nu`` hold each rank's local shard, laid out
as the parameter is, as the JAX package shards ``opt_state``. The update is
elementwise, so it runs on the shards; only the clip's global norm needs
every rank (``global_norm``).
"""

import math
import re
from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional

import torch
from torch import nn


@dataclass
class TrainConfig:
    learning_rate: float = 1e-3
    mm_projector_lr: Optional[float] = None
    mm_vision_sampler_lr: Optional[float] = 1e-4
    mm_vision_tower_lr: Optional[float] = None
    weight_decay: float = 0.0
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    adam_mu_dtype: Optional[str] = None  # "bfloat16": store the first moment in bf16
    max_grad_norm: float = 1.0
    warmup_ratio: float = 0.06
    lr_scheduler_type: str = "cosine"
    total_steps: int = 1000
    # freeze policy
    tune_mm_mlp_adapter: bool = False
    freeze_backbone: bool = False
    unfreeze_mm_vision_tower: bool = False


# parameters trainable under tune_mm_mlp_adapter
_CONNECTOR_KEYS = (
    "mm_projector", "pos_embed", "vision_sampler", "vision_query", "image_newline",
)


def _group_of(name: str) -> str:
    if "vision_sampler" in name:
        return "vision_sampler"
    if any(k in name for k in ("mm_projector", "vision_query", "image_newline")):
        return "projector"
    if "vision_tower" in name:
        return "vision_tower"
    return "base"


def label_params(names, config: TrainConfig) -> Dict[str, str]:
    """{name: group label} for parameter names, "frozen" per the freeze
    policy."""
    labels = {}
    for name in names:
        group = _group_of(name)
        if config.tune_mm_mlp_adapter and not any(k in name for k in _CONNECTOR_KEYS):
            group = "frozen"
        elif config.freeze_backbone and group == "base":
            group = "frozen"
        if group == "vision_tower" and not config.unfreeze_mm_vision_tower:
            group = "frozen"
        labels[name] = group
    return labels


_NORM_PATH_RE = re.compile(r"norm|(^|_)ln\d*($|_)", re.IGNORECASE)


def is_norm_param(name: str) -> bool:
    return any(_NORM_PATH_RE.search(c) for c in name.split("."))


def cast_frozen_params(named_params: Mapping[str, nn.Parameter], config: TrainConfig,
                       dtype=torch.bfloat16) -> None:
    """Store the frozen fp32 parameters in ``dtype`` (bf16), in place: they
    receive no updates, and the compute casts to bf16 either way. Norm
    weights and biases are exempt: the norms apply them in fp32."""
    labels = label_params(named_params, config)
    for name, p in named_params.items():
        if labels[name] == "frozen" and p.dtype == torch.float32 and not is_norm_param(name):
            p.data = p.data.to(dtype)


def _schedule(peak_lr: float, config: TrainConfig) -> Callable[[int], float]:
    """Learning rate at an optimizer step count: linear warmup from 0 over
    ``warmup_ratio * total_steps`` steps (none: lr(0) = peak), then cosine to
    0, linear to 0, or constant (optax's warmup_cosine_decay_schedule and
    join_schedules of linear / constant schedules)."""
    total = config.total_steps
    warmup = int(config.warmup_ratio * total)

    def warm(count):
        if warmup <= 0:
            return 0.0
        return peak_lr * min(max(count, 0), warmup) / warmup

    if config.lr_scheduler_type == "cosine":
        decay = max(total, warmup + 1) - warmup

        def after(count):
            return peak_lr * 0.5 * (1 + math.cos(math.pi * min(count, decay) / decay))
    elif config.lr_scheduler_type == "linear":
        decay = total - warmup

        def after(count):
            if decay <= 0:
                return peak_lr
            return peak_lr * (1 - min(max(count, 0), decay) / decay)
    elif config.lr_scheduler_type == "constant":
        def after(count):
            return peak_lr
    else:
        raise ValueError(f"unknown scheduler {config.lr_scheduler_type}")
    return lambda count: warm(count) if count < warmup else after(count - warmup)


def group_lrs(config: TrainConfig) -> Dict[str, float]:
    return {
        "base": config.learning_rate,
        "projector": config.mm_projector_lr or config.learning_rate,
        "vision_sampler": config.mm_vision_sampler_lr or config.learning_rate,
        "vision_tower": config.mm_vision_tower_lr or config.learning_rate,
    }


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (sharing its storage), or the tensor itself."""
    return t._local_tensor if hasattr(t, "placements") else t


def _shard_share(t: torch.Tensor) -> float:
    """The part of the world's ranks over which a DTensor's elements are
    spread without repeats: (ranks sharding it) / (world size). Summing
    each rank's local squares times this counts every element once."""
    import torch.distributed as dist

    mesh = t.device_mesh
    shards = 1
    for i, pl in enumerate(t.placements):
        if not pl.is_replicate():       # Shard, or FSDP2's _StridedShard under TP
            shards *= mesh.size(i)
    return shards / dist.get_world_size()


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32. Over DTensors
    (a sharded model's gradients, on the 2-D TP+FSDP mesh or the FSDP one)
    each rank sums its local squares, weighted so that a replicated shard
    counts once, and one all-reduce over the world adds them: every rank
    gets the same norm, so the clip decision agrees."""
    tensors = list(tensors)
    if not any(hasattr(t, "placements") for t in tensors):
        return torch.sqrt(sum(t.float().square().sum() for t in tensors))
    import torch.distributed as dist

    total = sum(local(t).float().square().sum()
                * (_shard_share(t) if hasattr(t, "placements") else 1.0 / dist.get_world_size())
                for t in tensors)
    dist.all_reduce(total)
    return torch.sqrt(total)


class GroupedAdamW:
    """The JAX package's optimizer over named torch parameters (see the
    module docstring). ``step(grads)`` takes {name: gradient} of the
    trainable parameters (and, with ``frozen_in_norm``, of the frozen ones)
    and returns whether it updated them (always, unless accumulating)."""

    def __init__(self, named_params: Mapping[str, nn.Parameter], labels: Mapping[str, str],
                 config: TrainConfig, accumulate: int = 1, frozen_in_norm: bool = False):
        self.config = config
        self.labels = dict(labels)
        self.accumulate = max(1, accumulate)
        self.schedules = {g: _schedule(lr, config) for g, lr in group_lrs(config).items()}
        self.mu_dtype = getattr(torch, config.adam_mu_dtype) if config.adam_mu_dtype else None
        self.params: Dict[str, nn.Parameter] = {}
        self.state: Dict[str, Dict[str, torch.Tensor]] = {}
        # frozen entries whose gradients count in the clip's norm, and their
        # running means under accumulation
        self.norm_only: Dict[str, torch.Tensor] = {}
        self.norm_acc: Dict[str, torch.Tensor] = {}
        for name, p in named_params.items():
            if self.labels[name] == "frozen":
                if frozen_in_norm:
                    p.requires_grad_(True)
                    self.norm_only[name] = p
                    if self.accumulate > 1:
                        self.norm_acc[name] = torch.zeros_like(p, dtype=torch.float32)
                else:
                    p.requires_grad_(False)
                continue
            p.requires_grad_(True)
            self.params[name] = p
            # the local shard of a sharded parameter: the update is elementwise
            data = local(p.data)
            master = data if p.dtype == torch.float32 else data.float()
            st = {"master": master,
                  "mu": torch.zeros_like(master, dtype=self.mu_dtype or torch.float32),
                  "nu": torch.zeros_like(master)}
            if self.accumulate > 1:
                st["acc"] = torch.zeros_like(master)
            self.state[name] = st
        self.count = 0        # optimizer steps taken (the Adam and schedule count)
        self.mini_step = 0    # micro-batches accumulated toward the next step

    @torch.no_grad()
    def step(self, grads: Mapping[str, torch.Tensor]) -> bool:
        want = set(self.params) | set(self.norm_only)
        if set(grads) != want:
            raise KeyError(f"gradients for {sorted(set(grads) ^ want)[:5]} "
                           "do not match the trainable parameters")
        if self.accumulate > 1:
            n = self.mini_step
            for name, g in grads.items():
                acc = self.norm_acc[name] if name in self.norm_acc else self.state[name]["acc"]
                acc += (local(g).float() - acc) / (n + 1)
            self.mini_step = (n + 1) % self.accumulate
            if self.mini_step:
                return False
            grads = {name: st["acc"] for name, st in self.state.items()}
            grads.update(self.norm_acc)
        self._update(grads)
        if self.accumulate > 1:
            for acc in [st["acc"] for st in self.state.values()] + list(self.norm_acc.values()):
                acc.zero_()
        return True

    def _update(self, grads):
        c = self.config
        g_norm = global_norm(self._as_params(grads).values())
        grads = {name: g for name, g in grads.items() if name in self.params}
        clip = not bool(g_norm < c.max_grad_norm)
        count_inc = self.count + 1
        # bias corrections 1 - b^t computed in fp32, as optax does
        bc1 = float(1 - torch.tensor(c.adam_b1, dtype=torch.float32) ** count_inc)
        bc2 = float(1 - torch.tensor(c.adam_b2, dtype=torch.float32) ** count_inc)
        for name, g in grads.items():
            st = self.state[name]
            g = local(g).float()
            if clip:
                g = (g / g_norm) * c.max_grad_norm
            # b1 * mu runs in the stored moment's dtype, b1 rounded to it
            # first, as optax's weakly typed product does
            b1 = torch.tensor(c.adam_b1, dtype=st["mu"].dtype, device=g.device)
            mu = (1 - c.adam_b1) * g + (b1 * st["mu"]).float()
            nu = (1 - c.adam_b2) * (g * g) + c.adam_b2 * st["nu"]
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + c.adam_eps)
            master = st["master"]
            if master.dim() >= 2:
                u = u + c.weight_decay * master
            master += -self.schedules[self.labels[name]](self.count) * u
            st["mu"].copy_(mu)
            st["nu"].copy_(nu)
            self._write_param(name)
        self.count = count_inc

    def _write_param(self, name: str) -> None:
        """Round the master into its parameter (a no-op for an fp32 one,
        which is its own master)."""
        data, master = local(self.params[name].data), self.state[name]["master"]
        if data.data_ptr() != master.data_ptr():
            data.copy_(master)

    def _like_param(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """A local state tensor of parameter ``name`` as a DTensor laid out
        as the parameter (sharing ``t``'s storage); ``t`` itself for a
        plain parameter, or when it is a DTensor already."""
        p = self.params.get(name, self.norm_only.get(name))
        if not hasattr(p, "placements") or hasattr(t, "placements"):
            return t
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(t, p.device_mesh, p.placements, run_check=False,
                                  shape=p.shape, stride=p.stride())

    def _as_params(self, tensors: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {name: self._like_param(name, t) for name, t in tensors.items()}

    def state_dict(self) -> dict:
        """The state, each tensor laid out as its parameter (a DTensor under
        a mesh, sharing the local state's storage), for
        ``torch.distributed.checkpoint``."""
        return {"count": self.count, "mini_step": self.mini_step,
                "state": {n: {k: self._like_param(n, t) for k, t in st.items()}
                          for n, st in self.state.items()},
                "norm_acc": self._as_params(self.norm_acc)}

    def load_state_dict(self, sd: Mapping) -> None:
        if set(sd["state"]) != set(self.state):
            raise KeyError("optimizer state does not match the trainable parameters")
        self.count, self.mini_step = int(sd["count"]), int(sd["mini_step"])

        def copy(dst, src):
            src = local(src)
            if dst.data_ptr() != src.data_ptr():
                dst.copy_(src)

        for name, acc in self.norm_acc.items():
            copy(acc, sd["norm_acc"][name])
        for name, saved in sd["state"].items():
            for key, t in self.state[name].items():
                copy(t, saved[key])
            self._write_param(name)


def build_optimizer(named_params: Mapping[str, nn.Parameter], config: TrainConfig,
                    accumulate: int = 1, frozen_in_norm: bool = False):
    """(GroupedAdamW, {name: label}); frozen parameters stop requiring grad
    (unless ``frozen_in_norm``)."""
    labels = label_params(named_params, config)
    return GroupedAdamW(named_params, labels, config, accumulate, frozen_in_norm), labels
