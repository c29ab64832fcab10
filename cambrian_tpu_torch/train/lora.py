"""LoRA: low-rank adapters over projection weights (cambrian_tpu/train/lora.py).

Adapters are kept apart from the model, as the JAX package keeps them apart
from its parameter tree: ``{key: {"a": [in, r], "b": [r, out]}}`` of fp32
tensors, one entry a targeted projection. ``key`` is the flax path of the
projection's kernel, the name the JAX package gives it
(``params/layers_3/self_attn/q_proj/kernel``), and ``a`` / ``b`` keep its
``[in, r]`` / ``[r, out]`` layout, so a file either package writes loads in
the other. The port's projection is an ``nn.Linear`` whose ``weight`` is the
transposed kernel, ``[out, in]``, named after the same path
(``layers_3.self_attn.q_proj``).

- A projection is targeted when its kernel's path holds one of ``targets``
  (a substring, as in the JAX package: the SVA samplers' ``q_proj``,
  ``k_proj_0``, ``v_proj_0`` and ``o_proj`` are targeted too).
- The merged weight is ``W + ((a @ b) * alpha / r)`` with the product cast to
  W's dtype before the sum, as the JAX package merges.
- Training differentiates the adapters alone: ``lora_merged`` makes each
  targeted linear merge its weight inside its own forward, so under remat
  (each decoder layer in ``torch.utils.checkpoint``) a merged weight lives
  only while its layer runs, and no merged copy of the model is built.
- ``merge_lora`` folds adapters into the model for export, after which the
  checkpoint is that of a full finetune.

The default init draws ``a`` from a ``torch.Generator``; the JAX package
draws it with ``jax.random``, which the port cannot reproduce, so the two
default inits differ. Given the same adapters the two packages agree.

On a (data, fsdp, model) mesh (``parallel/``), the base laid out by
``shard_model``, ``distribute_adapters`` makes each factor a DTensor laid
out like its linear's weight: replicated over data and fsdp; over model, B's
N columns split where the linear is column-parallel and A's K rows where it
is row-parallel (``lora_layout``), the other factor whole. Every rank draws
the same whole adapters from the seed first. The merged forward reads the
weight FSDP2 gathered for the layer (a DTensor over model under tensor
parallelism) and adds the rank's part of the delta; ``lora_state_dict`` and
``merge_lora`` work on whole tensors (every rank takes part).
"""

import contextlib
from typing import Callable, Dict, Iterator, Mapping, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

DEFAULT_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj",
                   "gate_proj", "up_proj", "down_proj")

Adapters = Dict[str, Dict[str, torch.Tensor]]


def _targeted(key: str, targets: Sequence[str]) -> bool:
    return key.endswith("kernel") and any(t in key for t in targets)


def kernel_key(module_name: str) -> str:
    """The JAX package's path of the kernel of the port's linear
    ``module_name`` (``layers_0.mlp.up_proj`` ->
    ``params/layers_0/mlp/up_proj/kernel``)."""
    return "params/" + module_name.replace(".", "/") + "/kernel"


def weight_name(key: str) -> str:
    """The port's parameter name of the kernel at ``key`` (the inverse of
    ``kernel_key``, with ``.weight``)."""
    return key[len("params/"):-len("/kernel")].replace("/", ".") + ".weight"


def _linears(model: nn.Module) -> Dict[str, nn.Linear]:
    """{kernel key: linear} of every ``nn.Linear`` of the model."""
    return {kernel_key(name): m for name, m in model.named_modules() if isinstance(m, nn.Linear)}


def lora_targets(model: nn.Module, targets: Sequence[str] = DEFAULT_TARGETS
                 ) -> Dict[str, nn.Linear]:
    """{kernel key: linear} of the model's targeted projections."""
    return {key: m for key, m in _linears(model).items() if _targeted(key, targets)}


def init_lora_params(model: nn.Module, rank: int, generator: torch.Generator,
                     targets: Sequence[str] = DEFAULT_TARGETS) -> Adapters:
    """Adapters for each targeted projection [in, out]: a ~ N(0, 1) / r of
    shape [in, r], drawn from ``generator`` on its device, and b = 0 of shape
    [r, out] (the merged weight starts as the base)."""
    adapters = {}
    for key, linear in lora_targets(model, targets).items():
        out_features, in_features = linear.weight.shape
        a = torch.randn((in_features, rank), generator=generator, device=generator.device,
                        dtype=torch.float32) / rank
        b = torch.zeros((rank, out_features), dtype=torch.float32, device=generator.device)
        adapters[key] = {"a": a, "b": b}
    return adapters


def _part(t: torch.Tensor) -> torch.Tensor:
    """A factor's local part (differentiable), or the factor itself."""
    return t.to_local() if hasattr(t, "placements") else t


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered whole (every rank takes part), or the tensor."""
    return t.full_tensor() if hasattr(t, "placements") else t


def merged_weight(w: torch.Tensor, adapter: Mapping[str, torch.Tensor], alpha: float,
                  rank: int) -> torch.Tensor:
    """``w + delta^T`` for an ``nn.Linear`` weight ``w`` [out, in]: the
    kernel's update ``delta = (a @ b) * alpha / rank`` in the adapters'
    dtype, cast to ``w``'s dtype before the sum. A tensor-parallel ``w`` (a
    DTensor over the model axis, as FSDP2 gathers it for the forward) takes
    the delta of the adapters' local parts, laid out as ``w`` is."""
    delta = (_part(adapter["a"]) @ _part(adapter["b"])) * (alpha / rank)
    delta = delta.to(device=w.device, dtype=w.dtype).t()
    if hasattr(w, "placements"):
        from torch.distributed.tensor import DTensor

        delta = DTensor.from_local(delta, w.device_mesh, w.placements, run_check=False)
    return w + delta


def apply_lora(params: Mapping[str, torch.Tensor], adapters: Adapters, alpha: float,
               rank: int) -> Dict[str, torch.Tensor]:
    """A state dict with the targeted weights merged; other entries pass
    through untouched."""
    out = dict(params)
    for key, adapter in adapters.items():
        name = weight_name(key)
        out[name] = merged_weight(params[name], adapter, alpha, rank)
    return out


@torch.no_grad()
def merge_lora(model: nn.Module, adapters: Adapters, alpha: float, rank: int) -> nn.Module:
    """Fold the adapters into the model's weights, in place (the export).
    On a sharded model (``shard_model``) each weight is gathered whole,
    merged with the whole adapters, and each rank keeps its shard of the
    result; every rank takes part."""
    linears = _linears(model)
    for key, adapter in adapters.items():
        w = linears[key].weight
        whole = {part: _whole(t) for part, t in adapter.items()}
        if not hasattr(w, "placements"):
            w.copy_(merged_weight(w, whole, alpha, rank))
            continue
        from torch.distributed.tensor import distribute_tensor

        merged = merged_weight(w.full_tensor(), whole, alpha, rank)
        shard = distribute_tensor(merged, w.device_mesh, w.placements, src_data_rank=None)
        w.to_local().copy_(shard.to_local())
    return model


def lora_state_dict(adapters: Adapters) -> Dict[str, torch.Tensor]:
    """Flat ``{<kernel key>.lora_a: [in, r], <kernel key>.lora_b: [r, out]}``
    of whole, contiguous CPU tensors, the JAX package's file layout (from
    DTensor adapters every rank takes part)."""
    out = {}
    for key, adapter in adapters.items():
        out[f"{key}.lora_a"] = _whole(adapter["a"].detach()).cpu().contiguous()
        out[f"{key}.lora_b"] = _whole(adapter["b"].detach()).cpu().contiguous()
    return out


def lora_from_state_dict(sd: Mapping, device=None) -> Adapters:
    """Adapters from a flat mapping of ``lora_state_dict``'s keys (numpy
    arrays or tensors), as fp32 tensors on ``device``."""
    adapters: Adapters = {}
    for k, v in sd.items():
        for suffix, part in ((".lora_a", "a"), (".lora_b", "b")):
            if k.endswith(suffix):
                t = torch.as_tensor(v).to(device=device, dtype=torch.float32)
                adapters.setdefault(k[:-len(suffix)], {})[part] = t
    return adapters


def lora_layout(model: nn.Module) -> Dict[str, Optional[str]]:
    """{kernel key: "column" | "row" | None} of every ``nn.Linear``: how
    ``shard_model`` split it over the model axis (``model.tp_plan``)."""
    plan = getattr(model, "tp_plan", None) or {}
    return {kernel_key(name): plan.get(name) for name, m in model.named_modules()
            if isinstance(m, nn.Linear)}


# the factor a parallel linear splits over the model axis, and its dim
_SPLIT = {"column": ("b", 1), "row": ("a", 0)}


def model_partial(kind: Optional[str], part: str) -> bool:
    """Whether factor ``part`` of an adapter on a linear split ``kind`` over
    the model axis is whole on every rank while each rank's gradient of it
    is a partial sum (A of a column-parallel linear, B of a row-parallel
    one): the gradient is summed over the model axis."""
    return kind is not None and _SPLIT[kind][0] != part


def distribute_adapters(adapters: Adapters, model: nn.Module, mesh) -> Adapters:
    """Whole adapters, the same on every rank, as DTensors on ``mesh`` laid
    out like their linears' weights (``lora_layout``; the module
    docstring): each rank keeps its slice, with no communication."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    layout = lora_layout(model)
    out: Adapters = {}
    for key, adapter in adapters.items():
        split = _SPLIT.get(layout.get(key))
        out[key] = {}
        for part, t in adapter.items():
            placements = [Shard(split[1]) if axis == "model" and split and split[0] == part
                          else Replicate() for axis in mesh.mesh_dim_names]
            out[key][part] = distribute_tensor(t.detach(), mesh, placements, src_data_rank=None)
    return out


def flat_adapters(adapters: Adapters) -> Dict[str, torch.Tensor]:
    """{``<kernel key>/a``: a, ``<kernel key>/b``: b}: the adapter tree's
    leaves under the paths the JAX package's optimizer labels them by."""
    return {f"{key}/{part}": t for key, adapter in adapters.items()
            for part, t in adapter.items()}


@contextlib.contextmanager
def lora_merged(model: nn.Module, adapters: Adapters, alpha: float, rank: int) -> Iterator[None]:
    """Within the block, each targeted linear of ``model`` computes
    ``F.linear(x, W + delta^T, bias)``, its merged weight built inside its
    own forward (so autograd reaches the adapters, and remat recomputes the
    merged weight instead of keeping it). Run the backward inside the block
    too: remat's recomputation calls the same forwards. On a sharded model
    ``W`` is read when the forward runs: the weight FSDP2 gathered for the
    layer, and under tensor parallelism the rank's DTensor shard, which the
    layout's hooks around the forward feed and read."""
    linears = _linears(model)
    missing = sorted(set(adapters) - set(linears))
    if missing:
        raise KeyError(f"adapters for projections the model lacks: {missing[:5]}")

    def merged_forward(linear, adapter):
        def forward(x):
            return F.linear(x, merged_weight(linear.weight, adapter, alpha, rank), linear.bias)
        return forward

    patched = []
    try:
        for key, adapter in adapters.items():
            linear = linears[key]
            linear.forward = merged_forward(linear, adapter)
            patched.append(linear)
        yield
    finally:
        for linear in patched:
            del linear.forward


def make_lora_loss_fn(model: nn.Module, alpha: float, rank: int,
                      loss_fn: Callable[..., torch.Tensor]) -> Callable[..., torch.Tensor]:
    """Wrap ``loss_fn(*args)`` (which runs ``model``) so that it runs on the
    merged weights of the adapters given first: ``wrapped(adapters, *args)``;
    autograd then reaches the adapters and the base stays as it is. Under
    remat, differentiate inside ``lora_merged`` (as ``make_lora_train_step``
    does), or the recomputation runs the base weights."""

    def wrapped(adapters: Adapters, *args, **kwargs):
        with lora_merged(model, adapters, alpha, rank):
            return loss_fn(*args, **kwargs)

    return wrapped
