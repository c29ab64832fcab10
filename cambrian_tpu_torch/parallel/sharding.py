"""Name-based sharding rules (cambrian_tpu/parallel/sharding.py) and their
application to the port's modules.

``_rule_for`` and ``_fit_spec`` are the JAX package's rules as pure
functions over flax paths, shapes and axis sizes; a spec is a tuple with one
entry a dimension: an axis name, a tuple of axis names, or None.
``infer_param_shardings`` applies them to the port's parameter names, each
mapped to the flax leaf the bridge (``checkpoint/from_jax.py``) maps there, so
a Dense weight [out, in] takes the JAX kernel's [in, out] spec reversed.

``shard_model`` lays a model out on a (data, fsdp, model) ``DeviceMesh``:

- tensor parallelism on ``model`` (``parallelize_module``) where the rules
  put ``model`` on a Dense: column-parallel q/k/v/gate/up projections and
  ``fc1``, row-parallel o/down projections and ``fc2``. Attention takes it
  only where its head counts divide by the axis (``attention_tp``), so that
  each rank holds whole heads; otherwise that block stays replicated over
  ``model``. The JAX package shards any divisible width; the head-aligned
  rule is a layout difference kept on purpose. Each rank computes with its
  local heads: the modules read the head count from the projection's width.
- then ``fully_shard`` (FSDP2) of every decoder layer, every SVA sampler,
  every tower block and tower, and the root, over ``mesh["data", "fsdp"]``:
  sharded over fsdp, replicated over data (HSDP), as the JAX layout shards
  parameters over fsdp alone. FSDP2 shards dim 0 of each tensor wherever
  the JAX rule puts fsdp; no value changes. FSDP2 wants one dtype among a
  unit's trainable parameters, so a bf16 model's trainable fp32 norms,
  position tables and queries (or its bf16 Linears, where fp32 holds the
  unit) become units of their own (``fsdp_units``).
- the token embedding and the LM head (one tensor when tied) are in no
  FSDP2 unit: each is a DTensor laid out as the JAX rule says, V split
  over the (model, fsdp) ranks model-major and replicated over data
  (``parallel.distributed.VocabParallel``), or whole on every rank where V
  does not divide by model x fsdp. The model's lookup, head and loss then
  run vocab-parallel (``models/cambrian.py``): no rank holds the whole
  embedding, head, head gradient or whole-vocab logits of others' rows.
- a quantized model (``load_8bit`` / ``load_4bit``) takes the same rules:
  the JAX ``QuantDense`` leaves (``kernel_q`` [K, N], ``kernel_q4`` [K/2,
  N], ``scale`` [N] or [K/group, N], the fp32 ``bias``) keep their names
  and shapes in the port, so ``param_spec`` reads them as JAX does. Each
  split ``QuantLinear`` / ``QuantLinear4`` keeps its rank's slice
  (``shard_``), so the hand-written K3/K4/K4b kernels read local tensors; a
  row-parallel int4 one takes the axis only where every rank's K is whole
  scale groups (``_tp_plan``). Its int8 tensors stay buffers, whole on
  every (data, fsdp) rank: FSDP2 shards parameters only, and in the card's
  PyTorch (2.11) it cannot hold an integer one (it makes each sharded
  parameter require grad). The JAX layout shards ``kernel_q`` over fsdp.
- LoRA's adapter leaves (``<kernel path>/a`` [in, r], ``/b`` [r, out]) get
  the JAX specs from the same rules; ``train/lora.py`` lays the adapters
  themselves out like their linears (``model.tp_plan``).

Gradients are reduced as sums (divide factor 1): the train step divides the
summed token loss by the valid tokens of the whole global batch
(``train/train_step.py``), and sums the embedding's and the head's over
data itself (``VocabParallel.sum_grad``). The model's methods called from outside
``forward`` (``hidden_states``, ``supervised_loss``, ``prefill``,
``decode_step``) are registered with ``register_fsdp_forward_method``, so
FSDP2 gathers the parameters for them too.

``constrain`` (GSPMD activation constraints) has no counterpart: eager
PyTorch has no partitioner to steer.
"""

import re
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
from torch import nn

from .distributed import VocabParallel
from .mesh import axis_sizes

Spec = Tuple


def replicated(mesh=None) -> Spec:
    return ()


def batch_sharding(mesh=None, ndim: int = 2) -> Spec:
    """Shard the leading (batch) dim over data+fsdp."""
    return (("data", "fsdp"),) + (None,) * (ndim - 1)


# (substring match on the flattened flax path) -> spec; the JAX package's
# rules, Megatron layout: column-parallel in, row-parallel out
def _rule_for(path: str, shape: Tuple[int, ...]) -> Spec:
    if len(shape) <= 1:
        # biases / norms / vectors: shard long vectors over fsdp, else replicate
        return ("fsdp",) if shape and shape[0] >= 8192 else ()
    if "embed_tokens" in path and path.endswith("embedding"):
        return (("model", "fsdp"), None)
    if "lm_head" in path:
        return (None, ("model", "fsdp"))
    if any(k in path for k in ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj",
                               "fc1", "weights_in", "pwconv1")):
        return ("fsdp", "model")           # column parallel
    if any(k in path for k in ("o_proj", "out_proj", "down_proj", "fc2",
                               "weights_out", "pwconv2")):
        return ("model", "fsdp")           # row parallel
    if path.endswith("patch_embed/kernel") or "conv" in path.lower():
        return (None, None, None, "fsdp") if len(shape) == 4 else ()
    if "pos_embed" in path:
        return (None, "fsdp") if len(shape) == 2 else ()
    # generic ND: shard dim 0 over fsdp (the reference's shard_param_on_dim_0)
    return ("fsdp",) + (None,) * (len(shape) - 1)


def _fit_spec(spec: Spec, shape: Tuple[int, ...], sizes: Mapping[str, int]) -> Spec:
    """Drop axes whose size does not divide the corresponding dim."""
    fitted = []
    for dim_i, axis in enumerate(spec):
        if axis is None or dim_i >= len(shape):
            fitted.append(None)
            continue
        axes = axis if isinstance(axis, tuple) else (axis,)
        size = int(np.prod([sizes[a] for a in axes]))
        fitted.append(axis if shape[dim_i] % size == 0 else None)
    while len(fitted) < len(shape):
        fitted.append(None)
    return tuple(fitted[: len(shape)])


def _flax_leaf(name: str, shape: Tuple[int, ...]):
    """(flax path, flax shape, port dim -> flax dim) of a port parameter: the
    inverse of ``state_dict_from_jax``'s renaming and transposes."""
    parts = name.split(".")
    leaf, owner = parts[-1], parts[:-1]
    order = tuple(range(len(shape)))
    if leaf == "weight" and len(shape) == 2 and owner and owner[-1] == "embed_tokens":
        leaf = "embedding"
    elif leaf == "weight" and len(shape) == 2:
        leaf, order = "kernel", (1, 0)               # [out, in] <- [in, out]
    elif leaf == "weight" and len(shape) == 4:
        leaf, order = "kernel", (3, 2, 0, 1)         # OIHW <- HWIO
    elif leaf == "weight" and len(shape) == 1:
        leaf = "scale"
    flax_shape = tuple(shape[order.index(j)] for j in range(len(shape)))
    return "/".join(owner + [leaf]), flax_shape, order


def param_spec(name: str, shape: Tuple[int, ...], sizes: Mapping[str, int]) -> Spec:
    """The spec the JAX rules give the flax leaf of a port parameter, in the
    port's dimension order."""
    path, flax_shape, order = _flax_leaf(name, tuple(shape))
    spec = _fit_spec(_rule_for(path, flax_shape), flax_shape, sizes)
    return tuple(spec[j] for j in order)


def infer_param_shardings(named_tensors: Mapping, mesh) -> Dict[str, Spec]:
    """{name: spec} for named tensors (or shapes) under a ``DeviceMesh`` or
    a mapping of axis sizes. Works on any mapping whose names are the
    parameters' (so also on the optimizer's state, which mirrors them)."""
    sizes = axis_sizes(mesh)
    return {n: param_spec(n, tuple(getattr(t, "shape", t)), sizes)
            for n, t in named_tensors.items()}


def spec_of(tensor) -> Spec:
    """The spec a tensor holds: for a DTensor, the mesh axes sharding each
    dimension (outermost first); () for a plain tensor."""
    placements = getattr(tensor, "placements", None)
    if placements is None:
        return ()
    names = tensor.device_mesh.mesh_dim_names
    dims = [[] for _ in range(tensor.dim())]
    for axis, pl in zip(names, placements):
        if not pl.is_replicate():       # Shard, or FSDP2's _StridedShard under TP
            dims[pl.dim].append(axis)
    return tuple(None if not a else a[0] if len(a) == 1 else tuple(a) for a in dims)


# -- applying the rules ----------------------------------------------------

_COLUMN = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj", "fc1")
_ROW = ("o_proj", "down_proj", "fc2")
# a tower's repeated blocks: ViT ``blocks_3``, ConvNeXt ``stage_2_block_7``
_TOWER_BLOCK = re.compile(r"^((blocks|layers|resblocks)_\d+|stage_\d+_block_\d+)$")


def attention_tp(num_heads: int, num_kv_heads: int, tp: int) -> bool:
    """Whether an attention block takes tensor parallelism over ``tp``
    ranks: both head counts divide by it."""
    return tp > 1 and num_heads % tp == 0 and num_kv_heads % tp == 0


def local_kv_heads(cfg, mesh, model: Optional[nn.Module] = None) -> int:
    """The decoder's kv heads on one rank of ``mesh`` (the KV cache's). For
    a model ``shard_model`` laid out, read from its plan: its attention
    blocks hold a share of the heads only where the plan split them (an
    int4 block whose o_proj keeps its groups whole stays replicated)."""
    tp = axis_sizes(mesh)["model"] if mesh is not None else 1
    kvh = cfg.num_key_value_heads
    plan = getattr(model, "tp_plan", None)
    if plan is not None:
        split = any(name.endswith("self_attn.k_proj") for name in plan)
        return kvh // tp if split else kvh
    return kvh // tp if attention_tp(cfg.num_attention_heads, kvh, tp) else kvh


def _on_model(axis) -> bool:
    return axis == "model" or (isinstance(axis, tuple) and "model" in axis)


def _quantized(mod: nn.Module) -> bool:
    from ..ops.quant import QuantLinear, QuantLinear4

    return isinstance(mod, (QuantLinear, QuantLinear4))


def _linear_axes(name: str, mod: nn.Module, sizes: Mapping[str, int]) -> Tuple:
    """(in-axis, out-axis) the rules give a Dense: of the weight [out, in]
    of an ``nn.Linear``, of ``kernel_q`` [K, N] or ``kernel_q4`` [K/2, N] of
    a quantized linear (the JAX ``QuantDense``/``QuantDense4`` leaves)."""
    if type(mod) is nn.Linear:
        out_axis, in_axis = param_spec(name + ".weight", tuple(mod.weight.shape), sizes)
        return in_axis, out_axis
    leaf = mod._WEIGHT
    return param_spec(f"{name}.{leaf}", tuple(getattr(mod, leaf).shape), sizes)


def _tp_plan(model: nn.Module, sizes: Mapping[str, int]) -> Dict[str, str]:
    """{linear's name: "column" | "row"} for the Dense weights, plain or
    quantized, the rules shard over ``model``, attention blocks whose heads
    do not divide by the axis left out. A row-parallel int4 linear takes the
    axis only where every rank's K is whole scale groups (its scale rows
    divide by the axis); otherwise it and its partners stay replicated."""
    from ..models.language.llama import LlamaAttention
    from ..models.sva import CrossAttention, MultiKVCrossAttention

    tp = sizes["model"]
    skip = []
    for name, mod in model.named_modules():
        if isinstance(mod, LlamaAttention):
            heads = (mod.cfg.num_attention_heads, mod.cfg.num_key_value_heads)
        elif isinstance(mod, (MultiKVCrossAttention, CrossAttention)):
            heads = (mod.num_heads, mod.num_heads)
        else:
            continue
        if not attention_tp(*heads, tp):
            skip.append(name + ".")
    plan = {}
    for name, mod in model.named_modules():
        if not (type(mod) is nn.Linear or _quantized(mod)) or any(
                name.startswith(s) for s in skip):
            continue
        last = name.rsplit(".", 1)[-1]
        in_axis, out_axis = _linear_axes(name, mod, sizes)
        if any(last.startswith(k) for k in _COLUMN) and _on_model(out_axis):
            plan[name] = "column"
        elif any(last.startswith(k) for k in _ROW) and _on_model(in_axis) and (
                not hasattr(mod, "kernel_q4") or mod.scale.shape[0] % tp == 0):
            plan[name] = "row"
    # a column-parallel Dense feeds its row-parallel partner: keep pairs whole
    for name in list(plan):
        owner = name.rsplit(".", 1)[0]
        partners = [n for n in plan if n.rsplit(".", 1)[0] == owner]
        if {plan[n] for n in partners} != {"column", "row"}:
            for n in partners:
                plan.pop(n, None)
    return plan


def _apply_tp(model: nn.Module, plan: Mapping[str, str], mesh) -> None:
    """Lay out the plan's linears on ``mesh["model"]``: ``nn.Linear``s through
    ``parallelize_module`` (DTensor weights), quantized ones by keeping each
    rank's slice of its tensors (``shard_``): the hand-written kernels read
    the local tensors."""
    from torch.distributed.tensor.parallel import (
        ColwiseParallel,
        RowwiseParallel,
        parallelize_module,
    )

    modules = dict(model.named_modules())
    tp_mesh = mesh["model"]
    styles = {n: ColwiseParallel() if kind == "column" else RowwiseParallel()
              for n, kind in plan.items() if type(modules[n]) is nn.Linear}
    if styles:
        parallelize_module(model, tp_mesh, styles)
    rank, size, group = tp_mesh.get_local_rank(), tp_mesh.size(), tp_mesh.get_group()
    for name, kind in plan.items():
        if _quantized(modules[name]):
            modules[name].shard_(kind, rank, size, group)


def _walk(module: nn.Module, done: set):
    """``module`` and its submodules outside the units already planned."""
    yield module
    for child in module.children():
        if id(child) not in done:
            yield from _walk(child, done)


def _direct_dtypes(module: nn.Module, ignored: frozenset = frozenset()) -> set:
    """The dtypes of the trainable parameters a module holds itself, those
    in ``ignored`` (ids) left out."""
    return {p.dtype for p in module.parameters(recurse=False)
            if p.requires_grad and id(p) not in ignored}


def _plan_unit(module: nn.Module, done: set, order: list,
               ignored: frozenset = frozenset()) -> None:
    """Plan ``module`` as an FSDP2 unit, after the units it needs below it.

    FSDP2 wants one dtype among a unit's trainable parameters, and the port
    trains a bf16 model's Linears in bf16 beside fp32 norms, position
    tables and queries. So the unit takes the dtype of the parameters it
    holds itself (else the dtype of most of its trainable elements), and
    every module below it whose own trainable parameters are of another
    dtype becomes a unit of its own, planned first. Parameters in
    ``ignored`` (ids) count nowhere."""
    direct = _direct_dtypes(module, ignored)
    if len(direct) > 1:
        raise ValueError(f"{type(module).__name__} holds trainable parameters of "
                         f"dtypes {direct}: FSDP2 cannot shard it as one unit")
    if direct:
        home = next(iter(direct))
    else:
        sizes: dict = {}
        for sub in _walk(module, done):
            for p in sub.parameters(recurse=False):
                if p.requires_grad and id(p) not in ignored:
                    sizes[p.dtype] = sizes.get(p.dtype, 0) + p.numel()
        home = max(sizes, key=sizes.get) if sizes else None
    if home is not None:
        for child in module.children():
            _split(child, home, done, order, ignored)
    order.append(module)
    done.add(id(module))


def _split(module: nn.Module, home, done: set, order: list, ignored: frozenset) -> None:
    if id(module) in done:
        return
    direct = _direct_dtypes(module, ignored)
    if direct and direct != {home}:
        _plan_unit(module, done, order, ignored)
        return
    for child in module.children():
        _split(child, home, done, order, ignored)


def fsdp_units(model: nn.Module, towers: Sequence[nn.Module] = (),
               ignored: Sequence[nn.Parameter] = ()) -> list:
    """The modules ``shard_model`` wraps with ``fully_shard``, inner ones
    first: every tower block and tower, every decoder layer and SVA
    sampler, the root, and below each the modules that keep its trainable
    parameters of one dtype (``_plan_unit``); the ``ignored`` parameters
    (the vocab-parallel embedding and head) count in no unit. Reads
    ``requires_grad``: plan after the freeze."""
    done: set = set()
    order: list = []
    skip = frozenset(id(p) for p in ignored)
    for tower in towers:
        for block in _tower_blocks(tower):
            _plan_unit(block, done, order)
        _plan_unit(tower, done, order)
    for name, child in model.named_children():
        if name.startswith(("layers_", "vision_sampler_")):
            _plan_unit(child, done, order)
    _plan_unit(model, done, order, skip)
    return order


def _tower_blocks(tower: nn.Module) -> Sequence[nn.Module]:
    """A tower's repeated blocks, innermost first (FSDP2 wraps bottom up)."""
    found = [(name.count("."), mod) for name, mod in tower.named_modules()
             if name and _TOWER_BLOCK.match(name.rsplit(".", 1)[-1])]
    return [mod for _, mod in sorted(found, key=lambda x: -x[0])]


FORWARD_METHODS = ("hidden_states", "supervised_loss", "prefill", "decode_step")

VOCAB_PARAMS = ("embed_tokens", "lm_head")


def vocab_params(model: nn.Module) -> list:
    """The token embedding's and the LM head's weights (one when tied)."""
    return [getattr(model, name).weight for name in VOCAB_PARAMS if hasattr(model, name)]


def _distribute_vocab(model: nn.Module, mesh) -> VocabParallel:
    """Replace the embedding's and the head's weights by DTensors of the
    vocab-parallel layout (``requires_grad`` kept); the model's lookup,
    head and loss read ``model.vocab_layout``."""
    layout = VocabParallel(mesh, model.cfg.vocab_size)
    for name in VOCAB_PARAMS:
        module = getattr(model, name, None)
        if module is not None:
            p = module.weight
            module.weight = nn.Parameter(layout.distribute(p), requires_grad=p.requires_grad)
    model.vocab_layout = layout
    return layout


def shard_model(model: nn.Module, towers: Sequence[nn.Module] = (), mesh=None) -> Optional[list]:
    """Lay ``model`` (a ``CambrianLM``, full precision or quantized) and
    ``towers`` out on ``mesh`` in place, as the module docstring says.
    Returns the FSDP2 modules, or None (and changes nothing) when ``mesh``
    is None. The plan of tensor parallelism is kept as ``model.tp_plan``
    ({linear's name: "column" | "row"}; empty where ``model`` is 1)."""
    if mesh is None:
        return None
    from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method

    for module in [model, *towers]:
        for p in module.parameters():
            if not p.is_contiguous():       # FSDP2 shards contiguous storage only
                p.data = p.data.contiguous()
    sizes = axis_sizes(mesh)
    plan = _tp_plan(model, sizes) if sizes["model"] > 1 else {}
    if plan:
        _apply_tp(model, plan, mesh)
    model.tp_plan = plan
    _distribute_vocab(model, mesh)
    ignored = set(vocab_params(model))
    dp_mesh = mesh["data", "fsdp"]
    units = [fully_shard(m, mesh=dp_mesh, ignored_params=ignored)
             for m in fsdp_units(model, towers, ignored)]
    for unit in units:
        unit.set_gradient_divide_factor(1.0)
        unit.set_force_sum_reduction_for_comms(True)    # gloo has no pre-scaled sum
    for method in FORWARD_METHODS:
        register_fsdp_forward_method(model, method)
    return units


def fsdp_unit_params(model: nn.Module) -> list:
    """The parameters every FSDP2 unit under ``model`` manages (gathers,
    reshards, reduces): to check that the vocab-parallel ones are in none."""
    from torch.distributed.fsdp import FSDPModule

    out = []
    for module in model.modules():
        if isinstance(module, FSDPModule):
            state = module._get_fsdp_state()
            groups = getattr(state, "_fsdp_param_groups", None)
            if groups is None:                  # older PyTorch: one group a unit
                groups = [g for g in [state._fsdp_param_group] if g is not None]
            out.extend(fp.sharded_param for g in groups for fp in g.fsdp_params)
    return out
