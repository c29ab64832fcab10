"""Bridge from the JAX package's parameters to the port's ``state_dict``.

The port names its modules after the flax tree (``layers_3.self_attn.q_proj``),
so the mapping is mechanical, leaf by leaf:

- a Dense ``kernel`` [in, out] becomes ``weight`` [out, in];
- a Conv ``kernel`` HWIO becomes ``weight`` OIHW (the depthwise
  (7, 7, 1, C) becomes (C, 1, 7, 7));
- a norm's ``scale`` and an embedding's ``embedding`` become ``weight``;
- a quantized Dense (one that holds ``kernel_q`` or ``kernel_q4``) keeps
  its leaves as they are: names (its ``scale`` stays ``scale``), shapes and
  the int8 dtype of the packed weights;
- every other leaf keeps its name and shape (BEiT's ``rel_pos_table``,
  SAM's ``rel_pos_h`` / ``rel_pos_w``, SD-2.1's ``empty_prompt_embeds``);
- a list of trees (the hybrid tower's, one a sub-tower) numbers its items:
  ``[a, b]`` under ``module.`` gives ``module.0.*`` and ``module.1.*``.

GroupNorm (SD-2.1's, under its ``gn`` child) and LayerNorm take the ``scale``
rule; SAM's ``ChannelLayerNorm`` already names its leaves ``weight`` and
``bias``. The VAE's, the UNet's and SAM's neck convolutions take the HWIO
rule.

Float leaves become fp32 and integer leaves keep their dtype.

``load_jax_params`` raises on any key left unused and on any parameter the
tree does not provide.
"""

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    items = tree.items() if isinstance(tree, Mapping) else enumerate(tree)
    out = {}
    for k, v in items:
        name = f"{prefix}{k}"
        if isinstance(v, (Mapping, list)):
            out.update(_flatten(v, name + "."))
        else:
            out[name] = v
    return out


def state_dict_from_jax(params, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Flax parameter tree (numpy or jax arrays; an outer ``{"params": ...}``
    is unwrapped; a list of trees numbers its items) -> flat {port name: CPU
    tensor}, fp32 for float leaves."""
    if isinstance(params, Mapping) and set(params) == {"params"}:
        params = params["params"]
    flat = _flatten(params)
    sd = {}
    for name, value in flat.items():
        arr = np.asarray(value)
        if not np.issubdtype(arr.dtype, np.integer):
            arr = arr.astype(np.float32, copy=False)    # np.array below copies
        head, _, leaf = name.rpartition(".")
        quantized = f"{head}.kernel_q" in flat or f"{head}.kernel_q4" in flat
        if leaf == "kernel":
            if arr.ndim == 2:
                arr = arr.T
            elif arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            else:
                raise ValueError(f"{name}: unexpected kernel rank {arr.ndim}")
            leaf = "weight"
        elif leaf == "embedding" or (leaf == "scale" and not quantized):
            leaf = "weight"
        key = f"{head}.{leaf}" if head else leaf
        sd[prefix + key] = torch.from_numpy(np.array(arr))  # a writable copy
    return sd


def load_state_dict_checked(module: nn.Module, sd: Mapping[str, torch.Tensor],
                            assign: bool = False) -> None:
    """``module.load_state_dict`` that names every unused and every missing
    key and casts each float tensor to its parameter's dtype; an integer
    tensor (quantized weights) must match its buffer's dtype exactly, and
    nothing is cast between integer and float. With ``assign`` the (cast)
    tensors become the parameters and buffers, keeping their device: use it
    on a module built on the ``meta`` device."""
    own = module.state_dict(keep_vars=True)
    unused = sorted(set(sd) - set(own))
    missing = sorted(set(own) - set(sd))
    if unused or missing:
        raise KeyError(f"state dict does not match {type(module).__name__}: "
                       f"unused {unused[:20]}{'...' if len(unused) > 20 else ''}, "
                       f"missing {missing[:20]}{'...' if len(missing) > 20 else ''}")
    cast = {}
    for k, v in sd.items():
        p = own[k]
        if tuple(v.shape) != tuple(p.shape):
            raise ValueError(f"{k}: shape {tuple(v.shape)} != {tuple(p.shape)}")
        if v.dtype != p.dtype and not (v.is_floating_point() and p.is_floating_point()):
            raise TypeError(f"{k}: dtype {v.dtype} does not load into {p.dtype}")
        cast[k] = v.to(dtype=p.dtype)
    module.load_state_dict(cast, strict=True, assign=assign)


def load_jax_params(module: nn.Module, params, prefix: str = "") -> nn.Module:
    """Copy a flax parameter tree into ``module`` in place; returns it."""
    load_state_dict_checked(module, state_dict_from_jax(params, prefix))
    return module
