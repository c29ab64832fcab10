"""Bridge from the JAX package's parameters to the port's ``state_dict``.

The port names its modules after the flax tree (``layers_3.self_attn.q_proj``),
so the mapping is mechanical, leaf by leaf:

- a Dense ``kernel`` [in, out] becomes ``weight`` [out, in];
- a Conv ``kernel`` HWIO becomes ``weight`` OIHW (the depthwise
  (7, 7, 1, C) becomes (C, 1, 7, 7));
- a norm's ``scale`` and an embedding's ``embedding`` become ``weight``;
- every other leaf keeps its name and shape.

``load_jax_params`` raises on any key left unused and on any parameter the
tree does not provide.
"""

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, name + "."))
        else:
            out[name] = v
    return out


def state_dict_from_jax(params: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Flax parameter tree (numpy or jax arrays; an outer ``{"params": ...}``
    is unwrapped) -> flat {port name: fp32 CPU tensor}."""
    if set(params) == {"params"}:
        params = params["params"]
    sd = {}
    for name, value in _flatten(params).items():
        arr = np.asarray(value, dtype=np.float32)
        head, _, leaf = name.rpartition(".")
        if leaf == "kernel":
            if arr.ndim == 2:
                arr = arr.T
            elif arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            else:
                raise ValueError(f"{name}: unexpected kernel rank {arr.ndim}")
            leaf = "weight"
        elif leaf in ("scale", "embedding"):
            leaf = "weight"
        key = f"{head}.{leaf}" if head else leaf
        sd[prefix + key] = torch.from_numpy(np.array(arr))  # a writable copy
    return sd


def load_state_dict_checked(module: nn.Module, sd: Mapping[str, torch.Tensor],
                            assign: bool = False) -> None:
    """``module.load_state_dict`` that names every unused and every missing
    key and casts each tensor to its parameter's dtype. With ``assign`` the
    (cast) tensors become the parameters, keeping their device: use it on a
    module built on the ``meta`` device."""
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
        cast[k] = v.to(dtype=p.dtype)
    module.load_state_dict(cast, strict=True, assign=assign)


def load_jax_params(module: nn.Module, params: Mapping, prefix: str = "") -> nn.Module:
    """Copy a flax parameter tree into ``module`` in place; returns it."""
    load_state_dict_checked(module, state_dict_from_jax(params, prefix))
    return module
