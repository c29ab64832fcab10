"""Checkpoint writing (cambrian_tpu/checkpoint/save.py): an HF-layout
directory (config.json + safetensors) with the published parameter names,
which ``models/builder.py::load_pretrained_model`` and the JAX package's
loader read back.

The port's module is first turned into the JAX package's parameter tree
(``module_params_tree``, the inverse of ``from_jax.state_dict_from_jax``),
then named by the port's ``hf_llm.export_cambrian`` and written by the
port's own ``safetensors_io`` (no ``safetensors`` package needed).
"""

import json
import os
from typing import Any, Optional

from torch import nn

from ..models.config import CambrianConfig
from ..ops.norms import LayerNorm
from .hf_llm import export_cambrian
from .safetensors_io import save_sharded

_REVERSE_MODEL_TYPE = {
    "llama": "cambrian_llama",
    "phi3": "cambrian_phi3",
    "mistral": "cambrian_mistral",
    "gemma": "cambrian_gemma",
    "cohere": "cambrian_cohere",
}


def _leaves(mod: nn.Module, params: dict) -> dict:
    """A module's own parameters under the flax leaf names, as fp32 numpy."""
    arr = {k: v.detach().float().cpu().numpy() for k, v in params.items()}
    if isinstance(mod, nn.Linear):
        out = {"kernel": arr["weight"].T}
    elif isinstance(mod, nn.Conv2d):
        out = {"kernel": arr["weight"].transpose(2, 3, 1, 0)}    # OIHW -> HWIO
    elif isinstance(mod, nn.Embedding):
        out = {"embedding": arr["weight"]}
    elif isinstance(mod, LayerNorm):
        out = {"scale": arr["weight"]}
    else:
        return arr
    if "bias" in arr:
        out["bias"] = arr["bias"]
    return out


def module_params_tree(module: nn.Module) -> dict:
    """The JAX package's parameter tree of a port module (a Dense ``kernel``
    [in, out], a LayerNorm ``scale``, an Embed ``embedding``; RMSNorm and
    free parameters keep their names), fp32 numpy leaves."""
    tree: dict = {}
    for name, mod in module.named_modules():
        params = dict(mod.named_parameters(recurse=False))
        if not params:
            continue
        node = tree
        for part in name.split(".") if name else []:
            node = node.setdefault(part, {})
        node.update(_leaves(mod, params))
    return tree


def save_config(config: CambrianConfig, path: str) -> None:
    """Write ``config.json`` with the published ``model_type``
    (``cambrian_llama``, ``cambrian_phi3``, ...)."""
    os.makedirs(path, exist_ok=True)
    raw = config.to_dict()
    raw["model_type"] = _REVERSE_MODEL_TYPE.get(config.model_type, config.model_type)
    raw["architectures"] = ["CambrianLlamaForCausalLM"]
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(raw, f, indent=2, sort_keys=True)


def save_pretrained(model: Any, config: CambrianConfig, path: str,
                    tokenizer: Optional[Any] = None,
                    shard_size_bytes: int = 4 * 1024 ** 3) -> None:
    """Write an HF-format checkpoint directory from a ``CambrianLM`` (or its
    JAX-layout parameter tree)."""
    save_config(config, path)
    params = module_params_tree(model) if isinstance(model, nn.Module) else model
    if "params" in params:
        params = params["params"]
    save_sharded(export_cambrian(params, config), path, shard_size_bytes)

    if tokenizer is not None:
        tokenizer.save_pretrained(path)
