"""Checkpoint consolidation (cambrian_tpu/checkpoint/consolidate.py): a
training checkpoint (``torch.distributed.checkpoint``, written by
``train/trainer.py`` under any mesh) -> an HF-format checkpoint that both
packages' ``load_pretrained_model`` read.

The checkpoint is read in one process with no process group, whatever mesh
wrote it: DCP stores each tensor's global shape and the pieces each rank
wrote, so ``read_checkpoint`` rebuilds whole tensors.

A LoRA run's checkpoint holds the adapters alone (and ``lora_alpha``): the
base is read from the checkpoint the run started from (``--base_model``, its
``model_name_or_path``), the adapters merged into it (``merge_lora``), and
the merged model written, as the trainer's own export at the end of the run.

Usage:
    python -m cambrian_tpu_torch.checkpoint.consolidate \\
        --ckpt_dir runs/exp1 [--step 2000] [--config runs/exp1/config.json] \\
        [--base_model BASE_DIR] --output_dir runs/exp1/hf
"""

import argparse
import json
import os
import re
from typing import List, Optional

import torch

_STEP_DIR = re.compile(r"^step_(\d+)$")


def checkpoint_dirs(path: str) -> List[str]:
    """The complete checkpoints under ``path`` (``step_N`` directories that
    hold DCP's ``.metadata``, which it writes last), oldest first."""
    if not os.path.isdir(path):
        return []
    found = [(int(m.group(1)), os.path.join(path, name)) for name in os.listdir(path)
             for m in [_STEP_DIR.match(name)]
             if m and os.path.exists(os.path.join(path, name, ".metadata"))]
    return [p for _, p in sorted(found)]


def read_checkpoint(path: str) -> dict:
    """The whole tree of one DCP checkpoint directory, as CPU tensors (and
    the ints it holds), read in this process alone."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata

    metadata = dcp.FileSystemReader(path).read_metadata()
    tree: dict = {}
    for fqn, meta in metadata.state_dict_metadata.items():
        keys = metadata.planner_data[fqn]
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = (torch.empty(meta.size, dtype=meta.properties.dtype)
                          if isinstance(meta, TensorStorageMetadata) else 0)
    dcp.load(tree, checkpoint_id=path, no_dist=True)
    return tree


def consolidate(ckpt_dir: str, output_dir: str, config_path: Optional[str] = None,
                step: Optional[int] = None, base_model: Optional[str] = None) -> str:
    """Write the model of the newest checkpoint (or of ``step``) under
    ``ckpt_dir`` (a training ``output_dir``, or its ``checkpoints/``) to
    ``output_dir`` as an HF checkpoint; ``config_path`` defaults to
    ``ckpt_dir/config.json``. A LoRA checkpoint needs ``base_model``."""
    from ..models.builder import _MODEL_TYPE_MAP, build_modules
    from ..models.config import CambrianConfig
    from .from_jax import load_state_dict_checked
    from .save import save_pretrained

    root = os.path.join(ckpt_dir, "checkpoints")
    if not os.path.isdir(root):
        root = ckpt_dir
    found = {int(_STEP_DIR.match(os.path.basename(p)).group(1)): p
             for p in checkpoint_dirs(root)}
    if step is None:
        step = max(found) if found else None
    if step is None or step not in found:
        raise FileNotFoundError(f"no checkpoint{'' if step is None else f' of step {step}'} "
                                f"under {root}")

    config_path = config_path or os.path.join(ckpt_dir, "config.json")
    with open(config_path) as f:
        raw = json.load(f)
    raw.setdefault("model_type", "llama")
    raw["model_type"] = _MODEL_TYPE_MAP.get(raw["model_type"], raw["model_type"])
    config = CambrianConfig.from_dict(raw)

    tree = read_checkpoint(found[step])
    if "lora" in tree:
        from ..train.lora import lora_from_state_dict, merge_lora
        from ..train.train import build_model

        if base_model is None:
            raise ValueError("a LoRA checkpoint holds the adapters alone: give the base "
                             "model it trained on (base_model)")
        model, _ = build_model(config, base_model, torch.float32, torch.device("cpu"))
        # the checkpoint's ``<kernel key>/a`` leaves under the file's names
        adapters = lora_from_state_dict({f"{k[:-2]}.lora_{k[-1]}": v
                                         for k, v in tree["lora"].items()})
        rank = next(iter(adapters.values()))["a"].shape[1]
        merge_lora(model, adapters, tree["lora_alpha"], rank)
    else:
        with torch.device("meta"):
            model, _ = build_modules(config, torch.float32)
        # the towers' weights (vision_towers.*, present when they trained)
        # are not part of the model's export, as in the JAX package
        load_state_dict_checked(model, {k: v for k, v in tree["model"].items()
                                        if not k.startswith("vision_towers.")}, assign=True)
    save_pretrained(model, config, output_dir)
    print(f"consolidated step {step} -> {output_dir}")
    return output_dir


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--ckpt_dir", required=True,
                        help="training output dir containing checkpoints/")
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--config", default=None,
                        help="config.json (defaults to ckpt_dir/config.json)")
    parser.add_argument("--step", type=int, default=None)
    parser.add_argument("--base_model", default=None,
                        help="the checkpoint a LoRA run started from (its model_name_or_path)")
    args = parser.parse_args(argv)
    consolidate(args.ckpt_dir, args.output_dir, args.config, args.step, args.base_model)


if __name__ == "__main__":
    main()
