"""Training entry point (cambrian_tpu/train/train.py).

Usage, with the flags of ``scripts/cambrian/pretrain_cambrian_8b.sh``
(``--flag True`` / ``--flag False`` spell booleans):

    python -m cambrian_tpu_torch.train.train \\
        --model_name_or_path <hf-dir-or-stock-name> --version llama_3 \\
        --data_path train.jsonl --image_folder images/ \\
        --vision_tower_aux_list '["siglip/CLIP-ViT-SO400M-14-384", ...]' \\
        --vision_tower_aux_token_len_list '[576, ...]' \\
        --tune_mm_mlp_adapter True --bf16 True --output_dir ckpt/ ...

The model trains on ``--device`` (default ``cuda``). Weights come from an HF
checkpoint directory (a Cambrian checkpoint, or a plain LLaMA one with a
fresh connector) or, for a stock name, from a seeded random init; each tower
loads its local snapshot (``CAMBRIAN_TOWER_CACHE``), else gets seeded random
weights with a warning.
``--pretrain_mm_mlp_adapter`` loads a stage-1 connector dump.
"""

import argparse
import dataclasses
import json
import logging
import os
import typing
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from .. import conversation as conversation_lib
from ..checkpoint import hf_llm
from ..checkpoint.from_jax import load_state_dict_checked, state_dict_from_jax
from ..models.builder import (
    _load_state_dict,
    _random_like,
    _to_device,
    build_modules,
    load_config,
    load_tower_params,
)
from ..models.cambrian import CambrianLM
from ..models.config import (
    COMMAND_R_35B,
    GEMMA_7B,
    LLAMA3_8B,
    PHI3_MINI,
    VICUNA_13B,
    YI_34B,
    CambrianConfig,
    tiny_debug,
)
from .trainer import CambrianTrainer, TrainingArguments, _check_one_device

logger = logging.getLogger(__name__)


@dataclass
class ModelArguments:
    """SVA and model flags."""

    model_name_or_path: str = "llama3-8b"
    version: str = "llama_3"
    vision_tower_aux_list: str = json.dumps([
        "siglip/CLIP-ViT-SO400M-14-384",
        "openai/clip-vit-large-patch14-336",
        "facebook/dinov2-giant-res378",
        "clip-convnext-XXL-multi-stage",
    ])
    vision_tower_aux_token_len_list: str = json.dumps([576, 576, 576, 9216])
    image_token_len: int = 576
    num_query_group: int = 1
    query_num_list: str = json.dumps([576])
    connector_depth: int = 3
    connector_only: bool = False
    num_of_vision_sampler_layers: int = 10
    start_of_vision_sampler_layers: int = 0
    stride_of_vision_sampler_layers: int = 3
    vision_hidden_size: int = 1024
    mm_projector_type: str = "sva"
    mm_vision_select_layer: int = -2
    mm_vision_select_feature: str = "patch"
    pretrain_mm_mlp_adapter: Optional[str] = None
    mm_use_im_start_end: bool = False
    mm_use_im_patch_token: bool = False


@dataclass
class DataArguments:
    data_path: str = ""
    image_folder: str = ""
    is_multimodal: bool = True
    image_position: int = 91
    image_aspect_ratio: str = "pad"
    lazy_preprocess: bool = True
    model_max_length: int = 2048


_STOCK = {
    "llama3-8b": LLAMA3_8B, "llama-3-8b": LLAMA3_8B,
    "vicuna-13b": VICUNA_13B, "yi-34b": YI_34B, "phi3": PHI3_MINI,
    "phi-3": PHI3_MINI, "gemma-7b": GEMMA_7B, "gemma": GEMMA_7B,
    "command-r": COMMAND_R_35B, "c4ai": COMMAND_R_35B, "tiny-debug": None,
}


def build_config(model_args: ModelArguments, data_args: DataArguments) -> CambrianConfig:
    name = model_args.model_name_or_path
    sva = dict(
        mm_projector_type=model_args.mm_projector_type,
        vision_hidden_size=model_args.vision_hidden_size,
        num_query_group=model_args.num_query_group,
        query_num_list=tuple(json.loads(model_args.query_num_list)),
        connector_depth=model_args.connector_depth,
        connector_only=model_args.connector_only,
        num_of_vision_sampler_layers=model_args.num_of_vision_sampler_layers,
        start_of_vision_sampler_layers=model_args.start_of_vision_sampler_layers,
        stride_of_vision_sampler_layers=model_args.stride_of_vision_sampler_layers,
        image_token_len=model_args.image_token_len,
        image_position=data_args.image_position,
        mm_vision_tower_aux_list=tuple(json.loads(model_args.vision_tower_aux_list)),
        mm_vision_tower_aux_token_len_list=tuple(
            json.loads(model_args.vision_tower_aux_token_len_list)),
        mm_vision_select_layer=model_args.mm_vision_select_layer,
        mm_vision_select_feature=model_args.mm_vision_select_feature,
        tokenizer_model_max_length=data_args.model_max_length,
    )
    if os.path.isdir(name) and os.path.exists(os.path.join(name, "config.json")):
        base = load_config(name).to_dict()
        base.update(sva)
        return CambrianConfig.from_dict(base)
    key = name.lower().split("/")[-1]
    for stock_key, stock in _STOCK.items():
        if stock_key in key:
            if stock is None:
                return tiny_debug().replace(image_position=data_args.image_position,
                                            tokenizer_model_max_length=data_args.model_max_length)
            return CambrianConfig(**{**stock, **sva})
    raise ValueError(f"unknown model {name}")


def _init_params(lm: CambrianLM, seed: int = 0, device=None) -> Dict[str, torch.Tensor]:
    """Seeded random weights for every parameter of ``lm`` (a module on any
    device, ``meta`` included): N(0, 0.02) matrices, unit norms, zero
    biases."""
    g = torch.Generator(device=device or "cpu").manual_seed(seed)
    return _random_like(lm.state_dict(), g, 0.02, device)


def _connector_tree(sd: Dict[str, np.ndarray], config: CambrianConfig, num_towers: int) -> dict:
    """The connector subtrees of a stage-1 dump with HF names
    (``model.mm_projector.*``, ``model.vision_sampler_*`` ...)."""
    tree = {}
    if "model.mm_projector.0.weight" in sd:
        tree["mm_projector"] = {"fc1": hf_llm._dense(sd, "model.mm_projector.0"),
                                "fc2": hf_llm._dense(sd, "model.mm_projector.2")}
    for i in range(num_towers):
        pfx = f"model.mm_projector_aux_{i}."
        if pfx + "0.weight" in sd:
            tree[f"mm_projector_aux_{i}"] = {"fc1": hf_llm._dense(sd, pfx + "0"),
                                             "fc2": hf_llm._dense(sd, pfx + "2"),
                                             "ln": hf_llm._ln(sd, pfx + "3")}
    for g in range(config.num_query_group):
        if f"model.vision_sampler_{g}.layers.0.proj_in.weight" in sd:
            tree[f"vision_sampler_{g}"] = hf_llm._convert_sampler(
                sd, f"model.vision_sampler_{g}.", config.connector_depth, num_towers)
    if not config.connector_only:
        for k in range(config.num_of_vision_sampler_layers):
            if f"model.vision_sampler_layers.{k}.layers.0.proj_in.weight" in sd:
                tree[f"vision_sampler_layers_{k}"] = hf_llm._convert_sampler(
                    sd, f"model.vision_sampler_layers.{k}.", 1, num_towers)
    for key in ("vision_query", "image_newline"):
        if f"model.{key}" in sd:
            tree[key] = sd[f"model.{key}"]
    return tree


def load_pretrain_mm_mlp_adapter(lm: CambrianLM, path: str, num_towers: int) -> list:
    """Load a stage-1 dump (a checkpoint directory, or a ``torch.save`` file
    of HF-named tensors) into ``lm``; returns the loaded top-level names. A
    connector-only dump sets the connector; a full Cambrian checkpoint sets
    every tensor it holds, as the JAX package's loader does."""
    if os.path.isdir(path):
        sd = _load_state_dict(path)
    else:
        sd = {k: v.float().numpy()
              for k, v in torch.load(path, map_location="cpu", weights_only=True).items()}
    if any(k.startswith("model.layers") for k in sd):
        tree = hf_llm.convert_cambrian(sd, lm.cfg, num_towers)
    else:
        tree = _connector_tree(sd, lm.cfg, num_towers)
    own = lm.state_dict()
    with torch.no_grad():
        for k, v in state_dict_from_jax(tree).items():
            if k not in own or own[k].shape != v.shape:
                raise KeyError(f"adapter tensor {k} {tuple(v.shape)} does not fit the model")
            own[k].copy_(v)
    logger.info("loaded pretrain_mm_mlp_adapter: %s", sorted(tree))
    return sorted(tree)


def build_model(config: CambrianConfig, model_name_or_path: str, dtype, device):
    """(CambrianLM, towers) on ``device`` in ``dtype`` (norms fp32), with the
    weights described in the module docstring."""
    with torch.device("meta"):
        lm, towers = build_modules(config, dtype)
    name = model_name_or_path
    if os.path.isdir(name) and any(f.endswith((".safetensors", ".bin"))
                                   for f in os.listdir(name)):
        hf = _load_state_dict(name)
        try:
            sd = state_dict_from_jax(hf_llm.convert_cambrian(hf, config))
        except KeyError:
            # a plain LLM checkpoint: decoder weights, fresh connector
            sd = _init_params(lm)
            sd.update(state_dict_from_jax(hf_llm.convert_decoder(hf, config, prefix="model.")))
            if "lm_head.weight" in hf:
                sd["lm_head.weight"] = torch.from_numpy(np.array(hf["lm_head.weight"]))
    else:
        sd = _init_params(lm)
    load_state_dict_checked(lm, {k: v.to(device) for k, v in sd.items()}, assign=True)
    for i, t in enumerate(towers):
        # the tower's snapshot, else random weights seeded per tower
        g = torch.Generator(device=device).manual_seed(i + 1)
        load_state_dict_checked(t, _to_device(load_tower_params(t, g, device), t.state_dict(),
                                              device), assign=True)
    return lm, towers


def train(model_args: ModelArguments, data_args: DataArguments,
          training_args: TrainingArguments, tokenizer=None):
    _check_one_device(training_args)
    conversation_lib.default_conversation = conversation_lib.conv_templates[model_args.version]
    config = build_config(model_args, data_args)
    dtype = torch.bfloat16 if training_args.bf16 else torch.float32
    device = torch.device(training_args.device)
    model, towers = build_model(config, model_args.model_name_or_path, dtype, device)
    if model_args.pretrain_mm_mlp_adapter:
        load_pretrain_mm_mlp_adapter(model, model_args.pretrain_mm_mlp_adapter, len(towers))

    if tokenizer is None:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(model_args.model_name_or_path)
    tokenizer.model_max_length = data_args.model_max_length
    if tokenizer.pad_token is None:
        tokenizer.pad_token = tokenizer.eos_token

    data_args.image_processor_aux_list = [t.image_processor for t in towers]
    data_args.image_token_len = config.image_token_len
    data_args.image_token_len_aux_list = list(config.mm_vision_tower_aux_token_len_list)
    from ..data.dataset import make_supervised_data_module

    data_module = make_supervised_data_module(tokenizer, data_args)
    trainer = CambrianTrainer(model=model, towers=towers, args=training_args,
                              train_dataset=data_module["train_dataset"],
                              data_collator=data_module["data_collator"])
    history = trainer.train(
        resume_from_checkpoint=training_args.resume_from_checkpoint is not None
        or training_args.train_continue)
    trainer.save_model(training_args.output_dir)
    return history


def _flag_type(tp):
    """The argparse type of a dataclass field: Optional[X] is X, and a bool
    reads True/False (the launch scripts write ``--flag True``)."""
    args = [a for a in typing.get_args(tp) if a is not type(None)]
    if args:
        tp = args[0]
    if tp is bool:
        def parse_bool(s: str) -> bool:
            if s.lower() in ("true", "1", "yes"):
                return True
            if s.lower() in ("false", "0", "no"):
                return False
            raise argparse.ArgumentTypeError(f"not a boolean: {s!r}")
        return parse_bool
    return tp


def parse_args(argv=None):
    """(ModelArguments, DataArguments, TrainingArguments) from flags named
    after their fields."""
    parser = argparse.ArgumentParser(description="Cambrian training (PyTorch port)")
    classes = (ModelArguments, DataArguments, TrainingArguments)
    for cls in classes:
        for f in dataclasses.fields(cls):
            typ = _flag_type(f.type)
            kw = dict(type=typ, default=argparse.SUPPRESS)
            if f.type is bool:
                kw.update(nargs="?", const=True)
            parser.add_argument(f"--{f.name}", **kw)
    given = vars(parser.parse_args(argv))
    return tuple(cls(**{f.name: given[f.name] for f in dataclasses.fields(cls)
                        if f.name in given}) for cls in classes)


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    train(*parse_args(argv))


if __name__ == "__main__":
    main()
