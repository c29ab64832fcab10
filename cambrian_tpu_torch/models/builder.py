"""Model loading and the user-facing bundle (cambrian_tpu/models/builder.py).

``load_pretrained_model`` keeps the reference's 4-tuple API
``(tokenizer, model, image_processor_list, context_len)``. The LM and
connector load from an HF-layout checkpoint directory: safetensors ->
``cambrian_tpu.checkpoint.hf_llm.convert_cambrian`` (the JAX package's name
mapping, which loads no JAX) -> ``checkpoint/from_jax.py``. Tower snapshot
loading is not ported yet: towers get random weights, with a loud warning.

``CambrianForInference.from_state_dict`` builds the model from a config and
a state dict (keys ``lm.*`` and ``towers.{i}.*``) without allocating a
second copy of the weights: modules are built on the ``meta`` device and
take the given tensors as their parameters.
"""

import glob
import json
import os
import time
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from cambrian_tpu.constants import IGNORE_INDEX
from cambrian_tpu.data.packing import prepare_multimodal_data
from cambrian_tpu.models.config import CambrianConfig

from ..checkpoint.from_jax import load_state_dict_checked, state_dict_from_jax
from ..infer.engine import GenerationConfig, GenerationEngine
from .cambrian import CambrianLM
from .encoders.base import VisionTower, build_vision_tower_aux_list

_MODEL_TYPE_MAP = {
    "cambrian_llama": "llama",
    "cambrian_phi3": "phi3",
    "cambrian_mistral": "mistral",
    "cambrian_gemma": "gemma",
    "cambrian_cohere": "cohere",
}


def load_config(model_path: str) -> CambrianConfig:
    with open(os.path.join(model_path, "config.json")) as f:
        raw = json.load(f)
    model_type = raw.get("model_type", "llama")
    raw["model_type"] = _MODEL_TYPE_MAP.get(model_type, model_type)
    raw.setdefault("tokenizer_model_max_length", raw.get("max_position_embeddings", 2048))
    return CambrianConfig.from_dict(raw)


def _load_safetensors(model_path: str) -> Dict[str, np.ndarray]:
    files = sorted(glob.glob(os.path.join(model_path, "*.safetensors")))
    if not files:
        raise FileNotFoundError(f"no *.safetensors shards in {model_path}")
    from safetensors.numpy import load_file

    sd = {}
    for f in files:
        sd.update(load_file(f))
    return sd


def build_modules(config: CambrianConfig, dtype=torch.bfloat16, device=None
                  ) -> Tuple[CambrianLM, List[VisionTower]]:
    towers = build_vision_tower_aux_list(config.mm_vision_tower_aux_list,
                                         config.mm_vision_tower_aux_token_len_list,
                                         dtype=dtype, device=device)
    lm = CambrianLM(config, tuple(t.hidden_size for t in towers), dtype=dtype,
                    device=device)
    return lm, towers


def _random_like(shapes: Dict[str, torch.Tensor], generator: torch.Generator, std: float,
                 device=None) -> Dict[str, torch.Tensor]:
    """N(0, std) for matrices, embeddings, queries and position tables; ones
    for norm and layer-scale weights; zeros for biases; each in the dtype of
    its (meta) template."""
    sd = {}
    for name, meta in shapes.items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "bias":
            sd[name] = torch.zeros(meta.shape, dtype=meta.dtype, device=device)
        elif meta.dim() == 1 and (leaf == "weight" or "gamma" in leaf):
            sd[name] = torch.ones(meta.shape, dtype=meta.dtype, device=device)
        else:
            t = torch.empty(meta.shape, dtype=meta.dtype, device=device)
            sd[name] = t.normal_(0.0, std, generator=generator)
    return sd


def random_state_dict(config: CambrianConfig, generator: torch.Generator, std: float,
                      dtype=torch.bfloat16, device=None) -> Dict[str, torch.Tensor]:
    """Random weights for the whole model (``lm.*``, ``towers.{i}.*``), made
    on ``device`` from ``generator``; norms and the LM head in fp32."""
    with torch.device("meta"):
        lm, towers = build_modules(config, dtype)
    shapes = {f"lm.{k}": v for k, v in lm.state_dict().items()}
    for i, t in enumerate(towers):
        shapes.update({f"towers.{i}.{k}": v for k, v in t.state_dict().items()})
    return _random_like(shapes, generator, std, device)


class CambrianForInference:
    """Config + LM + towers + generation engine."""

    def __init__(self, config: CambrianConfig, lm: CambrianLM, towers: Sequence[VisionTower],
                 tokenizer=None, cache_dtype=torch.bfloat16):
        self.config = config
        self.lm = lm
        self.towers = list(towers)
        self.tokenizer = tokenizer
        self.engine = GenerationEngine(lm, self.towers,
                                       max_len=config.tokenizer_model_max_length + 1024,
                                       cache_dtype=cache_dtype)

    @classmethod
    def from_state_dict(cls, config: CambrianConfig, state_dict: Dict[str, torch.Tensor],
                        dtype=torch.bfloat16, tokenizer=None, cache_dtype=torch.bfloat16):
        """Build from a full state dict (``lm.*``, ``towers.{i}.*``). The
        tensors become the parameters (cast to each parameter's dtype) and
        stay on their device."""
        with torch.device("meta"):
            lm, towers = build_modules(config, dtype)
        load_state_dict_checked(lm, _strip(state_dict, "lm."), assign=True)
        for i, t in enumerate(towers):
            load_state_dict_checked(t, _strip(state_dict, f"towers.{i}."), assign=True)
        unknown = [k for k in state_dict
                   if not k.startswith("lm.") and not k.startswith("towers.")]
        if unknown:
            raise KeyError(f"unused keys: {unknown[:20]}")
        return cls(config, lm.eval(), [t.eval() for t in towers], tokenizer, cache_dtype)

    def pack_prompt(self, input_ids: np.ndarray, image_size: Tuple[int, int],
                    pad_to: Optional[int] = None):
        """Expand the <image> marker of 1-D ``input_ids`` into the static
        image block and build the masks."""
        ids = np.asarray(input_ids)[None]
        labels = np.full_like(ids, IGNORE_INDEX)
        mask = np.ones_like(ids, dtype=bool)
        max_len = pad_to or (ids.shape[1] + self.config.image_block_len - 1)
        pids, _, pmask, ppos, aux_masks = prepare_multimodal_data(
            ids, labels, mask, [image_size], self.config.image_token_len,
            self.config.mm_vision_tower_aux_token_len_list, max_len)
        return pids, pmask, ppos, aux_masks

    def generate(self, input_ids: np.ndarray, images: Optional[Sequence] = None,
                 image_sizes: Optional[Sequence] = None, **gen_kwargs) -> np.ndarray:
        """Reference generate() semantics: a 1-D prompt (with the image
        marker when ``images`` is given) and per-tower image batches ->
        generated ids [1, T]. ``self.engine.last_timings`` then also holds
        the tower encode time."""
        if images is not None:
            image_size = image_sizes[0] if image_sizes else (
                self.towers[0].image_size, self.towers[0].image_size)
            pids, pmask, ppos, aux_masks = self.pack_prompt(input_ids, image_size)
            t0 = _now(self.engine)
            feats = self.engine.encode_images(images)
            encode_ms = (_now(self.engine) - t0) * 1e3
        else:
            pids = np.asarray(input_ids)[None]
            pmask = np.ones_like(pids, dtype=bool)
            ppos = np.tile(np.arange(pids.shape[1]), (pids.shape[0], 1))
            feats, aux_masks, encode_ms = None, None, 0.0
        eos = gen_kwargs.get("eos_token_id",
                             getattr(self.tokenizer, "eos_token_id", None)
                             or self.config.eos_token_id)
        cfg = GenerationConfig(
            max_new_tokens=gen_kwargs.get("max_new_tokens", 128),
            temperature=gen_kwargs.get("temperature", 0.0)
            if gen_kwargs.get("do_sample", False) else 0.0,
            top_p=gen_kwargs.get("top_p", 1.0) or 1.0,
            eos_token_id=eos,
            seed=gen_kwargs.get("seed", 0),
        )
        out = self.engine.generate(pids, pmask, ppos, feats, aux_masks, cfg)
        self.engine.last_timings["encode_ms"] = encode_ms
        return out


def _now(engine: GenerationEngine) -> float:
    engine._sync()
    return time.perf_counter()


def _strip(sd: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def load_pretrained_model(model_path: str, model_base: Optional[str] = None,
                          model_name: Optional[str] = None, load_8bit: bool = False,
                          load_4bit: bool = False, device_map: str = "auto",
                          device: str = "cuda", dtype=torch.bfloat16, **kwargs):
    """(tokenizer, model, image_processor_list, context_len)."""
    if load_8bit or load_4bit:
        raise NotImplementedError("quantized loading is not ported yet")
    if model_base is not None:
        raise NotImplementedError("LoRA merging onto a base model is not ported yet")
    from cambrian_tpu.checkpoint.hf_llm import convert_cambrian

    config = load_config(model_path)
    lm_sd = state_dict_from_jax(convert_cambrian(_load_safetensors(model_path), config),
                                prefix="lm.")
    sd = {k: v.to(device) for k, v in lm_sd.items()}
    with torch.device("meta"):
        _, towers = build_modules(config, dtype)
    for i, t in enumerate(towers):
        if t.hf_repo is not None:
            warnings.warn(
                f"Tower snapshot loading is not ported yet: {t.name} ({t.hf_repo}) "
                "uses RANDOM weights.")
        # seeded per tower, so that two loads give the same model
        gen = torch.Generator(device=device).manual_seed(i)
        sd.update(_random_like({f"towers.{i}.{k}": v for k, v in t.state_dict().items()},
                               gen, 0.02, device))

    tokenizer = None
    try:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(model_path, use_fast=True)
    except (ImportError, OSError, ValueError) as e:  # tokenizer-less checkpoints
        warnings.warn(f"tokenizer not loaded from {model_path}: {e}")

    model = CambrianForInference.from_state_dict(config, sd, dtype=dtype,
                                                 tokenizer=tokenizer)
    image_processor_list = [t.image_processor for t in model.towers]
    return tokenizer, model, image_processor_list, config.tokenizer_model_max_length
