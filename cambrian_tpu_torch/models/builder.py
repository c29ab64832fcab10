"""Model loading and the user-facing bundle (cambrian_tpu/models/builder.py).

``load_pretrained_model`` keeps the reference's 4-tuple API
``(tokenizer, model, image_processor_list, context_len)``. The LM and
connector load from an HF-layout checkpoint directory: safetensors shards
(read by ``checkpoint/safetensors_io.py``), else ``pytorch_model*.bin`` /
``*.pth`` shards -> ``checkpoint/hf_llm.py::convert_cambrian`` (the HF name
mapping) -> ``checkpoint/from_jax.py``; with ``load_8bit`` / ``load_4bit``
the decoder projections are then quantized (``ops/quant.py``). Each vision
tower loads from a local snapshot of its upstream repo
(``CAMBRIAN_TOWER_CACHE``, then the HF hub cache) through
``checkpoint/hf_vision.py``; a tower with no snapshot gets random weights,
with a loud warning.

``CambrianForInference.from_state_dict`` builds the model from a config and
a state dict (keys ``lm.*`` and ``towers.{i}.*``) without allocating a
second copy of the weights: modules are built on the ``meta`` device and
take the given tensors as their parameters.
"""

import glob
import itertools
import json
import os
import time
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..checkpoint import hf_vision
from ..checkpoint.from_jax import load_state_dict_checked, state_dict_from_jax
from ..checkpoint.hf_llm import convert_cambrian
from ..checkpoint.safetensors_io import load_file
from ..constants import IGNORE_INDEX
from ..data.packing import prepare_multimodal_data
from ..infer.engine import GenerationConfig, GenerationEngine
from ..ops.quant import quantize_state_dict
from .cambrian import CambrianLM
from .config import CambrianConfig
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


def _load_state_dict(model_path: str) -> Dict[str, np.ndarray]:
    """Flat {name: numpy} of a checkpoint directory: every ``*.safetensors``
    shard, else every ``pytorch_model*.bin`` (else ``*.pth``) shard through
    ``torch.load(weights_only=True)``; bf16 comes back as fp32."""
    st_files = sorted(glob.glob(os.path.join(model_path, "*.safetensors")))
    if st_files:
        sd = {}
        for f in st_files:
            sd.update(load_file(f))
        return sd
    bin_files = (sorted(glob.glob(os.path.join(model_path, "pytorch_model*.bin")))
                 or sorted(glob.glob(os.path.join(model_path, "*.pth"))))
    if not bin_files:
        raise FileNotFoundError(f"no weight shards found in {model_path}")
    sd = {}
    for f in bin_files:
        chunk = torch.load(f, map_location="cpu", weights_only=True)
        sd.update({k: v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()
                   for k, v in chunk.items()})
    return sd


def _tower_snapshot_dir(tower: VisionTower) -> Optional[str]:
    """A local snapshot of the tower's upstream repo: under
    ``CAMBRIAN_TOWER_CACHE`` (``org--name`` or ``org/name``), else the
    newest snapshot in the HF hub cache (``HF_HOME``)."""
    if tower.hf_repo is None:
        return None
    candidates = []
    cache = os.environ.get("CAMBRIAN_TOWER_CACHE")
    if cache:
        candidates.append(os.path.join(cache, tower.hf_repo.replace("/", "--")))
        candidates.append(os.path.join(cache, tower.hf_repo))
    hf_home = os.environ.get("HF_HOME", os.path.expanduser("~/.cache/huggingface"))
    hub_dir = os.path.join(hf_home, "hub", "models--" + tower.hf_repo.replace("/", "--"),
                           "snapshots")
    if os.path.isdir(hub_dir):
        snaps = sorted(os.listdir(hub_dir))
        if snaps:
            candidates.append(os.path.join(hub_dir, snaps[-1]))
    return next((c for c in candidates if os.path.isdir(c)), None)


def convert_tower(tower: VisionTower, sd: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """A tower snapshot's state dict -> the tower's (``module.*``, CPU
    tensors, fp32 floats), by the JAX package's dispatch on the tower name,
    in its order (ConvNeXt, SigLIP, DINOv2, MiDaS, EVA, SD-2.1, else CLIP):
    SigLIP in timm/open_clip naming when its keys hold ``.attn.qkv.``."""
    name = tower.name.lower()
    if "convnext" in name:
        tree = hf_vision.convert_convnext(sd, tower.config)
    elif "siglip" in name:
        timm_style = any(".attn.qkv." in k for k in sd)
        conv = hf_vision.convert_siglip_timm if timm_style else hf_vision.convert_siglip_vision
        tree = conv(sd, tower.config)
    elif "dinov2" in name:
        tree = hf_vision.convert_dinov2(sd, tower.config)
    elif "midas" in name:
        tree = hf_vision.convert_dpt_vit(sd, tower.config)
    elif "eva" in name:
        tree = hf_vision.convert_eva02(sd, tower.config)
    elif "diffusion" in name or "pixart" in name:
        tree = hf_vision.convert_sd_tower(sd, tower.config)
    else:
        tree = hf_vision.convert_clip_vision(sd, tower.config)
    return state_dict_from_jax(tree, prefix="module.")


def load_tower_params(tower: VisionTower, generator: Optional[torch.Generator] = None,
                      device=None) -> Dict[str, torch.Tensor]:
    """The tower's state dict from its local snapshot (CPU tensors), else
    random weights made on ``device`` from ``generator``, with a warning."""
    snap = _tower_snapshot_dir(tower)
    if snap is not None:
        return convert_tower(tower, _load_state_dict(snap))
    if tower.hf_repo is not None:
        warnings.warn(
            f"No local snapshot for tower {tower.name} ({tower.hf_repo}); "
            "using RANDOM weights. Set CAMBRIAN_TOWER_CACHE for real inference.")
    if generator is None:
        generator = torch.Generator(device=device or "cpu").manual_seed(0)
    return _random_like(tower.state_dict(), generator, 0.02, device)


def _to_device(sd: Dict[str, torch.Tensor], like: Dict[str, torch.Tensor], device,
               prefix: str = "") -> Dict[str, torch.Tensor]:
    """Each tensor on ``device`` in its parameter's float dtype (``like``,
    the module's meta state dict), one at a time, so that no second copy of
    the weights exists in the wider dtype."""
    out = {}
    for k, v in sd.items():
        v = v.to(device)
        p = like.get(k)
        if p is not None and v.is_floating_point() and p.is_floating_point():
            v = v.to(p.dtype)
        out[prefix + k] = v
    return out


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


def _decoder_layer(name: str) -> Optional[str]:
    """``lm.layers_{i}`` for a key of decoder layer i, else None."""
    if not name.startswith("lm.layers_"):
        return None
    return ".".join(name.split(".")[:2])


def quantize_decoder(sd: Dict[str, torch.Tensor], mode: str) -> Dict[str, torch.Tensor]:
    """Quantize the decoder projections of a full state dict (the
    ``lm.layers_*`` entries), as ``load_8bit`` / ``load_4bit`` do."""
    out = {}
    for layer, group in itertools.groupby(sd.items(), key=lambda kv: _decoder_layer(kv[0])):
        part = dict(group)
        out.update(quantize_state_dict(part, mode=mode) if layer else part)
    return out


def random_state_dict(config: CambrianConfig, generator: torch.Generator, std: float,
                      dtype=torch.bfloat16, device=None) -> Dict[str, torch.Tensor]:
    """Random weights for the whole model (``lm.*``, ``towers.{i}.*``), made
    on ``device`` from ``generator``; norms and the LM head in fp32.

    With ``config.quantize`` the weights are those of the unquantized model
    from the same generator, and each decoder layer is quantized as soon as
    it is made, so that memory peaks near the quantized model's size."""
    with torch.device("meta"):
        lm, towers = build_modules(config.replace(quantize=None), dtype)
    shapes = {f"lm.{k}": v for k, v in lm.state_dict().items()}
    for i, t in enumerate(towers):
        shapes.update({f"towers.{i}.{k}": v for k, v in t.state_dict().items()})
    if not config.quantize:
        return _random_like(shapes, generator, std, device)
    sd = {}
    for _, group in itertools.groupby(shapes.items(), key=lambda kv: _decoder_layer(kv[0])):
        sd.update(quantize_decoder(_random_like(dict(group), generator, std, device),
                                   config.quantize))
    return sd


def initialize_vision_tokenizer(sd: Dict[str, torch.Tensor], tokenizer, config: CambrianConfig,
                                mm_use_im_start_end: bool = False,
                                mm_use_im_patch_token: bool = False
                                ) -> Tuple[Dict[str, torch.Tensor], CambrianConfig]:
    """Add the image special tokens to ``tokenizer`` (in place) and give
    each new id a row of ``embed_tokens.weight`` and of ``lm_head.weight``
    (untied) equal to the mean of the existing rows (reference
    cambrian_arch.py:611-653). ``sd`` is a state dict of the port's names,
    with or without the ``lm.`` prefix. Returns (a state dict with the
    grown tensors, the config with the new ``vocab_size``); nothing changes
    when no token is new."""
    from ..constants import DEFAULT_IM_END_TOKEN, DEFAULT_IM_START_TOKEN, DEFAULT_IMAGE_PATCH_TOKEN

    new_tokens = []
    if mm_use_im_patch_token:
        new_tokens.append(DEFAULT_IMAGE_PATCH_TOKEN)
    if mm_use_im_start_end:
        new_tokens.extend([DEFAULT_IM_START_TOKEN, DEFAULT_IM_END_TOKEN])
    if not new_tokens:
        return sd, config
    num_new = tokenizer.add_tokens(new_tokens, special_tokens=True)
    if num_new == 0:
        return sd, config
    out = dict(sd)
    for name, t in sd.items():
        if name.split(".")[-2:] in (["embed_tokens", "weight"], ["lm_head", "weight"]):
            out[name] = torch.cat([t, t.mean(0, keepdim=True).expand(num_new, -1)], dim=0)
    return out, config.replace(vocab_size=config.vocab_size + num_new)


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
        stay on their device.

        A model whose projector is not SVA may come without ``lm.mm_projector.*``:
        the JAX package creates no parameters for a projector no path calls,
        and an HF checkpoint may hold none. It then gets N(0, 0.02) weights,
        as ``random_state_dict`` makes them."""
        with torch.device("meta"):
            lm, towers = build_modules(config, dtype)
        lm_sd = _strip(state_dict, "lm.")
        if config.mm_projector_type != "sva" and not any(
                k.startswith("mm_projector.") for k in lm_sd):
            dev = lm_sd["embed_tokens.weight"].device
            shapes = {k: v for k, v in lm.state_dict().items() if k.startswith("mm_projector.")}
            lm_sd.update(_random_like(shapes, torch.Generator(device=dev).manual_seed(0), 0.02,
                                      dev))
        load_state_dict_checked(lm, lm_sd, assign=True)
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
        the tower encode time. A ``stopping`` keyword (e.g. a
        ``KeywordsStoppingCriteria``) goes to ``GenerationEngine.generate``."""
        *args, encode_ms = self._prepare_generate(input_ids, images, image_sizes, **gen_kwargs)
        out = self.engine.generate(*args, stopping=gen_kwargs.get("stopping"))
        self.engine.last_timings["encode_ms"] = encode_ms
        return out

    def generate_stream(self, input_ids: np.ndarray, images: Optional[Sequence] = None,
                        image_sizes: Optional[Sequence] = None, **gen_kwargs):
        """``generate``'s inputs; yields the generated ids so far after each
        chunk of ``stream_chunk`` (default 8) decode steps."""
        *args, encode_ms = self._prepare_generate(input_ids, images, image_sizes, **gen_kwargs)
        for out in self.engine.generate_stream(*args):
            self.engine.last_timings["encode_ms"] = encode_ms
            yield out

    def _prepare_generate(self, input_ids, images=None, image_sizes=None, **gen_kwargs):
        """Pack the prompt, encode the images and read the generation
        options: (ids, mask, positions, features, window masks, config,
        encode ms)."""
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
            stream_chunk=gen_kwargs.get("stream_chunk", 8),
        )
        return pids, pmask, ppos, feats, aux_masks, cfg, encode_ms


def _now(engine: GenerationEngine) -> float:
    engine._sync()
    return time.perf_counter()


def _strip(sd: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def load_pretrained_model(model_path: str, model_base: Optional[str] = None,
                          model_name: Optional[str] = None, load_8bit: bool = False,
                          load_4bit: bool = False, device_map: str = "auto",
                          device: str = "cuda", dtype=torch.bfloat16, **kwargs):
    """(tokenizer, model, image_processor_list, context_len).

    ``load_8bit`` / ``load_4bit`` (mutually exclusive) quantize the decoder
    projections to int8, or to int4 in groups of 128 rows; embeddings, the
    LM head, the connector and the towers stay full precision.
    ``lm_head_bf16=True`` stores the LM head in bf16 (``lm_head_dtype``):
    fp32 logits from bf16 operands, accumulated in fp32. ``model_base`` is
    refused: the JAX loader takes it and never reads it."""
    if load_8bit and load_4bit:
        raise ValueError("load_8bit and load_4bit are mutually exclusive")
    if model_base is not None:
        raise NotImplementedError("LoRA merging onto a base model is not ported yet")

    quant_mode = "int8" if load_8bit else "int4" if load_4bit else None
    config = load_config(model_path)
    if quant_mode:
        config = config.replace(quantize=quant_mode)
    if kwargs.get("lm_head_bf16"):
        config = config.replace(lm_head_dtype="bf16")
    with torch.device("meta"):
        lm, towers = build_modules(config, dtype)
    lm_sd = state_dict_from_jax(convert_cambrian(_load_state_dict(model_path), config),
                                prefix="lm.")
    if quant_mode:
        lm_sd = quantize_decoder(lm_sd, quant_mode)
    sd = _to_device(lm_sd, {f"lm.{k}": v for k, v in lm.state_dict().items()}, device)
    del lm_sd
    for i, t in enumerate(towers):
        # seeded per tower, so that two loads give the same model
        gen = torch.Generator(device=device).manual_seed(i)
        sd.update(_to_device(load_tower_params(t, gen, device), t.state_dict(), device,
                             prefix=f"towers.{i}."))

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
