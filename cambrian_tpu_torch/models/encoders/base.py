"""Vision tower registry and wrapper (cambrian_tpu/models/encoders/base.py).

Tower names encode configuration as ``<model>-res{R}-interp{T}``; builders
dispatch on substring match; every ViT tower resamples its token grid to the
requested count with the fp32 bilinear resize. The production towers
register here; the encoder-study towers in ``extra.py`` and ``sam.py``,
which the package's ``__init__`` imports, so that any import of this module
registers them all.

Unlike the JAX package, where a tower bundles a stateless flax module and
its parameters live apart, a tower here is an ``nn.Module`` that owns its
weights (under ``module.``).
"""

from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

from ...mm_utils import (
    CLIP_MEAN,
    CLIP_STD,
    IMAGENET_MEAN,
    IMAGENET_STD,
    SIGLIP_MEAN,
    SIGLIP_STD,
    ImageProcessor,
)
from ...ops.resize import interpolate_tokens
from .convnext import ConvNeXtTokens, convnext_large, convnext_xxl
from .vit import (
    ViTConfig,
    VisionTransformer,
    clip_vit_l_336,
    dinov2_giant,
    siglip_so400m_384,
    tiny_vit,
)


def extract_res_interp(model_name: str) -> Tuple[str, Optional[int], Optional[int]]:
    """Parse ``-res{R}`` / ``-interp{T}`` suffixes out of a tower name."""
    res = None
    interp = None
    base_parts = []
    for part in model_name.split("-"):
        if part.startswith("res") and part[3:].isdigit():
            res = int(part[3:])
        elif part.startswith("interp") and part[6:].isdigit():
            interp = int(part[6:])
        else:
            base_parts.append(part)
    return "-".join(base_parts), res, interp


class VisionTower(nn.Module):
    """A vision encoder: module + static config + host image processor.
    ``forward(pixels)`` returns token features [B, num_patches, C] after the
    fp32 token-grid interpolation (when ``interp_size`` is set)."""

    def __init__(self, name: str, module: nn.Module, config: Any, hidden_size: int,
                 image_size: int, interp_size: Optional[int],
                 image_processor: ImageProcessor, hf_repo: Optional[str] = None):
        super().__init__()
        self.name = name
        self.module = module
        self.config = config
        self.hidden_size = hidden_size
        self.image_size = image_size
        self.interp_size = interp_size
        self.image_processor = image_processor
        self.hf_repo = hf_repo

    def forward(self, pixels: torch.Tensor, **kwargs) -> torch.Tensor:
        """``kwargs`` go to the module (the SD-2.1 tower's ``noise``)."""
        feats = self.module(pixels, **kwargs)
        if self.interp_size is not None and feats.shape[1] != self.interp_size:
            feats = interpolate_tokens(feats, self.interp_size)
        return feats

    @property
    def num_patches(self) -> int:
        if self.interp_size is not None:
            return self.interp_size
        if hasattr(self.config, "num_patches"):
            return self.config.num_patches
        return (self.image_size // self.config.reduction) ** 2


TowerBuilder = Callable[..., VisionTower]
_REGISTRY: Dict[str, TowerBuilder] = {}


def register_tower(substr: str):
    def deco(fn: TowerBuilder):
        _REGISTRY[substr] = fn
        return fn
    return deco


@register_tower("clip-convnext")
def _build_convnext(name, res, interp, dtype, device):
    cfg = convnext_xxl if "XXL" in name else convnext_large
    image_size = res if res is not None else 1024
    c = cfg(image_size=image_size, multi_stage="multi-stage" in name)
    interp_side = int(interp ** 0.5) if interp else image_size // c.reduction
    module = ConvNeXtTokens(c, interp_side=interp_side, dtype=dtype, device=device)
    return VisionTower(
        name=name, module=module, config=c, hidden_size=c.hidden_size,
        image_size=image_size, interp_size=interp_side ** 2,
        image_processor=ImageProcessor(size=image_size, image_mean=CLIP_MEAN,
                                       image_std=CLIP_STD),
        hf_repo="laion/CLIP-convnext_xxlarge-laion2B-s34B-b82K-augreg-soup"
        if "XXL" in name else "laion/CLIP-convnext_large_d_320.laion2B-s29B-b131K-ft-soup",
    )


def _build_vit(name, c: ViTConfig, interp, dtype, device, mean, std, hf_repo):
    return VisionTower(
        name=name, module=VisionTransformer(c, dtype=dtype, device=device), config=c,
        hidden_size=c.hidden_size, image_size=c.image_size, interp_size=interp,
        image_processor=ImageProcessor(size=c.image_size, image_mean=mean, image_std=std),
        hf_repo=hf_repo,
    )


def _with_res(c: ViTConfig, res: Optional[int]) -> ViTConfig:
    if res is not None and res != c.image_size:
        return ViTConfig(**{**c.__dict__, "image_size": res})
    return c


@register_tower("siglip")
def _build_siglip(name, res, interp, dtype, device):
    return _build_vit(name, _with_res(siglip_so400m_384(), res), interp, dtype, device,
                      SIGLIP_MEAN, SIGLIP_STD, "google/siglip-so400m-patch14-384")


@register_tower("dinov2")
def _build_dinov2(name, res, interp, dtype, device):
    c = dinov2_giant(image_size=res if res is not None else 518)
    return _build_vit(name, c, interp, dtype, device, IMAGENET_MEAN, IMAGENET_STD,
                      "facebook/dinov2-giant")


@register_tower("clip-vit")
@register_tower("openai/clip")
def _build_clip(name, res, interp, dtype, device):
    return _build_vit(name, _with_res(clip_vit_l_336(), res), interp, dtype, device,
                      CLIP_MEAN, CLIP_STD, "openai/clip-vit-large-patch14-336")


@register_tower("debug-tower")
def _build_debug(name, res, interp, dtype, device):
    """Tiny randomly-initialized ViT used by tests and dry runs."""
    c = tiny_vit(image_size=res if res is not None else 32, class_token=False,
                 select_layer=0)
    return _build_vit(name, c, interp, dtype, device, SIGLIP_MEAN, SIGLIP_STD, None)


def build_vision_tower(name: str, dtype=torch.float32, device=None) -> VisionTower:
    """Dispatch on substring match: prefix matches beat substring matches and
    longer keys beat shorter ones."""
    _, res, interp = extract_res_interp(name)
    lowered = name.lower()
    matches = [k for k in _REGISTRY if k.lower() in lowered]
    if not matches:
        raise ValueError(f"Unknown vision tower (or not ported yet): {name}")

    def rank(k):
        kl = k.lower()
        return (lowered.startswith(kl), lowered.split("/")[-1].startswith(kl), len(kl))

    return _REGISTRY[max(matches, key=rank)](name, res, interp, dtype, device)


def build_vision_tower_aux_list(tower_names, token_len_list, dtype=torch.float32,
                                device=None):
    """Build all aux towers, appending ``-interp{token_len}`` per tower."""
    towers = []
    for name, token_len in zip(tower_names, token_len_list):
        if "interp" not in name:
            name = f"{name}-interp{token_len}"
        towers.append(build_vision_tower(name, dtype=dtype, device=device))
    return towers
