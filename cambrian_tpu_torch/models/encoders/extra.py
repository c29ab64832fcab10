"""Long-tail research towers (cambrian_tpu/models/encoders/extra.py), the
paper's encoder-ablation zoo: MAE / MoCo-v3 / I-JEPA / MAWS / supervised-ViT
/ DFN-CLIP / EVA-02-CLIP as configurations of the generic ViT, the MiDaS DPT
depth towers (plain ViT and BEiT layouts), the hybrid concat tower, and the
registration of the SD-2.1 one-step-denoise tower (``diffusion.py``).

Builders take ``(name, res, interp, dtype, device)`` as every builder of
``base.py`` does; the registry's dispatch rule (a prefix beats a substring,
a longer key a shorter one) resolves ``dfn-clip-vit-h-14`` here, not to
``clip-vit``.
"""

import torch
from torch import nn

from ...mm_utils import (
    CLIP_MEAN,
    CLIP_STD,
    IMAGENET_MEAN,
    IMAGENET_STD,
    ImageProcessor,
)
from ...ops.resize import interpolate_tokens
from .base import VisionTower, register_tower
from .diffusion import SDConfig, SDFeatureTower, tiny_sd
from .vit import ViTConfig, VisionTransformer

# (hidden, layers, heads, mlp, patch, image) per published architecture
_VIT_SHAPES = {
    "vit-b-16": (768, 12, 12, 3072, 16, 224),
    "vit-l-16": (1024, 24, 16, 4096, 16, 224),
    "vit-l-14": (1024, 24, 16, 4096, 14, 224),
    "vit-h-14": (1280, 32, 16, 5120, 14, 224),
    "vit-g-16": (1408, 40, 16, 6144, 16, 224),
    "vit-2b-14": (2560, 24, 32, 10240, 14, 224),
}


def _plain_vit(shape_key: str, class_token: bool) -> ViTConfig:
    hidden, layers, heads, mlp, patch, img = _VIT_SHAPES[shape_key]
    return ViTConfig(
        hidden_size=hidden, num_layers=layers, num_heads=heads,
        intermediate_size=mlp, patch_size=patch, image_size=img, class_token=class_token,
        final_layernorm=True, act="gelu", select_layer=0, ln_eps=1e-6,
    )


def _vit_tower(name, cfg: ViTConfig, res, interp, dtype, device, mean, std,
               hf_repo=None) -> VisionTower:
    if res is not None and res != cfg.image_size:
        cfg = ViTConfig(**{**cfg.__dict__, "image_size": res})
    return VisionTower(
        name=name, module=VisionTransformer(cfg, dtype=dtype, device=device), config=cfg,
        hidden_size=cfg.hidden_size, image_size=cfg.image_size, interp_size=interp,
        image_processor=ImageProcessor(size=cfg.image_size, image_mean=mean, image_std=std),
        hf_repo=hf_repo,
    )


@register_tower("mae-vit")
def _build_mae(name, res, interp, dtype, device):
    """MAE ViT: timm vit_{l16,h14}.mae, patch tokens after the final norm."""
    h14 = "h-14" in name
    cfg = _plain_vit("vit-h-14" if h14 else "vit-l-16", class_token=True)
    return _vit_tower(name, cfg, res, interp, dtype, device, IMAGENET_MEAN, IMAGENET_STD,
                      hf_repo="facebook/vit-mae-huge" if h14 else "facebook/vit-mae-large")


@register_tower("moco-vit")
def _build_moco(name, res, interp, dtype, device):
    """MoCo-v3 ViT-B/16."""
    cfg = _plain_vit("vit-b-16", class_token=True)
    return _vit_tower(name, cfg, res, interp, dtype, device, IMAGENET_MEAN, IMAGENET_STD)


@register_tower("ijepa")
def _build_ijepa(name, res, interp, dtype, device):
    """I-JEPA ViT: no class token, final norm."""
    g16 = "g-16" in name
    cfg = _plain_vit("vit-g-16" if g16 else "vit-h-14", class_token=False)
    return _vit_tower(name, cfg, res, interp, dtype, device, IMAGENET_MEAN, IMAGENET_STD,
                      hf_repo="facebook/ijepa_vitg16_22k" if g16
                      else "facebook/ijepa_vith14_22k")


@register_tower("maws")
def _build_maws(name, res, interp, dtype, device):
    """MAWS ViTs: the first of 2B/14, H/14, L/16, B/16 the name holds."""
    key = next((k for k in ("vit-2b-14", "vit-h-14", "vit-l-16", "vit-b-16")
                if k.replace("vit-", "") in name.lower()), "vit-b-16")
    cfg = _plain_vit(key, class_token=True)
    return _vit_tower(name, cfg, res, interp, dtype, device, IMAGENET_MEAN, IMAGENET_STD)


@register_tower("supervised-vit")
def _build_supervised(name, res, interp, dtype, device):
    """Supervised ViT baselines."""
    key = "vit-h-14" if "h-14" in name else "vit-l-16" if "l-16" in name else "vit-b-16"
    cfg = _plain_vit(key, class_token=True)
    return _vit_tower(name, cfg, res, interp, dtype, device, IMAGENET_MEAN, IMAGENET_STD,
                      hf_repo="google/vit-huge-patch14-224-in21k"
                      if "h-14" in name else "google/vit-large-patch16-224")


@register_tower("dfn-clip")
def _build_dfn(name, res, interp, dtype, device):
    """Apple DFN CLIP ViT-H/14: pre-LN, quick_gelu, no patch bias, layer -2."""
    cfg = ViTConfig(hidden_size=1280, num_layers=32, num_heads=16,
                    intermediate_size=5120, patch_size=14,
                    image_size=res or 224, class_token=True, pre_layernorm=True,
                    final_layernorm=False, act="quick_gelu", patch_bias=False,
                    select_layer=-2, ln_eps=1e-5)
    return _vit_tower(name, cfg, res, interp, dtype, device, CLIP_MEAN, CLIP_STD,
                      hf_repo="apple/DFN5B-CLIP-ViT-H-14")


@register_tower("eva02")
@register_tower("eva/clip")
def _build_eva(name, res, interp, dtype, device):
    """EVA-02-CLIP ViT-L/14 trunk (timm/eva02_large_patch14_clip_{336,224}):
    2-D axial RoPE on the patch tokens (positions rescaled to the 16 x 16
    pretrain grid), sub-LN SwiGLU FFN (hidden 2/3 of 4d), key projection
    without bias, absolute position embeddings, tapped at layer -2."""
    size = 224 if ("224" in name and "336" not in name) else 336
    cfg = ViTConfig(hidden_size=1024, num_layers=24, num_heads=16,
                    intermediate_size=2730, patch_size=14,
                    image_size=res or size, class_token=True,
                    final_layernorm=False, act="gelu", select_layer=-2,
                    ln_eps=1e-6, k_bias=False, rope=True, rope_ref_side=16,
                    swiglu_ln=True)
    repo = ("timm/eva02_large_patch14_clip_224.merged2b_s4b_b131k"
            if cfg.image_size == 224
            else "timm/eva02_large_patch14_clip_336.merged2b_s6b_b61k")
    return _vit_tower(name, cfg, res, interp, dtype, device, CLIP_MEAN, CLIP_STD,
                      hf_repo=repo)


@register_tower("midas")
def _build_midas(name, res, interp, dtype, device):
    """MiDaS depth towers: DPT backbones tapped at hidden_states[-1] (before
    the final LayerNorm), class token dropped, mean and std 0.5.

    - large-midas: Intel/dpt-large, a plain ViT-L/16 at 384
    - large-beit-midas-512: Intel/dpt-beit-large-512, BEiT-L/16 at 512
      (per-block relative position bias, LayerScale, no absolute position
      embedding, key without bias)
    - hybrid-midas: raises, as in the JAX package (the upstream encoder
      NaNs at once and never used it)
    """
    lowered = name.lower()
    if "hybrid" in lowered:
        raise NotImplementedError(
            "hybrid-midas (ResNet-hybrid DPT) NaNs in the reference and is not supported")
    if "beit" in lowered:
        cfg = ViTConfig(hidden_size=1024, num_layers=24, num_heads=16,
                        intermediate_size=4096, patch_size=16,
                        image_size=res or 512, class_token=True,
                        final_layernorm=False, act="gelu", select_layer=-1,
                        ln_eps=1e-12, k_bias=False, abs_pos_embed=False,
                        rel_pos_bias=True, layer_scale=True)
        repo = "Intel/dpt-beit-large-512"
    else:
        cfg = ViTConfig(hidden_size=1024, num_layers=24, num_heads=16,
                        intermediate_size=4096, patch_size=16,
                        image_size=res or 384, class_token=True,
                        final_layernorm=False, act="gelu", select_layer=-1,
                        ln_eps=1e-12)
        repo = "Intel/dpt-large"
    half = (0.5, 0.5, 0.5)
    return _vit_tower(name, cfg, res, interp, dtype, device, half, half, hf_repo=repo)


class _HybridTower(nn.Module):
    """Concat of N towers, each resized to a shared token grid: feature dim =
    the sum of the towers'. Its parameters are the towers' modules in order
    (``module.{i}.*``), as the JAX package keeps a list of their trees."""

    def __init__(self, name, towers, interp):
        super().__init__()
        self.name = name
        self.module = nn.ModuleList([t.module for t in towers])
        self.towers = list(towers)          # a plain list: their weights are in ``module``
        self.interp_size = interp or min(t.num_patches for t in towers)
        self.hidden_size = sum(t.hidden_size for t in towers)
        self.image_size = max(t.image_size for t in towers)
        self.image_processor = towers[0].image_processor
        self.config = towers[0].config
        self.hf_repo = None

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        feats = []
        for tower in self.towers:
            f = tower(pixels)
            if f.shape[1] != self.interp_size:
                f = interpolate_tokens(f, self.interp_size)
            feats.append(f)
        return torch.cat(feats, dim=-1)

    @property
    def num_patches(self) -> int:
        return self.interp_size


@register_tower("hybridmodel")
def _build_hybrid(name, res, interp, dtype, device):
    """``hybridmodel-<a>-&&&-<b>...``: each part built by its own name (the
    last part keeps the name's ``-interp``/``-res`` suffixes, as in the JAX
    package)."""
    from .base import build_vision_tower

    parts = name.replace("hybridmodel-", "").split("-&&&-")
    towers = [build_vision_tower(p, dtype=dtype, device=device) for p in parts]
    return _HybridTower(name, towers, interp)


@register_tower("diffusion")
@register_tower("pixart")
def _build_diffusion(name, res, interp, dtype, device):
    """SD-2.1 one-step-denoise feature tower (the PixArt encoder loads the
    same SD-2.1 pipeline): hidden 3520 = the 4 up-block taps concatenated,
    a 32 x 32 token grid at 512, mean and std 0.5."""
    if "tiny" in name.lower():
        cfg = tiny_sd(image_size=res or 64)
    elif res is not None and res != 512:
        cfg = SDConfig(image_size=res)
    else:
        cfg = SDConfig()
    half = (0.5, 0.5, 0.5)
    return VisionTower(
        name=name, module=SDFeatureTower(cfg, dtype=dtype, device=device), config=cfg,
        hidden_size=cfg.hidden_size, image_size=cfg.image_size, interp_size=interp,
        image_processor=ImageProcessor(size=cfg.image_size, image_mean=half, image_std=half),
        hf_repo="stabilityai/stable-diffusion-2-1",
    )
