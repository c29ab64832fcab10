"""SAM ViT vision tower (cambrian_tpu/models/encoders/sam.py): a plain-ViT
trunk with window attention (global attention at a few block indices),
decomposed relative positional biases, and a conv neck to 256 channels, the
HF SamVisionEncoder architecture, so weights load from
facebook/sam-vit-{base,large,huge}.

The blocks keep the grid 2-D, [B, H, W, C], as the original does; windows
are folded into the batch axis for attention, which is plain fp32-softmax
attention with the decomposed bias, as in the JAX package. The patch
embedding and the neck run in NCHW.
"""

import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...mm_utils import ImageProcessor
from ...ops.activations import gelu_exact
from ...ops.norms import LayerNorm
from ...ops.resize import linear_resize_matrix
from .base import VisionTower, register_tower


@dataclass(frozen=True)
class SamViTConfig:
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    patch_size: int = 16
    image_size: int = 1024
    window_size: int = 14
    global_attn_indexes: Tuple[int, ...] = (2, 5, 8, 11)
    output_channels: int = 256
    use_rel_pos: bool = True
    ln_eps: float = 1e-6

    @property
    def grid_side(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_side ** 2


@functools.lru_cache(maxsize=None)
def _rel_pos_plan(q_size: int, k_size: int, rows: int):
    """(resize matrix [2 max(q, k) - 1, rows] or None, index [q, k]) of
    ``_get_rel_pos``: the table is resized (linear, as ``jax.image.resize``)
    when its rows differ from 2 max(q, k) - 1, then gathered at the relative
    coordinates."""
    max_rel_dist = 2 * max(q_size, k_size) - 1
    resize = None
    if rows != max_rel_dist:
        resize = torch.from_numpy(linear_resize_matrix(rows, max_rel_dist))
    q_coords = np.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    k_coords = np.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    relative = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return resize, torch.from_numpy(relative.astype(np.int64))


def _get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """Slice/resize the relative position table to [q_size, k_size, dim]. A
    table of other rows than 2 max(q, k) - 1 is resized first (the blocks
    size theirs to fit, so only a direct call reaches that)."""
    resize, index = _rel_pos_plan(q_size, k_size, rel_pos.shape[0])
    rel = rel_pos
    if resize is not None:
        rel = (resize.to(rel_pos.device) @ rel_pos.float()).to(rel_pos.dtype)
    return rel[index.to(rel_pos.device)]


class SamAttention(nn.Module):
    """``input_size`` gives the relative-position tables their rows
    (2 side - 1): the window's, or the grid's in a global block."""

    def __init__(self, cfg: SamViTConfig, input_size: Tuple[int, int], dtype=torch.float32,
                 device=None):
        super().__init__()
        c, kw = cfg, dict(dtype=dtype, device=device)
        self.cfg = cfg
        head_dim = c.hidden_size // c.num_heads
        self.qkv = nn.Linear(c.hidden_size, 3 * c.hidden_size, **kw)
        self.proj = nn.Linear(c.hidden_size, c.hidden_size, **kw)
        if c.use_rel_pos:
            self.rel_pos_h = nn.Parameter(
                torch.zeros(2 * input_size[0] - 1, head_dim, device=device))
            self.rel_pos_w = nn.Parameter(
                torch.zeros(2 * input_size[1] - 1, head_dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:          # x: [B, H, W, C]
        c = self.cfg
        b, h, w, _ = x.shape
        nh, hd = c.num_heads, c.hidden_size // c.num_heads
        qkv = self.qkv(x).reshape(b, h * w, 3, nh, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]                          # [B, nH, HW, d]
        attn = torch.einsum("bnqd,bnkd->bnqk", (q * hd ** -0.5).float(), k.float())
        if c.use_rel_pos:
            rh = _get_rel_pos(h, h, self.rel_pos_h).float()
            rw = _get_rel_pos(w, w, self.rel_pos_w).float()
            r_q = q.reshape(b, nh, h, w, hd).float()
            rel_h = torch.einsum("bnhwc,hkc->bnhwk", r_q, rh)
            rel_w = torch.einsum("bnhwc,wkc->bnhwk", r_q, rw)
            attn = attn.reshape(b, nh, h, w, h, w)
            attn = attn + rel_h[:, :, :, :, :, None] + rel_w[:, :, :, :, None, :]
            attn = attn.reshape(b, nh, h * w, h * w)
        attn = torch.softmax(attn, dim=-1).to(x.dtype)
        out = torch.einsum("bnqk,bnkd->bnqd", attn, v)
        out = out.permute(0, 2, 1, 3).reshape(b, h, w, c.hidden_size)
        return self.proj(out)


def window_partition(x: torch.Tensor, window: int):
    """[B, H, W, C] -> [B * nw, win, win, C] with bottom/right zero padding
    (a 64 x 64 grid becomes 70 x 70 for windows of 14)."""
    b, h, w, c = x.shape
    pad_h = (window - h % window) % window
    pad_w = (window - w % window) % window
    x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.reshape(b, hp // window, window, wp // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, c), (hp, wp)


def window_unpartition(windows: torch.Tensor, window: int, pad_hw, hw) -> torch.Tensor:
    hp, wp = pad_hw
    h, w = hw
    b = windows.shape[0] // (hp * wp // window // window)
    x = windows.reshape(b, hp // window, wp // window, window, window, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w]


class SamBlock(nn.Module):
    def __init__(self, cfg: SamViTConfig, window_size: int, dtype=torch.float32, device=None):
        super().__init__()
        c, kw = cfg, dict(dtype=dtype, device=device)
        self.window_size = window_size
        side = window_size if window_size > 0 else c.grid_side
        self.norm1 = LayerNorm(c.hidden_size, c.ln_eps, device=device)
        self.attn = SamAttention(c, (side, side), dtype, device)
        self.norm2 = LayerNorm(c.hidden_size, c.ln_eps, device=device)
        self.mlp_lin1 = nn.Linear(c.hidden_size, int(c.hidden_size * c.mlp_ratio), **kw)
        self.mlp_lin2 = nn.Linear(int(c.hidden_size * c.mlp_ratio), c.hidden_size, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        x = self.norm1(x)
        h, w = x.shape[1], x.shape[2]
        if self.window_size > 0:
            x, pad_hw = window_partition(x, self.window_size)
        x = self.attn(x)
        if self.window_size > 0:
            x = window_unpartition(x, self.window_size, pad_hw, (h, w))
        x = shortcut + x
        return x + self.mlp_lin2(gelu_exact(self.mlp_lin1(self.norm2(x))))


class ChannelLayerNorm(nn.Module):
    """SAM's LayerNorm2d over the channel axis of an NCHW map, fp32 math."""

    def __init__(self, channels: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(1, keepdim=True)
        var = (x32 - mean).square().mean(1, keepdim=True)
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight.float()[:, None, None] + self.bias.float()[:, None, None]).to(
            x.dtype)


class SamViT(nn.Module):
    """Trunk + neck: pixels [B, 3, H, W] -> tokens [B, grid^2, output_channels]."""

    def __init__(self, cfg: SamViTConfig, dtype=torch.float32, device=None):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.dtype = dtype
        self.patch_embed = nn.Conv2d(3, c.hidden_size, c.patch_size, stride=c.patch_size,
                                     dtype=dtype, device=device)
        self.pos_embed = nn.Parameter(
            torch.zeros(1, c.grid_side, c.grid_side, c.hidden_size, device=device))
        for i in range(c.num_layers):
            window = 0 if i in c.global_attn_indexes else c.window_size
            self.add_module(f"blocks_{i}", SamBlock(c, window, dtype, device))
        kw = dict(bias=False, dtype=dtype, device=device)
        self.neck_conv1 = nn.Conv2d(c.hidden_size, c.output_channels, 1, **kw)
        self.neck_ln1 = ChannelLayerNorm(c.output_channels, c.ln_eps, device=device)
        self.neck_conv2 = nn.Conv2d(c.output_channels, c.output_channels, 3, padding=1, **kw)
        self.neck_ln2 = ChannelLayerNorm(c.output_channels, c.ln_eps, device=device)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        x = self.patch_embed(pixels.to(self.dtype)).permute(0, 2, 3, 1)   # [B, H, W, C]
        x = x + self.pos_embed.to(x.dtype)
        for i in range(c.num_layers):
            x = getattr(self, f"blocks_{i}")(x)
        x = x.permute(0, 3, 1, 2)
        x = self.neck_ln1(self.neck_conv1(x))
        x = self.neck_ln2(self.neck_conv2(x))
        return x.flatten(2).transpose(1, 2)


SAM_MODEL_CONFIGS = {
    "sam_vit_b": SamViTConfig(hidden_size=768, num_layers=12, num_heads=12,
                              global_attn_indexes=(2, 5, 8, 11)),
    "sam_vit_l": SamViTConfig(hidden_size=1024, num_layers=24, num_heads=16,
                              global_attn_indexes=(5, 11, 17, 23)),
    "sam_vit_h": SamViTConfig(hidden_size=1280, num_layers=32, num_heads=16,
                              global_attn_indexes=(7, 15, 23, 31)),
}

_SAM_REPOS = {
    "sam_vit_b": "facebook/sam-vit-base",
    "sam_vit_l": "facebook/sam-vit-large",
    "sam_vit_h": "facebook/sam-vit-huge",
}


class SamImageProcessor(ImageProcessor):
    """Longest-side resize + bottom/right zero pad, 0-255-scale
    normalization. PIL, on the host."""

    def __init__(self, size=1024):
        super().__init__(size=size, image_mean=(0.485, 0.456, 0.406),
                         image_std=(0.229, 0.224, 0.225), resample="bilinear",
                         rescale_factor=1.0)
        self._mean255 = np.asarray([123.675, 116.28, 103.53], np.float32)
        self._std255 = np.asarray([58.395, 57.12, 57.375], np.float32)

    def preprocess(self, pil_img, return_tensors: Optional[str] = None):
        pil_img = pil_img.convert("RGB")
        w, h = pil_img.size
        scale = self.size / max(w, h)
        new_w, new_h = int(w * scale + 0.5), int(h * scale + 0.5)
        pil_img = pil_img.resize((new_w, new_h), 2)
        arr = np.asarray(pil_img, dtype=np.float32)
        arr = (arr - self._mean255) / self._std255
        out = np.zeros((self.size, self.size, 3), np.float32)
        out[:new_h, :new_w] = arr
        return {"pixel_values": out.transpose(2, 0, 1)[None]}


@register_tower("sam")
def _build_sam(name, res, interp, dtype, device):
    """SAM ViT-B/L/H; a ``-res`` override sizes the position embedding and
    the global blocks' tables for its own grid."""
    key = "sam_vit_h" if "vit_h" in name or "vit-h" in name else \
        "sam_vit_l" if "vit_l" in name or "vit-l" in name else "sam_vit_b"
    cfg = SAM_MODEL_CONFIGS[key]
    if res is not None and res != cfg.image_size:
        cfg = SamViTConfig(**{**cfg.__dict__, "image_size": res})
    module = SamViT(cfg, dtype=dtype, device=device)
    return VisionTower(
        name=name, module=module, config=cfg,
        hidden_size=cfg.output_channels, image_size=cfg.image_size,
        interp_size=interp,
        image_processor=SamImageProcessor(size=cfg.image_size),
        hf_repo=_SAM_REPOS[key],
    )


def convert_sam_vision(sd, cfg: SamViTConfig) -> dict:
    """HF SamVisionEncoder (vision_encoder.*) -> the JAX package's SamViT
    tree, which ``checkpoint/from_jax.py`` maps onto ``SamViT``."""
    p = "vision_encoder."
    if not any(k.startswith(p) for k in sd):
        p = ""

    def conv_k(w):
        return np.transpose(w, (2, 3, 1, 0))

    params = {
        "patch_embed": {
            "kernel": conv_k(sd[p + "patch_embed.projection.weight"]),
            "bias": sd[p + "patch_embed.projection.bias"],
        },
        "pos_embed": sd[p + "pos_embed"],
        "neck_conv1": {"kernel": conv_k(sd[p + "neck.conv1.weight"])},
        "neck_ln1": {"weight": sd[p + "neck.layer_norm1.weight"],
                     "bias": sd[p + "neck.layer_norm1.bias"]},
        "neck_conv2": {"kernel": conv_k(sd[p + "neck.conv2.weight"])},
        "neck_ln2": {"weight": sd[p + "neck.layer_norm2.weight"],
                     "bias": sd[p + "neck.layer_norm2.bias"]},
    }
    for i in range(cfg.num_layers):
        lp = f"{p}layers.{i}."
        block = {
            "norm1": {"scale": sd[lp + "layer_norm1.weight"],
                      "bias": sd[lp + "layer_norm1.bias"]},
            "norm2": {"scale": sd[lp + "layer_norm2.weight"],
                      "bias": sd[lp + "layer_norm2.bias"]},
            "attn": {
                "qkv": {"kernel": sd[lp + "attn.qkv.weight"].T,
                        "bias": sd[lp + "attn.qkv.bias"]},
                "proj": {"kernel": sd[lp + "attn.proj.weight"].T,
                         "bias": sd[lp + "attn.proj.bias"]},
            },
            "mlp_lin1": {"kernel": sd[lp + "mlp.lin1.weight"].T,
                         "bias": sd[lp + "mlp.lin1.bias"]},
            "mlp_lin2": {"kernel": sd[lp + "mlp.lin2.weight"].T,
                         "bias": sd[lp + "mlp.lin2.bias"]},
        }
        if cfg.use_rel_pos:
            block["attn"]["rel_pos_h"] = sd[lp + "attn.rel_pos_h"]
            block["attn"]["rel_pos_w"] = sd[lp + "attn.rel_pos_w"]
        params[f"blocks_{i}"] = block
    return params
