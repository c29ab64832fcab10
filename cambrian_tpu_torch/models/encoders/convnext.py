"""ConvNeXt trunk with multi-stage feature taps
(cambrian_tpu/models/encoders/convnext.py): OpenCLIP CLIP-convnext-XXL at
1024, reduction 32. Every stage's map is resized in fp32 (bilinear) to the
interp grid (96x96 for -interp9216) and the maps are concatenated along
channels -> [B, 9216, 384+768+1536+3072].

The convolutions run in PyTorch's NCHW layout; the depthwise 7x7 conv is
``F.conv2d(groups=C)``, as the JAX path uses XLA's conv there. The JAX
package's flat (h, w, b) row order is a TPU layout choice and is not kept.
"""

from dataclasses import dataclass
from typing import List, Tuple

import torch
from torch import nn

from ...ops.activations import gelu_exact
from ...ops.norms import LayerNorm
from ...ops.resize import resize_bilinear


@dataclass(frozen=True)
class ConvNeXtConfig:
    depths: Tuple[int, ...] = (3, 4, 30, 3)
    dims: Tuple[int, ...] = (384, 768, 1536, 3072)   # XXL
    image_size: int = 1024
    ln_eps: float = 1e-6
    multi_stage: bool = True

    @property
    def hidden_size(self) -> int:
        return sum(self.dims) if self.multi_stage else self.dims[-1]

    @property
    def reduction(self) -> int:
        return 32


def _channel_norm(norm: LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the channels of an NCHW map."""
    return norm(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class ConvNeXtBlock(nn.Module):
    """dwconv 7x7 -> LN -> Linear(4C) -> GELU -> Linear(C) -> gamma, + x."""

    def __init__(self, dim: int, ln_eps: float = 1e-6, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim, **kw)
        self.norm = LayerNorm(dim, ln_eps, device=device)
        self.pwconv1 = nn.Linear(dim, 4 * dim, **kw)
        self.pwconv2 = nn.Linear(4 * dim, dim, **kw)
        self.gamma = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:       # NCHW
        h = self.dwconv(x).permute(0, 2, 3, 1)                 # NHWC
        h = self.pwconv2(gelu_exact(self.pwconv1(self.norm(h))))
        h = h * self.gamma.to(h.dtype)
        return x + h.permute(0, 3, 1, 2)


class ConvNeXt(nn.Module):
    """pixels [B, 3, H, W] -> per-stage NCHW feature maps (list of 4)."""

    def __init__(self, cfg: ConvNeXtConfig, dtype=torch.float32, device=None):
        super().__init__()
        c, kw = cfg, dict(dtype=dtype, device=device)
        self.cfg = cfg
        self.dtype = dtype
        self.stem_conv = nn.Conv2d(3, c.dims[0], 4, stride=4, **kw)
        self.stem_norm = LayerNorm(c.dims[0], c.ln_eps, device=device)
        for s, (depth, dim) in enumerate(zip(c.depths, c.dims)):
            if s > 0:
                self.add_module(f"downsample_norm_{s}",
                                LayerNorm(c.dims[s - 1], c.ln_eps, device=device))
                self.add_module(f"downsample_conv_{s}",
                                nn.Conv2d(c.dims[s - 1], dim, 2, stride=2, **kw))
            for blk in range(depth):
                self.add_module(f"stage_{s}_block_{blk}",
                                ConvNeXtBlock(dim, c.ln_eps, dtype, device))

    def forward(self, pixels: torch.Tensor) -> List[torch.Tensor]:
        c = self.cfg
        x = _channel_norm(self.stem_norm, self.stem_conv(pixels.to(self.dtype)))
        maps = []
        for s, depth in enumerate(c.depths):
            if s > 0:
                x = _channel_norm(getattr(self, f"downsample_norm_{s}"), x)
                x = getattr(self, f"downsample_conv_{s}")(x)
            for blk in range(depth):
                x = getattr(self, f"stage_{s}_block_{blk}")(x)
            maps.append(x)
        return maps


class ConvNeXtTokens(nn.Module):
    """Full tower: stages -> fp32 bilinear resize of each (NHWC) map to the
    target grid -> channel concat -> tokens [B, grid^2, hidden]."""

    def __init__(self, cfg: ConvNeXtConfig, interp_side: int = 96,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        self.interp_side = interp_side
        self.trunk = ConvNeXt(cfg, dtype, device)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        maps = self.trunk(pixels)
        if not self.cfg.multi_stage:
            maps = maps[-1:]
        side = self.interp_side
        resized = [resize_bilinear(m.permute(0, 2, 3, 1), side, side) for m in maps]
        x = torch.cat(resized, dim=-1)
        return x.reshape(x.shape[0], side * side, -1)


def convnext_xxl(image_size: int = 1024, multi_stage: bool = True) -> ConvNeXtConfig:
    return ConvNeXtConfig(depths=(3, 4, 30, 3), dims=(384, 768, 1536, 3072),
                          image_size=image_size, multi_stage=multi_stage)


def convnext_large(image_size: int = 320, multi_stage: bool = True) -> ConvNeXtConfig:
    return ConvNeXtConfig(depths=(3, 3, 27, 3), dims=(192, 384, 768, 1536),
                          image_size=image_size, multi_stage=multi_stage)


def tiny_convnext(image_size: int = 64) -> ConvNeXtConfig:
    return ConvNeXtConfig(depths=(1, 1, 2, 1), dims=(16, 32, 64, 128),
                          image_size=image_size)
