"""Stable-Diffusion-2.1 one-step-denoise feature tower
(cambrian_tpu/models/encoders/diffusion.py): VAE-encode the image to
4 x 64 x 64 latents, add DDIM noise at a fixed timestep (t = 250), run the
SD-2.1 UNet conditioned on an empty-prompt embedding, tap the output of
every up block, resize each map bilinearly (fp32) to the 32 x 32 token grid
and concatenate the channels -> [B, 1024, 3520].

The convolutions run in PyTorch's NCHW layout; tokens are read row-major
over (h, w), the JAX package's order. GroupNorm statistics are fp32 (the
VAE's eps 1e-6, the UNet's 1e-5). The UNet's spatial self-attention goes
through the flash-attention kernel (K1) when it has at least 128 queries;
the cross-attention over the 77 empty-prompt rows, smaller self-attention
and the VAE's single-head attention are plain fp32-softmax attention, as in
the JAX package. The empty-prompt embedding is a tower parameter
([77, 1024]).

The noise: ``SDFeatureTower.forward`` takes it as ``noise`` (the latents'
shape, [B, 4, h, w]); without it, it draws from a ``torch.Generator`` seeded
with ``noise_seed`` on the latents' device. That draw is not JAX's
(``jax.random.normal(PRNGKey(noise_seed))``), so the two packages' default
features differ; given the same noise they agree.
"""

import functools
import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.activations import gelu_exact
from ...ops.flash_attention import flash_attention
from ...ops.norms import LayerNorm
from ...ops.resize import resize_bilinear


@dataclass(frozen=True)
class SDConfig:
    """Geometry of stabilityai/stable-diffusion-2-1 (UNet + VAE encoder)."""

    image_size: int = 512
    patch_size: int = 16                       # output grid = image/patch
    # VAE encoder
    vae_channels: Tuple[int, ...] = (128, 256, 512, 512)
    vae_layers_per_block: int = 2
    latent_channels: int = 4
    scaling_factor: float = 0.18215
    # UNet
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    num_heads: Tuple[int, ...] = (5, 10, 20, 20)   # head_dim 64 everywhere
    cross_attention_dim: int = 1024
    norm_groups: int = 32
    time_embed_dim: int = 1280                 # 4 * block_out_channels[0]
    # DDIM (scaled-linear betas, SD scheduler config)
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    time_step: int = 250
    up_ft_indices: Tuple[int, ...] = (0, 1, 2, 3)
    noise_seed: int = 0
    ln_eps: float = 1e-5
    gn_eps: float = 1e-6                       # VAE GroupNorm eps
    unet_gn_eps: float = 1e-5

    @property
    def hidden_size(self) -> int:
        rev = tuple(reversed(self.block_out_channels))
        return sum(rev[i] for i in self.up_ft_indices)

    @property
    def grid_side(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_side ** 2


def tiny_sd(image_size: int = 64) -> SDConfig:
    """Small geometry for tests: same topology, tiny widths. The latent grid
    must survive the UNet's 3 halvings, so image_size >= 64 (latent 8)."""
    return SDConfig(
        image_size=image_size, patch_size=16,
        vae_channels=(8, 8, 16, 16), latent_channels=4,
        block_out_channels=(8, 16, 16, 16), layers_per_block=1,
        num_heads=(1, 2, 2, 2), cross_attention_dim=16,
        norm_groups=4, time_embed_dim=32,
    )


def ddim_alphas_cumprod(cfg: SDConfig) -> np.ndarray:
    """SD scheduler's scaled-linear schedule: betas linear in sqrt space."""
    betas = np.linspace(cfg.beta_start ** 0.5, cfg.beta_end ** 0.5,
                        cfg.num_train_timesteps, dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas)


def add_noise(cfg: SDConfig, latents, noise, t: int):
    """The scheduler's add_noise: sqrt(acp) latents + sqrt(1 - acp) noise."""
    acp = ddim_alphas_cumprod(cfg)[t]
    return (np.sqrt(acp).astype(np.float32) * latents
            + np.sqrt(1.0 - acp).astype(np.float32) * noise)


class GroupNorm32(nn.Module):
    """GroupNorm with fp32 statistics whatever the compute dtype; its fp32
    weights sit in ``gn``, as the flax module's in its ``gn`` child."""

    def __init__(self, groups: int, channels: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.gn = nn.GroupNorm(groups, channels, eps, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gn = self.gn
        return F.group_norm(x.float(), gn.num_groups, gn.weight.float(), gn.bias.float(),
                            gn.eps).to(x.dtype)


def _conv(cin, cout, k, dtype, device, **kw):
    return nn.Conv2d(cin, cout, k, padding=k // 2, dtype=dtype, device=device, **kw)


class ResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, cfg: SDConfig, use_temb: bool = True,
                 gn_eps: float = 1e-5, dtype=torch.float32, device=None):
        super().__init__()
        self.norm1 = GroupNorm32(cfg.norm_groups, in_ch, gn_eps, device)
        self.conv1 = _conv(in_ch, out_ch, 3, dtype, device)
        if use_temb:
            self.time_emb_proj = nn.Linear(cfg.time_embed_dim, out_ch, dtype=dtype,
                                           device=device)
        self.norm2 = GroupNorm32(cfg.norm_groups, out_ch, gn_eps, device)
        self.conv2 = _conv(out_ch, out_ch, 3, dtype, device)
        if in_ch != out_ch:
            self.conv_shortcut = _conv(in_ch, out_ch, 1, dtype, device)

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None and hasattr(self, "time_emb_proj"):
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


def _plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[B, Q, H, D] x [B, K, H, D]: fp32 logits and softmax, probabilities in
    v's dtype for the PV product."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    probs = torch.softmax(logits * q.shape[-1] ** -0.5, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


class VAEAttnBlock(nn.Module):
    """Single-head spatial self-attention in the VAE mid block (plain)."""

    def __init__(self, channels: int, cfg: SDConfig, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.group_norm = GroupNorm32(cfg.norm_groups, channels, cfg.gn_eps, device)
        self.to_q = nn.Linear(channels, channels, **kw)
        self.to_k = nn.Linear(channels, channels, **kw)
        self.to_v = nn.Linear(channels, channels, **kw)
        self.to_out = nn.Linear(channels, channels, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        t = self.group_norm(x).flatten(2).transpose(1, 2)           # [B, HW, C]
        q, k, v = (p(t)[:, :, None] for p in (self.to_q, self.to_k, self.to_v))
        out = self.to_out(_plain_attention(q, k, v)[:, :, 0])
        return x + out.transpose(1, 2).reshape(b, c, h, w)


class VAEEncoder(nn.Module):
    """AutoencoderKL encoder + quant_conv; returns the latent mode (the mean
    channels), [B, latent_channels, H / 8, W / 8]."""

    def __init__(self, cfg: SDConfig, dtype=torch.float32, device=None):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.dtype = dtype
        vc = c.vae_channels
        self.conv_in = _conv(3, vc[0], 3, dtype, device)
        prev = vc[0]
        for i, ch in enumerate(vc):
            for j in range(c.vae_layers_per_block):
                self.add_module(f"down_{i}_resnet_{j}", ResnetBlock(
                    prev, ch, c, use_temb=False, gn_eps=c.gn_eps, dtype=dtype, device=device))
                prev = ch
            if i != len(vc) - 1:
                # diffusers pads (0, 1, 0, 1), then a VALID stride-2 conv
                self.add_module(f"down_{i}_downsample", nn.Conv2d(
                    ch, ch, 3, stride=2, dtype=dtype, device=device))
        for name in ("mid_resnet_0", "mid_resnet_1"):
            self.add_module(name, ResnetBlock(vc[-1], vc[-1], c, use_temb=False,
                                              gn_eps=c.gn_eps, dtype=dtype, device=device))
        self.mid_attn = VAEAttnBlock(vc[-1], c, dtype, device)
        self.conv_norm_out = GroupNorm32(c.norm_groups, vc[-1], c.gn_eps, device)
        self.conv_out = _conv(vc[-1], 2 * c.latent_channels, 3, dtype, device)
        self.quant_conv = _conv(2 * c.latent_channels, 2 * c.latent_channels, 1, dtype, device)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        x = self.conv_in(pixels.to(self.dtype))
        for i in range(len(c.vae_channels)):
            for j in range(c.vae_layers_per_block):
                x = getattr(self, f"down_{i}_resnet_{j}")(x)
            if i != len(c.vae_channels) - 1:
                x = getattr(self, f"down_{i}_downsample")(F.pad(x, (0, 1, 0, 1)))
        x = self.mid_resnet_1(self.mid_attn(self.mid_resnet_0(x)))
        x = self.conv_out(F.silu(self.conv_norm_out(x)))
        return self.quant_conv(x)[:, :c.latent_channels]


class TransformerBlock(nn.Module):
    """diffusers BasicTransformerBlock: self-attention, cross-attention over
    the context, GEGLU feed-forward (exact GELU)."""

    def __init__(self, heads: int, dim: int, cfg: SDConfig, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.heads = heads
        ctx = cfg.cross_attention_dim
        for i in (1, 2, 3):
            self.add_module(f"norm{i}", LayerNorm(dim, cfg.ln_eps, device=device))
        for name, kv_dim in (("attn1", dim), ("attn2", ctx)):
            self.add_module(f"{name}_to_q", nn.Linear(dim, dim, bias=False, **kw))
            self.add_module(f"{name}_to_k", nn.Linear(kv_dim, dim, bias=False, **kw))
            self.add_module(f"{name}_to_v", nn.Linear(kv_dim, dim, bias=False, **kw))
            self.add_module(f"{name}_to_out", nn.Linear(dim, dim, **kw))
        self.ff_geglu = nn.Linear(dim, 8 * dim, **kw)
        self.ff_out = nn.Linear(4 * dim, dim, **kw)

    def _attn(self, x: torch.Tensor, context: torch.Tensor, name: str) -> torch.Tensor:
        b, nq, c = x.shape
        nk = context.shape[1]
        q = getattr(self, f"{name}_to_q")(x).view(b, nq, self.heads, c // self.heads)
        k = getattr(self, f"{name}_to_k")(context).view(b, nk, self.heads, c // self.heads)
        v = getattr(self, f"{name}_to_v")(context).view(b, nk, self.heads, c // self.heads)
        if context is x and nq >= 128:
            out = flash_attention(q, k, v)
        else:
            out = _plain_attention(q, k, v)
        return getattr(self, f"{name}_to_out")(out.reshape(b, nq, c))

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        h = self.norm1(x)
        x = x + self._attn(h, h, "attn1")
        x = x + self._attn(self.norm2(x), context, "attn2")
        u, gate = self.ff_geglu(self.norm3(x)).chunk(2, dim=-1)
        return x + self.ff_out(u * gelu_exact(gate))


class SpatialTransformer(nn.Module):
    """Transformer2DModel with use_linear_projection=True (SD-2.x)."""

    def __init__(self, heads: int, channels: int, cfg: SDConfig, dtype=torch.float32,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        # diffusers Transformer2DModel hardcodes GroupNorm eps=1e-6
        self.norm = GroupNorm32(cfg.norm_groups, channels, 1e-6, device)
        self.proj_in = nn.Linear(channels, channels, **kw)
        self.block_0 = TransformerBlock(heads, channels, cfg, dtype, device)
        self.proj_out = nn.Linear(channels, channels, **kw)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        t = self.proj_in(self.norm(x).flatten(2).transpose(1, 2))
        t = self.proj_out(self.block_0(t, context))
        return x + t.transpose(1, 2).reshape(b, c, h, w)


@functools.lru_cache(maxsize=None)
def _timestep_freqs(dim: int) -> torch.Tensor:
    half = dim // 2
    exponent = -np.log(10000.0) * np.arange(half, dtype=np.float64) / half
    return torch.from_numpy(np.exp(exponent).astype(np.float32))


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """diffusers get_timestep_embedding with flip_sin_to_cos=True,
    downscale_freq_shift=0 (UNet2DConditionModel defaults): fp32 [B, dim]."""
    ang = t.float()[:, None] * _timestep_freqs(dim).to(t.device)[None, :]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


class SDUNet(nn.Module):
    """SD-2.1 UNet2DConditionModel with the up-block tap: returns
    ``{i: the output map of up block i}`` (NCHW) for i in cfg.up_ft_indices."""

    def __init__(self, cfg: SDConfig, dtype=torch.float32, device=None):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device)
        bc, n = c.block_out_channels, len(c.block_out_channels)
        self.time_linear_1 = nn.Linear(bc[0], c.time_embed_dim, **kw)
        self.time_linear_2 = nn.Linear(c.time_embed_dim, c.time_embed_dim, **kw)
        self.conv_in = _conv(c.latent_channels, bc[0], 3, dtype, device)

        def resnet(name, cin, cout):
            self.add_module(name, ResnetBlock(cin, cout, c, gn_eps=c.unet_gn_eps, **kw))

        def spatial(name, heads, ch):
            self.add_module(name, SpatialTransformer(heads, ch, c, **kw))

        skips, prev = [bc[0]], bc[0]
        for i, ch in enumerate(bc):
            for j in range(c.layers_per_block):
                resnet(f"down_{i}_resnet_{j}", prev, ch)
                prev = ch
                if i < n - 1:                  # the last down block has no attention
                    spatial(f"down_{i}_attn_{j}", c.num_heads[i], ch)
                skips.append(ch)
            if i != n - 1:
                self.add_module(f"down_{i}_downsample",
                                nn.Conv2d(ch, ch, 3, stride=2, padding=1, **kw))
                skips.append(ch)
        resnet("mid_resnet_0", bc[-1], bc[-1])
        spatial("mid_attn", c.num_heads[-1], bc[-1])
        resnet("mid_resnet_1", bc[-1], bc[-1])
        for i, ch in enumerate(reversed(bc)):
            for j in range(c.layers_per_block + 1):
                resnet(f"up_{i}_resnet_{j}", prev + skips.pop(), ch)
                prev = ch
                if i > 0:                      # the first up block has no attention
                    spatial(f"up_{i}_attn_{j}", c.num_heads[n - 1 - i], ch)
            if i != n - 1:
                self.add_module(f"up_{i}_upsample", _conv(ch, ch, 3, dtype, device))

    def forward(self, latents: torch.Tensor, t: int,
                context: torch.Tensor) -> Dict[int, torch.Tensor]:
        c = self.cfg
        n = len(c.block_out_channels)
        b = latents.shape[0]
        temb = timestep_embedding(torch.full((b,), t, device=latents.device),
                                  c.block_out_channels[0])
        temb = self.time_linear_2(F.silu(self.time_linear_1(temb.to(self.dtype))))
        x = self.conv_in(latents)
        skips = [x]
        for i in range(n):
            for j in range(c.layers_per_block):
                x = getattr(self, f"down_{i}_resnet_{j}")(x, temb)
                if i < n - 1:
                    x = getattr(self, f"down_{i}_attn_{j}")(x, context)
                skips.append(x)
            if i != n - 1:
                x = getattr(self, f"down_{i}_downsample")(x)
                skips.append(x)
        x = self.mid_resnet_0(x, temb)
        x = self.mid_attn(x, context)
        x = self.mid_resnet_1(x, temb)
        up_ft = {}
        for i in range(n):
            for j in range(c.layers_per_block + 1):
                x = torch.cat([x, skips.pop()], dim=1)
                x = getattr(self, f"up_{i}_resnet_{j}")(x, temb)
                if i > 0:
                    x = getattr(self, f"up_{i}_attn_{j}")(x, context)
            if i != n - 1:
                x = F.interpolate(x, scale_factor=2.0, mode="nearest")
                x = getattr(self, f"up_{i}_upsample")(x)
            if i in c.up_ft_indices:
                up_ft[i] = x
        return up_ft


class SDFeatureTower(nn.Module):
    """The one-step-denoise tower: pixels [B, 3, H, W] -> [B, grid^2,
    hidden_size]: each up-block tap resized bilinearly (fp32,
    align_corners=False) to the token grid, channels concatenated, tokens
    row-major."""

    def __init__(self, cfg: SDConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.vae = VAEEncoder(cfg, dtype, device)
        self.unet = SDUNet(cfg, dtype, device)
        self.empty_prompt_embeds = nn.Parameter(
            torch.zeros(77, cfg.cross_attention_dim, device=device))

    def forward(self, pixels: torch.Tensor, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``noise``: fp32 [B, latent_channels, H / 8, W / 8]; by default a
        draw from a ``torch.Generator`` seeded with ``cfg.noise_seed`` on the
        latents' device (not the JAX package's draw)."""
        c = self.cfg
        latents = c.scaling_factor * self.vae(pixels).float()
        if noise is None:
            g = torch.Generator(device=latents.device).manual_seed(c.noise_seed)
            noise = torch.randn(latents.shape, generator=g, device=latents.device)
        elif tuple(noise.shape) != tuple(latents.shape):
            raise ValueError(f"noise must be {tuple(latents.shape)}, got {tuple(noise.shape)}")
        acp = float(ddim_alphas_cumprod(c)[c.time_step])
        noisy = math.sqrt(acp) * latents + math.sqrt(1 - acp) * noise.to(latents.device).float()
        context = self.empty_prompt_embeds[None].to(self.dtype).expand(
            latents.shape[0], -1, -1)
        up_ft = self.unet(noisy.to(self.dtype), c.time_step, context)
        side = c.grid_side
        feats = []
        for i in sorted(up_ft):
            f = up_ft[i].permute(0, 2, 3, 1)                        # NHWC
            if f.shape[1] != side:
                f = resize_bilinear(f, side, side)
            feats.append(f.reshape(f.shape[0], side * side, f.shape[-1]))
        return torch.cat(feats, dim=-1)
