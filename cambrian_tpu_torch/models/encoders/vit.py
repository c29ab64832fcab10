"""Vision Transformer for the ViT towers
(cambrian_tpu/models/encoders/vit.py): CLIP-ViT-L/14-336 (class token,
pre-LayerNorm, quick_gelu, tapped at layer -2), SigLIP-SO400M/384 (no class
token, tanh GELU, final LayerNorm), DINOv2-giant (class token, registers
optional, SwiGLU FFN, LayerScale), and the encoder-study variants of
``extra.py``: EVA-02 (2-D axial rotary embedding on the patch tokens, sub-LN
SwiGLU FFN, key without bias) and BEiT (a learned relative-position bias in
every block, no absolute position embedding).

Module and parameter names mirror the flax tree (``blocks_3.attn.q_proj``),
so ``checkpoint/from_jax.py`` maps the JAX parameters mechanically. Every
block's attention goes through the flash-attention kernel on the card,
rotary q and k included, except BEiT's: its bias is added to the logits of
plain fp32-softmax attention, as in the JAX package.
"""

import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.activations import gelu_exact
from ...ops.flash_attention import flash_attention
from ...ops.norms import LayerNorm


@dataclass(frozen=True)
class ViTConfig:
    hidden_size: int
    num_layers: int
    num_heads: int
    intermediate_size: int
    patch_size: int
    image_size: int
    class_token: bool = True
    num_register_tokens: int = 0
    pre_layernorm: bool = False          # CLIP's pre_layrnorm after embeddings
    final_layernorm: bool = True         # applied only on full-depth forward
    act: str = "gelu"                    # gelu | quick_gelu | gelu_tanh
    swiglu: bool = False                 # DINOv2-giant FFN
    layer_scale: bool = False            # DINOv2 LayerScale
    ln_eps: float = 1e-5
    patch_bias: bool = True              # CLIP patch conv has no bias
    select_layer: int = 0                # 0/None = full forward; -2 = CLIP tap
    select_feature: str = "patch"        # patch | cls_patch
    # ----- BEiT / EVA-02 variants ----------------------------------------
    k_bias: bool = True                  # BEiT/EVA-02: key proj has no bias
    abs_pos_embed: bool = True           # BEiT: no absolute position embed
    rel_pos_bias: bool = False           # BEiT: per-block relative pos bias
    rope: bool = False                   # EVA-02: 2-D axial rotary embedding
    rope_ref_side: int = 0               # EVA-02 pretrain grid side (pt_seq_len)
    swiglu_ln: bool = False              # EVA-02 sub-LN SwiGLU (LN before fc2)

    @property
    def grid_side(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_side ** 2

    @property
    def num_prefix_tokens(self) -> int:
        return (1 if self.class_token else 0) + self.num_register_tokens

    @property
    def num_blocks_to_run(self) -> int:
        """select_layer indexes the HF hidden_states list: hidden_states[-2]
        is the output of block L-1."""
        if self.select_layer in (0, None):
            return self.num_layers
        if self.select_layer < 0:
            return self.num_layers + self.select_layer + 1
        return self.select_layer


def _activation(name: str):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    if name == "gelu_tanh":
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "gelu":
        return gelu_exact
    raise ValueError(f"unknown activation {name}")


@functools.lru_cache(maxsize=None)
def _rope_tables(side: int, head_dim: int, ref_side: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """EVA-02 2-D axial rotary tables (sin, cos), fp32 [side^2, head_dim], for
    a ``side`` x ``side`` patch grid: theta 10000 over ``head_dim // 2`` dims
    an axis, positions rescaled to the pretrain grid ``ref_side``
    (ft_seq_len / pt_seq_len), each angle repeated for its interleaved pair,
    the row axis' half before the column axis'. Computed in float64 and
    rounded once, as the JAX package computes them."""
    axis_dim = head_dim // 2
    freqs = 1.0 / (10000.0 ** (np.arange(0, axis_dim, 2, dtype=np.float64) / axis_dim))
    t = np.arange(side, dtype=np.float64)
    if ref_side and ref_side != side:
        t = t / side * ref_side
    ang = np.repeat(np.einsum("s,f->sf", t, freqs), 2, axis=-1)    # [side, axis_dim]
    ang_h = np.broadcast_to(ang[:, None, :], (side, side, axis_dim))
    ang_w = np.broadcast_to(ang[None, :, :], (side, side, axis_dim))
    full = np.concatenate([ang_h, ang_w], axis=-1).reshape(side * side, head_dim)
    return (torch.from_numpy(np.sin(full).astype(np.float32)),
            torch.from_numpy(np.cos(full).astype(np.float32)))


def _rotate_every_two(x: torch.Tensor) -> torch.Tensor:
    """(x0, x1, x2, x3, ...) -> (-x1, x0, -x3, x2, ...): EVA-02 rotates
    interleaved pairs, not the two halves LLaMA's ``rotate_half`` takes."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([-x2, x1], dim=-1).reshape(x.shape)


def _apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor,
                n_prefix: int) -> torch.Tensor:
    """Rotate the patch tokens of x [B, N, H, D]; the ``n_prefix`` prefix
    (class) tokens pass through, as EVA-02 splits them off first."""
    prefix, patches = x[:, :n_prefix], x[:, n_prefix:]
    sin = sin[None, :, None, :].to(x.dtype)
    cos = cos[None, :, None, :].to(x.dtype)
    patches = patches * cos + _rotate_every_two(patches) * sin
    return torch.cat([prefix, patches], dim=1) if n_prefix else patches


def beit_relative_position_index(side: int) -> np.ndarray:
    """Static [1+g^2, 1+g^2] lookup into the (2g-1)^2+3 BEiT relative-distance
    table; the 3 extra rows cover cls<->patch and cls<->cls (HF
    BeitRelativePositionBias semantics)."""
    coords = np.stack(np.meshgrid(np.arange(side), np.arange(side),
                                  indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel = rel + (side - 1)
    rel[:, :, 0] *= 2 * side - 1
    n = side * side
    num_dist = (2 * side - 1) ** 2 + 3
    index = np.zeros((n + 1, n + 1), dtype=np.int32)
    index[1:, 1:] = rel.sum(-1)
    index[0, 0:] = num_dist - 3
    index[0:, 0] = num_dist - 2
    index[0, 0] = num_dist - 1
    return index


@functools.lru_cache(maxsize=None)
def _rel_pos_index(side: int) -> torch.Tensor:
    return torch.from_numpy(beit_relative_position_index(side).astype(np.int64))


class ViTAttention(nn.Module):
    def __init__(self, cfg: ViTConfig, dtype=torch.float32, device=None):
        super().__init__()
        c, kw = cfg, dict(dtype=dtype, device=device)
        self.cfg = cfg
        self.q_proj = nn.Linear(c.hidden_size, c.hidden_size, **kw)
        self.k_proj = nn.Linear(c.hidden_size, c.hidden_size, bias=c.k_bias, **kw)
        self.v_proj = nn.Linear(c.hidden_size, c.hidden_size, **kw)
        self.out_proj = nn.Linear(c.hidden_size, c.hidden_size, **kw)
        if c.rel_pos_bias:
            num_dist = (2 * c.grid_side - 1) ** 2 + 3
            self.rel_pos_table = nn.Parameter(torch.zeros(num_dist, c.num_heads, device=device))

    def forward(self, x: torch.Tensor, rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                rel_pos_index: Optional[torch.Tensor] = None) -> torch.Tensor:
        c = self.cfg
        b, n, _ = x.shape
        head_dim = c.hidden_size // c.num_heads
        shape = (b, n, c.num_heads, head_dim)
        q = self.q_proj(x).view(shape)
        k = self.k_proj(x).view(shape)
        v = self.v_proj(x).view(shape)
        if rope is not None:
            q = _apply_rope(q, *rope, c.num_prefix_tokens)
            k = _apply_rope(k, *rope, c.num_prefix_tokens)
        if rel_pos_index is None:
            out = flash_attention(q, k, v)
        else:
            # BEiT: the learned bias added to fp32 logits; plain attention,
            # as in the JAX package (the flash kernel takes no bias)
            bias = self.rel_pos_table[rel_pos_index].permute(2, 0, 1)      # [H, N, N]
            logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
            logits = logits * head_dim ** -0.5 + bias[None]
            probs = torch.softmax(logits, dim=-1).to(v.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        return self.out_proj(out.reshape(b, n, c.hidden_size))


class ViTMlp(nn.Module):
    def __init__(self, cfg: ViTConfig, dtype=torch.float32, device=None):
        super().__init__()
        c, kw = cfg, dict(dtype=dtype, device=device)
        self.cfg = cfg
        if c.swiglu_ln:
            # EVA-02 sub-LN SwiGLU: silu(w1 x) * (w2 x) -> LayerNorm -> w3
            self.w1 = nn.Linear(c.hidden_size, c.intermediate_size, **kw)
            self.w2 = nn.Linear(c.hidden_size, c.intermediate_size, **kw)
            self.ffn_ln = LayerNorm(c.intermediate_size, c.ln_eps, device=device)
            self.w3 = nn.Linear(c.intermediate_size, c.hidden_size, **kw)
        elif c.swiglu:
            self.weights_in = nn.Linear(c.hidden_size, 2 * c.intermediate_size, **kw)
            self.weights_out = nn.Linear(c.intermediate_size, c.hidden_size, **kw)
        else:
            self.fc1 = nn.Linear(c.hidden_size, c.intermediate_size, **kw)
            self.fc2 = nn.Linear(c.intermediate_size, c.hidden_size, **kw)
            self.act = _activation(c.act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.swiglu_ln:
            return self.w3(self.ffn_ln(F.silu(self.w1(x)) * self.w2(x)))
        if self.cfg.swiglu:
            x1, x2 = self.weights_in(x).chunk(2, dim=-1)
            return self.weights_out(F.silu(x1) * x2)
        return self.fc2(self.act(self.fc1(x)))


class ViTBlock(nn.Module):
    def __init__(self, cfg: ViTConfig, dtype=torch.float32, device=None):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.norm1 = LayerNorm(c.hidden_size, c.ln_eps, device=device)
        self.attn = ViTAttention(c, dtype, device)
        self.norm2 = LayerNorm(c.hidden_size, c.ln_eps, device=device)
        self.mlp = ViTMlp(c, dtype, device)
        if c.layer_scale:
            self.ls1_gamma = nn.Parameter(torch.ones(c.hidden_size, device=device))
            self.ls2_gamma = nn.Parameter(torch.ones(c.hidden_size, device=device))

    def forward(self, x: torch.Tensor, rope=None, rel_pos_index=None) -> torch.Tensor:
        h = self.attn(self.norm1(x), rope, rel_pos_index)
        if self.cfg.layer_scale:
            h = h * self.ls1_gamma.to(h.dtype)
        x = x + h
        h = self.mlp(self.norm2(x))
        if self.cfg.layer_scale:
            h = h * self.ls2_gamma.to(h.dtype)
        return x + h


class VisionTransformer(nn.Module):
    """pixels [B, 3, H, W] -> token features [B, N(+prefix), C] at the
    configured tap depth (prefix tokens dropped for select_feature="patch")."""

    def __init__(self, cfg: ViTConfig, dtype=torch.float32, device=None):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.dtype = dtype
        self.patch_embed = nn.Conv2d(3, c.hidden_size, c.patch_size, stride=c.patch_size,
                                     bias=c.patch_bias, dtype=dtype, device=device)
        if c.class_token:
            self.cls_token = nn.Parameter(torch.zeros(1, 1, c.hidden_size, device=device))
        if c.num_register_tokens:
            self.register_tokens = nn.Parameter(
                torch.zeros(1, c.num_register_tokens, c.hidden_size, device=device))
        if c.abs_pos_embed:
            n_pos = (1 if c.class_token else 0) + c.num_patches
            self.pos_embed = nn.Parameter(torch.zeros(n_pos, c.hidden_size, device=device))
        if c.pre_layernorm:
            self.pre_layernorm = LayerNorm(c.hidden_size, c.ln_eps, device=device)
        for i in range(c.num_blocks_to_run):
            self.add_module(f"blocks_{i}", ViTBlock(c, dtype, device))
        if c.num_blocks_to_run == c.num_layers and c.final_layernorm:
            self.final_layernorm = LayerNorm(c.hidden_size, c.ln_eps, device=device)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        x = self.patch_embed(pixels.to(self.dtype))          # [B, C, h, w]
        x = x.flatten(2).transpose(1, 2)                      # [B, h*w, C]
        b = x.shape[0]
        prefix = []
        if c.class_token:
            prefix.append(self.cls_token.to(x.dtype).expand(b, 1, -1))
        if c.num_register_tokens:
            prefix.append(self.register_tokens.to(x.dtype).expand(b, -1, -1))
        if c.abs_pos_embed:
            pos = self.pos_embed.to(x.dtype)
            if c.class_token:
                # the pos embed covers [cls] + patches; registers carry none
                cls_tok = prefix[0] + pos[:1]
                x = torch.cat([cls_tok] + prefix[1:] + [x + pos[1:]], dim=1)
            else:
                x = x + pos
        elif prefix:
            x = torch.cat(prefix + [x], dim=1)
        if c.pre_layernorm:
            x = self.pre_layernorm(x)
        rope = rel_index = None
        if c.rope:
            rope = tuple(t.to(x.device) for t in _rope_tables(
                c.grid_side, c.hidden_size // c.num_heads, c.rope_ref_side))
        if c.rel_pos_bias:
            rel_index = _rel_pos_index(c.grid_side).to(x.device)
        for i in range(c.num_blocks_to_run):
            x = getattr(self, f"blocks_{i}")(x, rope, rel_index)
        if hasattr(self, "final_layernorm"):
            x = self.final_layernorm(x)
        if c.select_feature == "patch" and c.num_prefix_tokens:
            x = x[:, c.num_prefix_tokens:]
        return x


# ----- stock tower configs (public architecture hyperparameters) -----------

def clip_vit_l_336(select_layer: int = -2) -> ViTConfig:
    return ViTConfig(
        hidden_size=1024, num_layers=24, num_heads=16, intermediate_size=4096,
        patch_size=14, image_size=336, class_token=True, pre_layernorm=True,
        final_layernorm=False, act="quick_gelu", patch_bias=False,
        select_layer=select_layer, ln_eps=1e-5,
    )


def siglip_so400m_384() -> ViTConfig:
    return ViTConfig(
        hidden_size=1152, num_layers=27, num_heads=16, intermediate_size=4304,
        patch_size=14, image_size=384, class_token=False, final_layernorm=True,
        act="gelu_tanh", select_layer=0, ln_eps=1e-6,
    )


def dinov2_giant(image_size: int = 378) -> ViTConfig:
    return ViTConfig(
        hidden_size=1536, num_layers=40, num_heads=24, intermediate_size=4096,
        patch_size=14, image_size=image_size, class_token=True,
        final_layernorm=True, act="gelu", swiglu=True, layer_scale=True,
        select_layer=0, ln_eps=1e-6,
    )


def tiny_vit(image_size: int = 32, **kwargs) -> ViTConfig:
    base = dict(
        hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
        patch_size=8, image_size=image_size,
    )
    base.update(kwargs)
    return ViTConfig(**base)
