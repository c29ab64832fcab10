"""Spatial Vision Aggregator (cambrian_tpu/models/sva.py): learnable-query,
spatially-local cross-attention over several vision-tower grids. Each query
position owns its window of every tower as an explicit tensor axis, and the
attention is ``ops.attention.windowed_cross_attention`` (batched einsums;
the Pallas K5 kernel was never wired in the JAX package either).

Flax infers input widths; torch modules need them, so each constructor takes
the widths the flax module would have seen. All LayerNorms use eps=1e-5 and
GELU is the exact form.
"""

from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..ops.activations import gelu_exact
from ..ops.attention import windowed_cross_attention
from ..ops.norms import LayerNorm

_LN_EPS = 1e-5


def get_1d_sincos_pos_embed_from_grid(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    if embed_dim % 2:
        raise ValueError(f"embed_dim must be even, got {embed_dim}")
    omega = np.arange(embed_dim // 2, dtype=np.float32)
    omega /= embed_dim / 2.0
    omega = 1.0 / 10000 ** omega
    out = np.einsum("m,d->md", pos.reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_2d_sincos_pos_embed(embed_dim: int, grid_size: int, cls_token: bool = False) -> np.ndarray:
    grid_h = np.arange(grid_size, dtype=np.float32)
    grid_w = np.arange(grid_size, dtype=np.float32)
    grid = np.stack(np.meshgrid(grid_w, grid_h), axis=0).reshape(2, 1, grid_size, grid_size)
    emb_h = get_1d_sincos_pos_embed_from_grid(embed_dim // 2, grid[0])
    emb_w = get_1d_sincos_pos_embed_from_grid(embed_dim // 2, grid[1])
    pos_embed = np.concatenate([emb_h, emb_w], axis=1)
    if cls_token:
        pos_embed = np.concatenate([np.zeros([1, embed_dim]), pos_embed], axis=0)
    return pos_embed


def _linear(d_in, d_out, dtype, device, bias=False):
    return nn.Linear(d_in, d_out, bias=bias, dtype=dtype, device=device)


class Mlp(nn.Module):
    """Linear -> GELU -> Linear, no biases."""

    def __init__(self, d_in: int, d_hidden: int, d_out: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.linear_1 = _linear(d_in, d_hidden, dtype, device)
        self.linear_2 = _linear(d_hidden, d_out, dtype, device)

    def forward(self, x):
        return self.linear_2(gelu_exact(self.linear_1(x)))


class MultiKVCrossAttention(nn.Module):
    """Joint cross-attention over N per-tower KV banks: each tower has its own
    LayerNorm + projection for K and V; queries attend to the concatenation
    of all towers' window tokens."""

    def __init__(self, q_in: int, kv_in: Sequence[int], hidden_dim: int, out_dim: int,
                 num_heads: int = 16, attention_bias: bool = False,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.hidden_dim, self.num_heads = hidden_dim, num_heads
        self.num_towers = len(kv_in)
        self.q_ln = LayerNorm(q_in, _LN_EPS, device=device)
        self.q_proj = _linear(q_in, hidden_dim, dtype, device, attention_bias)
        for i, c in enumerate(kv_in):
            self.add_module(f"k_ln_{i}", LayerNorm(c, _LN_EPS, device=device))
            self.add_module(f"k_proj_{i}", _linear(c, hidden_dim, dtype, device, attention_bias))
            self.add_module(f"v_ln_{i}", LayerNorm(c, _LN_EPS, device=device))
            self.add_module(f"v_proj_{i}", _linear(c, hidden_dim, dtype, device, attention_bias))
        self.o_proj = _linear(hidden_dim, out_dim, dtype, device, attention_bias)

    def forward(self, queries, kv_list, mask_list=None):
        if len(kv_list) != self.num_towers:
            raise ValueError(f"expected {self.num_towers} KV banks, got {len(kv_list)}")
        b, q_len = queries.shape[:2]
        h = self.num_heads
        d = self.hidden_dim // h
        q = self.q_proj(self.q_ln(queries)).reshape(b, q_len, h, d)
        ks, vs = [], []
        for i, kv in enumerate(kv_list):
            w = kv.shape[2]
            k = getattr(self, f"k_proj_{i}")(getattr(self, f"k_ln_{i}")(kv))
            v = getattr(self, f"v_proj_{i}")(getattr(self, f"v_ln_{i}")(kv))
            ks.append(k.reshape(b, q_len, w, h, d))
            vs.append(v.reshape(b, q_len, w, h, d))
        mask = None
        if mask_list is not None:
            mask = torch.cat([m.to(torch.bool) for m in mask_list], dim=-1)
        out = windowed_cross_attention(q, torch.cat(ks, 2), torch.cat(vs, 2), mask)
        return self.o_proj(out.reshape(b, q_len, self.hidden_dim))


class CrossAttention(nn.Module):
    """Single-bank cross-attention, windowed layout."""

    def __init__(self, q_in: int, kv_in: int, hidden_dim: int, out_dim: int,
                 num_heads: int = 16, attention_bias: bool = False,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.hidden_dim, self.num_heads = hidden_dim, num_heads
        self.q_ln = LayerNorm(q_in, _LN_EPS, device=device)
        self.q_proj = _linear(q_in, hidden_dim, dtype, device, attention_bias)
        self.k_ln = LayerNorm(kv_in, _LN_EPS, device=device)
        self.k_proj = _linear(kv_in, hidden_dim, dtype, device, attention_bias)
        self.v_ln = LayerNorm(kv_in, _LN_EPS, device=device)
        self.v_proj = _linear(kv_in, hidden_dim, dtype, device, attention_bias)
        self.o_proj = _linear(hidden_dim, out_dim, dtype, device, attention_bias)

    def forward(self, queries, kv, mask=None):
        b, q_len = queries.shape[:2]
        h = self.num_heads
        d = self.hidden_dim // h
        w = kv.shape[2]
        q = self.q_proj(self.q_ln(queries)).reshape(b, q_len, h, d)
        k = self.k_proj(self.k_ln(kv)).reshape(b, q_len, w, h, d)
        v = self.v_proj(self.v_ln(kv)).reshape(b, q_len, w, h, d)
        out = windowed_cross_attention(q, k, v, mask)
        return self.o_proj(out.reshape(b, q_len, self.hidden_dim))


def _pos_embeds(module: nn.Module, kv_size_list, hidden_dim, device):
    for i, kv_size in enumerate(kv_size_list):
        if kv_size > 1:
            module.register_parameter(
                f"pos_embed_{i}",
                nn.Parameter(torch.zeros(kv_size ** 2, hidden_dim, device=device)))


def _add_pos(module: nn.Module, i: int, kv: torch.Tensor) -> torch.Tensor:
    pos = getattr(module, f"pos_embed_{i}", None)
    return kv if pos is None else kv + pos.to(kv.dtype)


class VisionCrossAttentionLayer(nn.Module):
    """One 'joint' SVA layer: queries + projected context -> proj_in ->
    cross-attend to every tower's window (with learnable per-tower position
    embeddings) -> residual -> LayerNorm -> MLP -> + original residual."""

    def __init__(self, q_dim: int, context_dim: int, kv_size_list: Sequence[int],
                 hidden_dim: int = 1024, num_heads: int = 16, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.proj_context = _linear(context_dim, hidden_dim, dtype, device)
        self.proj_in = _linear(q_dim + hidden_dim, hidden_dim, dtype, device)
        _pos_embeds(self, kv_size_list, hidden_dim, device)
        self.cross_attn = MultiKVCrossAttention(
            hidden_dim, [hidden_dim] * len(kv_size_list), hidden_dim, hidden_dim,
            num_heads, dtype=dtype, device=device)
        self.norm = LayerNorm(hidden_dim, _LN_EPS, device=device)
        self.proj_out = Mlp(hidden_dim, hidden_dim, q_dim, dtype, device)

    def forward(self, queries, context_feature, kv_list, mask_list=None):
        residual = queries
        context = self.proj_context(context_feature)
        x = self.proj_in(torch.cat([queries, context], dim=-1))
        kv_pos = [_add_pos(self, i, kv) for i, kv in enumerate(kv_list)]
        x = x + self.cross_attn(x, kv_pos, mask_list)
        x = self.proj_out(self.norm(x))
        return x + residual


class AggregationBlock(nn.Module):
    """Per-tower aggregation of the 'sep' layer type: attention when the
    tower has a spatial window, a plain MLP on the single window token
    otherwise."""

    def __init__(self, attention: bool, hidden_dim: int, out_dim: int,
                 num_heads: int = 16, dtype=torch.float32, device=None):
        super().__init__()
        self.attention = attention
        if attention:
            self.attention_layer = CrossAttention(hidden_dim, hidden_dim, hidden_dim,
                                                  out_dim, num_heads, dtype=dtype,
                                                  device=device)
        else:
            self.attention_layer = Mlp(hidden_dim, out_dim, out_dim, dtype, device)

    def forward(self, queries, kv, mask=None):
        if self.attention:
            return self.attention_layer(queries, kv, mask)
        return self.attention_layer(kv[..., 0, :] if kv.dim() == 4 else kv)


class VisionAggregationLayer(nn.Module):
    """'sep' SVA layer: aggregate each tower separately, then combine them
    with query-conditioned softmax weights."""

    def __init__(self, q_dim: int, context_dim: int, kv_size_list: Sequence[int],
                 hidden_dim: int = 1024, num_heads: int = 16, dtype=torch.float32,
                 device=None):
        super().__init__()
        n = len(kv_size_list)
        self.num_towers = n
        self.proj_context = _linear(context_dim, hidden_dim, dtype, device)
        if n > 1:
            self.weight_mlp = Mlp(q_dim + hidden_dim, hidden_dim, n, dtype, device)
        self.proj_in = _linear(q_dim + hidden_dim, hidden_dim, dtype, device)
        _pos_embeds(self, kv_size_list, hidden_dim, device)
        for i, kv_size in enumerate(kv_size_list):
            self.add_module(f"aggregate_{i}", AggregationBlock(
                kv_size > 1, hidden_dim, hidden_dim, num_heads, dtype, device))
        self.norm = LayerNorm(hidden_dim, _LN_EPS, device=device)
        self.proj_out = Mlp(hidden_dim, hidden_dim, q_dim, dtype, device)

    def forward(self, queries, context_feature, kv_list, mask_list=None):
        residual = queries
        cat = torch.cat([queries, self.proj_context(context_feature)], dim=-1)
        x = self.proj_in(cat)
        aggregated = []
        for i, kv in enumerate(kv_list):
            mask = None if mask_list is None else mask_list[i]
            aggregated.append(getattr(self, f"aggregate_{i}")(x, _add_pos(self, i, kv), mask))
        stacked = torch.stack(aggregated, dim=2)                   # [B, Q, N, hidden]
        if self.num_towers > 1:
            weights = torch.softmax(self.weight_mlp(cat).float(), dim=-1)
            combined = (stacked * weights.to(stacked.dtype)[..., None]).sum(2)
        else:
            combined = stacked[:, :, 0]
        x = self.proj_out(self.norm(x + combined))
        return x + residual


class VisionTokenSampler(nn.Module):
    """Stack of SVA layers (``layers_{i}``)."""

    def __init__(self, q_dim: int, context_dim: int, kv_size_list: Sequence[int],
                 vision_hidden_size: int = 1024, num_of_layers: int = 1,
                 layer_type: str = "joint", dtype=torch.float32, device=None):
        super().__init__()
        if layer_type not in ("joint", "sep"):
            raise ValueError(f"unknown SVA layer type {layer_type!r}")
        layer_cls = VisionCrossAttentionLayer if layer_type == "joint" else VisionAggregationLayer
        self.num_of_layers = num_of_layers
        for idx in range(num_of_layers):
            self.add_module(f"layers_{idx}", layer_cls(
                q_dim, context_dim, kv_size_list, vision_hidden_size,
                dtype=dtype, device=device))

    def forward(self, queries, context_feature, kv_list, mask_list=None):
        for idx in range(self.num_of_layers):
            queries = getattr(self, f"layers_{idx}")(queries, context_feature, kv_list,
                                                     mask_list)
        return queries
