"""LLaMA-family decoder (cambrian_tpu/models/language/llama.py), LLaMA only:
fp32 RMSNorm, GQA with rotary embeddings (HF rotate-half convention), a KV
cache with a shared write offset, and fp32 attention softmax.

Prefill follows the JAX package's branch rule exactly: the flash-attention
kernel when ``s >= 128`` (no softcap), plain attention over a dense mask
otherwise (decode steps). The two treat a row with no valid key
differently (0 against uniform weights), so the rule must not drift.

The KV cache is updated in place (``copy_`` into preallocated buffers),
where the JAX package returns a new cache.
"""

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cambrian_tpu.models.config import CambrianConfig

from ...ops.attention import dot_product_attention
from ...ops.flash_attention import flash_attention
from ...ops.norms import RMSNorm


def check_supported(cfg: CambrianConfig) -> None:
    """Raise for the decoder switches this port does not cover yet."""
    if cfg.model_type != "llama":
        raise NotImplementedError(
            f"decoder family {cfg.model_type!r} is not ported yet (LLaMA only)")
    if cfg.rope_scaling:
        raise NotImplementedError("rope_scaling is not ported yet")
    if cfg.quantize:
        raise NotImplementedError("quantized decoders are not ported yet")
    if cfg.use_qk_norm or cfg.attn_logit_softcapping is not None:
        raise NotImplementedError("qk-norm and logit softcapping are not ported yet")
    if cfg.hidden_act != "silu":
        raise NotImplementedError(f"activation {cfg.hidden_act!r} is not ported yet")


def rope_cos_sin(position_ids: torch.Tensor, head_dim: int, theta: float,
                 dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [B, S, head_dim] (duplicated-half layout), computed in
    fp32 and cast to the compute dtype before they are applied."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                             device=position_ids.device) / head_dim))
    angles = position_ids.float()[..., None] * inv_freq
    emb = torch.cat([angles, angles], dim=-1)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def _rotate_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(q, k, cos, sin):
    """q, k [B, S, H, D]; cos/sin [B, S, D] broadcast over heads."""
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return q * cos + _rotate_half(q) * sin, k * cos + _rotate_half(k) * sin


@dataclass
class AttentionMask:
    """Structural mask: per-key validity [B, K] plus a causal flag — never a
    materialized [S, S] tensor; ``dense()`` builds one for the plain path."""

    key_valid: torch.Tensor
    causal: bool = True
    q_offset: int = 0

    def dense(self, s_q: int, s_k: int, sliding_window: Optional[int] = None) -> torch.Tensor:
        """[B, 1, S_q, S_k] bool mask."""
        mask = self.key_valid.to(torch.bool)[:, None, None, :]
        if self.causal or sliding_window is not None:
            dev = self.key_valid.device
            q_pos = self.q_offset + torch.arange(s_q, device=dev)[:, None]
            k_pos = torch.arange(s_k, device=dev)[None, :]
            keep = torch.ones((s_q, s_k), dtype=torch.bool, device=dev)
            if self.causal:
                keep = keep & (k_pos <= q_pos)
            if sliding_window is not None:
                keep = keep & ((q_pos - k_pos) < sliding_window)
            mask = mask & keep[None, None]
        return mask


def make_causal_mask(valid: torch.Tensor) -> AttentionMask:
    return AttentionMask(key_valid=valid.to(torch.bool), causal=True)


def make_decode_mask(cache_valid: torch.Tensor) -> AttentionMask:
    return AttentionMask(key_valid=cache_valid.to(torch.bool), causal=False)


def init_kv_cache(cfg: CambrianConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, device=None):
    """Per-layer (k, v) buffers [B, max_len, kv_heads, head_dim]."""
    shape = (batch, max_len, cfg.num_key_value_heads, cfg.head_dim)
    return tuple(
        (torch.zeros(shape, dtype=dtype, device=device),
         torch.zeros(shape, dtype=dtype, device=device))
        for _ in range(cfg.num_hidden_layers))


class LlamaAttention(nn.Module):
    def __init__(self, cfg: CambrianConfig, dtype=torch.float32, device=None):
        super().__init__()
        c, kw = cfg, dict(bias=cfg.attention_bias, dtype=dtype, device=device)
        self.cfg = cfg
        h, kvh, d = c.num_attention_heads, c.num_key_value_heads, c.head_dim
        self.q_proj = nn.Linear(c.hidden_size, h * d, **kw)
        self.k_proj = nn.Linear(c.hidden_size, kvh * d, **kw)
        self.v_proj = nn.Linear(c.hidden_size, kvh * d, **kw)
        self.o_proj = nn.Linear(h * d, c.hidden_size, **kw)

    def forward(self, x, mask: AttentionMask, position_ids, cache=None, cache_index=None):
        c = self.cfg
        b, s, _ = x.shape
        h, kvh, d = c.num_attention_heads, c.num_key_value_heads, c.head_dim
        q = self.q_proj(x).view(b, s, h, d)
        k = self.k_proj(x).view(b, s, kvh, d)
        v = self.v_proj(x).view(b, s, kvh, d)
        cos, sin = rope_cos_sin(position_ids, d, c.rope_theta, x.dtype)
        q, k = apply_rope(q, k, cos, sin)

        if cache is not None:
            cache_k, cache_v = cache
            idx = int(cache_index)
            cache_k[:, idx:idx + s].copy_(k)
            cache_v[:, idx:idx + s].copy_(v)
            # attend over the whole cache as stored (its dtype rounding
            # included), cast to the compute dtype
            k, v = cache_k.to(q.dtype), cache_v.to(q.dtype)

        if s >= 128 and c.attn_logit_softcapping is None:
            # prefill: fused kernel, GQA read in place
            out = flash_attention(q, k, v, key_valid=mask.key_valid, causal=mask.causal,
                                  sliding_window=c.sliding_window, q_offset=mask.q_offset)
        else:
            if kvh != h:
                k = k.repeat_interleave(h // kvh, dim=2)
                v = v.repeat_interleave(h // kvh, dim=2)
            out = dot_product_attention(q, k, v, mask.dense(s, k.shape[1], c.sliding_window))
        return self.o_proj(out.reshape(b, s, h * d)), cache


class LlamaMlp(nn.Module):
    def __init__(self, cfg: CambrianConfig, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(bias=cfg.mlp_bias, dtype=dtype, device=device)
        self.gate_proj = nn.Linear(cfg.hidden_size, cfg.intermediate_size, **kw)
        self.up_proj = nn.Linear(cfg.hidden_size, cfg.intermediate_size, **kw)
        self.down_proj = nn.Linear(cfg.intermediate_size, cfg.hidden_size, **kw)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, cfg: CambrianConfig, dtype=torch.float32, device=None):
        super().__init__()
        check_supported(cfg)
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, device=device)
        self.self_attn = LlamaAttention(cfg, dtype, device)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                                device=device)
        self.mlp = LlamaMlp(cfg, dtype, device)

    def forward(self, x, mask, position_ids, cache=None, cache_index=None):
        h, cache = self.self_attn(self.input_layernorm(x), mask, position_ids, cache,
                                  cache_index)
        x = x + h
        return x + self.mlp(self.post_attention_layernorm(x)), cache
