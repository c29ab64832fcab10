"""LLaMA-family decoder (cambrian_tpu/models/language/llama.py): LLaMA,
Phi-3, Mistral, Gemma and Cohere. fp32 RMSNorm, GQA with rotary embeddings
(HF rotate-half convention), a KV cache written at a shared offset or at one
index a row, and fp32 attention softmax. Phi-3 and Mistral are the LLaMA
block with a sliding window and, where the config has it, scaled rotary
frequencies (LongRoPE/"su" or linear, ``rope_scaling_factors``).

The other families' switches, as in the JAX package:

- Gemma (``model_type`` starting "gemma"): RMSNorm scaled by ``1 + w``,
  tanh GELU (``hidden_act``), head_dim 256 at 7B; with
  ``attn_logit_softcapping`` (Gemma-2's) every attention call is the plain
  one with logits squashed to cap * tanh(logits / cap), prefill included.
  The embedding normaliser and the final-logit cap live in
  ``models/cambrian.py``.
- Cohere: a bias-free LayerNorm, rotary embeddings on interleaved pairs in
  fp32, optional per-head qk RMSNorm (``use_qk_norm``) and the parallel
  residual x + attn(ln(x)) + mlp(ln(x)) with one shared norm.

Prefill follows the JAX package's branch rule exactly: the flash-attention
kernel when ``s >= 128`` (no softcap), plain attention over a dense mask
otherwise (decode steps). The two treat a row with no valid key
differently (0 against uniform weights), so the rule must not drift.

The KV cache is updated in place (``copy_`` into preallocated buffers),
where the JAX package returns a new cache.

With ``cfg.quantize`` ("int8" or "int4") the seven decoder projections are
weight-only quantized linears (``ops/quant.py``), as in the JAX package's
``load_8bit`` / ``load_4bit`` serving paths.
"""

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.attention import dot_product_attention
from ...ops.flash_attention import flash_attention
from ...ops.norms import RMSNorm
from ...ops.quant import DECODER_QUANT_TARGETS, QuantLinear, QuantLinear4
from ..config import CambrianConfig


def check_supported(cfg: CambrianConfig) -> None:
    """Raise for a rope scaling type the JAX package refuses, and for a
    quantization mode other than int8 and int4."""
    if cfg.rope_scaling:
        rope_scaling_factors(cfg, 0)        # raises for a type the JAX package refuses
    if cfg.quantize not in (None, "int8", "int4"):
        raise NotImplementedError(f"quantize={cfg.quantize!r} is not ported")


class BiaslessLayerNorm(nn.Module):
    """Cohere's LayerNorm: mean-centred, no bias, fp32 statistics and an fp32
    ``weight``."""

    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        xc = x32 - x32.mean(-1, keepdim=True)
        y = xc * torch.rsqrt(xc.square().mean(-1, keepdim=True) + self.eps) * self.weight
        return y.to(x.dtype)


def decoder_norm(cfg: CambrianConfig, device=None) -> nn.Module:
    """The family's norm over ``hidden_size``: the bias-free LayerNorm for
    Cohere, RMSNorm otherwise (scaled by 1 + w for Gemma)."""
    if cfg.model_type == "cohere":
        return BiaslessLayerNorm(cfg.hidden_size, cfg.rms_norm_eps, device)
    offset = 1.0 if cfg.model_type.startswith("gemma") else 0.0
    return RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, device, weight_offset=offset)


def activation(cfg: CambrianConfig, x: torch.Tensor) -> torch.Tensor:
    """The MLP's activation by ``hidden_act``, in x's dtype: SiLU; tanh GELU
    (flax's ``nn.gelu(approximate=True)``) for "gelu_pytorch_tanh" and
    "gelu_tanh"; exact (erf) GELU for any other name, as in the JAX
    package."""
    if cfg.hidden_act == "silu":
        return F.silu(x)
    if cfg.hidden_act in ("gelu_pytorch_tanh", "gelu_tanh"):
        return F.gelu(x, approximate="tanh")
    return F.gelu(x)


def decoder_linear(cfg: CambrianConfig, in_features: int, out_features: int, bias: bool,
                   dtype, device, name: str) -> nn.Module:
    """nn.Linear, or a quantized linear when cfg.quantize is set and ``name``
    is a decoder GEMM target."""
    if cfg.quantize == "int8" and name in DECODER_QUANT_TARGETS:
        return QuantLinear(in_features, out_features, bias, dtype, device)
    if cfg.quantize == "int4" and name in DECODER_QUANT_TARGETS:
        return QuantLinear4(in_features, out_features, bias, dtype, device)
    return nn.Linear(in_features, out_features, bias=bias, dtype=dtype, device=device)


def rope_cos_sin(position_ids: torch.Tensor, head_dim: int, theta: float,
                 dtype=torch.float32, ext_factors: Optional[torch.Tensor] = None,
                 mscale: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [B, S, head_dim] (duplicated-half layout), computed in
    fp32 and cast to the compute dtype before they are applied.
    ``ext_factors`` ([head_dim/2] fp32) divide the inverse frequencies and
    ``mscale`` rescales both tables (LongRoPE/"su" and linear scaling)."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                             device=position_ids.device) / head_dim))
    if ext_factors is not None:
        # a host tensor: copied without waiting for the stream, so a decode
        # step queued behind others does not stall the host
        inv_freq = inv_freq / ext_factors.to(inv_freq.device, non_blocking=True)
    angles = position_ids.float()[..., None] * inv_freq
    emb = torch.cat([angles, angles], dim=-1)
    return (emb.cos() * mscale).to(dtype), (emb.sin() * mscale).to(dtype)


def rope_scaling_factors(cfg: CambrianConfig, seq_capacity: int
                         ) -> Tuple[Optional[torch.Tensor], float]:
    """(ext_factors, mscale) of ``cfg.rope_scaling`` for a sequence capacity:
    the KV cache's length when there is a cache, else the call's span (the
    JAX package's stand-in for HF's dynamic long/short switch, so an engine
    must size its cache as the JAX engine does).

    "longrope"/"su" (Phi-3 128k): the long factor list when the capacity
    exceeds ``original_max_position_embeddings``, else the short one, and
    the attention rescale sqrt(1 + ln s / ln orig) with s = max positions /
    orig; "linear": every frequency divided by ``factor``. No scaling gives
    (None, 1.0); any other type raises, as in the JAX package."""
    rs = cfg.rope_scaling
    if not rs:
        return None, 1.0
    typ = rs.get("type", rs.get("rope_type", ""))
    if typ in ("longrope", "su"):
        orig = cfg.original_max_position_embeddings or cfg.max_position_embeddings
        factors = rs["long_factor"] if seq_capacity > orig else rs["short_factor"]
        scale = cfg.max_position_embeddings / orig
        mscale = 1.0 if scale <= 1.0 else math.sqrt(1.0 + math.log(scale) / math.log(orig))
        return torch.tensor(factors, dtype=torch.float32), mscale
    if typ == "linear":
        return torch.full((cfg.head_dim // 2,), float(rs["factor"]), dtype=torch.float32), 1.0
    raise ValueError(f"unsupported rope_scaling type: {typ!r}")


def _rotate_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(q, k, cos, sin):
    """q, k [B, S, H, D]; cos/sin [B, S, D] broadcast over heads."""
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return q * cos + _rotate_half(q) * sin, k * cos + _rotate_half(k) * sin


def rope_cos_sin_interleaved(position_ids: torch.Tensor, head_dim: int, theta: float,
                             dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cohere's cos/sin tables [B, S, head_dim]: each frequency repeated over
    an adjacent pair of columns; computed in fp32, cast to ``dtype``."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                             device=position_ids.device) / head_dim))
    emb = (position_ids.float()[..., None] * inv_freq).repeat_interleave(2, dim=-1)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def _rotate_interleaved(x):
    """(x0, x1, x2, x3, ...) -> (-x1, x0, -x3, x2, ...)."""
    return torch.stack([-x[..., 1::2], x[..., 0::2]], dim=-1).reshape(x.shape)


def apply_rope_interleaved(q, k, cos, sin):
    """Cohere's rotation of adjacent pairs, in fp32 whatever the inputs'
    dtype (as the JAX package runs it), cast back to q's and k's dtypes."""
    cos, sin = cos[:, :, None, :].float(), sin[:, :, None, :].float()
    q32, k32 = q.float(), k.float()
    return ((q32 * cos + _rotate_interleaved(q32) * sin).to(q.dtype),
            (k32 * cos + _rotate_interleaved(k32) * sin).to(k.dtype))


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


def write_cache_rows(buf: torch.Tensor, rows: torch.Tensor, index: torch.Tensor) -> None:
    """``buf[b, index[b]] = rows[b]`` for each row b of ``buf`` [B, L, ...];
    an index at or past L writes nothing, as the JAX scatter drops it: the
    row's old value goes back in place. The index stays on the device, so
    nothing waits for the host."""
    b, length = buf.shape[:2]
    index = index.to(buf.device)
    flat = buf.view(b, length, -1)
    at = index.clamp(0, length - 1).long().view(b, 1, 1).expand(b, 1, flat.shape[2])
    new = rows.reshape(b, 1, -1).to(buf.dtype)
    flat.scatter_(1, at, torch.where((index < length).view(b, 1, 1), new, flat.gather(1, at)))


class LlamaAttention(nn.Module):
    def __init__(self, cfg: CambrianConfig, dtype=torch.float32, device=None):
        super().__init__()
        c, kw = cfg, dict(bias=cfg.attention_bias, dtype=dtype, device=device)
        self.cfg = cfg
        h, kvh, d = c.num_attention_heads, c.num_key_value_heads, c.head_dim
        self.q_proj = decoder_linear(c, c.hidden_size, h * d, name="q_proj", **kw)
        self.k_proj = decoder_linear(c, c.hidden_size, kvh * d, name="k_proj", **kw)
        self.v_proj = decoder_linear(c, c.hidden_size, kvh * d, name="v_proj", **kw)
        self.o_proj = decoder_linear(c, h * d, c.hidden_size, name="o_proj", **kw)
        if c.use_qk_norm:       # Cohere (Command-R+): per-head RMSNorm of q and k
            self.q_norm = RMSNorm(d, c.rms_norm_eps, device=device)
            self.k_norm = RMSNorm(d, c.rms_norm_eps, device=device)

    def forward(self, x, mask: AttentionMask, position_ids, cache=None, cache_index=None):
        c = self.cfg
        b, s, _ = x.shape
        h, kvh, d = c.num_attention_heads, c.num_key_value_heads, c.head_dim
        q = self.q_proj(x).view(b, s, h, d)
        k = self.k_proj(x).view(b, s, kvh, d)
        v = self.v_proj(x).view(b, s, kvh, d)
        if c.use_qk_norm:
            q, k = self.q_norm(q), self.k_norm(k)
        if c.model_type == "cohere":
            cos, sin = rope_cos_sin_interleaved(position_ids, d, c.rope_theta, x.dtype)
            q, k = apply_rope_interleaved(q, k, cos, sin)
        else:
            # the cache's length when decoding or prefilling, else this call's span
            ext, mscale = rope_scaling_factors(c, cache[0].shape[1] if cache is not None else s)
            cos, sin = rope_cos_sin(position_ids, d, c.rope_theta, x.dtype, ext, mscale)
            q, k = apply_rope(q, k, cos, sin)

        if cache is not None:
            cache_k, cache_v = cache
            if torch.is_tensor(cache_index) and cache_index.dim() == 1:
                # per-row write positions [B] (continuous batching: each slot
                # sits at its own depth), one new row each
                if s != 1:
                    raise ValueError(f"a vector cache_index writes one row, got {s}")
                write_cache_rows(cache_k, k[:, 0], cache_index)
                write_cache_rows(cache_v, v[:, 0], cache_index)
            else:
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
            # decode steps, and Gemma-2's softcapped logits at any length (the
            # kernel has no tanh cap, as the TPU kernel has none)
            if kvh != h:
                k = k.repeat_interleave(h // kvh, dim=2)
                v = v.repeat_interleave(h // kvh, dim=2)
            out = dot_product_attention(q, k, v, mask.dense(s, k.shape[1], c.sliding_window),
                                        logit_cap=c.attn_logit_softcapping)
        return self.o_proj(out.reshape(b, s, h * d)), cache


class LlamaMlp(nn.Module):
    def __init__(self, cfg: CambrianConfig, dtype=torch.float32, device=None):
        super().__init__()
        c, kw = cfg, dict(bias=cfg.mlp_bias, dtype=dtype, device=device)
        self.gate_proj = decoder_linear(c, c.hidden_size, c.intermediate_size, name="gate_proj",
                                        **kw)
        self.up_proj = decoder_linear(c, c.hidden_size, c.intermediate_size, name="up_proj", **kw)
        self.down_proj = decoder_linear(c, c.intermediate_size, c.hidden_size, name="down_proj",
                                        **kw)

        self.cfg = cfg

    def forward(self, x):
        return self.down_proj(activation(self.cfg, self.gate_proj(x)) * self.up_proj(x))


class LlamaDecoderLayer(nn.Module):
    """Pre-norm residual block; Cohere's is parallel, with one shared norm
    and no ``post_attention_layernorm``."""

    def __init__(self, cfg: CambrianConfig, dtype=torch.float32, device=None):
        super().__init__()
        check_supported(cfg)
        self.parallel = cfg.model_type == "cohere"
        self.input_layernorm = decoder_norm(cfg, device)
        self.self_attn = LlamaAttention(cfg, dtype, device)
        if not self.parallel:
            self.post_attention_layernorm = decoder_norm(cfg, device)
        self.mlp = LlamaMlp(cfg, dtype, device)

    def forward(self, x, mask, position_ids, cache=None, cache_index=None):
        if self.parallel:
            normed = self.input_layernorm(x)
            h, cache = self.self_attn(normed, mask, position_ids, cache, cache_index)
            return x + h + self.mlp(normed), cache
        h, cache = self.self_attn(self.input_layernorm(x), mask, position_ids, cache,
                                  cache_index)
        x = x + h
        return x + self.mlp(self.post_attention_layernorm(x)), cache
