"""The Cambrian multimodal model (cambrian_tpu/models/cambrian.py):
multi-tower features -> SVA connector -> LLaMA-family decoder (LLaMA, Phi-3,
Mistral, Gemma, Cohere) with periodic in-LLM SVA re-injection -> fp32 logits
(times Cohere's ``logit_scale``, under Gemma-2's final cap).

``CambrianLM`` holds the token embeddings, the connector, the decoder and
the LM head; the vision towers are separate modules. Module names mirror the
flax tree (``mm_projector_aux_0``, ``vision_sampler_layers_3``,
``layers_12``) for ``checkpoint/from_jax.py``; the JAX package's
``_SvaProjector`` is ``projectors.SvaProjector``.

With ``cfg.remat`` and grad enabled, each decoder layer, in-LLM sampler, aux
projector and connector sampler runs under ``torch.utils.checkpoint``
(non-reentrant), where the JAX package wraps them in ``nn.remat``; serving
runs without grad and is unchanged. The scan-layers machinery is an XLA
concern and is not ported.

Training losses: ``cross_entropy_loss`` on whole logits, and
``chunked_cross_entropy``, an autograd Function that never holds the fp32
[B, S, V] logits (``cambrian_tpu/models/cambrian.py:611-776``).
"""

from typing import Callable, Sequence, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from ..ops.activations import gelu_exact
from ..ops.norms import LayerNorm
from ..ops.resize import resize_bilinear
from .config import CambrianConfig
from .language.llama import (
    LlamaDecoderLayer,
    decoder_norm,
    make_causal_mask,
    make_decode_mask,
)
from .projectors import SvaProjector
from .sva import VisionTokenSampler


def window_features(feats: torch.Tensor, q_side: int) -> torch.Tensor:
    """[B, S*S, C] tower grid -> [B, q_side^2, (S/q_side)^2, C] local windows."""
    b, n, c = feats.shape
    s = int(n ** 0.5)
    if s * s != n or s % q_side:
        raise ValueError(f"{n} tokens do not window onto a {q_side}x{q_side} grid")
    r = s // q_side
    x = feats.reshape(b, q_side, r, q_side, r, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, q_side * q_side, r * r, c)


def unwindow_mask(mask: torch.Tensor, q_side: int) -> torch.Tensor:
    """Inverse of the window view for masks: [B, q^2, r^2] -> [B, (q*r)^2]."""
    b, _, r2 = mask.shape
    r = int(r2 ** 0.5)
    x = mask.reshape(b, q_side, q_side, r, r).permute(0, 1, 3, 2, 4)
    return x.reshape(b, (q_side * r) ** 2)


def window_mask(flat: torch.Tensor, q_side: int) -> torch.Tensor:
    """[B, S*S] -> [B, q^2, r^2] window masks; all-invalid windows are
    force-unmasked."""
    b, n = flat.shape
    r = int(n ** 0.5) // q_side
    x = flat.reshape(b, q_side, r, q_side, r).permute(0, 1, 3, 2, 4)
    x = x.reshape(b, q_side * q_side, r * r).to(torch.bool)
    dead = x.sum(-1, keepdim=True) == 0
    return x | dead


class _AuxProjector(nn.Module):
    """Dense -> GELU -> Dense -> LayerNorm, per tower into the vision width."""

    def __init__(self, in_dim: int, vision_hidden_size: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, vision_hidden_size, dtype=dtype, device=device)
        self.fc2 = nn.Linear(vision_hidden_size, vision_hidden_size, dtype=dtype,
                             device=device)
        self.ln = LayerNorm(vision_hidden_size, 1e-5, device=device)

    def forward(self, x):
        return self.ln(self.fc2(gelu_exact(self.fc1(x))))


def _block_index(start: torch.Tensor, length: int, seq_len: int) -> torch.Tensor:
    """[B, length] positions of each sample's block, with the start clamped
    so the block fits (``lax.dynamic_slice`` semantics)."""
    start = start.clamp(0, seq_len - length)
    return start[:, None] + torch.arange(length, device=start.device)[None, :]


class CambrianLM(nn.Module):
    """Token embeddings + SVA connector + decoder + LM head.

    Inputs are pre-packed (cambrian_tpu/data/packing.py): ``input_ids``
    [B, S] with the image indicator at the block start, per-token validity
    ``attention_mask`` [B, S], ``position_ids`` [B, S], and per-tower window
    masks [B, 576, W_i].
    """

    def __init__(self, cfg: CambrianConfig, tower_hidden_sizes: Sequence[int],
                 dtype=torch.float32, device=None):
        super().__init__()
        if cfg.mm_projector_type != "sva":
            raise NotImplementedError(
                f"projector type {cfg.mm_projector_type!r} is not ported yet")
        if cfg.lm_head_dtype not in (None, "bf16"):
            raise ValueError(f"lm_head_dtype must be None or 'bf16', got {cfg.lm_head_dtype!r}")
        c = cfg
        self.cfg = cfg
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device)
        vh = c.vision_hidden_size
        self.num_towers = len(tower_hidden_sizes)
        self.embed_tokens = nn.Embedding(c.vocab_size, c.hidden_size, **kw)
        for i, hs in enumerate(tower_hidden_sizes):
            self.add_module(f"mm_projector_aux_{i}", _AuxProjector(hs, vh, **kw))
        for g, qn in enumerate(c.query_num_list):
            self.add_module(f"vision_sampler_{g}", VisionTokenSampler(
                vh, vh, c.cross_att_window_sizes(qn), vh, c.connector_depth, **kw))
        if not c.connector_only:
            for k in range(c.num_of_vision_sampler_layers):
                self.add_module(f"vision_sampler_layers_{k}", VisionTokenSampler(
                    c.hidden_size, vh, c.cross_att_window_sizes(c.image_token_len), vh,
                    1, **kw))
        self.mm_projector = SvaProjector(vh * c.num_query_group, c.hidden_size, **kw)
        self.vision_query = nn.Parameter(torch.zeros(c.num_query_group, vh, device=device))
        self.image_newline = nn.Parameter(torch.zeros(c.hidden_size, device=device))
        for i in range(c.num_hidden_layers):
            self.add_module(f"layers_{i}", LlamaDecoderLayer(c, **kw))
        self.norm = decoder_norm(c, device)
        if not c.tie_word_embeddings:
            # fp32, or bf16 under the serving option lm_head_dtype="bf16"
            # (half the bytes of the largest read of a decode step)
            head_dtype = torch.bfloat16 if c.lm_head_dtype == "bf16" else torch.float32
            self.lm_head = nn.Linear(c.hidden_size, c.vocab_size, bias=False,
                                     dtype=head_dtype, device=device)

    # -- vision connector ---------------------------------------------------

    def prepare_vision(self, aux_features_list, aux_masks_list):
        """Multi-tower SVA aggregation. Returns (image_embeds [B, 600, hidden],
        vision_kv N x [B, 576, W_i, vh], vision_masks, global_context
        [B, 576, vh])."""
        c = self.cfg
        b = aux_features_list[0].shape[0]
        final_side = c.image_token_len_per_side
        vh = c.vision_hidden_size
        projected = [self._remat(getattr(self, f"mm_projector_aux_{i}"), f.to(self.dtype))
                     for i, f in enumerate(aux_features_list)]
        global_context = projected[0].mean(1, keepdim=True)          # [B, 1, vh]
        group_features = []
        for g, qn in enumerate(c.query_num_list):
            q_side = int(qn ** 0.5)
            queries = self.vision_query[g].to(self.dtype)[None, None, :].expand(b, qn, vh)
            ctx = global_context.expand(b, qn, vh)
            kvs = [window_features(p, q_side) for p in projected]
            if q_side == final_side:
                masks = list(aux_masks_list)
            else:
                masks = [window_mask(unwindow_mask(m, final_side), q_side)
                         for m in aux_masks_list]
            out = self._remat(getattr(self, f"vision_sampler_{g}"), queries, ctx, kvs, masks)
            if q_side != final_side:
                grid = resize_bilinear(out.reshape(b, q_side, q_side, -1),
                                       final_side, final_side)
                out = grid.reshape(b, final_side * final_side, -1)
            group_features.append(out)
        image_features = self.mm_projector(torch.cat(group_features, dim=-1))
        grid = image_features.reshape(b, final_side, final_side, -1)
        newline = self.image_newline.to(grid.dtype).expand(b, final_side, 1, c.hidden_size)
        image_embeds = torch.cat([grid, newline], dim=2).reshape(
            b, c.image_block_len, c.hidden_size)
        vision_kv = [window_features(p, final_side) for p in projected]
        global_ctx = global_context.expand(b, c.image_token_len, vh)
        return image_embeds, vision_kv, list(aux_masks_list), global_ctx

    def _inject_sva(self, k: int, hidden, vision_kv, vision_masks, global_context,
                    im_start):
        """In-decoder SVA step k: cut the image block at each sample's start,
        strip the newline column, cross-attend, write the block back."""
        c = self.cfg
        b, s, width = hidden.shape
        side = c.image_token_len_per_side
        idx = _block_index(im_start, c.image_block_len, s)[..., None].expand(-1, -1, width)
        block = hidden.gather(1, idx).reshape(b, side, side + 1, width)
        latent, newline = block[:, :, :side], block[:, :, side:]
        latent = self._remat(getattr(self, f"vision_sampler_layers_{k}"),
                             latent.reshape(b, c.image_token_len, width), global_context,
                             vision_kv, vision_masks)
        block = torch.cat([latent.reshape(b, side, side, width), newline], dim=2)
        return hidden.scatter(1, idx, block.reshape(b, c.image_block_len, width))

    def _remat(self, module: nn.Module, *args):
        """``module(*args)``, recomputed in the backward under ``cfg.remat``
        while grad is enabled (the JAX package's ``nn.remat``)."""
        if self.cfg.remat and torch.is_grad_enabled():
            return checkpoint(module, *args, use_reentrant=False)
        return module(*args)

    # -- decoder ------------------------------------------------------------

    def _decoder(self, hidden, mask, position_ids, cache, cache_index, vision_kv,
                 vision_masks, global_context, inject: bool, im_start=None):
        c = self.cfg
        inject_layers = set(c.vision_sampler_layer_indices) if inject else set()
        for i in range(c.num_hidden_layers):
            layer_cache = None if cache is None else cache[i]
            hidden, _ = self._remat(getattr(self, f"layers_{i}"), hidden, mask, position_ids,
                                    layer_cache, cache_index)
            if i in inject_layers:
                k = (i - c.start_of_vision_sampler_layers) // c.stride_of_vision_sampler_layers
                hidden = self._inject_sva(k, hidden, vision_kv, vision_masks,
                                          global_context, im_start)
        return self.norm(hidden)

    def head(self) -> torch.Tensor:
        """The LM head weight [V, hidden]: ``lm_head.weight``, or the token
        embeddings when tied."""
        if self.cfg.tie_word_embeddings:
            return self.embed_tokens.weight
        return self.lm_head.weight

    def logits(self, hidden):
        """fp32 logits (``head_logits``)."""
        return head_logits(self.cfg, self.head(), hidden)

    def _image_start(self, input_ids) -> torch.Tensor:
        """Per-sample index of the image indicator [B]; cfg.image_position
        when a sample has none."""
        is_img = input_ids == IMAGE_TOKEN_INDEX
        idx = is_img.int().argmax(1)
        return torch.where(is_img.any(1), idx, torch.full_like(idx, self.cfg.image_position))

    def _splice_image(self, input_ids, image_embeds, im_start=None):
        """Embed text tokens (ids < 0 clamped to 0) and overwrite each
        sample's image block; Gemma then scales the whole sequence, image
        block included, by sqrt(hidden_size) in the embeddings' dtype."""
        embeds = self.embed_tokens(input_ids.clamp(min=0))
        if image_embeds is not None:
            b, s, width = embeds.shape
            idx = _block_index(im_start, image_embeds.shape[1], s)
            embeds = embeds.scatter(1, idx[..., None].expand(-1, -1, width),
                                    image_embeds.to(embeds.dtype))
        if self.cfg.model_type.startswith("gemma"):
            embeds = embeds * torch.tensor(self.cfg.hidden_size ** 0.5, dtype=embeds.dtype)
        return embeds

    def _vision(self, aux_features_list, aux_masks_list):
        if aux_features_list is None:
            return None, None, None, None
        return self.prepare_vision(aux_features_list, aux_masks_list)

    def forward(self, input_ids, attention_mask, position_ids,
                aux_features_list=None, aux_masks_list=None):
        """No-cache (training) forward; fp32 logits [B, S, V]."""
        return self.logits(self.hidden_states(input_ids, attention_mask, position_ids,
                                              aux_features_list, aux_masks_list))

    def hidden_states(self, input_ids, attention_mask, position_ids,
                      aux_features_list=None, aux_masks_list=None):
        """The training forward up to (excluding) the LM head, so that the
        loss can run over sequence chunks (``chunked_cross_entropy``)."""
        image_embeds, vision_kv, vision_masks, global_ctx = self._vision(
            aux_features_list, aux_masks_list)
        im_start = self._image_start(input_ids)
        hidden = self._splice_image(input_ids, image_embeds, im_start)
        return self._decoder(hidden, make_causal_mask(attention_mask), position_ids,
                             None, None, vision_kv, vision_masks, global_ctx,
                             inject=image_embeds is not None, im_start=im_start)

    def prefill(self, input_ids, attention_mask, position_ids, cache,
                aux_features_list=None, aux_masks_list=None):
        """Forward over the prompt that fills the KV cache. The keys span the
        whole cache; slots past the prompt are invalid. Returns (logits
        [B, S, V] fp32, cache)."""
        image_embeds, vision_kv, vision_masks, global_ctx = self._vision(
            aux_features_list, aux_masks_list)
        im_start = self._image_start(input_ids)
        hidden = self._splice_image(input_ids, image_embeds, im_start)
        b, s = input_ids.shape
        k_len = cache[0][0].shape[1]
        pad = torch.zeros((b, k_len - s), dtype=torch.bool, device=input_ids.device)
        mask = make_causal_mask(torch.cat([attention_mask.to(torch.bool), pad], dim=-1))
        hidden = self._decoder(hidden, mask, position_ids, cache, 0, vision_kv,
                               vision_masks, global_ctx, inject=image_embeds is not None,
                               im_start=im_start)
        return self.logits(hidden), cache

    def decode_step(self, token_ids, position_ids, cache, cache_valid,
                    cache_index: Union[int, torch.Tensor]):
        """One decode step over the cache, writing slot ``cache_index``: an
        int shared by every row, or a [B] tensor of one index a row (an index
        past the cache writes nothing). Returns (logits [B, V], cache).

        The new token's embedding is not scaled by Gemma's normaliser: the
        JAX package's ``decode_step`` applies it only in the prefill's
        splice, and the port keeps that (ROADMAP queue 3)."""
        hidden = self.embed_tokens(token_ids)
        hidden = self._decoder(hidden, make_decode_mask(cache_valid), position_ids,
                               cache, cache_index, None, None, None, inject=False)
        return self.logits(hidden)[:, 0], cache


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Shifted next-token CE in fp32, ignoring IGNORE_INDEX."""
    shift_logits = logits[:, :-1].float()
    shift_labels = labels[:, 1:]
    valid = shift_labels != IGNORE_INDEX
    safe = torch.where(valid, shift_labels, torch.zeros_like(shift_labels))
    logp = torch.log_softmax(shift_logits, dim=-1)
    token_ll = logp.gather(-1, safe[..., None])[..., 0]
    token_loss = torch.where(valid, -token_ll, torch.zeros_like(token_ll))
    return token_loss.sum() / valid.sum().clamp_min(1)


def _bf16_head_logits(head: torch.Tensor, hidden: torch.Tensor) -> torch.Tensor:
    """fp32 logits from bf16 operands with fp32 accumulation, never rounded
    to bf16 (``cambrian_tpu/models/cambrian.py::_f32_acc_dot_general``). On
    the card one GEMM reads the head as stored (``aten::mm.dtype``), so the
    option's halved read is kept; on the CPU, and where autograd needs the
    product, the plain version: fp32 products of the bf16-rounded operands."""
    h = hidden.to(torch.bfloat16)
    w = head.to(torch.bfloat16)             # a no-op for a head stored bf16
    grad = torch.is_grad_enabled() and (h.requires_grad or w.requires_grad)
    if h.is_cuda and not grad:
        out = torch.mm(h.reshape(-1, h.shape[-1]), w.T, out_dtype=torch.float32)
        return out.reshape(*h.shape[:-1], w.shape[0])
    return h.float() @ w.float().T


def head_logits(cfg: CambrianConfig, head: torch.Tensor, hidden: torch.Tensor) -> torch.Tensor:
    """fp32 logits from the head weight [V, hidden] (``CambrianLM.head()``:
    the JAX package's ``lm_head/kernel`` transposed, or the tied embedding),
    with the config's logit scale and final softcap. The head runs in fp32
    on fp32 activations, or, under ``lm_head_dtype="bf16"``, on bf16
    operands with fp32 accumulation (``_bf16_head_logits``)."""
    if cfg.lm_head_dtype == "bf16":
        logits = _bf16_head_logits(head, hidden)
    else:
        logits = hidden.float() @ head.float().T
    if cfg.logit_scale is not None:
        logits = logits * cfg.logit_scale
    if cfg.final_logit_softcapping is not None:
        cap = cfg.final_logit_softcapping
        logits = cap * torch.tanh(logits / cap)
    return logits


def extract_head(cfg: CambrianConfig, model: CambrianLM) -> torch.Tensor:
    """The head argument of ``head_logits`` / ``chunked_cross_entropy``."""
    return model.head()


def _ce_chunk_total(logits_fn, head, hc, lc):
    """Sum of the valid tokens' NLL over one [B, chunk] slab, in fp32."""
    logp = torch.log_softmax(logits_fn(head, hc).float(), dim=-1)
    valid = lc != IGNORE_INDEX
    safe = torch.where(valid, lc, torch.zeros_like(lc))
    ll = logp.gather(-1, safe[..., None])[..., 0]
    return torch.where(valid, -ll, torch.zeros_like(ll)).sum()


class _ChunkedCrossEntropy(torch.autograd.Function):
    """Forward: the loss, chunk by chunk, under no grad. Backward: each
    chunk's logits recomputed and differentiated alone (the JAX package's
    custom_vjp over ``lax.scan``); the head's gradient is accumulated only
    when the head requires grad."""

    @staticmethod
    def forward(ctx, hidden, next_labels, head, logits_fn, chunk):
        total = hidden.new_zeros((), dtype=torch.float32)
        for i in range(0, hidden.shape[1], chunk):
            total = total + _ce_chunk_total(logits_fn, head, hidden[:, i:i + chunk],
                                            next_labels[:, i:i + chunk])
        count = (next_labels != IGNORE_INDEX).sum().clamp_min(1).float()
        ctx.save_for_backward(hidden, next_labels, head)
        ctx.logits_fn, ctx.chunk = logits_fn, chunk
        return total / count

    @staticmethod
    def backward(ctx, g):
        hidden, next_labels, head = ctx.saved_tensors
        scale = g / (next_labels != IGNORE_INDEX).sum().clamp_min(1).float()
        need_head = ctx.needs_input_grad[2]
        dhidden = torch.zeros_like(hidden)
        dhead = torch.zeros_like(head, dtype=torch.float32) if need_head else None
        hd = head.detach().requires_grad_(need_head)
        for i in range(0, hidden.shape[1], ctx.chunk):
            with torch.enable_grad():
                hc = hidden[:, i:i + ctx.chunk].detach().requires_grad_(True)
                total = _ce_chunk_total(ctx.logits_fn, hd, hc, next_labels[:, i:i + ctx.chunk])
                grads = torch.autograd.grad(total * scale, [hc, hd] if need_head else [hc])
            dhidden[:, i:i + ctx.chunk] = grads[0]
            if need_head:
                dhead += grads[1].float()
        return dhidden, None, (dhead.to(head.dtype) if need_head else None), None, None


def chunked_cross_entropy(hidden: torch.Tensor, labels: torch.Tensor,
                          logits_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                          chunk: int, head: torch.Tensor) -> torch.Tensor:
    """Shifted next-token CE over sequence chunks of ``chunk`` tokens,
    applying ``logits_fn(head, hidden_chunk)`` per chunk: the math of
    ``cross_entropy_loss(logits_fn(head, hidden), labels)`` with another fp32
    summation order, but only one chunk's [B, chunk, V] fp32 logits exist at
    a time, in the forward and in the backward."""
    b = labels.shape[0]
    next_labels = torch.cat([labels[:, 1:], labels.new_full((b, 1), IGNORE_INDEX)], dim=1)
    return _ChunkedCrossEntropy.apply(hidden, next_labels, head, logits_fn, chunk)
