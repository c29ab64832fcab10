"""The Cambrian multimodal model (cambrian_tpu/models/cambrian.py):
multi-tower features -> SVA connector -> LLaMA decoder with periodic in-LLM
SVA re-injection -> fp32 logits.

``CambrianLM`` holds the token embeddings, the connector, the decoder and
the LM head; the vision towers are separate modules. Module names mirror the
flax tree (``mm_projector_aux_0``, ``vision_sampler_layers_3``,
``layers_12``) for ``checkpoint/from_jax.py``; the JAX package's
``_SvaProjector`` is ``projectors.SvaProjector``. The scan-layers and remat
machinery of the JAX package are XLA concerns and are not ported.
"""

from typing import Sequence

import torch
from torch import nn

from cambrian_tpu.constants import IMAGE_TOKEN_INDEX
from cambrian_tpu.models.config import CambrianConfig

from ..ops.activations import gelu_exact
from ..ops.norms import LayerNorm, RMSNorm
from ..ops.resize import resize_bilinear
from .language.llama import LlamaDecoderLayer, make_causal_mask, make_decode_mask
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
        if cfg.lm_head_dtype == "bf16":
            raise NotImplementedError("the bf16 lm_head option is not ported yet")
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
        self.norm = RMSNorm(c.hidden_size, c.rms_norm_eps, device=device)
        if not c.tie_word_embeddings:
            self.lm_head = nn.Linear(c.hidden_size, c.vocab_size, bias=False,
                                     dtype=torch.float32, device=device)

    # -- vision connector ---------------------------------------------------

    def prepare_vision(self, aux_features_list, aux_masks_list):
        """Multi-tower SVA aggregation. Returns (image_embeds [B, 600, hidden],
        vision_kv N x [B, 576, W_i, vh], vision_masks, global_context
        [B, 576, vh])."""
        c = self.cfg
        b = aux_features_list[0].shape[0]
        final_side = c.image_token_len_per_side
        vh = c.vision_hidden_size
        projected = [getattr(self, f"mm_projector_aux_{i}")(f.to(self.dtype))
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
            out = getattr(self, f"vision_sampler_{g}")(queries, ctx, kvs, masks)
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
        latent = getattr(self, f"vision_sampler_layers_{k}")(
            latent.reshape(b, c.image_token_len, width), global_context, vision_kv,
            vision_masks)
        block = torch.cat([latent.reshape(b, side, side, width), newline], dim=2)
        return hidden.scatter(1, idx, block.reshape(b, c.image_block_len, width))

    # -- decoder ------------------------------------------------------------

    def _decoder(self, hidden, mask, position_ids, cache, cache_index, vision_kv,
                 vision_masks, global_context, inject: bool, im_start=None):
        c = self.cfg
        inject_layers = set(c.vision_sampler_layer_indices) if inject else set()
        for i in range(c.num_hidden_layers):
            layer_cache = None if cache is None else cache[i]
            hidden, _ = getattr(self, f"layers_{i}")(hidden, mask, position_ids,
                                                     layer_cache, cache_index)
            if i in inject_layers:
                k = (i - c.start_of_vision_sampler_layers) // c.stride_of_vision_sampler_layers
                hidden = self._inject_sva(k, hidden, vision_kv, vision_masks,
                                          global_context, im_start)
        return self.norm(hidden)

    def _logits(self, hidden):
        """fp32 logits: the head runs in fp32 on fp32 activations."""
        if self.cfg.tie_word_embeddings:
            return hidden.float() @ self.embed_tokens.weight.float().T
        return self.lm_head(hidden.float())

    def _image_start(self, input_ids) -> torch.Tensor:
        """Per-sample index of the image indicator [B]; cfg.image_position
        when a sample has none."""
        is_img = input_ids == IMAGE_TOKEN_INDEX
        idx = is_img.int().argmax(1)
        return torch.where(is_img.any(1), idx, torch.full_like(idx, self.cfg.image_position))

    def _splice_image(self, input_ids, image_embeds, im_start=None):
        """Embed text tokens (ids < 0 clamped to 0) and overwrite each
        sample's image block."""
        embeds = self.embed_tokens(input_ids.clamp(min=0))
        if image_embeds is not None:
            b, s, width = embeds.shape
            idx = _block_index(im_start, image_embeds.shape[1], s)
            embeds = embeds.scatter(1, idx[..., None].expand(-1, -1, width),
                                    image_embeds.to(embeds.dtype))
        return embeds

    def _vision(self, aux_features_list, aux_masks_list):
        if aux_features_list is None:
            return None, None, None, None
        return self.prepare_vision(aux_features_list, aux_masks_list)

    def forward(self, input_ids, attention_mask, position_ids,
                aux_features_list=None, aux_masks_list=None):
        """No-cache forward; fp32 logits [B, S, V]."""
        image_embeds, vision_kv, vision_masks, global_ctx = self._vision(
            aux_features_list, aux_masks_list)
        im_start = self._image_start(input_ids)
        hidden = self._splice_image(input_ids, image_embeds, im_start)
        hidden = self._decoder(hidden, make_causal_mask(attention_mask), position_ids,
                               None, None, vision_kv, vision_masks, global_ctx,
                               inject=image_embeds is not None, im_start=im_start)
        return self._logits(hidden)

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
        return self._logits(hidden), cache

    def decode_step(self, token_ids, position_ids, cache, cache_valid, cache_index: int):
        """One decode step over the cache. Returns (logits [B, V], cache)."""
        hidden = self.embed_tokens(token_ids)
        hidden = self._decoder(hidden, make_decode_mask(cache_valid), position_ids,
                               cache, cache_index, None, None, None, inject=False)
        return self._logits(hidden)[:, 0], cache
