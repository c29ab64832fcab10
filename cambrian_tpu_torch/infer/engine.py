"""Inference runtime (cambrian_tpu/infer/engine.py): prefill through towers,
SVA and decoder into a fixed-size KV cache, then a Python decode loop with
greedy or temperature/top-p sampling and per-sample EOS.

The JAX engine compiles the whole generation into one program; eager
PyTorch runs the same steps from Python. Streaming and continuous batching
belong to the serving slice.
"""

import time
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..models.cambrian import CambrianLM
from ..models.language.llama import init_kv_cache


@dataclass
class GenerationConfig:
    max_new_tokens: int = 128
    temperature: float = 0.0        # 0 => greedy
    top_p: float = 1.0
    eos_token_id: Optional[int] = None
    pad_token_id: int = 0
    seed: int = 0


def sample_token(logits: torch.Tensor, generator: Optional[torch.Generator],
                 temperature: float, top_p: float) -> torch.Tensor:
    """[B, V] -> [B] next tokens (greedy when temperature == 0)."""
    if temperature == 0.0:
        return logits.argmax(-1)
    logits = logits.float() / temperature
    if top_p < 1.0:
        sorted_logits = logits.sort(-1, descending=True).values
        cum = torch.softmax(sorted_logits, -1).cumsum(-1)
        # smallest set with cumulative probability >= top_p
        cutoff_idx = (cum < top_p).sum(-1, keepdim=True).clamp(max=logits.shape[-1] - 1)
        cutoff = sorted_logits.gather(-1, cutoff_idx)
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    probs = torch.softmax(logits, -1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


class GenerationEngine:
    """Batched multimodal generation over a fixed-size KV cache.

    After ``generate``: ``last_lengths`` [B] holds each sample's generated
    length, ``last_next_logits`` the [B, V] fp32 logits that picked the
    first token, and ``last_timings`` the prefill and decode wall times
    (ms, each ending in a device synchronize) and the decode step count.
    """

    def __init__(self, model: CambrianLM, towers: Sequence = (), max_len: int = 4096,
                 cache_dtype=torch.bfloat16):
        self.model = model
        self.towers = list(towers)
        self.max_len = max_len
        self.cache_dtype = cache_dtype
        self.last_lengths = None
        self.last_next_logits = None
        self.last_timings = {}

    @property
    def device(self) -> torch.device:
        return self.model.image_newline.device

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def encode_images(self, images):
        """Per-tower pixel batches [B, 3, H_i, W_i] -> token features."""
        return [t(torch.as_tensor(px).to(self.device))
                for t, px in zip(self.towers, images)]

    @torch.inference_mode()
    def generate(self, input_ids, attention_mask, position_ids, aux_features=None,
                 aux_masks=None, config: Optional[GenerationConfig] = None) -> np.ndarray:
        """Generated ids [B, <= max_new_tokens] (prompt excluded), pad past
        each sample's end; trailing columns where every sample has finished
        are trimmed."""
        cfg = config or GenerationConfig()
        dev = self.device
        ids = torch.as_tensor(np.asarray(input_ids), device=dev).long()
        mask = torch.as_tensor(np.asarray(attention_mask), device=dev).to(torch.bool)
        pos = torch.as_tensor(np.asarray(position_ids), device=dev).long()
        if aux_masks is not None:
            aux_masks = [torch.as_tensor(np.asarray(m), device=dev).to(torch.bool)
                         for m in aux_masks]
        b, s = ids.shape
        k_len = min(self.max_len, s + cfg.max_new_tokens)
        cache = init_kv_cache(self.model.cfg, b, k_len, self.cache_dtype, dev)

        t0 = time.perf_counter()
        logits, cache = self.model.prefill(ids, mask, pos, cache, aux_features, aux_masks)
        # next-token logits from each prompt's last valid slot
        last_idx = (mask * torch.arange(s, device=dev)[None, :]).amax(1)
        next_logits = logits[torch.arange(b, device=dev), last_idx]
        self.last_next_logits = next_logits
        self._sync()
        t1 = time.perf_counter()

        generator = None
        if cfg.temperature != 0.0:
            generator = torch.Generator(device=dev).manual_seed(cfg.seed)
        next_pos = pos.amax(1) + 1
        cache_valid = torch.zeros((b, k_len), dtype=torch.bool, device=dev)
        cache_valid[:, :s] = mask
        tokens = torch.full((b, cfg.max_new_tokens), cfg.pad_token_id, dtype=torch.long,
                            device=dev)
        finished = torch.zeros(b, dtype=torch.bool, device=dev)
        lengths = torch.zeros(b, dtype=torch.long, device=dev)
        steps = max(0, min(cfg.max_new_tokens, k_len - s))
        decode_steps = 0
        for t in range(steps):
            token = sample_token(next_logits, generator, cfg.temperature, cfg.top_p)
            if cfg.eos_token_id is not None:
                finished |= token == cfg.eos_token_id
            tokens[:, t] = torch.where(finished, cfg.pad_token_id, token)
            lengths += (~finished).long()
            if t == steps - 1 or bool(finished.all()):
                break
            write_index = s + t
            cache_valid[:, write_index] = ~finished
            next_logits, cache = self.model.decode_step(
                token[:, None], (next_pos + t)[:, None], cache, cache_valid, write_index)
            decode_steps += 1
        self._sync()
        t2 = time.perf_counter()
        self.last_timings = {"prefill_ms": (t1 - t0) * 1e3, "decode_ms": (t2 - t1) * 1e3,
                             "decode_steps": decode_steps}
        self.last_lengths = lengths.cpu().numpy()
        last = max(1, int(self.last_lengths.max()))
        return tokens[:, :last].cpu().numpy()
