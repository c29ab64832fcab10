"""Inference runtime (cambrian_tpu/infer/engine.py): prefill through towers,
SVA and decoder into a fixed-size KV cache, then a Python decode loop with
greedy or temperature/top-p sampling and per-sample EOS.

The JAX engine compiles the whole generation into one program; eager
PyTorch runs the same steps from Python. ``generate_stream`` yields the ids so
far after every chunk of ``stream_chunk`` decode steps, with the JAX engine's
chunking, cache sizing and stopping rules; in eager PyTorch a chunk is only
the cadence of the yields. ``infer/continuous.py`` serves concurrent
requests through one shared cache; its chunked decode samples each row with
``sample_token_per_slot``.

``GenerationEngine(mesh=...)`` serves a model laid out on a (data, fsdp,
model) mesh by the training rules (``parallel.sharding.shard_model``): each
rank holds its heads' share of the KV cache. A quantized model
(``load_8bit`` / ``load_4bit``) is laid out by the same rules: each rank's
K3/K4/K4b calls read its slice of each split projection. ``generate``
splits the batch over (data, fsdp) where it divides (else every rank runs
every row, as ``_fit_spec`` drops the axis), agrees across ranks on when
every sample has finished, and gathers the tokens, so every rank returns
the whole result.
``generate_stream`` runs every row on every rank, so that the ranks' host
decisions (chunks, stopping) agree. The embedding and the LM head are
vocab-parallel there (``models/cambrian.py``): each rank holds V/n of their
rows, n = model x fsdp, and the prefill and every decode step compute its
slab's fp32 logits of the fsdp ranks' rows, then send each row's slabs to
its owner, so that ``last_next_logits`` and the sampling hold the rank's
own rows over the whole vocab (greedy ties go to the lowest index, as on
one card).
"""

import functools
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..models.cambrian import CambrianLM
from ..models.language.llama import init_kv_cache
from ..parallel.distributed import dp_coordinate
from ..parallel.mesh import axis_sizes
from ..parallel.sharding import local_kv_heads, shard_model


def _serving(method):
    """Run an engine method under ``torch.inference_mode()``, or under
    ``torch.no_grad()`` for a sharded model: FSDP2's gathered parameters
    track versions, which inference tensors cannot."""
    inference, plain = torch.inference_mode()(method), torch.no_grad()(method)

    @functools.wraps(method)
    def run(self, *args, **kwargs):
        return (plain if self.mesh is not None else inference)(self, *args, **kwargs)

    return run


@dataclass
class GenerationConfig:
    max_new_tokens: int = 128
    temperature: float = 0.0        # 0 => greedy
    top_p: float = 1.0
    eos_token_id: Optional[int] = None
    pad_token_id: int = 0
    seed: int = 0
    # generate_stream: decode steps between yields; forced to 1 when a
    # stopping callable is given, so that it sees every token
    stream_chunk: int = 8


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


def sample_token_per_slot(logits: torch.Tensor, generator: Optional[torch.Generator],
                          temps: torch.Tensor, top_ps: torch.Tensor) -> torch.Tensor:
    """``sample_token`` a row: [B, V] logits with temperatures and top-p
    values [B] -> [B] int64 tokens; rows with temperature 0 are greedy, and
    top-p applies to the rows whose top-p is below 1 (the smallest set with
    cumulative probability >= top-p). The draw is the Gumbel-max form of a
    categorical sample, made on the device from ``generator`` with no host
    sync."""
    greedy = logits.argmax(-1)
    scaled = logits.float() / temps.clamp_min(1e-6)[:, None]
    sorted_logits = scaled.sort(-1, descending=True).values
    cum = torch.softmax(sorted_logits, -1).cumsum(-1)
    # where the sums never reach top-p, the last (smallest) logit: nothing
    # is dropped, as the JAX package's out-of-range cutoff drops nothing
    cutoff_idx = (cum < top_ps[:, None]).sum(-1, keepdim=True).clamp(max=scaled.shape[-1] - 1)
    cutoff = sorted_logits.gather(-1, cutoff_idx)
    drop = (top_ps[:, None] < 1.0) & (scaled < cutoff)
    filtered = scaled.masked_fill(drop, float("-inf"))
    noise = torch.empty_like(filtered).exponential_(generator=generator)
    sampled = (filtered - noise.log()).argmax(-1)
    return torch.where(temps == 0.0, greedy, sampled)


class GenerationEngine:
    """Batched multimodal generation over a fixed-size KV cache.

    After ``generate``: ``last_lengths`` [B] holds each sample's generated
    length, ``last_next_logits`` the [B, V] fp32 logits that picked the
    first token, and ``last_timings`` the prefill and decode wall times
    (ms, each ending in a device synchronize) and the decode step count.
    """

    def __init__(self, model: CambrianLM, towers: Sequence = (), max_len: int = 4096,
                 cache_dtype=torch.bfloat16, mesh=None):
        """``mesh``: a (data, fsdp, model) ``DeviceMesh``; the model and the
        towers are frozen and sharded on it in place (``shard_model``)."""
        self.model = model
        self.towers = list(towers)
        self.max_len = max_len
        self.cache_dtype = cache_dtype
        self.mesh = mesh
        if mesh is not None:
            # serving trains nothing: no FSDP2 unit then needs one trainable dtype
            for module in [model, *self.towers]:
                module.requires_grad_(False)
        shard_model(model, self.towers, mesh)
        self.kv_heads = local_kv_heads(model.cfg, mesh, model)
        self.last_lengths = None
        self.last_next_logits = None
        self.last_timings = {}

    @property
    def device(self) -> torch.device:
        return self.model.image_newline.device

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @_serving
    def encode_images(self, images):
        """Per-tower pixel batches [B, 3, H_i, W_i] -> token features."""
        return [t(torch.as_tensor(px).to(self.device))
                for t, px in zip(self.towers, images)]

    def _prefill(self, input_ids, attention_mask, position_ids, aux_features, aux_masks,
                 n_new: int):
        """Prefill into a fresh cache of min(max_len, S + n_new) slots.
        Returns (next_logits [B, V] from each prompt's last valid slot, cache,
        cache_valid [B, k_len], next_pos [B]) and records ``prefill_ms``."""
        dev = self.device
        ids = torch.as_tensor(np.asarray(input_ids), device=dev).long()
        mask = torch.as_tensor(np.asarray(attention_mask), device=dev).to(torch.bool)
        pos = torch.as_tensor(np.asarray(position_ids), device=dev).long()
        if aux_masks is not None:
            aux_masks = [torch.as_tensor(np.asarray(m), device=dev).to(torch.bool)
                         for m in aux_masks]
        b, s = ids.shape
        k_len = min(self.max_len, s + n_new)
        cache = init_kv_cache(self.model.cfg, b, k_len, self.cache_dtype, dev, self.kv_heads)

        t0 = time.perf_counter()
        logits, cache = self.model.prefill(ids, mask, pos, cache, aux_features, aux_masks)
        last_idx = (mask * torch.arange(s, device=dev)[None, :]).amax(1)
        next_logits = logits[torch.arange(b, device=dev), last_idx]
        self.last_next_logits = next_logits
        self._sync()
        self.last_timings = {"prefill_ms": (time.perf_counter() - t0) * 1e3,
                             "decode_ms": 0.0, "decode_steps": 0}
        cache_valid = torch.zeros((b, k_len), dtype=torch.bool, device=dev)
        cache_valid[:, :s] = mask
        return next_logits, cache, cache_valid, pos.amax(1) + 1

    def _generator(self, cfg: GenerationConfig) -> Optional[torch.Generator]:
        if cfg.temperature == 0.0:
            return None
        return torch.Generator(device=self.device).manual_seed(cfg.seed)

    @_serving
    def generate(self, input_ids, attention_mask, position_ids, aux_features=None,
                 aux_masks=None, config: Optional[GenerationConfig] = None,
                 stopping: Optional[Callable[[np.ndarray], bool]] = None,
                 on_device: bool = True) -> np.ndarray:
        """Generated ids [B, <= max_new_tokens] (prompt excluded), pad past
        each sample's end; trailing columns where every sample has finished
        are trimmed.

        As in the JAX engine, a ``stopping`` callable (given the ids so far
        after every token; True ends generation) or ``on_device=False`` runs
        the call through ``generate_stream`` and returns its last yield.
        Otherwise the decode loop below runs: ``on_device`` keeps the JAX
        meaning, no Python-side stopping."""
        if stopping is not None or not on_device:
            out = None
            for out in self.generate_stream(input_ids, attention_mask, position_ids,
                                            aux_features, aux_masks, config, stopping):
                pass
            if out is None:
                return np.zeros((np.asarray(input_ids).shape[0], 0), np.int32)
            return out
        cfg = config or GenerationConfig()
        dev = self.device
        rows = self._local_rows(np.asarray(input_ids).shape[0])
        if rows is not None:
            input_ids, attention_mask, position_ids = (
                np.asarray(x)[rows] for x in (input_ids, attention_mask, position_ids))
            if aux_features is not None:
                aux_features = [f[rows] for f in aux_features]
            if aux_masks is not None:
                aux_masks = [np.asarray(m)[rows] for m in aux_masks]
        next_logits, cache, cache_valid, next_pos = self._prefill(
            input_ids, attention_mask, position_ids, aux_features, aux_masks,
            cfg.max_new_tokens)
        b, k_len = cache_valid.shape
        s = np.asarray(input_ids).shape[1]
        t1 = time.perf_counter()

        generator = self._generator(cfg)
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
            if t == steps - 1 or self._all_finished(finished, rows is not None):
                break
            write_index = s + t
            cache_valid[:, write_index] = ~finished
            next_logits, cache = self._decode(token, next_pos + t, cache, cache_valid,
                                              write_index)
            decode_steps += 1
        if rows is not None:
            tokens, lengths = self._gather_rows(tokens), self._gather_rows(lengths)
        self._sync()
        t2 = time.perf_counter()
        self.last_timings.update(decode_ms=(t2 - t1) * 1e3, decode_steps=decode_steps)
        self.last_lengths = lengths.cpu().numpy()
        last = max(1, int(self.last_lengths.max()))
        return tokens[:, :last].cpu().numpy()

    def _local_rows(self, batch: int) -> Optional[slice]:
        """This rank's rows of a batch under the mesh, or None when every
        rank runs every row (no mesh, one (data, fsdp) rank, or a batch
        that does not divide)."""
        index, size = dp_coordinate(self.mesh)
        if size == 1 or batch % size:
            return None
        n = batch // size
        return slice(index * n, (index + 1) * n)

    def _all_finished(self, finished: torch.Tensor, split: bool) -> bool:
        """Whether every sample has finished, on every rank when the batch
        is split (the ranks must run the same number of steps: each step's
        forward holds collectives)."""
        done = finished.all().int()
        if split:
            dist.all_reduce(done, op=dist.ReduceOp.MIN)
        return bool(done)

    def _gather_rows(self, local: torch.Tensor) -> torch.Tensor:
        """The whole batch from each (data, fsdp) rank's rows, in order (the
        ranks of one model group hold the same rows; the mesh numbers ranks
        with model innermost)."""
        parts = [torch.empty_like(local) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, local.contiguous())
        return torch.cat(parts[::axis_sizes(self.mesh)["model"]], dim=0)

    def _decode(self, token, position, cache, cache_valid, write_index: int):
        """One decode step writing slot ``write_index``; retires the slots
        that fall out of a sliding window first. Returns (next_logits, cache)."""
        window = self.model.cfg.sliding_window
        if window is not None and write_index - window >= 0:
            cache_valid[:, :write_index - window + 1] = False
        return self.model.decode_step(token[:, None], position[:, None], cache, cache_valid,
                                      write_index)

    @_serving
    def generate_stream(self, input_ids, attention_mask, position_ids, aux_features=None,
                        aux_masks=None, config: Optional[GenerationConfig] = None,
                        stopping: Optional[Callable[[np.ndarray], bool]] = None):
        """Yields the generated ids so far, int32 [B, t], after every chunk
        of ``stream_chunk`` decode steps (every step when ``stopping`` is
        given; generation ends when it returns True).

        The cache holds the prompt plus ``max_new_tokens`` rounded up to whole
        chunks, capped by ``max_len``; when the cap binds mid-chunk, the tail
        runs per token. ``last_lengths`` [B] holds each sample's generated
        length so far; once every sample has finished, the yield is trimmed
        to the longest. ``last_timings["decode_steps"]`` counts the decode
        steps run."""
        cfg = config or GenerationConfig()
        dev = self.device
        chunk = 1 if stopping is not None else max(1, int(cfg.stream_chunk))
        n_new = -(-cfg.max_new_tokens // chunk) * chunk
        next_logits, cache, cache_valid, next_pos = self._prefill(
            input_ids, attention_mask, position_ids, aux_features, aux_masks, n_new)
        b, k_len = cache_valid.shape
        s = np.asarray(input_ids).shape[1]
        timings = self.last_timings
        t_start = time.perf_counter()

        generator = self._generator(cfg)
        cols: List[np.ndarray] = []
        finished = torch.zeros(b, dtype=torch.bool, device=dev)
        lengths = np.zeros(b, dtype=np.int32)
        self.last_lengths = lengths
        t = 0

        def step(j: int) -> torch.Tensor:
            """Sample token t + j and decode it (slot s + t + j); returns its
            column, pad where the sample has finished."""
            nonlocal next_logits, cache
            token = sample_token(next_logits, generator, cfg.temperature, cfg.top_p)
            if cfg.eos_token_id is not None:
                finished.logical_or_(token == cfg.eos_token_id)
            cache_valid[:, s + t + j] = ~finished
            next_logits, cache = self._decode(token, next_pos + t + j, cache, cache_valid,
                                              s + t + j)
            timings["decode_steps"] += 1
            return torch.where(finished, cfg.pad_token_id, token)

        if chunk > 1:
            # whole chunks only: a chunk starting at t writes slots [s+t, s+t+chunk)
            while t < cfg.max_new_tokens and s + t + chunk <= k_len:
                chunk_lengths = torch.zeros(b, dtype=torch.int32, device=dev)
                tokens = []
                for j in range(chunk):
                    tokens.append(step(j))
                    chunk_lengths += (~finished).int()
                cols.append(torch.stack(tokens, 1).cpu().numpy().astype(np.int32))
                lengths = np.minimum(lengths + chunk_lengths.cpu().numpy(), cfg.max_new_tokens)
                self.last_lengths = lengths
                t += chunk
                done = bool(finished.all())
                cum = np.concatenate(cols, axis=1)[:, :cfg.max_new_tokens]
                if done:
                    cum = cum[:, :max(1, int(lengths.max()))]
                timings["decode_ms"] = (time.perf_counter() - t_start) * 1e3
                yield cum
                if done:
                    return

        while t < cfg.max_new_tokens:
            token = sample_token(next_logits, generator, cfg.temperature, cfg.top_p)
            if cfg.eos_token_id is not None:
                finished |= token == cfg.eos_token_id
            fin = finished.cpu().numpy()
            lengths = lengths + (~fin).astype(np.int32)
            self.last_lengths = lengths
            cols.append(np.where(fin, cfg.pad_token_id, token.cpu().numpy())[:, None]
                        .astype(np.int32))
            cum = np.concatenate(cols, axis=1)
            timings["decode_ms"] = (time.perf_counter() - t_start) * 1e3
            if fin.all():
                yield cum[:, :max(1, int(lengths.max()))]
                return
            yield cum
            if stopping is not None and stopping(cum):
                return
            write_index = s + t
            if write_index >= k_len:
                return
            cache_valid[:, write_index] = ~finished
            next_logits, cache = self._decode(token, next_pos + t, cache, cache_valid,
                                              write_index)
            timings["decode_steps"] += 1
            t += 1
