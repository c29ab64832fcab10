"""Continuous-batching inference engine (cambrian_tpu/infer/continuous.py).

Requests occupy slots of one shared KV cache: a new request prefills into its
slot while the other slots keep decoding, and every decode step advances all
the slots in one forward, each writing its own cache row (``decode_step``
with a vector ``cache_index``). Vision features matter only during prefill
(the in-decoder SVA injection runs on the prompt's latent window), so a slot
carries no vision state afterwards.

- The cache is per-layer (k, v) [num_slots, max_len, kv_heads, head_dim] in
  ``cache_dtype``, with ``cache_valid`` [num_slots, max_len] and
  ``next_logits`` [num_slots, V] fp32, all on the model's device.
- Admission prefills straight into the slot's row of the cache, a view of
  ``max_len`` rows, so LongRoPE takes the factors the JAX engine's
  ``max_len`` scratch cache gives. Rows past the prompt keep the last
  occupant's values; ``cache_valid`` masks them off.
- ``step_chunk(n)`` queues n lockstep decode steps with every slot's
  sampling settings, budget and EOS on the device, and reads the tokens once,
  after the chunk: no host sync inside it. ``step()`` is the per-token path.
- Every public method runs under ``torch.inference_mode()`` itself: the
  serving worker drives the engine from a thread of its own, where grad mode
  is on by default.
- As in the JAX engine, no cache slot is retired for falling outside a
  sliding window: a windowed model's decode attends its whole cache row.
"""

import queue
import threading
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..models.cambrian import CambrianLM
from ..models.language.llama import init_kv_cache, write_cache_rows
from .engine import GenerationConfig, sample_token, sample_token_per_slot


@dataclass
class Request:
    request_id: int
    input_ids: np.ndarray          # [S] packed prompt
    attention_mask: np.ndarray     # [S]
    position_ids: np.ndarray       # [S]
    aux_features: Optional[Sequence] = None
    aux_masks: Optional[Sequence] = None
    config: GenerationConfig = field(default_factory=GenerationConfig)
    # outputs
    tokens: List[int] = field(default_factory=list)
    finished: bool = False
    on_token: Optional[Callable[[int], None]] = None


def _model_device(model: CambrianLM, device) -> torch.device:
    """The engine's device: the model's, and ``device`` must name it. A CUDA
    device without a card raises: nothing falls back to the CPU."""
    own = model.image_newline.device
    if device is None:
        return own
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"no CUDA device for the engine on {dev}")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    if dev != own:
        raise ValueError(f"the engine on {dev}, the model on {own}")
    return dev


class ContinuousBatchingEngine:
    @torch.inference_mode()
    def __init__(self, model: CambrianLM, num_slots: int = 4, max_len: int = 4096,
                 cache_dtype=torch.bfloat16, device=None):
        self.model = model
        self.num_slots = num_slots
        self.max_len = max_len
        self.cache_dtype = cache_dtype
        self.device = dev = _model_device(model, device)

        self.cache = init_kv_cache(model.cfg, num_slots, max_len, cache_dtype, dev)
        self.cache_valid = torch.zeros((num_slots, max_len), dtype=torch.bool, device=dev)
        self.next_logits = torch.zeros((num_slots, model.cfg.vocab_size), dtype=torch.float32,
                                       device=dev)
        self.slot_request: List[Optional[Request]] = [None] * num_slots
        self.slot_pos = np.zeros(num_slots, np.int64)     # next position id
        self.slot_len = np.zeros(num_slots, np.int64)     # next cache index
        self._generator = torch.Generator(device=dev).manual_seed(0)
        self._pending: "queue.Queue[Request]" = queue.Queue()
        self._next_id = 0
        self._lock = threading.Lock()

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        # from host memory, without waiting for the work queued on the stream
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device, non_blocking=True)

    # -- public API -----------------------------------------------------------

    def submit(self, input_ids, attention_mask, position_ids, aux_features=None,
               aux_masks=None, config: Optional[GenerationConfig] = None,
               on_token=None) -> Request:
        with self._lock:
            req = Request(self._next_id, np.asarray(input_ids), np.asarray(attention_mask),
                          np.asarray(position_ids), aux_features, aux_masks,
                          config or GenerationConfig(), on_token=on_token)
            self._next_id += 1
        self._pending.put(req)
        return req

    def _free_slots(self):
        return [i for i, r in enumerate(self.slot_request) if r is None]

    def _admit(self):
        """Prefill pending requests into free slots."""
        dev = self.device
        for slot in self._free_slots():
            try:
                req = self._pending.get_nowait()
            except queue.Empty:
                return
            ids = np.atleast_2d(req.input_ids)
            amask = np.atleast_2d(req.attention_mask)
            pos = np.atleast_2d(req.position_ids)
            s = ids.shape[1]
            mask = self._to_device(amask.astype(bool))
            feats = aux_masks = None
            if req.aux_features is not None:
                feats = [torch.as_tensor(f).to(dev) for f in req.aux_features]
            if req.aux_masks is not None:
                aux_masks = [self._to_device(np.asarray(m, dtype=bool)) for m in req.aux_masks]
            slot_cache = tuple((k[slot:slot + 1], v[slot:slot + 1]) for k, v in self.cache)
            logits, _ = self.model.prefill(self._to_device(ids.astype(np.int64)), mask,
                                           self._to_device(pos.astype(np.int64)), slot_cache,
                                           feats, aux_masks)

            last_idx = int((amask[0].astype(bool) * np.arange(s)).max())
            self.next_logits[slot] = logits[0, last_idx]
            self.cache_valid[slot] = False
            self.cache_valid[slot, :s] = mask[0]
            self.slot_request[slot] = req
            self.slot_len[slot] = s
            self.slot_pos[slot] = int(pos[0].max()) + 1

    def _retire(self, slot: int):
        self.slot_request[slot] = None
        self.cache_valid[slot] = False

    def _decode_chunk(self, chunk: int, positions, write_index, active, remaining, temps,
                      top_ps, eos_ids) -> torch.Tensor:
        """``chunk`` lockstep decode steps of every slot, each slot with its
        own sampling settings, budget and EOS, queued with no host sync.
        Returns the tokens [num_slots, chunk], -1 where a slot was inactive
        (or had finished earlier in the chunk); inactive slots are fed token
        0 and their writes past the cache are dropped."""
        toks = torch.full((self.num_slots, chunk), -1, dtype=torch.long, device=self.device)
        for j in range(chunk):
            token = sample_token_per_slot(self.next_logits, self._generator, temps, top_ps)
            toks[:, j] = torch.where(active, token, -1)
            hit_eos = (eos_ids >= 0) & (token == eos_ids)
            remaining = torch.where(active, remaining - 1, remaining)
            new_active = active & ~hit_eos & (remaining > 0)
            wi = write_index + j
            write_cache_rows(self.cache_valid, active, wi)
            feed = torch.where(active, token, 0)
            logits, _ = self.model.decode_step(feed[:, None], (positions + j)[:, None],
                                               self.cache, self.cache_valid, wi)
            self.next_logits = torch.where(active[:, None], logits, self.next_logits)
            active = new_active
        return toks

    @torch.inference_mode()
    def step_chunk(self, chunk: int) -> int:
        """Admit pending work and advance every active slot up to ``chunk``
        tokens in one queue of device work. New requests are admitted at
        chunk boundaries. Returns the number of active slots afterwards."""
        self._admit()
        active_idx = [i for i, r in enumerate(self.slot_request) if r is not None]
        if not active_idx:
            return 0
        chunk_eff = max(1, int(chunk))
        if chunk_eff == 1:
            return self.step()

        s = self.num_slots
        active = np.zeros(s, bool)
        remaining = np.zeros(s, np.int64)
        temps = np.ones(s, np.float32)
        top_ps = np.ones(s, np.float32)
        eos_ids = np.full(s, -1, np.int64)
        for i in active_idx:
            req = self.slot_request[i]
            active[i] = True
            # per-slot budget: generation budget AND remaining cache capacity.
            # A nearly-full slot caps only itself (it goes inactive mid-chunk
            # and is retired below); its writes after that fall past the
            # cache and are dropped, never clamped into live rows.
            remaining[i] = min(req.config.max_new_tokens - len(req.tokens),
                               self.max_len - int(self.slot_len[i]))
            temps[i] = req.config.temperature
            top_ps[i] = req.config.top_p
            if req.config.eos_token_id is not None:
                eos_ids[i] = req.config.eos_token_id

        toks = self._decode_chunk(
            chunk_eff, self._to_device(self.slot_pos), self._to_device(self.slot_len),
            self._to_device(active), self._to_device(remaining), self._to_device(temps),
            self._to_device(top_ps), self._to_device(eos_ids))

        toks_np = toks.cpu().numpy()     # the chunk's one read
        n_active = 0
        for i in active_idx:
            req = self.slot_request[i]
            emitted = 0
            done = False
            for j in range(chunk_eff):
                tok = int(toks_np[i, j])
                if tok < 0:
                    break
                emitted += 1
                req.tokens.append(tok)
                if req.on_token:
                    req.on_token(tok)
                eos = req.config.eos_token_id
                if (eos is not None and tok == eos) or \
                        len(req.tokens) >= req.config.max_new_tokens:
                    done = True
                    break
            self.slot_len[i] += emitted
            self.slot_pos[i] += emitted
            if done or int(self.slot_len[i]) >= self.max_len:
                req.finished = True
                self._retire(i)
            else:
                n_active += 1
        return n_active

    @torch.inference_mode()
    def step(self) -> int:
        """Admit pending work and advance every active slot one token.
        Returns the number of active slots after the step."""
        self._admit()
        active = [i for i, r in enumerate(self.slot_request) if r is not None]
        if not active:
            return 0

        # each slot samples from its own logits; mixed temperatures sample per
        # group (rare; the loop is cheap)
        temps = {self.slot_request[i].config.temperature for i in active}
        tokens = np.zeros(self.num_slots, np.int64)
        for t in temps:
            idx = [i for i in active if self.slot_request[i].config.temperature == t]
            toks = sample_token(self.next_logits[idx], self._generator, t,
                                self.slot_request[idx[0]].config.top_p)
            tokens[idx] = toks.cpu().numpy()

        write_index = self.slot_len.copy()
        positions = self.slot_pos.copy()

        # record tokens + finish bookkeeping on host
        still_active = []
        for i in active:
            req = self.slot_request[i]
            tok = int(tokens[i])
            req.tokens.append(tok)
            if req.on_token:
                req.on_token(tok)
            eos = req.config.eos_token_id
            done = (eos is not None and tok == eos) or \
                len(req.tokens) >= req.config.max_new_tokens or \
                int(write_index[i]) + 1 >= self.max_len
            if done:
                req.finished = True
                self._retire(i)
            else:
                still_active.append(i)

        if not still_active:
            return 0

        # mark the new tokens' slots valid and decode all slots
        for i in still_active:
            self.cache_valid[i, int(write_index[i])] = True
        logits, _ = self.model.decode_step(
            self._to_device(tokens[:, None]), self._to_device(positions[:, None]), self.cache,
            self.cache_valid, self._to_device(write_index))
        for i in still_active:
            self.next_logits[i] = logits[i]
            self.slot_len[i] += 1
            self.slot_pos[i] += 1
        return len(still_active)

    @torch.inference_mode()
    def run_until_complete(self, requests: Sequence[Request], chunk: int = 1):
        """Drive steps until the given requests all finish; ``chunk`` > 1
        advances every slot that many tokens a step. Returns each request's
        tokens, int32."""
        while not all(r.finished for r in requests):
            if chunk > 1:
                self.step_chunk(chunk)
            else:
                self.step()
        return [np.asarray(r.tokens, dtype=np.int32) for r in requests]
