"""The serving cells: requests through the worker's continuous path
(``CambrianForInference._prepare_generate`` -> ``ContinuousBatchingEngine.
submit`` -> ``step_chunk``), without HTTP or a tokenizer, driven from one
loop that submits requests at chunk boundaries, as the worker's stepper
thread admits them.

The traffic (``kind`` ``closed``) is an offline batch: at least
``queue_depth`` requests wait at all times; the window is a whole number of
chunks, closing at the first chunk boundary ``--seconds`` after it opened,
and its rate is every token read on the host in it over its length.

The seed draws the token ids and the pixels only. Prompt lengths and
output budgets are the traffic file's fixed cycles, used in order; EOS is
ignored (``eos_token_id=None``), so each request emits exactly its budget.
"""

import gc
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from . import clocks, program, weights


def request_shape(traffic: Dict, n: int) -> Dict:
    """Request n's question length and output budget: each its own fixed
    cycle, used in order."""
    q = traffic["question_tokens"]
    b = traffic["budgets"]
    return {"question": q[n % len(q)], "budget": b[n % len(b)]}


def request_inputs(cfg_file: Dict, traffic: Dict, seed: int, n: int, device) -> Dict:
    """Request n's prompt ids (a prefix of ``image_position`` tokens, the
    image marker, the question) and one square image a tower, from the
    seed: ids from numpy, pixels from a generator on the device."""
    shape = request_shape(traffic, n)
    lo, hi = cfg_file["token_ids"]
    rng = np.random.default_rng([int(seed), n])
    prefix = rng.integers(lo, hi, cfg_file["model"]["image_position"])
    prefix[0] = cfg_file["model"]["bos_token_id"]
    question = rng.integers(lo, hi, shape["question"])
    ids = np.concatenate([prefix, [cfg_file["image_marker"]], question]).astype(np.int64)
    gen = torch.Generator(device=device).manual_seed(weights.group_seed(seed, f"pixels/{n}"))
    pixels = [torch.randn((1, 3, t["image_size"], t["image_size"]), generator=gen,
                          device=device) for t in cfg_file["towers"]]
    return {"n": n, "ids": ids, "pixels": pixels, **shape}


class Server:
    """The program, its engine and the requests it has taken."""

    def __init__(self, cfg_file: Dict, traffic: Dict, seed: int, device, quantize="config"):
        from cambrian_tpu_torch.infer.continuous import ContinuousBatchingEngine

        self.cfg_file, self.traffic, self.seed, self.device = cfg_file, traffic, seed, device
        t0 = time.perf_counter()
        self.model = program.build(cfg_file, seed, device, quantize)
        _sync(device)
        print(f"model built in {time.perf_counter() - t0:.3f} s", file=sys.stderr, flush=True)
        self.engine = ContinuousBatchingEngine(self.model.lm, num_slots=traffic["slots"],
                                               max_len=traffic["max_len"], device=device)
        self.spans = program.serving_spans(self.model, self.engine)
        self.requests: Dict[int, Dict] = {}
        self.waiting: List[Dict] = []
        self.next_n = 0

    def submit(self) -> Dict:
        """Encode and submit the next request of the traffic's order."""
        n = self.next_n
        self.next_n += 1
        r = request_inputs(self.cfg_file, self.traffic, self.seed, n, self.device)
        side = self.cfg_file["towers"][0]["image_size"]
        r["submitted"] = time.perf_counter()
        pids, pmask, ppos, feats, masks, gen_cfg, _ = self.model._prepare_generate(
            r["ids"], images=r["pixels"], image_sizes=[(side, side)],
            max_new_tokens=r["budget"], eos_token_id=None)
        r["req"] = self.engine.submit(pids[0], pmask[0], ppos[0], feats, masks, gen_cfg)
        self.requests[n] = r
        self.waiting.append(r)
        return r

    def step(self) -> None:
        """One chunk of the engine. A request's tower features are dropped
        once it is admitted, as the worker's request thread drops them when
        its stream ends."""
        self.engine.step_chunk(self.traffic["chunk"])
        taken = [s for s in self.engine.slot_request if s is not None]
        still = []
        for r in self.waiting:
            if r["req"].finished or any(s is r["req"] for s in taken):
                r["req"].aux_features = None
            else:
                still.append(r)
        self.waiting = still

    def tokens(self) -> int:
        return sum(len(r["req"].tokens) for r in self.requests.values())

    def free(self) -> None:
        for r in self.requests.values():
            r["req"].aux_features = None
        del self.model, self.engine
        self.spans = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_closed(srv: Server, seconds: float, trace_fn) -> Dict:
    """The offline batch: returns the window's tokens and length, the
    requests that finished in it and those still in a slot at its close.
    The card's clocks and the host's gc pauses are logged a chunk."""
    t = srv.traffic
    depth = t["queue_depth"]
    for _ in range(t["slots"] + depth):
        srv.submit()
    watch = clocks.Watch(srv.device)
    with watch:
        for _ in range(t["warmup_chunks"]):
            srv.step()
            while srv.engine._pending.qsize() < depth:
                srv.submit()
        _sync(srv.device)
        done_before = {n for n, r in srv.requests.items() if r["req"].finished}
        tokens0, t0 = srv.tokens(), watch.mark()
        chunks = 0
        tracer = trace_fn()
        marks = [t0]
        while True:
            tracer.step(chunks)
            srv.step()
            while srv.engine._pending.qsize() < depth:
                srv.submit()
            chunks += 1
            marks.append(watch.mark())
            if marks[-1] - t0 - tracer.stall >= seconds:
                break
    elapsed = marks[-1] - t0 - tracer.stall
    print(f"window: {chunks} chunks in {elapsed:.3f} s", file=sys.stderr)
    watch.report(marks, "chunk")
    tracer.step(None)
    finished = [n for n, r in srv.requests.items()
                if r["req"].finished and n not in done_before]
    active = [n for n, r in srv.requests.items() if not r["req"].finished
              and any(s is r["req"] for s in srv.engine.slot_request)]
    return {"tokens": srv.tokens() - tokens0, "seconds": elapsed, "chunks": chunks, "t0": t0,
            "finished": finished, "active": active, "attempted": len(finished) + len(active),
            "failed": sum(1 for n in finished
                          if len(srv.requests[n]["req"].tokens) != srv.requests[n]["budget"])}
