#!/usr/bin/env python3
"""Smoke run of the PyTorch port (cambrian_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--out results.json]

Phases, each of which must pass (a failure raises and exits non-zero):

1. the card's name and power limit (nvidia-smi), then the build of every
   kernel from the repository's sources (one nvcc per source, all started
   together, sm_90a);
2. K1, flash attention, against its plain PyTorch version on the card at the
   shapes the main path gives it (SigLIP, CLIP, DINOv2 blocks; decoder
   prefill with GQA) in bf16 and fp32, plus a causal case with padding and
   dead rows; max abs error against the fp32 plain result, CUDA-event times
   of the kernel, the plain version and ``F.scaled_dot_product_attention``
   (the library yardstick), and the bound from the case's bytes and
   operations;
3. K3, K4 and K4b/K4c, the int8 / int4 dequant-matmuls, against their plain
   versions at the seven decoder projection shapes of Cambrian-8B, at
   M = 1 (decode) and M = request 0's prompt length (prefill), bf16 and
   fp32: max abs error against the plain version on the inputs upcast to
   fp32, CUDA-event times with the L2 cache flushed before each call (as a
   decode step finds the weights) of the kernel, the plain version and
   ``torch.matmul`` on the dequantized weight, and the bound;
4. a tiny Cambrian, unquantized, int8 and int4: the kernel path on the card
   in fp32 (TF32 off) against the plain path on the CPU; greedy tokens must
   be identical and the kernels launched exactly as often as the path needs;
5. Cambrian-8B at full width (four towers, SVA, LLaMA-3-8B), bf16 weights
   and an fp32 LM head made on the card from a seed: three requests of 32
   greedy tokens through ``CambrianForInference.generate``; each must launch
   K1 exactly 27 + 23 + 40 + 32 = 122 times (decode steps use plain
   attention) and give finite logits;
6. the same model quantized on the card, layer by layer, with ``load_8bit``
   and then ``load_4bit`` semantics (the bf16 model freed first): two
   requests through ``generate``, each launching K1 122 times and its quant
   kernel 7 x 32 x 32 = 7,168 times (prefill and 31 decode steps), and one
   through ``generate_stream``, whose 4 chunks of 8 decode steps launch it
   7 x 32 x (1 + 32) = 7,392 times and whose tokens must equal
   ``generate``'s on the same prompt; with int4, one more request under
   ``CAMBRIAN_INT4_V2=1`` runs the scale-on-weights kernel 7,168 times.

Prints one JSON line of kernel results, then, as the last line, the device
record. Exits non-zero without a result when no CUDA device is present.
"""

import argparse
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
NEW_TOKENS = 32
N_REQUESTS = 3
LAUNCHES_PER_REQUEST = 27 + 23 + 40 + 32   # SigLIP, CLIP (layer -2), DINOv2, prefill
LAYERS = 32
QUANT_PER_STEP = 7 * LAYERS                 # decoder projections per forward
QUANT_LAUNCHES = QUANT_PER_STEP * NEW_TOKENS  # prefill + 31 decode steps = 7,168
STREAM_CHUNK = 8
SPIN_CYCLES = 200_000    # ~0.1 ms at the H100's clock: longer than one host launch
# the card's published peaks (H100 SXM, dense): memory rate, and the
# operation rate for the inputs' type (bf16 tensor cores, fp32 CUDA cores)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
# (site, K, N) of the decoder projections of LLaMA-3-8B
QUANT_SHAPES = [("q_proj", 4096, 4096), ("k_proj", 4096, 1024), ("v_proj", 4096, 1024),
                ("o_proj", 4096, 4096), ("gate_proj", 4096, 14336),
                ("up_proj", 4096, 14336), ("down_proj", 14336, 4096)]
QUANT_KERNELS = {
    "int8_matmul": ("cambrian_tpu/ops/quant.py:55", "int8"),
    "int4_matmul": ("cambrian_tpu/ops/quant.py:227", "int4"),
    # K4b (:190, CAMBRIAN_INT4_V2=1) and K4c (:282, CAMBRIAN_INT4_V1=1)
    "int4_matmul_scale_on_weights": ("cambrian_tpu/ops/quant.py:190", "int4"),
}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def cuda_ms(torch, fn, iters=10, flush=None):
    """Mean device time of ``fn`` over ``iters`` calls, after one warm-up.
    With ``flush``, each call is timed alone after ``flush()`` has run; a
    spin kernel then holds the stream until the host has queued the timed
    call, so that its launch cost on the host is not read as device time."""
    fn()
    torch.cuda.synchronize()
    if flush is None:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters
    events = []
    for _ in range(iters):
        flush()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def bound(n_bytes, n_ops, dtype_name):
    """Least time for the work on the card (ms) and which side bounds it:
    bytes moved once over the memory rate, operations over the peak rate
    for the inputs' type."""
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = n_ops / PEAK_OPS_PER_S[dtype_name] * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations"), \
        bytes_ms, ops_ms


def request_images(torch, towers, r):
    """Request r's per-tower pixel batches, the same in every phase."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 1 + r)
    return [torch.randn((1, 3, t.image_size, t.image_size), generator=g, device="cuda")
            for t in towers]


def all_counters(fa, quant):
    return {"flash_attention_fwd": fa.flash_attention, "int8_matmul": quant.int8_matmul,
            "int4_matmul": quant.int4_matmul,
            "int4_matmul_scale_on_weights": quant.int4_matmul_scale_on_weights}


def zero_counts(counters):
    for fn in counters.values():
        fn.launches = 0


def read_counts(counters):
    return {name: fn.launches for name, fn in counters.items()}


def build_prompts(cfg, rng):
    """Token ids with one image marker, packed as the model packs them."""
    from cambrian_tpu_torch import IMAGE_TOKEN_INDEX, prepare_multimodal_data

    prompts = []
    for r, size in enumerate([(640, 480), (480, 640), (1024, 1024)][:N_REQUESTS]):
        pre = rng.integers(0, 128000, 24 + 4 * r)
        post = rng.integers(0, 128000, 20 + 3 * r)
        ids = np.concatenate([[cfg.bos_token_id], pre, [IMAGE_TOKEN_INDEX], post])
        packed = prepare_multimodal_data(
            ids[None], ids[None].copy(), np.ones((1, len(ids)), bool), [size],
            cfg.image_token_len, cfg.mm_vision_tower_aux_token_len_list,
            len(ids) + cfg.image_block_len - 1)
        prompts.append(dict(ids=ids, size=size, mask=packed[2][0]))
    return prompts


def kernel_phase(torch, fa, prompt):
    """K1 vs plain at the main path's shapes; returns per-case records."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    s = len(prompt["mask"])
    prefill_valid = torch.zeros(s + NEW_TOKENS, dtype=torch.bool)
    prefill_valid[:s] = torch.from_numpy(prompt["mask"])
    cases = [
        # name, b, s_q, s_k, h, kvh, d, causal, key_valid, per-request launches
        ("siglip", 1, 729, 729, 16, 16, 72, False, None, 27),
        ("clip", 1, 577, 577, 16, 16, 64, False, None, 23),
        ("dinov2", 1, 730, 730, 24, 24, 64, False, None, 40),
        ("prefill_request0", 1, s, s + NEW_TOKENS, 32, 8, 128, True, prefill_valid[None], 32),
        ("prefill_640", 1, 640, 640 + NEW_TOKENS, 32, 8, 128, True,
         (torch.arange(640 + NEW_TOKENS) < 640)[None], 0),
    ]
    dead = torch.ones((2, 340), dtype=torch.bool)
    dead[0, :50] = False      # causal rows 0..49 of batch 0 see no valid key
    dead[1] = False           # batch 1 sees none at all
    cases.append(("dead_rows", 2, 300, 340, 8, 2, 128, True, dead, 0))

    g = torch.Generator(device=dev).manual_seed(SEED)
    records = []
    for name, b, s_q, s_k, h, kvh, d, causal, valid, per_req in cases:
        if valid is not None:
            valid = valid.to(dev)
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn((b, s_q, h, d), generator=g, device=dev).to(dtype)
            k = torch.randn((b, s_k, kvh, d), generator=g, device=dev).to(dtype)
            v = torch.randn((b, s_k, kvh, d), generator=g, device=dev).to(dtype)
            out = fa.flash_attention(q, k, v, valid, causal)
            torch.cuda.synchronize()
            ref = fa.flash_attention_reference(q.float(), k.float(), v.float(), valid, causal)
            err = float((out.float() - ref).abs().max())
            tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
            check(torch.isfinite(out).all().item(), f"{name} {dtype}: non-finite output")
            check(err <= tol, f"{name} {dtype}: max abs error {err} > {tol}")
            if name == "dead_rows":
                check((out[1] == 0).all().item() and (out[0, :50] == 0).all().item(),
                      "dead rows are not exactly 0")
            ms = cuda_ms(torch, lambda: fa.flash_attention(q, k, v, valid, causal))
            plain_ms = cuda_ms(torch, lambda: fa.flash_attention_reference(
                q, k, v, valid, causal))
            dtype_name = str(dtype).replace("torch.", "")
            # the (query, key) pairs this case's mask lets through
            keep = torch.ones((b, s_q, s_k), dtype=torch.bool, device=dev)
            if valid is not None:
                keep &= valid[:, None, :]
            if causal:
                keep &= torch.ones((s_q, s_k), dtype=torch.bool, device=dev).tril()
            pairs = int(keep.sum())
            n_bytes = (q.numel() + k.numel() + v.numel() + out.numel()) * q.element_size() + (
                0 if valid is None else valid.numel())
            bound_ms, bound_by, bytes_ms, ops_ms = bound(n_bytes, 4 * h * d * pairs, dtype_name)
            library_ms = None
            if per_req:
                # the library call on the same work: heads first, GQA expanded,
                # the mask dense
                qt = q.transpose(1, 2).contiguous()
                kt = k.repeat_interleave(h // kvh, 2).transpose(1, 2).contiguous()
                vt = v.repeat_interleave(h // kvh, 2).transpose(1, 2).contiguous()
                dense = None if valid is None and not causal else keep[:, None]
                library_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=dense))
            rec = dict(case=name, dtype=dtype_name, b=b, s_q=s_q,
                       s_k=s_k, h=h, kvh=kvh, d=d, causal=causal, max_abs_err=err,
                       tol=tol, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=bound_ms, bound_by=bound_by, bytes_ms=bytes_ms,
                       ops_ms=ops_ms, per_request=per_req)
            lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
            print(f"kernel {name:16s} {dtype_name:8s} Sq={s_q} Sk={s_k} H={h}/{kvh} D={d} "
                  f"err={err:.3e} kernel={ms:.4f} ms plain={plain_ms:.4f} ms sdpa={lib} "
                  f"bound={bound_ms * 1e3:.2f} us ({bound_by})", flush=True)
            records.append(rec)
    return records


def quant_kernel_phase(torch, quant, prompt_len):
    """K3, K4 and K4b/K4c against their plain versions at the 8B decoder's
    projection shapes; returns per-case records."""
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False     # plain fp32 products in fp32
    g = torch.Generator(device=dev).manual_seed(SEED)
    # evict the L2 cache (50 MB) by reading 64 MB: writing would leave dirty
    # lines whose write-back the next timed call would pay for
    l2 = torch.zeros(16 << 20, dtype=torch.float32, device=dev)
    flush = l2.sum
    records = []
    int8pack = None     # torch.ops.aten._weight_int8pack_mm, where this build runs it on CUDA
    for site, k, n in QUANT_SHAPES:
        w = (torch.randn((k, n), generator=g, device=dev) * 0.02).bfloat16()
        q8, s8 = quant.quantize_int8(w)
        q4, s4 = quant.quantize_int4(w)
        cases = {
            "int8_matmul": (quant.int8_matmul, quant.int8_matmul_reference, q8, s8,
                            quant.dequantize_int8),
            "int4_matmul": (quant.int4_matmul, quant.int4_matmul_reference, q4, s4,
                            quant.dequantize_int4),
            "int4_matmul_scale_on_weights": (
                quant.int4_matmul_scale_on_weights,
                lambda x, wq, sc: quant.int4_matmul_reference(x, wq, sc, scale_on_weights=True),
                q4, s4, quant.dequantize_int4),
        }
        for name, (fn, plain, wq, sc, dequant) in cases.items():
            for m in (1, prompt_len):
                for dtype in (torch.bfloat16, torch.float32):
                    dtype_name = str(dtype).replace("torch.", "")
                    x = torch.randn((m, k), generator=g, device=dev).to(dtype)
                    out = fn(x, wq, sc)
                    torch.cuda.synchronize()
                    ref = plain(x.float(), wq, sc)
                    err = float((out.float() - ref).abs().max())
                    # bf16: the output's rounding (2^-8 relative) plus, with the
                    # scale on the weights, their bf16 rounding; fp32: sums
                    rel = 2 ** -7 if dtype == torch.bfloat16 else 1e-5
                    tol = rel * max(1.0, float(ref.abs().max()))
                    check(torch.isfinite(out).all().item(), f"{name} {site} M={m}: non-finite")
                    check(out.shape == (m, n) and out.dtype == dtype,
                          f"{name} {site} M={m}: {tuple(out.shape)} {out.dtype}")
                    check(err <= tol, f"{name} {site} M={m} {dtype_name}: "
                          f"max abs error {err} > {tol}")
                    ms = cuda_ms(torch, lambda: fn(x, wq, sc), flush=flush)
                    plain_ms = cuda_ms(torch, lambda: plain(x, wq, sc), flush=flush)
                    w_deq = dequant(wq, sc, dtype)
                    library_ms = cuda_ms(torch, lambda: torch.matmul(x, w_deq), flush=flush)
                    del w_deq
                    int8pack_ms = None
                    if name == "int8_matmul" and dtype == torch.bfloat16:
                        if int8pack is None:
                            try:
                                torch.ops.aten._weight_int8pack_mm(x, q8.T.contiguous(),
                                                                   s8.to(dtype))
                                int8pack = True
                            except (RuntimeError, NotImplementedError) as e:
                                print(f"_weight_int8pack_mm on CUDA: none ({str(e)[:120]})",
                                      flush=True)
                                int8pack = False
                        if int8pack:
                            wt, st = q8.T.contiguous(), s8.to(dtype)
                            int8pack_ms = cuda_ms(torch, lambda: torch.ops.aten._weight_int8pack_mm(
                                x, wt, st), flush=flush)
                    n_bytes = wq.numel() + sc.numel() * 4 + (m * k + m * n) * x.element_size()
                    bound_ms, bound_by, bytes_ms, ops_ms = bound(n_bytes, 2 * m * n * k,
                                                                 dtype_name)
                    rec = dict(kernel=name, site=site, m=m, k=k, n=n, dtype=dtype_name,
                               max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                               library_ms=library_ms, library_int8pack_ms=int8pack_ms,
                               bound_ms=bound_ms, bound_by=bound_by, bytes_ms=bytes_ms,
                               ops_ms=ops_ms)
                    print(f"kernel {name:29s} {site:9s} {dtype_name:8s} M={m:<4d} K={k:<5d} "
                          f"N={n:<5d} err={err:.3e} kernel={ms:.4f} ms plain={plain_ms:.4f} ms "
                          f"matmul={library_ms:.4f} ms"
                          + ("" if int8pack_ms is None else f" int8pack={int8pack_ms:.4f} ms")
                          + f" bound={bound_ms * 1e3:.2f} us ({bound_by})", flush=True)
                    records.append(rec)
        del q8, s8, q4, s4, w
    del l2
    return records


def request_sum(records, key, kernel, prompt_len):
    """One 8B request's worth of a quant kernel's ``key`` (bf16): each
    projection once per layer at the prompt length and 31 times at M = 1."""
    total = 0.0
    for r in records:
        if r["kernel"] == kernel and r["dtype"] == "bfloat16" and r[key] is not None:
            total += LAYERS * r[key] * (1 if r["m"] == prompt_len else NEW_TOKENS - 1)
    return total


def tiny_slice_phase(torch, fa, quant, rng, quantize=None):
    """Kernel path on the card (fp32, TF32 off) against plain on the CPU."""
    from cambrian_tpu_torch import IMAGE_TOKEN_INDEX, tiny_debug
    from cambrian_tpu_torch.models.builder import CambrianForInference, random_state_dict

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = tiny_debug(num_towers=2).replace(tokenizer_model_max_length=192, quantize=quantize)
    sd = random_state_dict(cfg, torch.Generator().manual_seed(SEED), 0.05,
                           dtype=torch.float32, device="cpu")
    cpu = CambrianForInference.from_state_dict(cfg, sd, torch.float32,
                                               cache_dtype=torch.float32)
    gpu = CambrianForInference.from_state_dict(
        cfg, {k: v.cuda() for k, v in sd.items()}, torch.float32, cache_dtype=torch.float32)
    ids = rng.integers(5, cfg.vocab_size, 140)
    ids[cfg.image_position] = IMAGE_TOKEN_INDEX
    images = [rng.standard_normal((1, 3, t.image_size, t.image_size)).astype(np.float32)
              for t in cpu.towers]
    kw = dict(images=images, image_sizes=[(640, 360)], max_new_tokens=8, eos_token_id=None)
    want = cpu.generate(ids, **kw)
    counters = all_counters(fa, quant)
    zero_counts(counters)
    got = gpu.generate(ids, **kw)
    counts = read_counts(counters)
    steps = gpu.engine.last_timings["decode_steps"]
    logit_err = float((gpu.engine.last_next_logits.cpu() - cpu.engine.last_next_logits)
                      .abs().max())
    label = quantize or "fp32"
    print(f"tiny slice ({label}): cpu tokens {want.tolist()} gpu tokens {got.tolist()} "
          f"launches {counts} first-token logits max abs diff {logit_err:.3e}", flush=True)
    check(got.shape == (1, 8) and (got == want).all(), f"tiny slice ({label}) tokens differ")
    expected = {name: 0 for name in counters}
    expected["flash_attention_fwd"] = (sum(t.config.num_blocks_to_run for t in gpu.towers)
                                       + cfg.num_hidden_layers)
    if quantize:
        expected[f"{quantize}_matmul"] = 7 * cfg.num_hidden_layers * (1 + steps)
    check(counts == expected, f"tiny slice ({label}) launched {counts}, not {expected}")
    check(logit_err < 1e-3, f"tiny slice ({label}) logits differ by {logit_err}")
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    return dict(tokens=got.tolist(), launches=counts, logit_err=logit_err)


def serve_request(torch, model, counters, cfg, r, pr, stream=False):
    """One request through ``generate`` (or ``generate_stream``) with its
    checks; returns its record and the kernel launches it made."""
    images = request_images(torch, model.towers, r)
    before = read_counts(counters)
    t0 = time.perf_counter()
    kw = dict(images=images, image_sizes=[pr["size"]], max_new_tokens=NEW_TOKENS,
              eos_token_id=None)
    if stream:
        yields = 0
        for out in model.generate_stream(pr["ids"], stream_chunk=STREAM_CHUNK, **kw):
            yields += 1
        check(yields == NEW_TOKENS // STREAM_CHUNK, f"stream request {r}: {yields} yields")
    else:
        out = model.generate(pr["ids"], **kw)
    wall_ms = (time.perf_counter() - t0) * 1e3
    after = read_counts(counters)
    delta = {k: after[k] - before[k] for k in after}
    tm = dict(model.engine.last_timings)
    logits = model.engine.last_next_logits
    label = f"{'stream ' if stream else ''}request {r}"
    check(out.shape == (1, NEW_TOKENS), f"{label}: output shape {out.shape}")
    check(((out >= 0) & (out < cfg.vocab_size)).all(), f"{label}: token out of range")
    check(tuple(logits.shape) == (1, cfg.vocab_size) and logits.dtype == torch.float32,
          f"{label}: logits {tuple(logits.shape)} {logits.dtype}")
    check(torch.isfinite(logits).all().item(), f"{label}: non-finite logits")
    check(delta["flash_attention_fwd"] == LAUNCHES_PER_REQUEST,
          f"{label}: K1 launched {delta['flash_attention_fwd']}x, not {LAUNCHES_PER_REQUEST}x")
    tok_s = tm["decode_steps"] / tm["decode_ms"] * 1e3
    rec = dict(request=r, stream=stream, prompt_slots=len(pr["mask"]), image_size=pr["size"],
               encode_ms=tm["encode_ms"], prefill_ms=tm["prefill_ms"],
               decode_ms=tm["decode_ms"], decode_steps=tm["decode_steps"],
               decode_tokens_per_s=tok_s, wall_ms=wall_ms, launches=delta,
               tokens=out[0].tolist())
    print(f"{label}: slots={rec['prompt_slots']} encode={tm['encode_ms']:.1f} ms "
          f"prefill={tm['prefill_ms']:.1f} ms decode={tok_s:.2f} tok/s "
          f"({tm['decode_steps']} steps in {tm['decode_ms']:.1f} ms) "
          f"launches={ {k: v for k, v in delta.items() if v} }", flush=True)
    return rec


def full_width_phase(torch, fa, quant, prompts, quantize=None):
    """Cambrian-8B through the user entry points, bf16 or quantized."""
    from cambrian_tpu_torch import cambrian_8b
    from cambrian_tpu_torch.models.builder import CambrianForInference, random_state_dict

    dev = torch.device("cuda")
    cfg = cambrian_8b().replace(quantize=quantize)
    label = quantize or "bf16"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(SEED)
    sd = random_state_dict(cfg, g, 0.02, dtype=torch.bfloat16, device=dev)
    model = CambrianForInference.from_state_dict(cfg, sd, torch.bfloat16)
    del sd
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.lm.parameters()) + sum(
        p.numel() for t in model.towers for p in t.parameters())
    weight_bytes = sum(t.numel() * t.element_size() for m in [model.lm, *model.towers]
                       for t in [*m.parameters(), *m.buffers()])
    print(f"8B {label} build: {n_params / 1e9:.3f}B float parameters, "
          f"{weight_bytes / 1e9:.2f} GB of weights in {time.perf_counter() - t0:.1f} s",
          flush=True)

    counters = all_counters(fa, quant)
    requests = []
    zero_counts(counters)                    # the main path's count starts here
    if quantize is None:
        for r, pr in enumerate(prompts):
            requests.append(serve_request(torch, model, counters, cfg, r, pr))
    else:
        kernel = f"{quantize}_matmul"
        for r, pr in enumerate(prompts[:2]):
            rec = serve_request(torch, model, counters, cfg, r, pr)
            check(rec["launches"][kernel] == QUANT_LAUNCHES,
                  f"{label} request {r}: {kernel} launched {rec['launches'][kernel]}x, "
                  f"not {QUANT_LAUNCHES}x")
            requests.append(rec)
        rec = serve_request(torch, model, counters, cfg, 0, prompts[0], stream=True)
        want = QUANT_PER_STEP * (1 + rec["decode_steps"])
        check(rec["decode_steps"] == NEW_TOKENS, f"{label} stream: {rec['decode_steps']} steps")
        check(rec["launches"][kernel] == want,
              f"{label} stream: {kernel} launched {rec['launches'][kernel]}x, not {want}x")
        check(rec["tokens"] == requests[0]["tokens"],
              f"{label} stream tokens differ from generate's on the same prompt")
        requests.append(rec)
        if quantize == "int4":
            os.environ["CAMBRIAN_INT4_V2"] = "1"
            try:
                rec = serve_request(torch, model, counters, cfg, 1, prompts[1])
            finally:
                del os.environ["CAMBRIAN_INT4_V2"]
            got = (rec["launches"]["int4_matmul_scale_on_weights"], rec["launches"]["int4_matmul"])
            check(got == (QUANT_LAUNCHES, 0),
                  f"int4 scale-on-weights request: launches {got}, not ({QUANT_LAUNCHES}, 0)")
            rec["scale_on_weights"] = True
            requests.append(rec)
    launches = read_counts(counters)
    peak = torch.cuda.max_memory_allocated()
    print(f"8B {label} peak memory allocated: {peak / 2**30:.2f} GiB ({peak / 1e9:.2f} GB)",
          flush=True)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return dict(requests=requests, launches=launches, n_params=n_params,
                weight_bytes=weight_bytes, peak_bytes=peak)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", help="also write every measurement to this JSON file")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from cambrian_tpu_torch import cambrian_8b
    from cambrian_tpu_torch.ops import cuda_build, quant
    from cambrian_tpu_torch.ops import flash_attention as fa

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    built = cuda_build.build("flash_attention", "quant_matmul")
    print(f"kernel build: {time.perf_counter() - t0:.2f} s in all", flush=True)
    for name, b in built.items():
        print(f"{name}: {b['seconds']:.2f} s -> {b['path']}", flush=True)
        # ptxas: registers, shared memory and spills of each kernel
        for line in b["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(line.strip(), flush=True)

    rng = np.random.default_rng(SEED)
    prompts = build_prompts(cambrian_8b(), rng)
    prompt_len = len(prompts[0]["mask"])
    kernels = kernel_phase(torch, fa, prompts[0])
    quant_kernels = quant_kernel_phase(torch, quant, prompt_len)
    tiny = {q or "fp32": tiny_slice_phase(torch, fa, quant, rng, q)
            for q in (None, "int8", "int4")}
    full = {q or "bf16": full_width_phase(torch, fa, quant, prompts, q)
            for q in (None, "int8", "int4")}

    # launches: each 8B path's counts, read just after it, summed over paths
    launches = {name: sum(f["launches"][name] for f in full.values())
                for name in all_counters(fa, quant)}
    path = [k for k in kernels if k["per_request"] and k["dtype"] == "bfloat16"]
    # one request's worth of launches at the path's shapes, bf16
    k1_bytes_ms = sum(k["per_request"] * k["bytes_ms"] for k in path)
    k1_ops_ms = sum(k["per_request"] * k["ops_ms"] for k in path)
    rows = [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "cambrian_tpu_torch/csrc/flash_attention.cu",
        "replaces": "cambrian_tpu/ops/flash_attention.py:36",
        "launches": launches["flash_attention_fwd"],
        "max_abs_err": max(k["max_abs_err"] for k in path),
        "ms": sum(k["ms"] * k["per_request"] for k in path),
        "plain_ms": sum(k["plain_ms"] * k["per_request"] for k in path),
        "bound_ms": sum(k["bound_ms"] * k["per_request"] for k in path),
        "bound_by": "bytes" if k1_bytes_ms >= k1_ops_ms else "operations",
        "library_ms": sum(k["library_ms"] * k["per_request"] for k in path),
    }]
    k1 = rows[0]
    print(f"flash_attention_fwd: per request kernel {k1['ms']:.3f} ms, plain "
          f"{k1['plain_ms']:.3f} ms, sdpa {k1['library_ms']:.3f} ms, bound "
          f"{k1['bound_ms']:.4f} ms ({k1['bound_by']})", flush=True)
    for name, (replaces, _) in QUANT_KERNELS.items():
        recs = [r for r in quant_kernels if r["kernel"] == name and r["dtype"] == "bfloat16"]
        bytes_ms = request_sum(recs, "bytes_ms", name, prompt_len)
        ops_ms = request_sum(recs, "ops_ms", name, prompt_len)
        rows.append({
            "name": name,
            "route": "cuda",
            "source": "cambrian_tpu_torch/csrc/quant_matmul.cu",
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": request_sum(recs, "ms", name, prompt_len),
            "plain_ms": request_sum(recs, "plain_ms", name, prompt_len),
            "bound_ms": request_sum(recs, "bound_ms", name, prompt_len),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": request_sum(recs, "library_ms", name, prompt_len),
        })
        for label, m in (("decode step", 1), ("prefill", prompt_len)):
            # the 7 x 32 projections of one decoder forward at this M
            per = {key: LAYERS * sum(r[key] or 0.0 for r in recs if r["m"] == m)
                   for key in ("ms", "plain_ms", "library_ms", "library_int8pack_ms",
                               "bound_ms")}
            int8pack = (f" int8pack {per['library_int8pack_ms']:.3f} ms"
                        if per["library_int8pack_ms"] else "")
            print(f"{name}: decoder GEMMs per {label}: kernel {per['ms']:.3f} ms, "
                  f"plain {per['plain_ms']:.3f} ms, matmul {per['library_ms']:.3f} ms"
                  f"{int8pack}, bound {per['bound_ms']:.3f} ms", flush=True)
        print(f"{name}: per request {rows[-1]['ms']:.1f} ms (bound "
              f"{rows[-1]['bound_ms']:.2f} ms, matmul {rows[-1]['library_ms']:.1f} ms)",
              flush=True)
    summary = {"kernels": rows}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=smi, build={k: v["seconds"] for k, v in built.items()},
                           kernels=kernels, quant_kernels=quant_kernels, tiny=tiny, full=full,
                           summary=summary), f, indent=1)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
