#!/usr/bin/env python3
"""Smoke run of the PyTorch port (cambrian_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--out results.json]

Phases, each of which must pass (a failure raises and exits non-zero):

1. the card's name and power limit (nvidia-smi), then the flash-attention
   kernel build from the repository's sources (nvcc, sm_90a);
2. kernel against its plain PyTorch version on the card at the shapes the
   main path gives it (SigLIP, CLIP, DINOv2 blocks; decoder prefill with GQA)
   in bf16 and fp32, plus a causal case with padding and dead rows; max abs
   error against the fp32 plain result, and CUDA-event times of both;
3. a tiny Cambrian: the kernel path on the card in fp32 (TF32 off) against
   the plain path on the CPU; greedy tokens must be identical;
4. Cambrian-8B at full width (four towers, SVA, LLaMA-3-8B), bf16 weights
   and an fp32 LM head made on the card from a seed: three requests of 32
   greedy tokens through ``CambrianForInference.generate``; each must launch
   the kernel exactly 27 + 23 + 40 + 32 = 122 times (decode steps use plain
   attention) and give finite logits.

Prints one JSON line of kernel results, then, as the last line, the device
record. Exits non-zero without a result when no CUDA device is present.
"""

import argparse
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


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def cuda_ms(torch, fn, iters=10):
    """Mean device time of ``fn`` over ``iters`` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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
    """Kernel vs plain at the main path's shapes; returns per-case records."""
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
            rec = dict(case=name, dtype=str(dtype).replace("torch.", ""), b=b, s_q=s_q,
                       s_k=s_k, h=h, kvh=kvh, d=d, causal=causal, max_abs_err=err,
                       tol=tol, ms=ms, plain_ms=plain_ms, per_request=per_req)
            print(f"kernel {name:16s} {rec['dtype']:8s} Sq={s_q} Sk={s_k} H={h}/{kvh} D={d} "
                  f"err={err:.3e} kernel={ms:.4f} ms plain={plain_ms:.4f} ms", flush=True)
            records.append(rec)
    return records


def tiny_slice_phase(torch, fa, rng):
    """Kernel path on the card (fp32, TF32 off) against plain on the CPU."""
    from cambrian_tpu_torch import IMAGE_TOKEN_INDEX, tiny_debug
    from cambrian_tpu_torch.models.builder import CambrianForInference, random_state_dict

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = tiny_debug(num_towers=2).replace(tokenizer_model_max_length=192)
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
    fa.flash_attention.launches = 0
    got = gpu.generate(ids, **kw)
    launches = fa.flash_attention.launches
    logit_err = float((gpu.engine.last_next_logits.cpu() - cpu.engine.last_next_logits)
                      .abs().max())
    print(f"tiny slice: cpu tokens {want.tolist()} gpu tokens {got.tolist()} "
          f"launches {launches} first-token logits max abs diff {logit_err:.3e}", flush=True)
    check(got.shape == (1, 8) and (got == want).all(), "tiny slice greedy tokens differ")
    expected = sum(t.config.num_blocks_to_run for t in gpu.towers) + cfg.num_hidden_layers
    check(launches == expected, f"tiny slice launched the kernel {launches}x, not {expected}x")
    check(logit_err < 1e-3, f"tiny slice logits differ by {logit_err}")
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    return dict(tokens=got.tolist(), launches=launches, logit_err=logit_err)


def full_width_phase(torch, fa, prompts):
    """Cambrian-8B, three requests through the user entry point."""
    from cambrian_tpu_torch import cambrian_8b
    from cambrian_tpu_torch.models.builder import CambrianForInference, random_state_dict

    dev = torch.device("cuda")
    cfg = cambrian_8b()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(SEED)
    sd = random_state_dict(cfg, g, 0.02, dtype=torch.bfloat16, device=dev)
    model = CambrianForInference.from_state_dict(cfg, sd, torch.bfloat16)
    del sd
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.lm.parameters()) + sum(
        p.numel() for t in model.towers for p in t.parameters())
    print(f"8B build: {n_params / 1e9:.3f}B parameters in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    requests = []
    fa.flash_attention.launches = 0          # the main path's count starts here
    for r, pr in enumerate(prompts):
        images = [torch.randn((1, 3, t.image_size, t.image_size), generator=g, device=dev)
                  for t in model.towers]
        before = fa.flash_attention.launches
        t0 = time.perf_counter()
        out = model.generate(pr["ids"], images=images, image_sizes=[pr["size"]],
                             max_new_tokens=NEW_TOKENS, eos_token_id=None)
        wall_ms = (time.perf_counter() - t0) * 1e3
        delta = fa.flash_attention.launches - before
        tm = dict(model.engine.last_timings)
        logits = model.engine.last_next_logits
        check(out.shape == (1, NEW_TOKENS), f"request {r}: output shape {out.shape}")
        check(((out >= 0) & (out < cfg.vocab_size)).all(), f"request {r}: token out of range")
        check(tuple(logits.shape) == (1, cfg.vocab_size) and logits.dtype == torch.float32,
              f"request {r}: logits {tuple(logits.shape)} {logits.dtype}")
        check(torch.isfinite(logits).all().item(), f"request {r}: non-finite logits")
        check(delta == LAUNCHES_PER_REQUEST,
              f"request {r}: kernel launched {delta}x, not {LAUNCHES_PER_REQUEST}x")
        tok_s = tm["decode_steps"] / tm["decode_ms"] * 1e3
        rec = dict(request=r, prompt_slots=len(pr["mask"]), image_size=pr["size"],
                   encode_ms=tm["encode_ms"], prefill_ms=tm["prefill_ms"],
                   decode_ms=tm["decode_ms"], decode_steps=tm["decode_steps"],
                   decode_tokens_per_s=tok_s, wall_ms=wall_ms, launches=delta,
                   tokens=out[0, :8].tolist())
        print(f"request {r}: slots={rec['prompt_slots']} encode={tm['encode_ms']:.1f} ms "
              f"prefill={tm['prefill_ms']:.1f} ms decode={tok_s:.2f} tok/s "
              f"({tm['decode_steps']} steps in {tm['decode_ms']:.1f} ms) "
              f"launches={delta}", flush=True)
        requests.append(rec)
    peak = torch.cuda.max_memory_allocated()
    print(f"8B peak memory allocated: {peak / 2**30:.2f} GiB", flush=True)
    return dict(requests=requests, launches=fa.flash_attention.launches,
                n_params=n_params, peak_bytes=peak)


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
    from cambrian_tpu_torch.ops import flash_attention as fa

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    built = fa.build()
    print(f"flash-attention kernel build: {built['seconds']:.2f} s -> {built['path']}", flush=True)
    if built["log"]:
        print(built["log"].strip(), flush=True)

    rng = np.random.default_rng(SEED)
    prompts = build_prompts(cambrian_8b(), rng)
    kernels = kernel_phase(torch, fa, prompts[0])
    tiny = tiny_slice_phase(torch, fa, rng)
    full = full_width_phase(torch, fa, prompts)

    path = [k for k in kernels if k["per_request"] and k["dtype"] == "bfloat16"]
    summary = {"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "cambrian_tpu_torch/csrc/flash_attention.cu",
        "replaces": "cambrian_tpu/ops/flash_attention.py:36",
        "launches": full["launches"],
        "max_abs_err": max(k["max_abs_err"] for k in path),
        # one request's worth of launches at the path's shapes, bf16
        "ms": sum(k["ms"] * k["per_request"] for k in path),
        "plain_ms": sum(k["plain_ms"] * k["per_request"] for k in path),
    }]}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=smi, build_s=built["seconds"], kernels=kernels, tiny=tiny,
                           full=full, summary=summary), f, indent=1)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
