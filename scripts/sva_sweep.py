#!/usr/bin/env python3
"""K5 (the port's SVA windowed cross-attention) at the shape of the 8B
request's SVA sites and at its training batch, on one CUDA card, under the
plan ``_sva_plan`` chooses and under forced heads a unit, stages and blocks
an SM.

    python3 scripts/sva_sweep.py [--iters 30] [--heads 1,2,4] [--stages 2,3,4]
                                 [--bps 1,2,3,4] [--no-forced] [--profile]

For each case (B x Q x W x H x D: the 8B site, 1 x 576 x 19 x 16 x 64, whose
13 calls a request are the 3 connector and 10 decoder SVA attentions, and
its training batch, B = 8; bf16 q, k, v and a [B, Q, W] bool mask made on the
card from a seed, k and v contiguous as the SVA module concatenates them):
the error of each setting against the plain version on the fp32-upcast
inputs, within 2^-7 x max(1, |ref|max); the median device time of
``--iters`` calls, every setting timed in turns with the first port's
``sva_attention_kernel`` (forced through the plan) and
``F.scaled_dot_product_attention`` on the batch-flattened windows (as
``chip_smoke.py`` phase 10 times them), each call alone with the L2 flushed
before it and a spin kernel ahead of it, with the share of the bound (q, k,
v and the mask read once and the output written once at 3.35 TB/s; 4 D + 5
operations a key at 67 TFLOP/s). It first prints the floor of that timing: a
one-element ``add_`` timed the same way. ``--heads`` x ``--stages`` force
units and stages (blocks an SM as the plan picks them), ``--bps`` forces
blocks an SM under the plan's unit and stages; ``--profile`` adds the
plan's device time by ``torch.profiler``. Ends with one request's sum (the
8B site's calls) for every setting.
"""

import argparse
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (B, Q, W, H, D, calls a request), as chip_smoke.py phase 10 captures them
CASES = [(1, 576, 19, 16, 64, 13), (8, 576, 19, 16, 64, 0)]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--iters", type=int, default=30, help="timed calls a median")
    parser.add_argument("--heads", default="1,2,4", help="heads a unit to force")
    parser.add_argument("--stages", default="2,3,4", help="stages to force")
    parser.add_argument("--bps", default="", help="blocks an SM to force")
    parser.add_argument("--no-forced", action="store_true", help="the chosen plan only")
    parser.add_argument("--profile", action="store_true",
                        help="also the plan's device time by torch.profiler")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("sva_sweep: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from cambrian_tpu_torch.ops import sva_attention as sva

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    flush = torch.zeros(16 << 20, dtype=torch.float32, device=dev).sum
    one = torch.zeros(1, device=dev)
    floor_ms = cs.cuda_ms(torch, lambda: one.add_(1), args.iters, flush, median=True)
    print(f"timing floor (a one-element add_, timed alike): {floor_ms * 1e3:.2f} us", flush=True)
    sms = sva._sms(dev)

    def occupancy(*a):
        return sva._occupancy(dev, 1, *a)

    forced = []
    if not args.no_forced:
        forced = [dict(heads=int(h), stages=int(s)) for h in args.heads.split(",") if h
                  for s in args.stages.split(",") if s]
        forced += [dict(blocks_per_sm=int(b)) for b in args.bps.split(",") if b]
    totals, counted = {}, {}    # a request's ms by setting, and the cases it covers

    def add(label, ms, calls):
        totals[label] = totals.get(label, 0.0) + calls * ms
        counted[label] = counted.get(label, 0) + 1

    requested = sum(1 for *_, calls in CASES if calls)
    with torch.no_grad():
        for b, n_q, w, h, d, calls in CASES:
            q = torch.randn((b, n_q, h, d), generator=g, device=dev).bfloat16()
            k = torch.randn((b, n_q, w, h, d), generator=g, device=dev).bfloat16()
            v = torch.randn((b, n_q, w, h, d), generator=g, device=dev).bfloat16()
            mask = torch.rand((b, n_q, w), generator=g, device=dev) > 0.2
            scale = d ** -0.5
            ref = sva.fused_windowed_cross_attention_reference(q.float(), k.float(), v.float(),
                                                               mask, scale)
            tol = 2 ** -7 * max(1.0, float(ref.abs().max()))
            site = dict(q=q, k=k, v=v, mask=mask)
            n_bytes, n_ops, rate = cs.site_work("fused_windowed_cross_attention", site)
            bound_ms, bound_by, _, _ = cs.bound(n_bytes, n_ops, rate)
            sdpa = cs.library_call(torch, "fused_windowed_cross_attention", site)["sdpa"]
            fns = {
                "sva_attention_kernel (first port)":
                    lambda: sva._sva_kernel(q, k, v, mask, scale, sva.SVA_OLD),
                "sdpa": sdpa,
            }
            labels = {name: name for name in fns}
            settings = [("plan", {})] + [
                (" ".join(f"{key} {val}" for key, val in f.items()), f) for f in forced]
            plans = {}
            for label, f in settings:
                plan = sva._sva_plan(b, n_q, h, w, d, torch.bfloat16,
                                     (q.stride(), k.stride(), v.stride()), True, sms,
                                     occupancy, **f)
                if plan.function != sva.SVA_TMA:
                    print(f"  {b}x{n_q} {label:34s} (no TMA plan)", flush=True)
                    continue
                # (lanes, window, heads, stages, blocks_per_sm, blocks)
                key = str(tuple(plan)[1:7])
                labels[label] = key
                plans[key] = plan
                if key in fns:
                    continue
                got = sva._sva_kernel(q, k, v, mask, scale, plan)
                err = float((got.float() - ref).abs().max())
                cs.check(err <= tol, f"{b}x{n_q} {label} {plan}: error {err} > {tol}")
                fns[key] = (lambda pl=plan: sva._sva_kernel(q, k, v, mask, scale, pl))
            got = fns["sva_attention_kernel (first port)"]()
            err = float((got.float() - ref).abs().max())
            cs.check(err <= tol, f"{b}x{n_q} first port's kernel: error {err} > {tol}")
            times = cs.cuda_ms_turns(torch, fns, args.iters, flush, cs.SITE_SPIN_CYCLES)
            print(f"{b}x{n_q}x{w}x{h}x{d} x{calls}: bound {bound_ms * 1e3:.2f} us ({bound_by}), "
                  f"{n_bytes / 1e6:.2f} MB", flush=True)
            for label, key in labels.items():
                ms = times[key]
                add(label, ms, calls)
                plan = plans.get(key)
                extra = "" if plan is None else (
                    f" (lanes, window, heads, stages, blocks_per_sm, blocks) {key}, busiest SM "
                    f"{plan.share:.3f}x the mean, {plan.in_flight / 1024:.1f} KB in flight an SM")
                print(f"  {label:34s} {ms * 1e3:8.2f} us {bound_ms / ms:6.1%} of bound "
                      f"{ms / times['sva_attention_kernel (first port)']:6.3f}x first port "
                      f"{ms / times['sdpa']:6.3f}x sdpa{extra}", flush=True)
            add("bound", bound_ms, calls)
            if args.profile:
                key = labels["plan"]
                prof, _ = cs.profiled(torch, lambda: [fns[key]() for _ in range(args.iters)])
                for us, count, name in cs.kernel_events(prof):
                    if sva.SVA_TMA in name:
                        print(f"  plan by torch.profiler: {us / count:.2f} us of device time a "
                              f"call ({count} calls)", flush=True)
    for label, ms in totals.items():
        part = "" if counted[label] == len(CASES) else \
            f" (only {counted[label]} of the {len(CASES)} cases)"
        print(f"a request ({requested} site shape), {label}: {ms:.4f} ms{part}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
