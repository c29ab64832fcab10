#!/usr/bin/env python3
"""K8 (the port's fused GELU MLP) at the shapes of one Cambrian-8B request's
drop-in sites, on one CUDA card, over hidden-chunk budgets and tile widths.

    python3 scripts/fused_mlp_sweep.py [--budgets 16,24,32,40] [--tiles]

For each site shape (ConvNeXt-XXL stages 1-4, the SVA ``Mlp``s at 576 rows;
inputs made on the card from a seed): the error against the plain version on
the fp32-upcast inputs, the device time of one call (CUDA events, L2 flushed
and a spin kernel ahead of each call, as ``chip_smoke.py`` phase 10 times
it) and its TFLOP/s, at each chunk budget and, with ``--tiles``, with each
GEMM's output tile width forced to 64, 128, 192 and 256 in turn; the cuBLAS
pair (two ``F.linear`` and the port's GELU) beside it; and each GEMM's
device time per launch from ``torch.profiler``. Ends with one request's sum
(the sites times their calls) for every setting.
"""

import argparse
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (M, C, H, C2, biases, calls a request)
SITES = [(65536, 384, 1536, 384, True, 3), (16384, 768, 3072, 768, True, 4),
         (4096, 1536, 6144, 1536, True, 30), (1024, 3072, 12288, 3072, True, 3),
         (576, 1024, 1024, 1024, False, 3), (576, 1024, 1024, 4096, False, 10)]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--budgets", default="24", help="hidden chunk budgets, MiB")
    parser.add_argument("--tiles", action="store_true", help="also force each tile width")
    args = parser.parse_args(argv)

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("fused_mlp_sweep: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from cambrian_tpu_torch.ops import fused_mlp as fm
    from cambrian_tpu_torch.ops.activations import gelu_exact
    from torch.profiler import ProfilerActivity, profile

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    flush = torch.zeros(16 << 20, dtype=torch.float32, device=dev).sum
    plan_of = fm._plan
    settings = [(int(b) << 20, None, None) for b in args.budgets.split(",")]
    if args.tiles:
        settings += [(fm.HIDDEN_CHUNK_BYTES, bn, None) for bn in fm.TILE_COLS]
        settings += [(fm.HIDDEN_CHUNK_BYTES, None, bn) for bn in fm.TILE_COLS]
    totals = {}
    try:
        with torch.no_grad():
            for m, c, h, c2, bias, calls in SITES:
                x = torch.randn((m, c), generator=g, device=dev).bfloat16()
                w1l = (torch.randn((h, c), generator=g, device=dev) / c ** 0.5).bfloat16()
                w2l = (torch.randn((c2, h), generator=g, device=dev) / h ** 0.5).bfloat16()
                b1 = torch.randn(h, generator=g, device=dev) * 0.1 if bias else None
                b2 = torch.randn(c2, generator=g, device=dev) * 0.1 if bias else None
                w1, w2 = w1l.t(), w2l.t()       # nn.Linear's weights, read in place
                ref = fm.fused_mlp_reference(x.float(), w1.float(), b1, w2.float(), b2)
                tol = 2 ** -7 * max(1.0, float(ref.abs().max()))
                flops = 2 * m * h * (c + c2)
                b1l, b2l = (None if b is None else b.bfloat16() for b in (b1, b2))
                lib_ms = cs.cuda_ms(torch, lambda: F.linear(gelu_exact(F.linear(x, w1l, b1l)),
                                                            w2l, b2l),
                                    5, flush, cs.SITE_SPIN_CYCLES)
                totals["cuBLAS pair"] = totals.get("cuBLAS pair", 0.0) + calls * lib_ms
                print(f"site M={m} C={c} H={h} C2={c2} x{calls}: cuBLAS pair {lib_ms:.4f} ms, "
                      f"bound {flops / cs.PEAK_OPS_PER_S['bfloat16'] * 1e3:.4f} ms", flush=True)
                timed = {}     # plan: ms (settings that plan alike are timed once)
                for budget, up, down in settings:
                    base = plan_of(m, c, h, c2, c, budget=budget)
                    plan = base._replace(bn_up=up or base.bn_up, bn_down=down or base.bn_down)
                    label = (f"budget {budget >> 20} MiB" if up is down is None else
                             f"up tile {up}" if up else f"down tile {down}")
                    if plan in timed:
                        totals[label] = totals.get(label, 0.0) + calls * timed[plan]
                        continue
                    fm._plan = lambda *a, plan=plan, **k: plan
                    out = fm.fused_mlp(x, w1, b1, w2, b2)
                    torch.cuda.synchronize()
                    err = float((out.float() - ref).abs().max())
                    cs.check(err <= tol, f"M={m} {plan}: max abs error {err} > {tol}")
                    ms = cs.cuda_ms(torch, lambda: fm.fused_mlp(x, w1, b1, w2, b2), 5, flush,
                                    cs.SITE_SPIN_CYCLES)
                    timed[plan] = ms
                    totals[label] = totals.get(label, 0.0) + calls * ms
                    print(f"  {label:16s} {plan} err={err:.3e} (tol {tol:.2e}) {ms:.4f} ms "
                          f"{flops / (ms * 1e9):.1f} TFLOP/s", flush=True)
                fm._plan = plan_of
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(3):
                        fm.fused_mlp(x, w1, b1, w2, b2)
                    torch.cuda.synchronize()
                for us, n, key in cs.kernel_events(prof):
                    print(f"    {cs.mlp_functions([key]) or key[:60]} x{n}: {us / n:.1f} us a "
                          f"launch", flush=True)
    finally:
        fm._plan = plan_of
    for label, ms in totals.items():
        print(f"a request, {label}: {ms:.3f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
