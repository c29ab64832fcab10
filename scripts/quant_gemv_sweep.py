#!/usr/bin/env python3
"""The bf16 decode GEMV of K3 (int8), K4 (int4) and K4b/K4c (int4 with the
scale on the weights, mode 2) at the seven decoder projection shapes of
Cambrian-8B (LLaMA-3-8B), on one CUDA card, at M rows of x (``--m``: 1,
``gemv_m1_kernel``, by default; 2..8, ``gemv_m8_kernel``, a continuous-
batching decode step over M slots), under the plan ``_gemv_plan`` chooses
and under forced slab widths, cluster sizes and warps a block.

    python3 scripts/quant_gemv_sweep.py [--m 1] [--iters 30] [--warps 4,8] [--no-forced]
                                        [--shapes q_proj,k_proj] [--modes 0,1,2]

For each shape and mode (weights made on the card from a seed): the error of
the planned kernel against the plain version on x upcast to fp32, within
2^-7 x max(1, |ref|max); the median device time of ``--iters`` calls, each
timed alone with the L2 flushed before it and a spin kernel ahead of it (as
``chip_smoke.py`` phase 3 times them), with the achieved TB/s and the share
of the bound (the weights, scales, x and out moved once at 3.35 TB/s); the
same for the first port's ``gemv_kernel`` (``_route="gemv_kernel"``) and for
``torch.matmul`` on the dequantized bf16 weight. It first prints the floor of
that timing: a one-element ``add_`` timed the same way. Ends with a decode
step's sum (the seven shapes times 32 layers) for every setting.
"""

import argparse
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--m", type=int, default=1, help="rows of x, 1 to 8")
    parser.add_argument("--iters", type=int, default=30, help="timed calls a median")
    parser.add_argument("--warps", default="", help="also force these warps a block, e.g. 4,8")
    parser.add_argument("--no-forced", action="store_true", help="the chosen plan only")
    parser.add_argument("--shapes", default="", help="only these projections, e.g. q_proj,k_proj")
    parser.add_argument("--modes", default="0,1,2", help="modes: 0 int8, 1 int4, 2 int4 with "
                        "the scale on the weights")
    args = parser.parse_args(argv)
    if not 1 <= args.m <= 8:
        parser.error(f"--m takes 1 to 8, got {args.m}")

    import torch

    if not torch.cuda.is_available():
        print("quant_gemv_sweep: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from cambrian_tpu_torch.ops import quant

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    flush = torch.zeros(16 << 20, dtype=torch.float32, device=dev).sum
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    settings = [(None, None, None)]
    if not args.no_forced:
        warps = [None] + [int(w) for w in args.warps.split(",") if w]
        settings += [(slab, cluster, w) for slab in quant.GEMV_SLABS
                     for cluster in quant.GEMV_CLUSTERS for w in warps]
    totals, shapes = {}, {}    # a decode step's ms by setting, and the shapes it covers
    one = torch.zeros(1, device=dev)
    floor_ms = cs.cuda_ms(torch, lambda: one.add_(1), args.iters, flush, median=True)
    print(f"timing floor (a one-element add_, timed alike): {floor_ms * 1e3:.2f} us", flush=True)

    def add(label, ms):
        totals[label] = totals.get(label, 0.0) + cs.LAYERS * ms
        shapes[label] = shapes.get(label, 0) + 1

    def timed(fn):
        return cs.cuda_ms(torch, fn, args.iters, flush, median=True)

    with torch.no_grad():
        for site, k, n in cs.QUANT_SHAPES:
            if args.shapes and site not in args.shapes.split(","):
                continue
            w = (torch.randn((k, n), generator=g, device=dev) * 0.02).bfloat16()
            x = torch.randn((args.m, k), generator=g, device=dev).bfloat16()
            for mode, name in ((0, "int8"), (1, "int4"), (2, "int4_sow")):
                if str(mode) not in args.modes.split(","):
                    continue
                if mode == 0:
                    wq, sc = quant.quantize_int8(w)
                    fn, plain, deq = (quant.int8_matmul, quant.int8_matmul_reference,
                                      quant.dequantize_int8)
                    group = 1
                else:
                    wq, sc = quant.quantize_int4(w)
                    fn = quant.int4_matmul if mode == 1 else quant.int4_matmul_scale_on_weights
                    plain, deq = quant.int4_matmul_reference, quant.dequantize_int4
                    if mode == 2:
                        def plain(x, q, s):
                            return quant.int4_matmul_reference(x, q, s, scale_on_weights=True)
                    group = k // sc.shape[0]
                ref = plain(x.float(), wq, sc)
                tol = 2 ** -7 * max(1.0, float(ref.abs().max()))
                n_bytes = wq.numel() + sc.numel() * 4 + args.m * (k + n) * 2
                bound_ms = n_bytes / cs.PEAK_BYTES_PER_S * 1e3

                def show(label, ms, err=None, total=None):
                    add(f"{name} {total or label}", ms)
                    tail = "" if err is None else f" err={err:.3e} (tol {tol:.2e})"
                    print(f"  {name} {site:9s} {label:34s} {ms * 1e3:8.2f} us "
                          f"{n_bytes / (ms * 1e9):6.3f} TB/s {bound_ms / ms:6.1%} of bound"
                          f"{tail}", flush=True)

                print(f"{name} {site} M={args.m} K={k} N={n}: bound {bound_ms * 1e3:.2f} us",
                      flush=True)
                w_deq = deq(wq, sc, torch.bfloat16)
                show("torch.matmul (dequantized)", timed(lambda: torch.matmul(x, w_deq)))
                del w_deq
                out = fn(x, wq, sc, _route="gemv_kernel")
                err = float((out.float() - ref).abs().max())
                cs.check(err <= tol, f"{name} {site} gemv_kernel: error {err} > {tol}")
                show("gemv_kernel (first port)",
                     timed(lambda: fn(x, wq, sc, _route="gemv_kernel")), err)
                seen = {}
                for slab, cluster, warps in settings:
                    plan = quant._gemv_plan(mode, torch.bfloat16, args.m, n, k, group,
                                            x.data_ptr(), wq.data_ptr(), sms, sc.data_ptr(),
                                            slab, cluster, warps)
                    label = ("plan" if slab is None else
                             f"slab {slab} cluster {cluster}" + (f" warps {warps}" if warps
                                                                 else ""))
                    if plan is None:
                        print(f"  {name} {site:9s} {label:34s} (no such split)", flush=True)
                        continue
                    if plan in seen:
                        add(f"{name} {label}", seen[plan])
                        continue
                    out = fn(x, wq, sc, _route=plan)
                    torch.cuda.synchronize()
                    err = float((out.float() - ref).abs().max())
                    cs.check(err <= tol, f"{name} {site} {plan}: error {err} > {tol}")
                    ms = timed(lambda: fn(x, wq, sc, _route=plan))
                    seen[plan] = ms
                    show(f"{label} {tuple(plan)}" if label == "plan" else label, ms, err, label)
                add(f"{name} bound", bound_ms)
    for label, ms in totals.items():
        n_shapes = len(args.shapes.split(",")) if args.shapes else len(cs.QUANT_SHAPES)
        part = "" if shapes[label] == n_shapes else \
            f" (only {shapes[label]} of the {n_shapes} shapes split so)"
        print(f"a decode step, {label}: {ms:.3f} ms{part}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
