#!/usr/bin/env python3
"""K7 (the port's depthwise 7x7 convolution) at the shapes of one Cambrian-8B
request's ConvNeXt-XXL sites, on one CUDA card, under the plan ``_dw_plan``
chooses and under forced warps a block, stages and grids.

    python3 scripts/dwconv_sweep.py [--iters 30] [--stages 2,3] [--grids 132,264]
                                    [--no-forced]

For each site shape (B x H x W x C: the four ConvNeXt stages at 1024 px;
bf16 x, the ConvNeXt weight [C, 1, 7, 7] read in place as [7, 7, C] and the
bias in bf16, made on the card from a seed): the error of each setting
against the plain version on the fp32-upcast inputs, within 2^-7 x max(1,
|ref|max); the median device time of ``--iters`` calls, every setting timed
in turns with the first port's ``dwconv7x7_kernel`` (forced through the
plan) and PyTorch's depthwise ``F.conv2d`` (groups = C, as it dispatches:
cuDNN or PyTorch's own depthwise kernel) on the same bytes read as NCHW
(channels-last) and on an NCHW-contiguous copy, each call alone
with the L2 flushed before it and a spin kernel ahead of it (as
``chip_smoke.py`` phase 10 times them), with the share of the bound (the
larger of x read once and the output written once at 3.35 TB/s, and 99
operations an output at 67 TFLOP/s). It first prints the floor of that
timing: a one-element ``add_`` timed the same way. Ends with one request's
sum (each site times its calls) for every setting.
"""

import argparse
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (B, H, W, C, calls a request), as chip_smoke.py phase 10 captures them
SITES = [(1, 256, 256, 384, 3), (1, 128, 128, 768, 4), (1, 64, 64, 1536, 30),
         (1, 32, 32, 3072, 3)]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--iters", type=int, default=30, help="timed calls a median")
    parser.add_argument("--stages", default="2,3", help="stages to force")
    parser.add_argument("--grids", default="", help="persistent grids (blocks) to force")
    parser.add_argument("--no-forced", action="store_true", help="the chosen plan only")
    args = parser.parse_args(argv)

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("dwconv_sweep: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from cambrian_tpu_torch.ops import dwconv

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    flush = torch.zeros(16 << 20, dtype=torch.float32, device=dev).sum
    one = torch.zeros(1, device=dev)
    floor_ms = cs.cuda_ms(torch, lambda: one.add_(1), args.iters, flush, median=True)
    print(f"timing floor (a one-element add_, timed alike): {floor_ms * 1e3:.2f} us", flush=True)
    sms = dwconv._sms(dev)

    def occupancy(*a):
        return dwconv._occupancy(dev, 1, *a)

    forced = []
    if not args.no_forced:
        forced = [dict(warps_h=wh, warps_w=ww, stages=int(s)) for wh, ww in dwconv.DW_WARPS
                  for s in args.stages.split(",")]
        forced += [dict(blocks=int(b)) for b in args.grids.split(",") if b]
    totals, counted = {}, {}    # a request's ms by setting, and the sites it covers

    def add(label, ms, calls):
        totals[label] = totals.get(label, 0.0) + calls * ms
        counted[label] = counted.get(label, 0) + 1

    with torch.no_grad():
        for b, h, w, c, calls in SITES:
            x = torch.randn((b, h, w, c), generator=g, device=dev).bfloat16()
            conv_w = (torch.randn((c, 1, 7, 7), generator=g, device=dev) * 0.2).bfloat16()
            wt = conv_w[:, 0].permute(1, 2, 0)
            bias = torch.randn(c, generator=g, device=dev).bfloat16()
            x_cl = x.permute(0, 3, 1, 2)                    # the same bytes as NCHW
            x_nchw = x_cl.contiguous()
            ref = dwconv.depthwise_conv7x7_reference(x.float(), wt.float(), bias.float())
            tol = 2 ** -7 * max(1.0, float(ref.abs().max()))
            n_bytes = 2 * x.numel() * 2 + 50 * c * 2
            bound_ms, bound_by, _, _ = cs.bound(n_bytes, 99 * x.numel(), "float32")
            fns = {
                "dwconv7x7_kernel (first port)":
                    lambda: dwconv._dwconv_kernel(x, wt, bias, dwconv.DW_OLD),
                "F.conv2d channels-last":
                    lambda: F.conv2d(x_cl, conv_w, bias, padding=3, groups=c),
                "F.conv2d nchw":
                    lambda: F.conv2d(x_nchw, conv_w, bias, padding=3, groups=c),
            }
            labels = {k: k for k in fns}
            settings = [("plan", {})] + [
                (" ".join(f"{k} {v}" for k, v in f.items()), f) for f in forced]
            for label, f in settings:
                plan = dwconv._dw_plan(b, h, w, c, torch.bfloat16, x.stride(), True, sms,
                                       occupancy, **f)
                if plan.function != dwconv.DW_TMA:
                    print(f"  {c}x{h}x{w} {label:34s} (no TMA plan)", flush=True)
                    continue
                # (rows, cols, warps_h, warps_w, stages, blocks, tiles)
                key = str(tuple(plan)[1:])
                labels[label] = key
                if key in fns:
                    continue
                got = dwconv._dwconv_kernel(x, wt, bias, plan)
                err = float((got.float() - ref).abs().max())
                cs.check(err <= tol, f"{h}x{w}x{c} {label} {plan}: error {err} > {tol}")
                fns[key] = (lambda pl=plan: dwconv._dwconv_kernel(x, wt, bias, pl))
            got = fns["dwconv7x7_kernel (first port)"]()
            err = float((got.float() - ref).abs().max())
            cs.check(err <= tol, f"{h}x{w}x{c} first port's kernel: error {err} > {tol}")
            times = cs.cuda_ms_turns(torch, fns, args.iters, flush, cs.SITE_SPIN_CYCLES)
            conv = min(times["F.conv2d channels-last"], times["F.conv2d nchw"])
            print(f"{b}x{h}x{w}x{c} x{calls}: bound {bound_ms * 1e3:.2f} us ({bound_by})",
                  flush=True)
            for label, key in labels.items():
                ms = times[key]
                add(label, ms, calls)
                print(f"  {label:34s} {ms * 1e3:8.2f} us {bound_ms / ms:6.1%} of bound "
                      f"{ms / times['dwconv7x7_kernel (first port)']:6.3f}x first port "
                      f"{ms / conv:6.3f}x the faster F.conv2d"
                      + ("" if key == label else
                         f" (rows, cols, warps_h, warps_w, stages, blocks, tiles) {key}"),
                      flush=True)
            add("bound", bound_ms, calls)
    for label, ms in totals.items():
        part = "" if counted[label] == len(SITES) else \
            f" (only {counted[label]} of the {len(SITES)} site shapes)"
        print(f"a request, {label}: {ms:.3f} ms{part}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
