#!/usr/bin/env python3
"""K6 (the port's fused LayerNorm) at the shapes of one Cambrian-8B request's
LayerNorm sites, on one CUDA card, under the plan ``_ln_plan`` chooses and
under forced lanes a row and warps a block.

    python3 scripts/layer_norm_sweep.py [--iters 30] [--lanes 4,8,16,32] [--warps 1,2,4]
                                        [--no-forced]

For each site shape (C x rows: ConvNeXt-XXL stages 1-4, CLIP, SigLIP,
DINOv2 and the SVA connector; bf16 inputs made on the card from a seed):
the error of each setting against the plain version on the fp32-upcast
inputs, within 2^-7 x max(1, |ref|max); the median device time of
``--iters`` calls, every setting timed in turns with ``F.layer_norm`` (bf16
weights) and the scalar ``layer_norm_kernel``, each call alone with the L2
flushed before it and a spin kernel ahead of it (as ``chip_smoke.py`` phase
10 times them), with the share of the bound (x read once, the output written
once, w and b once, at 3.35 TB/s). It first prints the floor of that timing:
a one-element ``add_`` timed the same way. Ends with one request's sum (each
site times its calls) for every setting.
"""

import argparse
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (C, rows, calls a request), as chip_smoke.py phase 10 captures them
SITES = [(384, 65536, 5), (768, 16384, 5), (1536, 4096, 31), (3072, 1024, 3),
         (1024, 576, 107), (1024, 577, 47), (1024, 9216, 27), (1152, 729, 55),
         (1536, 730, 81)]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--iters", type=int, default=30, help="timed calls a median")
    parser.add_argument("--lanes", default="4,8,16,32", help="lanes a row to force")
    parser.add_argument("--warps", default="1,2,4", help="warps a block to force")
    parser.add_argument("--no-forced", action="store_true", help="the chosen plan only")
    args = parser.parse_args(argv)

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("layer_norm_sweep: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from cambrian_tpu_torch.ops import cuda_build, norms

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    flush = torch.zeros(16 << 20, dtype=torch.float32, device=dev).sum
    lib = norms._library()
    one = torch.zeros(1, device=dev)
    floor_ms = cs.cuda_ms(torch, lambda: one.add_(1), args.iters, flush, median=True)
    print(f"timing floor (a one-element add_, timed alike): {floor_ms * 1e3:.2f} us", flush=True)
    forced = [] if args.no_forced else [(int(la), int(wa)) for la in args.lanes.split(",")
                                        for wa in args.warps.split(",")]
    totals, counted = {}, {}    # a request's ms by setting, and the sites it covers

    def add(label, ms, calls):
        totals[label] = totals.get(label, 0.0) + calls * ms
        counted[label] = counted.get(label, 0) + 1

    with torch.no_grad():
        for c, rows, calls in SITES:
            x = (torch.randn((rows, c), generator=g, device=dev) * 3 + 1).bfloat16()
            w = torch.randn(c, generator=g, device=dev)
            b = torch.randn(c, generator=g, device=dev)
            wd, bd = w.bfloat16(), b.bfloat16()
            ref = norms.fused_layer_norm_reference(x.float(), w, b, 1e-6)
            tol = 2 ** -7 * max(1.0, float(ref.abs().max()))
            bound_ms = (2 * x.numel() * 2 + 8 * c) / cs.PEAK_BYTES_PER_S * 1e3
            out = torch.empty_like(x)
            stream = torch.cuda.current_stream().cuda_stream

            def scalar():
                err = lib.cambrian_layer_norm(1, x.data_ptr(), w.data_ptr(), b.data_ptr(),
                                              out.data_ptr(), rows, c, 1e-6, stream)
                cuda_build.check_launch(lib, err, "layer_norm")

            fns = {"F.layer_norm": lambda: F.layer_norm(x, (c,), wd, bd, 1e-6),
                   "layer_norm_kernel (scalar)": scalar}
            labels = {"F.layer_norm": "F.layer_norm",
                      "layer_norm_kernel (scalar)": "layer_norm_kernel (scalar)"}
            for label, lanes, warps in [("plan", None, None)] + [
                    (f"lanes {la} warps {wa}", la, wa) for la, wa in forced]:
                plan = norms._ln_plan(rows, c, torch.bfloat16, True, norms._sms(dev),
                                      lambda *a: norms._occupancy(dev, 1, *a), lanes, warps)
                if plan.function != "layer_norm_vec_kernel":
                    print(f"  C={c:<5d} rows={rows:<6d} {label:24s} (no vector plan)", flush=True)
                    continue
                key = str(tuple(plan)[1:])          # (lanes, chunks, warps, blocks)
                labels[label] = key
                if key in fns:
                    continue
                got = norms._ln_kernel(x, w, b, 1e-6, lanes, warps)
                err = float((got.float() - ref).abs().max())
                cs.check(err <= tol, f"C={c} rows={rows} {label} {plan}: error {err} > {tol}")
                fns[key] = (lambda la=lanes, wa=warps: norms._ln_kernel(x, w, b, 1e-6, la, wa))
            scalar()
            torch.cuda.synchronize()
            err = float((out.float() - ref).abs().max())
            cs.check(err <= tol, f"C={c} rows={rows} scalar: error {err} > {tol}")
            times = cs.cuda_ms_turns(torch, fns, args.iters, flush, cs.SITE_SPIN_CYCLES)
            print(f"C={c} rows={rows} x{calls}: {2 * x.numel() * 2 / 1e6:.2f} MB, bound "
                  f"{bound_ms * 1e3:.2f} us", flush=True)
            for label, key in labels.items():
                ms = times[key]
                add(label, ms, calls)
                print(f"  {label:26s} {ms * 1e3:8.2f} us {ms / times['F.layer_norm']:6.3f}x "
                      f"F.layer_norm {bound_ms / ms:6.1%} of bound"
                      + ("" if key == label else f" (lanes, chunks, warps, blocks) {key}"),
                      flush=True)
            add("bound", bound_ms, calls)
    for label, ms in totals.items():
        part = "" if counted[label] == len(SITES) else \
            f" (only {counted[label]} of the {len(SITES)} site shapes)"
        print(f"a request, {label}: {ms:.3f} ms{part}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
