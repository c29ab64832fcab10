#!/usr/bin/env python3
"""Where one call of K7's TMA kernel (``dwconv7x7_tma_kernel``) spends its
time, phase by phase, at the four ConvNeXt-XXL sites of a Cambrian-8B
request and at the training batch.

    python3 scripts/dwconv_phases.py [--warps-h 2 --warps-w 2] [--blocks 528] [--warm]

Copies the port into ``build/dw_phases/`` (git-ignored), adds ``%globaltimer``
stamps to that copy's kernel (thread 0 of every block: after the barriers
are set up, when its first slice's weights have arrived and when they are
staged, when it has asked for its first box and when that box has landed,
when its first tile's taps are done, when its last box has landed, and at
its end), builds it, and runs each shape's planned call (or the block
shape and grid forced by ``--warps-h``/``--warps-w`` and ``--blocks``) with
the L2 flushed before it, or not with ``--warm`` (the third of three calls
is read). Prints, for each phase, the minimum, median and maximum over the
blocks of the time since the first block's start, a block's mean time a
tile between its first and its last box, and the kernel's device time by
``torch.profiler`` (no event floor). The port itself is not changed.
"""

import argparse
import ctypes
import functools
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPY = os.path.join(REPO, "build", "dw_phases")
PHASES = ["start", "weights staged", "first box landed", "first tile's taps done",
          "last box landed", "end", "weights loaded", "first box asked for"]
MAX_BLOCKS = 4096
# (text of csrc/dwconv.cu, the stamp that follows it, only its first pass)
STAMPS = [
    ("    if (n > 0) issue_next();\n  }\n  __syncthreads();\n", 0, True),
    ("    __syncthreads();\n    float wt[kTaps];\n", 1, True),
    ("      hopper::mbar_wait(&hd.full[s], parity);\n", 2, True),
    ("        hopper::mbar_arrive(&hd.empty[s]);\n", 3, True),
    ("      hopper::mbar_wait(&hd.full[s], parity);\n", 4, False),
    ("  if (lane == 0) hopper::bulk_wait_read();   // the box stays until its last store has "
     "read it\n", 5, False),
    ("    load_params(p, taps, chans, ok, share, c, c < p.C, bc);\n", 6, True),
    ("    if (n > 0) issue_next();\n", 7, True),
]
SITES = [(1, 256, 256, 384), (1, 128, 128, 768), (1, 64, 64, 1536), (1, 32, 32, 3072),
         (8, 64, 64, 1536)]


def stamped_source(src):
    """The source with the stamps, a buffer for them and C entries that clear
    it and copy it to the host; raises if the kernel's text moved."""
    src = src.replace("namespace {\n", f"""namespace {{
__device__ unsigned long long dw_stamps[{MAX_BLOCKS}][8];
#define DW_STAMP(i, once) if (threadIdx.x == 0 && blockIdx.x < {MAX_BLOCKS} && \\
    (!(once) || dw_stamps[blockIdx.x][i] == 0)) {{ \\
    unsigned long long t; asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t)); \\
    dw_stamps[blockIdx.x][i] = t; }}
""", 1)
    for text, i, once in STAMPS:
        if src.count(text) != 1:
            raise RuntimeError(f"dwconv7x7_tma_kernel no longer has the text before stamp {i}: "
                               f"{text!r}")
        src = src.replace(text, text + f"  DW_STAMP({i}, {int(once)})\n")
    return src.replace('extern "C" {\n', '''extern "C" {
int dw_stamps_read(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, dw_stamps, sizeof(dw_stamps));
}
int dw_stamps_clear() {
  static unsigned long long zeros[''' + str(MAX_BLOCKS) + '''][8];
  return (int)cudaMemcpyToSymbol(dw_stamps, zeros, sizeof(zeros));
}
''', 1)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--warps-h", type=int, help="force the warps along a tile's rows")
    parser.add_argument("--warps-w", type=int, help="force the warps along a tile's columns")
    parser.add_argument("--blocks", type=int, help="force the persistent grid")
    parser.add_argument("--warm", action="store_true",
                        help="no L2 flush before the calls (x, w and the maps stay cached)")
    args = parser.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("dwconv_phases: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(os.path.join(REPO, "cambrian_tpu_torch"),
                    os.path.join(COPY, "cambrian_tpu_torch"))
    source = os.path.join(COPY, "cambrian_tpu_torch", "csrc", "dwconv.cu")
    with open(source) as f:
        text = stamped_source(f.read())
    with open(source, "w") as f:
        f.write(text)
    sys.path.insert(0, COPY)
    from cambrian_tpu_torch.ops import dwconv

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    lib = dwconv._library()
    lib.dw_stamps_read.argtypes = [ctypes.c_void_p]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    flush = torch.zeros(16 << 20, device=dev)
    occupancy = functools.partial(dwconv._occupancy, dev, 1)
    for b, h, w, c in SITES:
        x = torch.randn((b, h, w, c), generator=g, device=dev).bfloat16()
        conv_w = (torch.randn((c, 1, 7, 7), generator=g, device=dev) * 0.2).bfloat16()
        wt, bias = conv_w[:, 0].permute(1, 2, 0), torch.randn(c, device=dev).bfloat16()
        plan = dwconv._dw_plan(b, h, w, c, torch.bfloat16, x.stride(), True, dwconv._sms(dev),
                               occupancy, warps_h=args.warps_h, warps_w=args.warps_w,
                               blocks=args.blocks)
        for _ in range(3):
            if not args.warm:
                flush.sum()
            torch.cuda._sleep(1_000_000)
            lib.dw_stamps_clear()
            dwconv._dwconv_kernel(x, wt, bias, plan)
            torch.cuda.synchronize()
        stamps = torch.zeros((MAX_BLOCKS, 8), dtype=torch.int64)
        lib.dw_stamps_read(stamps.data_ptr())
        t = stamps[:plan.blocks, :len(PHASES)].double() / 1e3
        t -= t[:, 0].min()
        tiles = torch.tensor([(k + 1) * plan.tiles // plan.blocks - k * plan.tiles // plan.blocks
                              for k in range(plan.blocks)], dtype=torch.float64)
        many = tiles > 1
        per_tile = ((t[many, 4] - t[many, 2]) / (tiles[many] - 1)).median() if many.any() else 0
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                if not args.warm:
                    flush.sum()
                dwconv._dwconv_kernel(x, wt, bias, plan)
            torch.cuda.synchronize()
        dev_us = [e.self_device_time_total / e.count for e in prof.key_averages()
                  if "dwconv7x7_tma_kernel" in e.key]
        cols = " | ".join(f"{p} {t[:, i].min():.2f}/{t[:, i].median():.2f}/{t[:, i].max():.2f}"
                          for i, p in enumerate(PHASES))
        print(f"{b}x{h}x{w}x{c} {tuple(plan)[1:]} (us since the first block's start, "
              f"min/median/max): {cols}; a tile {float(per_tile):.2f} us (median over blocks "
              f"of more than one tile); kernel device time {dev_us} us (torch.profiler, "
              f"mean of 5)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
