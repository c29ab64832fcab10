#!/usr/bin/env python3
"""Where a unit of K5's TMA kernel (``sva_attention_tma_kernel``) spends its
time, in SM cycles, at the 8B request's SVA site and at its training batch.

    python3 scripts/sva_phases.py [--heads 4] [--stages 2] [--bps 1] [--ring-only]

Copies the kernel's source into ``build/sva_phases/`` (git-ignored), adds
``clock64`` stamps to that copy's consumer loop (lane 0 of compute warp 0 of
every block: the mask's ballots and the next unit's mask loads, the wait for
the unit's stage, the unit's compute up to the stage's release, and the
reductions and store after it, summed over the block's units, and the
block's whole run), builds it, and runs each case's planned call (or the
unit, stages and blocks an SM forced by ``--heads``, ``--stages`` and
``--bps``) with the L2 flushed before it (the third of three calls is
read). Prints each part's mean cycles a unit over the blocks, the blocks'
mean and largest run, and the call's device time by ``torch.profiler`` (the
mean of 20 calls, L2 flushed before each). With one block an SM (``--bps
1``) nothing hides a warp's latency, so "compute" is the length of its
dependency chain; with the plan's blocks, "wait" says how long the stage
took to land. ``--ring-only`` builds the copy with each compute warp
releasing its stage as soon as it lands, computing nothing: the ring's own
streaming rate, the least time the kernel's loads take. The port itself is
not changed.
"""

import argparse
import ctypes
import os
import shutil
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPY = os.path.join(REPO, "build", "sva_phases")
MAX_BLOCKS = 4096
PARTS = ["mask", "wait", "compute", "after release", "block"]
# (B, Q, W, H, D): the 8B request's SVA attention and its training batch
CASES = [(1, 576, 19, 16, 64), (8, 576, 19, 16, 64)]
# (text of csrc/sva_attention.cu, the text that replaces it)
EDITS = [
    ("  for (int i = 0; i < n; ++i) {\n    const uint64_t keys",
     "  unsigned long long c[4] = {0, 0, 0, 0}, t0 = clock64(), t1, t2, t3;\n"
     "  for (int i = 0; i < n; ++i) {\n    t1 = clock64();\n    const uint64_t keys"),
    ("    hopper::mbar_wait(&hd.full[s], parity);\n",
     "    t2 = clock64(); c[0] += t2 - t1;\n    hopper::mbar_wait(&hd.full[s], parity);\n"
     "    t3 = clock64(); c[1] += t3 - t2;\n"),
    ("    if (lane == 0) hopper::mbar_arrive(&hd.empty[s]);   // the warp has read the stage\n",
     "    if (lane == 0) hopper::mbar_arrive(&hd.empty[s]);   // the warp has read the stage\n"
     "    t2 = clock64(); c[2] += t2 - t3;\n"),
    ("    if (++s == a.stages) s = 0, parity ^= 1;\n  }\n}\n",
     "    if (++s == a.stages) s = 0, parity ^= 1;\n    c[3] += clock64() - t2;\n  }\n"
     f"  if (warp == 0 && lane == 0 && blockIdx.x < {MAX_BLOCKS}) {{\n"
     "    for (int k = 0; k < 4; ++k) sva_cycles[blockIdx.x][k] = c[k];\n"
     "    sva_cycles[blockIdx.x][4] = clock64() - t0;\n  }\n}\n"),
]


# the compute warps' loop after the stage has landed, for --ring-only
RING_ONLY = ("    const uint8_t* st = stages + s * a.stage_bytes;\n",
             "    if (true) {   // the ring alone: release the stage, compute nothing\n"
             "      __syncwarp();\n      if (lane == 0) hopper::mbar_arrive(&hd.empty[s]);\n"
             "      if (++s == a.stages) s = 0, parity ^= 1;\n      continue;\n    }\n"
             "    const uint8_t* st = stages + s * a.stage_bytes;\n")


def stamped_source(src, ring_only=False):
    """The source with the stamps, a buffer for them and a C entry that
    copies it to the host (and, ``ring_only``, compute warps that only
    release their stages); raises if the kernel's text moved."""
    src = src.replace("namespace {\n", "namespace {\n__device__ unsigned long long "
                      f"sva_cycles[{MAX_BLOCKS}][{len(PARTS)}];\n", 1)
    for old, new in EDITS + ([RING_ONLY] if ring_only else []):
        if src.count(old) != 1:
            raise RuntimeError(f"csrc/sva_attention.cu moved; no single {old!r}")
        src = src.replace(old, new)
    return src.replace('extern "C" {\n', '''extern "C" {
int sva_read_cycles(unsigned long long* host) {
  return (int)cudaMemcpyFromSymbol(host, sva_cycles, sizeof(sva_cycles));
}
''', 1)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--heads", type=int, help="heads a unit to force")
    parser.add_argument("--stages", type=int, help="stages to force")
    parser.add_argument("--bps", type=int, help="blocks an SM to force")
    parser.add_argument("--ring-only", action="store_true",
                        help="compute warps release each stage without computing")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("sva_phases: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from cambrian_tpu_torch.ops import cuda_build
    from cambrian_tpu_torch.ops import sva_attention as sva

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    os.makedirs(COPY, exist_ok=True)
    shutil.copy(os.path.join(cuda_build.CSRC, "hopper.cuh"), COPY)
    with open(os.path.join(cuda_build.CSRC, "sva_attention.cu")) as f:
        src = stamped_source(f.read(), args.ring_only)
    path, lib_path = os.path.join(COPY, "sva_attention.cu"), os.path.join(COPY, "stamped.so")
    with open(path, "w") as f:
        f.write(src)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    subprocess.run([nvcc, *cuda_build.NVCC_FLAGS, "-o", lib_path, path], check=True,
                   capture_output=True, text=True)
    port = sva._library()
    lib = ctypes.CDLL(lib_path)
    for name in ("cambrian_sva_attention", "cambrian_sva_attention_tma",
                 "cambrian_sva_attention_tma_occupancy"):
        getattr(lib, name).argtypes = getattr(port, name).argtypes
        getattr(lib, name).restype = ctypes.c_int
    lib.cambrian_cuda_error_string.argtypes = [ctypes.c_int]
    lib.cambrian_cuda_error_string.restype = ctypes.c_char_p
    lib.sva_read_cycles.argtypes = [ctypes.c_void_p]
    sva._library = lambda: lib            # this process only: the stamped copy
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    flush = torch.zeros(16 << 20, dtype=torch.float32, device=dev).sum
    host = (ctypes.c_ulonglong * (MAX_BLOCKS * len(PARTS)))()
    forced = {k: v for k, v in (("heads", args.heads), ("stages", args.stages),
                                ("blocks_per_sm", args.bps)) if v is not None}
    for b, n_q, w, h, d in CASES:
        q = torch.randn((b, n_q, h, d), generator=g, device=dev).bfloat16()
        k = torch.randn((b, n_q, w, h, d), generator=g, device=dev).bfloat16()
        v = torch.randn((b, n_q, w, h, d), generator=g, device=dev).bfloat16()
        mask = torch.rand((b, n_q, w), generator=g, device=dev) > 0.2
        plan = sva._sva_plan(b, n_q, h, w, d, torch.bfloat16,
                             (q.stride(), k.stride(), v.stride()), True, sva._sms(dev),
                             lambda *a: sva._occupancy(dev, 1, *a), **forced)
        cs.check(plan.function == sva.SVA_TMA, f"no TMA plan for {forced}")
        for _ in range(3):
            flush()
            torch.cuda.synchronize()
            sva._sva_kernel(q, k, v, mask, d ** -0.5, plan)
            torch.cuda.synchronize()
        cs.check(lib.sva_read_cycles(ctypes.addressof(host)) == 0, "reading the stamps")

        def calls():
            for _ in range(20):
                flush()
                sva._sva_kernel(q, k, v, mask, d ** -0.5, plan)

        prof, _ = cs.profiled(torch, calls)
        device_us = [us / n for us, n, name in cs.kernel_events(prof) if sva.SVA_TMA in name]
        cycles = np.frombuffer(host, dtype=np.uint64).reshape(MAX_BLOCKS, len(PARTS))
        cycles = cycles[:plan.blocks].astype(np.float64)
        per_unit = plan.units / plan.blocks
        parts = ", ".join(f"{name} {cycles[:, i].mean() / per_unit:.0f}"
                          for i, name in enumerate(PARTS[:-1]))
        print(f"{b}x{n_q}x{w}x{h}x{d} (lanes, window, heads, stages, blocks_per_sm, blocks) "
              f"{tuple(plan)[1:7]}{' ring only' if args.ring_only else ''}: cycles a unit: "
              f"{parts}; a block's run {cycles[:, -1].mean():.0f} cycles (largest "
              f"{cycles[:, -1].max():.0f}); device time a call {device_us[0]:.2f} us",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
