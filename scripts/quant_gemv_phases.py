#!/usr/bin/env python3
"""Where one call of the bf16 M = 1 decode GEMV (``gemv_m1_kernel``) spends its
time, phase by phase, at the decoder projection shapes of Cambrian-8B.

    python3 scripts/quant_gemv_phases.py

Copies the port into ``build/gemv_phases/`` (git-ignored), adds ``%globaltimer``
stamps to that copy's kernel (thread 0 of every block, at its start, when x
and the scales are staged, when its warp 0 has consumed its rows, when its
sums are pushed to their ranks, after the cluster barrier, and at its end),
builds it, and runs each shape's planned call with the L2 flushed before it
(the third of three calls is read). Prints, for each phase, the minimum,
median and maximum over the blocks of the time since the first block's start
(the global timer ticks in steps of a few hundred ns on the H100). The port
itself is not changed.
"""

import ctypes
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPY = os.path.join(REPO, "build", "gemv_phases")
PHASES = ["start", "x and scales staged", "warp 0's rows done", "sums pushed",
          "cluster barrier", "end"]
MAX_BLOCKS = 4096
# (text of csrc/quant_matmul.cu, the stamp that follows it)
STAMPS = [
    ("  cg::cluster_group cluster = cg::this_cluster();\n", 0),
    ("    ss4[i] = m1_scale_load(a, scale_rows, g0, slab0, n_scales, i);\n  __syncthreads();\n", 1),
    ("    for (int u = 0; u < kM1Loads; ++u) cur[u] = nxt[u];\n  }\n", 2),
    ("          make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);\n"
     "    }\n  }\n", 3),
    ("  cluster.sync();\n  // every warp of the cluster, rank by rank, in order\n", 4),
    ("      a.out[n] = __float2bfloat16(v);\n    }\n  }\n", 5),
]


def stamped_source(src):
    """The source with the stamps, a buffer for them and a C entry that
    copies the buffer to the host; raises if the kernel's text moved."""
    src = src.replace("namespace {\n", f"""namespace {{
__device__ unsigned long long m1_stamps[{MAX_BLOCKS}][8];
#define M1_STAMP(i) if (threadIdx.x == 0 && blockIdx.x < {MAX_BLOCKS}) {{ \\
    unsigned long long t; asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t)); \\
    m1_stamps[blockIdx.x][i] = t; }}
""", 1)
    for text, i in STAMPS:
        if src.count(text) != 1:
            raise RuntimeError(f"gemv_m1_kernel no longer has the text before stamp {i}: {text!r}")
        src = src.replace(text, text + f"  M1_STAMP({i})\n")
    return src.replace('extern "C" {\n', '''extern "C" {
int m1_stamps_read(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, m1_stamps, sizeof(m1_stamps));
}
''', 1)


def main():
    import torch

    if not torch.cuda.is_available():
        print("quant_gemv_phases: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(os.path.join(REPO, "cambrian_tpu_torch"),
                    os.path.join(COPY, "cambrian_tpu_torch"))
    source = os.path.join(COPY, "cambrian_tpu_torch", "csrc", "quant_matmul.cu")
    with open(source) as f:
        text = stamped_source(f.read())
    with open(source, "w") as f:
        f.write(text)
    sys.path.insert(0, COPY)
    from cambrian_tpu_torch.ops import quant

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    lib = quant._library()
    lib.m1_stamps_read.argtypes = [ctypes.c_void_p]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    flush = torch.zeros(16 << 20, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    shapes = [("q_proj", 4096, 4096), ("k_proj", 4096, 1024), ("gate_proj", 4096, 14336),
              ("down_proj", 14336, 4096)]
    for site, k, n in shapes:
        w = (torch.randn((k, n), generator=g, device=dev) * 0.02).bfloat16()
        x = torch.randn((1, k), generator=g, device=dev).bfloat16()
        for mode, name in ((0, "int8"), (1, "int4")):
            wq, sc = quant.quantize_int8(w) if mode == 0 else quant.quantize_int4(w)
            fn = quant.int8_matmul if mode == 0 else quant.int4_matmul
            for _ in range(3):
                flush.sum()
                torch.cuda._sleep(200_000)
                fn(x, wq, sc)
                torch.cuda.synchronize()
            plan = quant._gemv_plan(mode, torch.bfloat16, 1, n, k, 1 if mode == 0 else 128,
                                    x.data_ptr(), wq.data_ptr(), sms, sc.data_ptr())
            blocks = -(-n // plan.slab) * plan.cluster
            stamps = torch.zeros((MAX_BLOCKS, 8), dtype=torch.int64)
            lib.m1_stamps_read(stamps.data_ptr())
            t = stamps[:blocks, :len(PHASES)].double() / 1e3
            t -= t[:, 0].min()
            cols = " | ".join(f"{p} {t[:, i].min():.2f}/{t[:, i].median():.2f}/"
                              f"{t[:, i].max():.2f}" for i, p in enumerate(PHASES))
            print(f"{name} {site} {tuple(plan)}, {blocks} blocks (us since the first block's "
                  f"start, min/median/max): {cols}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
