"""Kernel K3 (``ops/quant.py`` + ``csrc/quant_matmul.cu``) in the decode
steps: the least time of the seven int8 projections of every layer at
M = the engine's slots (their int8 weights, fp32 scales, x and outputs,
each once; bound by bytes), over the device time of the kernels that ran
them."""

from gpu_bench.harness import readers
from gpu_bench.work import kernels

K3 = r"gemv_m1_kernel|gemv_m8_kernel|gemv_kernel|gemm_wgmma_kernel|gemm_tc_kernel|quant_matmul"


def read(ctx):
    m = ctx.cfg["model"]
    if ctx.cfg.get("quantize") != "int8":
        return None
    h, f = m["hidden_size"], m["intermediate_size"]
    d = m["head_dim"] or h // m["num_attention_heads"]
    q, kv = m["num_attention_heads"] * d, m["num_key_value_heads"] * d
    shapes = [(h, q), (h, kv), (h, kv), (q, h), (h, f), (h, f), (f, h)]
    rows = ctx.traffic["slots"]
    step = m["num_hidden_layers"] * sum(
        readers.seconds(ctx, *kernels.quant_gemv(rows, k, n, 8)) for k, n in shapes)
    return readers.roofline(ctx, ["decode_step"], K3, lambda kind, work: step)
