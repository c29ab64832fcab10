"""Kernel K2 (``csrc/flash_attention_bwd.cu``) in the training steps: the
least time of each layer's attention backward at the step's shape (the
causal pairs over each sample's valid slots; q, k, v, o, dO, the row
statistic, dq, dk, dv over the whole padded batch, each once) over the
device time of every K2 kernel launched under the step spans: the row
statistic (``bwd_delta_kernel``, the only one that reads o), dK/dV and dQ,
in bf16 and in fp32."""

from gpu_bench.harness import readers
from gpu_bench.work import kernels

K2 = r"bwd_delta_kernel|bwd_dkdv|bwd_dq"


def read(ctx):
    m = ctx.cfg["model"]
    d = m["head_dim"] or m["hidden_size"] // m["num_attention_heads"]
    rows = ctx.traffic["batch"] * ctx.traffic["seq_len"]

    def bound(kind, work):
        call = kernels.attention_bwd(kernels.causal_pairs(work["lengths"]),
                                     m["num_attention_heads"], d, rows,
                                     m["num_key_value_heads"])
        return m["num_hidden_layers"] * readers.seconds(ctx, *call)

    return readers.roofline(ctx, ["train_step"], K2, bound)
