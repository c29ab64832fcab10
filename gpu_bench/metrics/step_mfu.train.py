"""The traced window's model FLOPs of its training steps (counted from
shapes over the valid slots, no recomputation) over the window times the
card's bf16 peak."""

from gpu_bench.harness import readers


def read(ctx):
    return readers.mfu(ctx, readers.train_flops(ctx))
