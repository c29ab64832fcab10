"""The traced window's model FLOPs (encodes, prefills, each active slot's
decode tokens at its cache depth; counted from shapes) over the window
times the card's bf16 peak."""

from gpu_bench.harness import readers


def read(ctx):
    return readers.mfu(ctx, readers.serving_flops(ctx))
