"""Share of the traced window in which no operation ran on the device."""

from gpu_bench.harness import readers


def read(ctx):
    return readers.idle_share(ctx)
