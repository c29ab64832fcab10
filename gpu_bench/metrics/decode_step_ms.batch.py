"""Device ms of one lockstep decode step of the continuous engine: the
kernels launched under each ``CambrianLM.decode_step`` span, over the
steps."""

from gpu_bench.harness import readers


def read(ctx):
    return readers.device_ms_per_span(ctx, "decode_step")
