"""carry_kernels_per_step.stream: device kernels launched under the stream step's carry (nnaudio.stream.carry in the launching chain), per step, in the host's traced stretch."""
from bench_port import spans


def read(ctx):
    return spans.kernels_per_call(ctx, "nnaudio.stream.carry")
