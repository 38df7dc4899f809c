"""host_ms_per_step.train: host ms from a call's start until it returns, averaged over the window."""
from bench_port.reduce import host_ms


def read(ctx):
    return host_ms(ctx)
