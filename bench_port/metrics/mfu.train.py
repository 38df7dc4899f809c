"""mfu.train: the least time of the window's steps over its wall time."""
from bench_port.reduce import mfu_pct


def read(ctx):
    return mfu_pct(ctx, "step")
