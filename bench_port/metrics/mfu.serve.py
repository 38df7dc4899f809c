"""mfu.serve: the least time of the window's calls over its wall time."""
from bench_port.reduce import mfu_pct


def read(ctx):
    return mfu_pct(ctx, "call")
