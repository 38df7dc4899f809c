"""roofline_pct.K5.train: the pair's (K5, framed_tc PAIR) least time under grad over its device time."""
from bench_port.reduce import roofline_pct


def read(ctx):
    if ctx.trace is None:
        return None
    return roofline_pct(ctx, "K5", ctx.trace.seconds_of("framed_tc_kernel"))
