"""roofline_pct.K6.serve: K6's least time over its device time (the banded split-K magnitude with its pack pre-pass, hull and reduce)."""
from bench_port.reduce import roofline_pct


def read(ctx):
    if ctx.trace is None:
        return None
    return roofline_pct(ctx, "K6", ctx.trace.seconds_of("kchunk_"))
