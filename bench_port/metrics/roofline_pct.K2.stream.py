"""roofline_pct.K2.stream: K2's least time at a stream step over its device time (framed_tc FILTERBANK and its bin-tile reduce)."""
from bench_port.reduce import roofline_pct


def read(ctx):
    if ctx.trace is None:
        return None
    return roofline_pct(ctx, "K2", ctx.trace.seconds_of("framed_tc_kernel", "filterbank_reduce_kernel"))
