"""roofline_pct.K5.invert: the least time of the inversion's analyses (K5 outside grad, n_iter a call) over the device time of framed_tc_kernel, whose only epilogue in this cell is the pair."""
from bench_port.reduce import roofline_pct


def read(ctx):
    if ctx.trace is None:
        return None
    return roofline_pct(ctx, "K5", ctx.trace.seconds_of("framed_tc_kernel"))
