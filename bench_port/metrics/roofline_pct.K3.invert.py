"""roofline_pct.K3.invert: the least time of the inversion's syntheses (K3, n_iter + 1 a call) over the device time of synthesis_tc_kernel."""
from bench_port.reduce import roofline_pct


def read(ctx):
    if ctx.trace is None:
        return None
    return roofline_pct(ctx, "K3", ctx.trace.seconds_of("synthesis_tc_kernel"))
