"""roofline_pct.K3.synth: the least time of the synthesis stream's K3 launches (one a step, T frames) over the device time of synthesis_tc_kernel."""
from bench_port.reduce import roofline_pct


def read(ctx):
    if ctx.trace is None:
        return None
    return roofline_pct(ctx, "K3", ctx.trace.seconds_of("synthesis_tc_kernel"))
