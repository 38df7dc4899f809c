"""roofline_pct.K3fft.synth: the least time of the synthesis stream's K3 launches (one a step, T frames) over the device time of K3's FFT route (synthesis_fft_ola_kernel), where a frozen Fourier synthesis basis takes it."""
from bench_port.reduce import roofline_pct


def read(ctx):
    if ctx.trace is None:
        return None
    return roofline_pct(ctx, "K3", ctx.trace.seconds_of("synthesis_fft_ola_kernel"))
