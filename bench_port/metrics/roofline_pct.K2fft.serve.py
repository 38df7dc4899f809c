"""roofline_pct.K2fft.serve: K2's least time over the device time of its FFT route (framed_fft_filterbank_kernel), where a frozen Fourier basis takes it."""
from bench_port.reduce import roofline_pct


def read(ctx):
    if ctx.trace is None:
        return None
    return roofline_pct(ctx, "K2", ctx.trace.seconds_of("framed_fft_filterbank"))
