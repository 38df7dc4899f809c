"""roofline_pct.K4fft.invert: the least time of the inversion's Griffin-Lim analysis steps over the device time of K4's FFT route (gl_step_fft_kernel). A call's n_iter steps each read the padded signal, S and the two previous carries and write the four new carries (c and r, re and im), and compute a real FFT a frame and 12 operations a bin (the update)."""
from bench_port.work.counts import FLOAT32, least_seconds, rfft_flops
from bench_port.work.mel80_22k import UPDATE_FLOPS


def step_work(shape: tuple, s: dict):
    """``(operations, bytes)`` of one call's steps, ``shape = (B, T, n_iter,
    n_iter_nnls)``."""
    b, t, n_iter, _ = shape
    n, hop = s["n_fft"], s["hop_length"]
    f = n // 2 + 1
    flops = n_iter * b * t * (rfft_flops(n) + UPDATE_FLOPS * f)
    nbytes = n_iter * FLOAT32 * (b * (n + hop * (t - 1)) + 7 * b * f * t)
    return flops, nbytes


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    device_s = t.seconds_of("gl_step_fft_kernel")
    if device_s <= 0:
        return None
    least = sum(n * least_seconds(*step_work(shape, ctx.settings))
                for shape, n in t.stats["shapes"].items())
    return 100.0 * least / device_s
