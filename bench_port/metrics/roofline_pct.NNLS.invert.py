"""roofline_pct.NNLS.invert: the least time of the inversion's NNLS over the device time of the NNLS kernel (nnls_banded_seed_kernel and nnls_banded_kernel, by the name they share). The least counts the work whatever implements it: the operations of the dense seed and of M s and M^T r at 2 a nonzero entry of M each step (work/mel80_22k.py's nnls_gemm), and the bytes of M and pinv(M) and of the mels read once and of s written once."""
from bench_port.work.counts import FLOAT32, least_seconds
from bench_port.work.mel80_22k import nnls_gemm


def nnls_work(shape: tuple, s: dict):
    """``(operations, bytes)`` of one call's NNLS, ``shape = (B, T, n_iter,
    n_iter_nnls)``."""
    b, t, _, _ = shape
    f, m = s["n_fft"] // 2 + 1, s["n_mels"]
    flops, _ = nnls_gemm(shape, s)
    return flops, FLOAT32 * (2 * m * f + b * m * t + b * f * t)


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    device_s = t.seconds_of("nnls_banded")
    if device_s <= 0:
        return None
    least = sum(n * least_seconds(*nnls_work(shape, ctx.settings))
                for shape, n in t.stats["shapes"].items())
    return 100.0 * least / device_s
