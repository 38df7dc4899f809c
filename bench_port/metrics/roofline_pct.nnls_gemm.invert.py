"""roofline_pct.nnls_gemm.invert: the least time of the NNLS's products (the pseudo-inverse seed, then M s and M^T r each step) over the device time of the cuBLAS kernels whose name holds gemm, the only products of this cell outside the port's own kernels."""
from bench_port.reduce import roofline_pct


def read(ctx):
    if ctx.trace is None:
        return None
    return roofline_pct(ctx, "nnls_gemm", ctx.trace.seconds_of("gemm"))
