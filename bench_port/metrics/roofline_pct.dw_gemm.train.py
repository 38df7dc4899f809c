"""roofline_pct.dw_gemm.train: the least time of the basis gradients' two products over the device time of the cuBLAS GEMMs that the pair's backward launches."""
from bench_port.reduce import roofline_pct

#: host operations whose kernels are matrix products
GEMM_OPS = ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm")


def read(ctx):
    if ctx.trace is None:
        return None
    return roofline_pct(ctx, "dw_gemm", ctx.trace.launched_under("_PairBackward", GEMM_OPS),
                        host_stretch=True)
