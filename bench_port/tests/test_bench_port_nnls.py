"""The readers of the inverse Mel's NNLS kernel in the Griffin-Lim cell: the
least work of a call's NNLS at the cell's shape, held to hand-worked values,
and the kernel route's share of the NNLS dispatches on made-up span
tables."""
import json
from types import SimpleNamespace as NS

import pytest

from bench_port import harness, spans, trace
from bench_port.tests.tiny import BENCH
from bench_port.work import counts

#: one inversion call: 32 mels of 862 frames (10 s at hop 256), 32 Griffin-Lim
#: iterations, 64 NNLS steps
INVERT = (32, 862, 32, 64)


def settings():
    cfg = json.loads((BENCH / "configs" / "mel80_22k.json").read_text())
    return cfg["settings"]


def _trace(kernel_s, shapes):
    return trace.Trace(window_s=1.0, busy_s=0.9, kernel_s=kernel_s, launches=[],
                       idle_by_host=[], stats={"attempted": sum(shapes.values()),
                                               "shapes": shapes}, host_stats={})


def test_a_calls_nnls_moves_65_8_mb_and_takes_19_6_us_at_the_bound():
    nnls_work = harness.reader("roofline_pct.NNLS.invert").__globals__["nnls_work"]
    flops, nbytes = nnls_work(INVERT, settings())
    bases, mel, s = 4 * 2 * 80 * 513, 4 * 32 * 80 * 862, 4 * 32 * 513 * 862
    assert nbytes == bases + mel + s  # M and pinv(M), the mels in; s out
    assert round(nbytes / 1e6, 1) == 65.8
    cols = 32 * 862
    assert flops == 2.0 * 513 * 80 * cols + 64 * 4 * 727 * cols  # the seed, then 64 steps
    assert (round(2.0 * 513 * 80 * cols / 1e9, 2), round(flops / 1e9, 2)) == (2.26, 7.40)
    # bytes bound a call: 19.6 us at 3.35 TB/s (the operations 14.9 us at 495 TFLOP/s)
    assert counts.least_seconds(flops, nbytes) == pytest.approx(nbytes / 3.35e12)
    assert (round(nbytes / 3.35e12 * 1e6, 1), round(flops / 495e12 * 1e6, 1)) == (19.6, 14.9)


def test_the_roofline_reads_the_kernels_device_time():
    read = harness.reader("roofline_pct.NNLS.invert")
    ctx = NS(trace=_trace({"nnls_banded_kernel(float const*, int4 const*)": 0.0180,
                           "nnls_banded_seed_kernel(float const*)": 0.0012,
                           "gl_step_fft_kernel<9>": 0.0812}, {INVERT: 10}),
             settings=settings())
    least = 10 * 65_757_568 / 3.35e12  # ten calls, bytes bound
    assert read(ctx) == pytest.approx(100 * least / 0.0192)
    assert read(NS(trace=None, settings=settings())) is None
    parent = NS(trace=_trace({"cutlass_80_simt_sgemm_128x32_8x5_nn_align1": 0.07,
                              "gl_step_fft_kernel<9>": 0.08}, {INVERT: 10}),
                settings=settings())
    assert read(parent) is None  # the products, not the kernel: nothing to read


def _table(**rows):
    return {f"nnaudio.route.NNLS.{k}": NS(count=v) for k, v in rows.items()}


@pytest.mark.parametrize("rows,want", [({}, None), (dict(fused=10), 100.0),
                                       (dict(fused=3, plain=1), 75.0),
                                       (dict(plain=2), 0.0)])
def test_the_route_share_counts_the_nnls_notes(monkeypatch, rows, want):
    monkeypatch.setattr(spans, "device_stretch_table", lambda: {
        **_table(**rows), "nnaudio.route.K4.fft": NS(count=320)})
    assert harness.reader("nnls_route_pct.invert")(NS()) == want


def test_the_route_share_reads_nothing_without_a_table(monkeypatch):
    monkeypatch.setattr(spans, "device_stretch_table", lambda: None)
    assert harness.reader("nnls_route_pct.invert")(NS()) is None
