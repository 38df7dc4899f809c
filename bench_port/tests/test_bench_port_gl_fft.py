"""The readers of K4's FFT route in the Griffin-Lim cell: the least work of
a step at the cell's shape, held to hand-worked values, and the route's
share of the steps on made-up span tables."""
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


def test_a_step_moves_424_6_mb_and_takes_0_127_ms_at_the_bound():
    step_work = harness.reader("roofline_pct.K4fft.invert").__globals__["step_work"]
    flops, nbytes = step_work((32, 862, 1, 64), settings())
    padded, plane = 4 * 32 * (1024 + 256 * 861), 4 * 32 * 513 * 862
    assert (round(padded / 1e6, 1), round(plane / 1e6, 1)) == (28.3, 56.6)
    assert nbytes == padded + 7 * plane  # the signal, S and p in; c and r out
    assert round(nbytes / 1e6, 1) == 424.6
    assert flops == 32 * 862 * (2.5 * 1024 * 10 + 12 * 513)
    assert round(flops / 1e9, 3) == 0.876
    # bytes bound a step: 0.127 ms at 3.35 TB/s
    assert counts.least_seconds(flops, nbytes) == pytest.approx(nbytes / 3.35e12)
    assert round(nbytes / 3.35e12 * 1e3, 3) == 0.127
    assert step_work(INVERT, settings()) == (32 * flops, 32 * nbytes)


def test_the_roofline_reads_the_kernels_device_time():
    read = harness.reader("roofline_pct.K4fft.invert")
    ctx = NS(trace=_trace({"void gl_step_fft_kernel<9>(float const*)": 0.0812,
                           "synthesis_fft_ola_kernel<9>": 0.05}, {INVERT: 10}),
             settings=settings())
    least = 10 * 32 * 424_560_896 / 3.35e12  # ten calls of 32 steps, bytes bound
    assert read(ctx) == pytest.approx(100 * least / 0.0812)
    assert read(NS(trace=None, settings=settings())) is None
    parent = NS(trace=_trace({"framed_tc_kernel<float, 112>": 0.2}, {INVERT: 10}),
                settings=settings())
    assert read(parent) is None  # no kernel of the route: nothing to read


def _table(**rows):
    return {f"nnaudio.route.K4.{k}": NS(count=v) for k, v in rows.items()}


@pytest.mark.parametrize("rows,want", [({}, None), (dict(fft=64), 100.0),
                                       (dict(fft=3, pair=1), 75.0),
                                       (dict(dense=2), 0.0)])
def test_the_route_share_counts_the_k4_notes(monkeypatch, rows, want):
    monkeypatch.setattr(spans, "device_stretch_table", lambda: {
        **_table(**rows), "nnaudio.route.K3.fft": NS(count=33)})
    assert harness.reader("gl_fft_route_pct.invert")(NS()) == want


def test_the_route_share_reads_nothing_without_a_table(monkeypatch):
    monkeypatch.setattr(spans, "device_stretch_table", lambda: None)
    assert harness.reader("gl_fft_route_pct.invert")(NS()) is None
