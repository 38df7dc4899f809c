"""The port's spans and counters on the CPU: off without a profiler, nested
and counted under one, the self-time arithmetic, the operand-copy counter,
``utils.trace``'s table, and the benchmark's readers of them on made-up
tables and traces.

The kernel route is driven on the CPU with each ``ctypes`` launch replaced
by one that does nothing (``stubbed_launches``): the wrappers' checks,
copies, allocations and spans run as on the card; their outputs are left
unwritten, which no test here reads.
"""
import contextlib
import json
import threading
import time
from pathlib import Path
from types import MappingProxyType

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bench_port import harness, spans
from bench_port import trace as bench_trace
from nnaudio_tpu_torch import _spans, features, models, streaming
from nnaudio_tpu_torch.ops import framed_kernels as fk
from nnaudio_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parent.parent
#: the cells' Mel (mel128_22k): its bank is 128 x 1025 fp32
MEL = dict(sr=22050, n_fft=2048, hop_length=512, n_mels=128)
FB_BYTES = 128 * 1025 * 4
CALLS = {"mel": 2, "cqt": 2, "stream": 3, "train": 2}


@contextlib.contextmanager
def stubbed_launches():
    """Every wrapper takes the branch of a CUDA tensor and each ``ctypes``
    launch returns success without running."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fk, "_on_card", lambda t: True)
        mp.setattr(fk, "_check_cuda", lambda t: None)
        mp.setattr(fk, "_fn", lambda name: lambda *args: 0)
        mp.setattr(fk, "_stream", lambda: 0)
        mp.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
        yield


class Workloads:
    """The cells' entries at their settings, on the CPU, on short inputs."""

    def __init__(self):
        self.mel = features.MelSpectrogram(**MEL, verbose=False, device="cpu")
        self.cqt = features.CQT1992v2(sr=22050, hop_length=512, n_bins=24, verbose=False,
                                      device="cpu")
        self.stream = streaming.StreamingMel(**MEL, device="cpu")
        self.model = models.SpectrogramClassifier(n_classes=3, **MEL, device="cpu")
        gen = torch.Generator().manual_seed(3)
        self.x = torch.randn(2, 8192, generator=gen)
        # contiguous chunks, as a stream's arrive
        self.chunks = self.x.reshape(2, 4, 2048).transpose(0, 1).contiguous()
        self.labels = torch.tensor([0, 2])

    def run(self, which: str, calls: int = 1) -> None:
        with torch.no_grad():
            if which == "mel":
                for _ in range(calls):
                    self.mel(self.x)
            elif which == "cqt":
                for _ in range(calls):
                    self.cqt(self.x)
            elif which == "stream":
                state = self.stream.init_state(2)
                for s in range(calls):
                    state, _ = self.stream.step(state, self.chunks[s])
        if which == "train":
            params = dict(self.model.init_params)
            for _ in range(calls):
                _, params = models.train_step(self.model, params, self.x, self.labels)


@pytest.fixture(scope="module")
def workloads():
    return Workloads()


@pytest.fixture(scope="module", params=["plain", "kernel"])
def traced(request, workloads):
    """``(route, events, table)``: every workload under one CPU profiler
    session, on the plain route or the (stubbed) kernel route."""
    route = contextlib.nullcontext() if request.param == "plain" else stubbed_launches()
    with route, profile(activities=[ProfilerActivity.CPU]) as prof:
        for which, n in CALLS.items():
            workloads.run(which, n)
    return request.param, prof.events(), profiling.span_table()


def _port_parent(event):
    event = event.cpu_parent
    while event is not None and not event.name.startswith("nnaudio."):
        event = event.cpu_parent
    return None if event is None else event.name


# ----------------------------------------------------------------- off --
def test_without_a_profiler_span_returns_one_shared_object():
    assert profiling.span("nnaudio.a") is profiling.span("nnaudio.b")
    with profiling.span("nnaudio.a") as inside:
        assert inside is None


@pytest.mark.parametrize("which", list(CALLS))
def test_without_a_profiler_nothing_is_recorded(workloads, which):
    sessions = profiling.span_sessions()
    before = dict(profiling.span_table()) if sessions else None
    workloads.run(which)
    assert profiling.span_sessions() == sessions
    if sessions:
        assert dict(profiling.span_table()) == before


# ------------------------------------------------------------------ on --
NESTING = {  # span -> the nearest port span around it (None: outermost)
    "nnaudio.transform.MelSpectrogram": {None},
    "nnaudio.transform.CQT1992v2": {None},
    "nnaudio.stream.step.StreamingMel": {None},
    "nnaudio.stream.carry": {"nnaudio.stream.step.StreamingMel"},
    "nnaudio.train.step": {None},
    "nnaudio.train.forward": {"nnaudio.train.step"},
    "nnaudio.train.backward": {"nnaudio.train.step"},
    "nnaudio.train.update": {"nnaudio.train.step"},
}
KERNEL_NESTING = {
    "nnaudio.wrap.K2": {"nnaudio.transform.MelSpectrogram", "nnaudio.stream.step.StreamingMel"},
    "nnaudio.launch.K2": {"nnaudio.wrap.K2"},
    "nnaudio.wrap.K6": {"nnaudio.transform.CQT1992v2"},
    "nnaudio.launch.K6": {"nnaudio.wrap.K6"},
    "nnaudio.wrap.K5": {"nnaudio.train.forward"},
    "nnaudio.launch.K5": {"nnaudio.wrap.K5"},
    "nnaudio.K5.backward": {"nnaudio.train.backward"},
}


@pytest.mark.parametrize("name", list(NESTING) + list(KERNEL_NESTING))
def test_spans_sit_in_the_profiler_events_nested_as_documented(traced, name):
    route, events, _ = traced
    found = [e for e in events if e.name == name]
    if route == "plain" and name in KERNEL_NESTING:
        assert not found  # a plain route crosses no wrapper
        return
    assert found
    want = {**NESTING, **KERNEL_NESTING}[name]
    assert {_port_parent(e) for e in found} <= want


def test_self_times_add_up_to_the_outer_spans_total(traced):
    _, _, table = traced
    outer_total = sum(r.total_ns for r in table.values() if r.outer)
    assert all(r.outer in (0, r.count) for r in table.values())
    assert sum(r.self_ns for r in table.values()) == pytest.approx(outer_total, rel=0.01)
    assert sum(r.outer for r in table.values()) == sum(CALLS.values())


COUNTS = {"nnaudio.transform.MelSpectrogram": CALLS["mel"],
          "nnaudio.transform.CQT1992v2": CALLS["cqt"],
          "nnaudio.stream.step.StreamingMel": CALLS["stream"],
          "nnaudio.stream.carry": CALLS["stream"],
          "nnaudio.train.step": CALLS["train"], "nnaudio.train.forward": CALLS["train"],
          "nnaudio.train.backward": CALLS["train"], "nnaudio.train.update": CALLS["train"]}
KERNEL_COUNTS = {"nnaudio.wrap.K2": CALLS["mel"] + CALLS["stream"],
                 "nnaudio.launch.K2": CALLS["mel"] + CALLS["stream"],
                 "nnaudio.wrap.K6": CALLS["cqt"], "nnaudio.wrap.K5": CALLS["train"],
                 "nnaudio.K5.backward": CALLS["train"]}


@pytest.mark.parametrize("name", list(COUNTS) + list(KERNEL_COUNTS))
def test_each_row_counts_the_calls(traced, name):
    route, _, table = traced
    if route == "plain" and name in KERNEL_COUNTS:
        assert name not in table
        return
    assert table[name].count == {**COUNTS, **KERNEL_COUNTS}[name]


def test_launches_and_copies_count_against_the_wrapper(traced):
    route, _, table = traced
    if route == "plain":
        assert not any(r.launches or r.copies for r in table.values())
        return
    k2, k6, k5 = (table[f"nnaudio.wrap.{k}"] for k in ("K2", "K6", "K5"))
    assert (k2.launches, k6.launches, k5.launches) == (k2.count, k6.count, k5.count)
    # the Mel's frozen Fourier basis takes K2's FFT route, whose packed bank
    # is made once per basis: no operand is copied on a call or a step
    assert (k2.copies, k2.copy_bytes) == (0, 0)
    assert table["nnaudio.route.K2.fft"].count == k2.count
    assert "nnaudio.route.K2.dense" not in table
    assert (k6.copies, k5.copies) == (0, 0)
    assert not table["nnaudio.launch.K2"].launches


def test_self_time_arithmetic_on_a_made_up_nest():
    def child():
        with profiling.span("nnaudio.test.thread"):
            time.sleep(0.004)

    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("nnaudio.test.outer"):
            time.sleep(0.002)
            with profiling.span("nnaudio.test.inner"):
                time.sleep(0.003)
            worker = threading.Thread(target=child)
            worker.start()
            worker.join(timeout=30)
    assert not worker.is_alive()
    t = profiling.span_table()
    outer, inner, other = (t[f"nnaudio.test.{k}"] for k in ("outer", "inner", "thread"))
    assert outer.self_ns == outer.total_ns - inner.total_ns - other.total_ns
    assert (inner.self_ns, other.self_ns) == (inner.total_ns, other.total_ns)
    assert (outer.outer, inner.outer, other.outer) == (1, 0, 0)
    assert other.total_ns >= 4e6 and outer.self_ns >= 2e6


@pytest.mark.parametrize("make,copies", [
    (lambda: torch.ones(3, 5).t(), 1),
    (lambda: torch.ones(5, 3), 0),
])
def test_operand_records_a_copy_only_when_it_makes_one(make, copies):
    t = make()
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("nnaudio.wrap.K2"):
            out = fk._operand(t, "t", 2, t.device)
    row = profiling.span_table()["nnaudio.wrap.K2"]
    assert (row.copies, row.copy_bytes) == (copies, copies * out.nbytes)
    assert (out is t) == (copies == 0)


@pytest.mark.parametrize("activities,records", [
    ({ProfilerActivity.CPU, ProfilerActivity.CUDA}, True),
    ({ProfilerActivity.CUDA}, False),
    (set(), True),  # the NVTX and ITT modes
])
def test_a_session_starts_with_the_profiler_and_skips_records_it_would_not_keep(
        monkeypatch, activities, records):
    monkeypatch.setattr(_spans, "_records_host", [None])
    before, enabled = profiling.span_sessions(), []
    _spans._on_enable_profiler("config", activities, enable=lambda *a: enabled.append(a))
    assert profiling.span_sessions() == before + 1 and enabled == [("config", activities)]
    assert _spans._records_host[0] is records
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled", True)
    assert (profiling.span("nnaudio.test.session").rf is not None) is records


def test_trace_hands_back_the_blocks_span_table(tmp_path, workloads):
    with profiling.trace(str(tmp_path)) as where:
        workloads.run("mel")
    assert where == str(tmp_path)
    assert where.spans["nnaudio.transform.MelSpectrogram"].count == 1
    assert "nnaudio.transform.MelSpectrogram" in profiling.format_span_table(where.spans)
    assert len(list(tmp_path.glob("*.json"))) == 1


def test_the_readers_read_the_first_of_the_traced_stretches():
    for name in ("nnaudio.test.device", "nnaudio.test.host"):
        with profile(activities=[ProfilerActivity.CPU]):
            with profiling.span(name):
                pass
    assert list(spans.device_stretch_table()) == ["nnaudio.test.device"]


# ------------------------------------------------------------- readers --
def _row(count, outer, total, self_, launches=0, copies=0, copy_bytes=0):
    return profiling.SpanRow(count, outer, int(total), int(self_), launches, copies, copy_bytes)


MADE_UP_TABLE = MappingProxyType({
    "nnaudio.transform.MelSpectrogram": _row(4, 4, 4e6, 1e6),
    "nnaudio.wrap.K2": _row(4, 0, 2e6, 1.2e6, 4, 4, 4 * FB_BYTES),
    "nnaudio.route.K2.fft": _row(3, 0, 0, 0),
    "nnaudio.route.K2.dense": _row(1, 0, 0, 0),
    "nnaudio.launch.K2": _row(4, 0, 8e5, 8e5),
    "nnaudio.stream.carry": _row(4, 0, 4e5, 4e5),
})


def _made_up_trace():
    Launch = bench_trace.Launch
    step = "nnaudio.stream.step.StreamingMel"
    return bench_trace.Trace(
        window_s=1.0, busy_s=0.5, kernel_s={},
        launches=[Launch("framed_tc_kernel", 1e-3, ("nnaudio.launch.K2", "nnaudio.wrap.K2", step)),
                  Launch("CatArrayBatchedCopy", 1e-5, ("aten::cat", "nnaudio.stream.carry", step)),
                  Launch("fill", 1e-5, ("aten::fill_", "aten::pad", "nnaudio.stream.carry", step)),
                  Launch("copy", 1e-5, ("aten::copy_", "aten::pad", "nnaudio.stream.carry", step))],
        idle_by_host=[("harness, between calls", 0.003), ("nnaudio.wrap.K2", 0.002),
                      ("aten::empty", 0.001), ("nnaudio.stream.carry", 0.001)],
        stats={}, host_stats={"attempted": 4})


READINGS = {  # each new reader on the made-up table and trace
    "host_self_ms.transform.serve": 0.25, "host_self_ms.wrap.serve": 0.3,
    "host_self_ms.launch.serve": 0.2, "operand_copy_mb_per_call.serve": 0.5248,
    "idle_ms_per_call.port.serve": 0.75, "host_self_ms.carry.stream": 0.1,
    "host_self_ms.wrap.stream": 0.3, "host_self_ms.launch.stream": 0.2,
    "operand_copy_mb_per_step.stream": 0.5248, "carry_kernels_per_step.stream": 0.75,
    "idle_ms_per_step.port.stream": 0.75, "idle_ms_per_step.port.train": 0.75,
    "fft_route_pct.serve": 75.0, "fft_route_pct.stream": 75.0,
}


def _context(trace):
    return harness.Context(cell=None, window={}, trace=trace, work=None)


@pytest.mark.parametrize("metric", list(READINGS))
def test_reader_on_a_made_up_table_and_trace(monkeypatch, metric):
    monkeypatch.setattr(spans, "device_stretch_table", lambda: MADE_UP_TABLE)
    assert harness.reader(metric)(_context(_made_up_trace())) == pytest.approx(READINGS[metric])


@pytest.mark.parametrize("metric", list(READINGS))
def test_reader_of_a_port_without_spans_reads_nothing(monkeypatch, metric):
    monkeypatch.setattr(spans, "device_stretch_table", lambda: None)
    t = _made_up_trace()
    t.launches = [bench_trace.Launch(l.kernel, l.seconds, ("aten::cat", "bench_port.call"))
                  for l in t.launches]
    t.idle_by_host = [("port Python inside a call", 0.005)]
    assert harness.reader(metric)(_context(t)) is None


def _perf_layers():
    """The first column of the table of layers in PERF.md's section 3."""
    section = (ROOT / "PERF.md").read_text().split("## 3. Layers", 1)[1].split("\n## ", 1)[0]
    table = section.split("\n| Layer |", 1)[1].split("\n\n", 1)[0]
    return {line.split("|")[1].strip() for line in table.splitlines()[2:]}


BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("metric", [m for m in BENCH["per_layer"]], ids=lambda m: m["name"])
def test_every_per_layer_metric_has_a_reader_and_a_layer_of_perf_md(metric):
    assert callable(harness.reader(metric["name"]))
    assert metric["layer"] in _perf_layers()


def test_every_new_reader_is_declared():
    declared = {m["name"] for m in BENCH["per_layer"]}
    assert set(READINGS) <= declared
    assert np.all([m["layer"] == "port host path" for m in BENCH["per_layer"]
                   if m["name"] in READINGS])


# ------------------------------------------------ the synthesis streams --
SYNTH_STEP = "nnaudio.stream.step.StreamingiSTFT"


@pytest.mark.parametrize("route", ["plain", "kernel"])
def test_a_synthesis_step_holds_its_envelope_and_carry_and_flush_is_its_own(route):
    """Under a profiler each ``StreamingiSTFT`` step is an outermost span
    with ``nnaudio.stream.envelope`` and ``nnaudio.stream.carry`` inside (and
    K3's wrapper on the kernel route), and ``flush`` one of its own."""
    s = streaming.StreamingiSTFT(n_fft=256, hop_length=64, padding="same", device="cpu")
    X = torch.randn(2, 129, 12, 2, generator=torch.Generator().manual_seed(4))
    ctx = contextlib.nullcontext() if route == "plain" else stubbed_launches()
    with ctx, profile(activities=[ProfilerActivity.CPU]) as prof:
        state = s.init_state(2)
        for a in range(0, 12, 4):
            state, _ = s.step(state, X[:, :, a:a + 4])
        s.flush(state)
    events, table = prof.events(), profiling.span_table()
    flush = "nnaudio.stream.flush.StreamingiSTFT"
    assert (table[SYNTH_STEP].count, table[SYNTH_STEP].outer) == (3, 3)
    assert (table[flush].count, table[flush].outer) == (1, 1)
    children = ["nnaudio.stream.envelope", "nnaudio.stream.carry"]
    if route == "kernel":
        children.append("nnaudio.wrap.K3")
        assert table["nnaudio.wrap.K3"].launches == 3
    for child in children:
        assert (table[child].count, table[child].outer) == (3, 0)
        assert {_port_parent(e) for e in events if e.name == child} == {SYNTH_STEP}
    assert {_port_parent(e) for e in events if e.name in (SYNTH_STEP, flush)} == {None}


def test_an_inverse_cqt_step_holds_its_carry_and_flush_is_its_own():
    s = streaming.StreamingInverseCQT(sr=22050, fmin=220, n_bins=24, hop_length=128,
                                      verbose=False, device="cpu")
    X = torch.randn(1, 24, 6, 2, generator=torch.Generator().manual_seed(5))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state = s.init_state(1)
        for a in range(0, 6, 3):
            state, _ = s.step(state, X[:, :, a:a + 3])
        s.flush(state)
    events, table = prof.events(), profiling.span_table()
    step = "nnaudio.stream.step.StreamingInverseCQT"
    flush = "nnaudio.stream.flush.StreamingInverseCQT"
    assert (table[step].count, table[step].outer) == (2, 2)
    assert (table[flush].count, table[flush].outer) == (1, 1)
    assert (table["nnaudio.stream.carry"].count, table["nnaudio.stream.carry"].outer) == (2, 0)
    assert {_port_parent(e) for e in events if e.name == "nnaudio.stream.carry"} == {step}


#: four steps and a flush: 2.5 MB of K3's operand copies a launch
SYNTH_TABLE = MappingProxyType({
    SYNTH_STEP: _row(4, 4, 4e6, 1e6),
    "nnaudio.stream.flush.StreamingiSTFT": _row(1, 1, 1e5, 1e5),
    "nnaudio.stream.envelope": _row(4, 0, 6e5, 6e5),
    "nnaudio.stream.carry": _row(4, 0, 4e5, 4e5),
    "nnaudio.wrap.K3": _row(4, 0, 2e6, 1.2e6, 4, 16, 10_000_000),
    "nnaudio.launch.K3": _row(4, 0, 8e5, 8e5),
})
SYNTH_READINGS = {  # per outermost span: 4 steps and 1 flush
    "host_self_ms.step.synth": 0.2, "host_self_ms.carry.synth": 0.08,
    "host_self_ms.envelope.synth": 0.12, "operand_copy_mb_per_step.synth": 2.0,
    "kernels_per_step.synth": 1.5,
}


def _synth_trace():
    Launch = bench_trace.Launch
    k3 = ("nnaudio.launch.K3", "nnaudio.wrap.K3", SYNTH_STEP)
    return bench_trace.Trace(
        window_s=1.0, busy_s=0.5, kernel_s={},
        launches=[Launch("synthesis_tc_kernel", 1e-4, k3), Launch("copy", 1e-6, k3[1:]),
                  Launch("fold", 1e-6, ("aten::col2im", "nnaudio.stream.envelope", SYNTH_STEP)),
                  Launch("cat", 1e-6, ("aten::cat", "nnaudio.stream.carry", SYNTH_STEP)),
                  Launch("cat", 1e-6, ("aten::cat", "nnaudio.stream.carry", SYNTH_STEP)),
                  Launch("div", 1e-6, ("aten::div", SYNTH_STEP)),
                  Launch("div", 1e-6, ("aten::div", "nnaudio.stream.flush.StreamingiSTFT"))],
        idle_by_host=[], stats={}, host_stats={"attempted": 4})


@pytest.mark.parametrize("metric", list(SYNTH_READINGS))
def test_synthesis_reader_on_a_made_up_table_and_trace(monkeypatch, metric):
    monkeypatch.setattr(spans, "device_stretch_table", lambda: SYNTH_TABLE)
    got = harness.reader(metric)(_context(_synth_trace()))
    assert got == pytest.approx(SYNTH_READINGS[metric])


@pytest.mark.parametrize("metric", list(SYNTH_READINGS))
def test_synthesis_reader_of_a_port_without_the_step_span_reads_nothing(monkeypatch, metric):
    """A port whose synthesis step opens no span (K3's wrapper and launch
    alone) reads nothing, not zero."""
    table = {k: v for k, v in SYNTH_TABLE.items() if "stream" not in k}
    monkeypatch.setattr(spans, "device_stretch_table", lambda: MappingProxyType(table))
    t = _synth_trace()
    t.launches = [bench_trace.Launch(l.kernel, l.seconds, tuple(c for c in l.chain
                                                                 if "stream" not in c)
                                     + ("bench_port.call",)) for l in t.launches]
    assert harness.reader(metric)(_context(t)) is None


def test_the_k3_roofline_of_a_synthesis_step_counts_its_block():
    """128 streams of 4 frames at n_fft 1024, hop 256: K3 reads the spectra
    (2,101,248 B) and writes 1,792 samples a stream (917,504 B); bytes bound
    it, so ten launches in 1 ms of K3 read 100 x 10 x 3,018,752 / 3.35e12 /
    1e-3."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.find_cell(bench, "istft1024_24k.synth_128x4", ROOT)
    trace = _synth_trace()
    trace.kernel_s = {"void synthesis_tc_kernel<float, 128, false>": 1e-3, "fold": 1.0}
    trace.stats = {"shapes": {(128, 4, 1024, False, False): 10}}
    ctx = harness.Context(cell=cell, window={}, trace=trace, work=harness.work(cell))
    got = harness.reader("roofline_pct.K3.synth")(ctx)
    assert got == pytest.approx(100 * 10 * 3_018_752 / 3.35e12 / 1e-3)
    assert harness.reader("roofline_pct.K3.synth")(_context(None)) is None


@pytest.mark.parametrize("cell,metric,shape", [
    ("istft1024_24k.synth_128x4", "roofline_pct.K3fft.synth", (128, 4, 1024, False, False)),
    ("mel80_22k.invert_gl32", "roofline_pct.K3fft.invert", (32, 862, 32, 64))])
def test_the_k3_fft_roofline_reads_the_routes_kernel_alone(cell, metric, shape):
    """K3's FFT route's share reads K3's least time over synthesis_fft_ola_kernel's
    device time, not dense K3's, and nothing where the route did not run (a
    parent without it)."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    found = harness.find_cell(bench, cell, ROOT)
    work = harness.work(found)
    trace = _synth_trace()
    trace.stats = {"shapes": {shape: 10}}
    ctx = harness.Context(cell=found, window={}, trace=trace, work=work)
    least = ctx.least_seconds("K3", trace.stats["shapes"])
    trace.kernel_s = {"void synthesis_tc_kernel<float, 64, false>": 5.0}
    assert harness.reader(metric)(ctx) is None
    trace.kernel_s["void (anonymous namespace)::synthesis_fft_ola_kernel<9>"] = 2e-3
    assert harness.reader(metric)(ctx) == pytest.approx(100 * least / 2e-3)


# ----------------------------------------------- the dB epilogue's span --
@pytest.mark.parametrize("name,make", [
    ("WhisperLogMel", lambda: features.WhisperLogMel(device="cpu")),
    ("MFCC", lambda: features.MFCC(sr=16000, n_fft=400, hop_length=160, n_mels=40,
                                   verbose=False, device="cpu"))])
def test_power_to_db_is_the_db_span_inside_its_transform(name, make):
    """``nnaudio.db`` holds ``power_to_db``'s operations (the clamp, the
    log, the max) and sits inside the transform's own span."""
    layer = make()
    x = torch.randn(2, 3200, generator=torch.Generator().manual_seed(11))
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        layer(x)
        layer(x)
    found = [e for e in prof.events() if e.name == "nnaudio.db"]
    assert len(found) == 2
    assert {_port_parent(e) for e in found} == {f"nnaudio.transform.{name}"}
    inside = {e.name for e in prof.events() if e.cpu_parent is not None
              and any(e.cpu_parent is f or e.cpu_parent.id == f.id for f in found)}
    assert {"aten::log10", "aten::amax"} <= inside
    table = profiling.span_table()
    assert table["nnaudio.db"].count == 2 and table["nnaudio.db"].outer == 0


WHISPER = "whisper128_16k.serve_b32x30s"
WHISPER_SHAPE = (32, 480_000)


def _whisper_context(trace):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.find_cell(bench, WHISPER, ROOT)
    window = {"attempted": 4, "seconds": 2.0, "host_s": 0.004, "audio_s": 4 * 960.0,
              "shapes": {WHISPER_SHAPE: 4}}
    return harness.Context(cell=cell, window=window, trace=trace, work=harness.work(cell))


def _whisper_trace():
    Launch = bench_trace.Launch
    db = ("aten::log10", "nnaudio.db", "nnaudio.transform.WhisperLogMel", "bench_port.call")
    return bench_trace.Trace(
        window_s=1.0, busy_s=0.75,
        kernel_s={"void (anonymous namespace)::framed_fft_filterbank_mixed_kernel": 1e-3,
                  "void at::native::reflection_pad1d_out_kernel": 5.0},
        launches=[Launch("framed_fft_filterbank_mixed_kernel", 1e-4,
                         ("nnaudio.launch.K2", "nnaudio.wrap.K2", db[2], db[3])),
                  Launch("elementwise_kernel", 2e-4, db), Launch("reduce_kernel", 1e-4, db),
                  Launch("elementwise_kernel", 3e-4, ("aten::div", db[2], db[3]))],
        idle_by_host=[], stats={"shapes": {WHISPER_SHAPE: 10}},
        host_stats={"attempted": 2, "shapes": {WHISPER_SHAPE: 2}})


def test_the_whisper_cells_readers_on_a_made_up_trace():
    """K2's least time at 32 x 30 s (bytes: the signal in, the (B, M, T)
    mel out, 110.6 MB) over the mixed-radix kernel's device time; the
    kernels under nnaudio.db per call; the host ms, idle share and the
    call's least time (K2's and the epilogue's) over the window."""
    ctx = _whisper_context(_whisper_trace())
    k2 = 4 * (32 * 480_000 + 32 * 128 * 3001) / 3.35e12
    assert ctx.least_seconds("K2", {WHISPER_SHAPE: 1}) == pytest.approx(k2)
    read = lambda m: harness.reader(m)(ctx)  # noqa: E731
    assert read("roofline_pct.K2fft.serve") == pytest.approx(100 * 10 * k2 / 1e-3)
    assert read("db_ms_per_call.whisper") == pytest.approx(1e3 * 3e-4 / 2)
    assert read("host_ms_per_call.serve") == pytest.approx(1.0)
    assert read("device_idle_pct.serve") == pytest.approx(25.0)
    call = 4 * (32 * 480_000 + 32 * 128 * 3000) / 3.35e12
    assert read("mfu.serve") == pytest.approx(100 * 4 * call / 2.0)


#: the per-layer metrics cell 7 reports: the accepted serve cells' readers,
#: which read its call as theirs, and the dB epilogue's own
WHISPER_METRICS = ("host_ms_per_call.serve", "device_idle_pct.serve", "mfu.serve",
                   "host_self_ms.transform.serve", "host_self_ms.wrap.serve",
                   "host_self_ms.launch.serve", "operand_copy_mb_per_call.serve",
                   "idle_ms_per_call.port.serve", "roofline_pct.K2fft.serve",
                   "fft_route_pct.serve", "db_ms_per_call.whisper")


@pytest.mark.parametrize("metric", WHISPER_METRICS)
def test_the_whisper_cell_is_on_its_metrics_lists(metric):
    """Each metric cell 7 reports lists the cell, moves its end-to-end
    metric and has a reader; no other metric lists it."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    assert WHISPER in entries[metric]["workloads"]
    assert entries[metric]["moves"] == "audio_s_per_s"
    assert callable(harness.reader(metric))
    assert {m["name"] for m in bench["per_layer"]
            if WHISPER in m.get("workloads", [])} == set(WHISPER_METRICS)


def test_the_whisper_cells_readers_read_nothing_without_the_route_or_the_span():
    """A port without the mixed-radix route or the dB span (the parent of
    the change that brought them) reads nothing there, not zero."""
    t = _whisper_trace()
    t.kernel_s = {"void at::native::reflection_pad1d_out_kernel": 5.0}
    t.launches = [bench_trace.Launch(l.kernel, l.seconds, tuple(c for c in l.chain
                                                                 if c != "nnaudio.db"))
                  for l in t.launches]
    ctx = _whisper_context(t)
    for metric in ("roofline_pct.K2fft.serve", "db_ms_per_call.whisper"):
        assert harness.reader(metric)(ctx) is None
        assert harness.reader(metric)(_whisper_context(None)) is None
