"""The traced stretches: the loop's own work under ``torch.profiler``,
reduced to what the per-layer readers take.

The first stretch traces the device alone: the device's busy time (the
union of its operations), its window and each operation's time by name. The
second also traces the host, in spans of the benchmark's own
(``bench_port.window`` around the loop's calls, ``bench_port.call`` around
each): each kernel with the chain of host operations that launched it
(``launches``), and the device's idle time by what the host was doing
meanwhile.
"""
from __future__ import annotations

import bisect
import collections
import time
from dataclasses import dataclass

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

WINDOW = "bench_port.window"
CALL = "bench_port.call"
#: what the host was doing where no operation of its own ran inside a span
HOST_LABELS = {WINDOW: "harness, between calls", CALL: "port Python inside a call"}
#: entries of each list of the breakdown
TOP = 10


@dataclass
class Launch:
    kernel: str
    seconds: float
    chain: tuple  # host operations, innermost first


@dataclass
class Trace:
    window_s: float
    busy_s: float
    kernel_s: dict
    launches: list
    idle_by_host: list
    stats: dict  # the loop's counts in the device's stretch
    host_stats: dict  # and in the host's

    def seconds_of(self, *fragments: str) -> float:
        """Device seconds of the operations whose name holds a fragment."""
        return sum(s for name, s in self.kernel_s.items()
                   if any(f in name for f in fragments))

    def launched_under(self, ancestor: str, ops: tuple) -> float:
        """Device seconds of kernels launched by a host operation in ``ops``
        below a host operation whose name holds ``ancestor``."""
        return sum(l.seconds for l in self.launches
                   if l.chain and l.chain[0] in ops and any(ancestor in c for c in l.chain))

    def breakdown(self) -> dict:
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[name, s] for name, s in ops],
                "idle_gaps": [[name, s] for name, s in self.idle_by_host[:TOP]]}


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _chain(event) -> tuple:
    names = []
    while event is not None:
        names.append(event.name)
        event = event.cpu_parent
    return tuple(names)


def _host_at(starts, events, t):
    """The innermost host operation running at ``t`` (events sorted by
    start; nested operations start later than those around them)."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0:
        e = events[i]
        if e.time_range.end > t:
            return HOST_LABELS.get(e.name, e.name)
        i -= 1
    return "no host operation"


def _on_device(events, w0=float("-inf"), w1=float("inf")):
    """``(start, end, name)`` of the device's operations that start in
    ``[w0, w1)``. A span of the benchmark's own also shows on the device's
    timeline, as a user annotation around the operations it holds: it is not
    one."""
    return [(e.time_range.start, min(e.time_range.end, w1), e.name) for e in events
            if e.device_type == DeviceType.CUDA and w0 <= e.time_range.start < w1
            and e.name not in HOST_LABELS and not getattr(e, "is_user_annotation", False)]


def traced(run, seconds: float) -> Trace:
    """Two stretches of ``run(seconds, keep=False, ...)`` under the
    profiler. The first traces the device alone, which adds the least to the
    host: its busy time, window (first operation's start to last one's end)
    and time by operation. The second traces the host's operations too, in
    the benchmark's spans: each kernel's launching chain and what the host
    was doing while the device was idle (slower host, so more idle)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # the tracer needs a moment before it records every launch
        time.sleep(0.05)
        stats = run(seconds, keep=False)
        torch.cuda.synchronize()
    device = _on_device(prof.events())
    kernel_s = collections.Counter()
    for a, b, name in device:
        kernel_s[name] += (b - a) * 1e-6
    busy = _union([(a, b) for a, b, _ in device])
    window_s = (busy[-1][1] - busy[0][0]) * 1e-6 if busy else 0.0

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)
        with record_function(WINDOW):
            host_stats = run(seconds, keep=False, span_name=CALL)
            torch.cuda.synchronize()
    events = prof.events()
    window = next(e for e in events if e.name == WINDOW and e.device_type == DeviceType.CPU)
    w0, w1 = window.time_range.start, window.time_range.end
    host = sorted((e for e in events if e.device_type == DeviceType.CPU
                   and e.thread == window.thread and w0 <= e.time_range.start <= w1),
                  key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in host]
    idle = collections.Counter()
    edges = [w0] + [t for a, b in _union([(a, b) for a, b, _ in _on_device(events, w0, w1)])
                    for t in (a, b)] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            idle[_host_at(starts, host, (a + b) / 2)] += (b - a) * 1e-6
    launches = [Launch(k.name, k.duration * 1e-6, _chain(e)) for e in events
                if e.device_type == DeviceType.CPU and e.kernels
                and w0 <= e.time_range.start < w1 for k in e.kernels]
    return Trace(window_s=window_s, busy_s=sum(b - a for a, b in busy) * 1e-6,
                 kernel_s=dict(kernel_s), launches=launches,
                 idle_by_host=sorted(idle.items(), key=lambda kv: -kv[1]), stats=stats,
                 host_stats=host_stats)
