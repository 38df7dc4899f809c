"""Spans and counters of the port's host path, on the profiler's clock.

Tracing is on exactly while a ``torch.profiler`` session is active (the
profiler's own flag, ``torch.autograd.profiler._is_profiler_enabled``); no
switch of the port's turns it on. The public face of this module is
:mod:`nnaudio_tpu_torch.utils.profiling`; it lives here so that the hot path
can import it without loading ``utils``, which loads on first use.

- **Off**, :func:`span` reads that flag and returns one shared no-op context:
  nothing is allocated, formatted or called in torch.
- **On**, a span enters ``torch._C._profiler._RecordFunctionFast`` (or
  ``record_function`` where torch lacks it), so it sits in the profiler's
  trace beside the kernels, which it launches; in a session that records no
  host operations (``activities=[CUDA]``) it skips that, since the trace
  would not keep it. A table per session and span
  name keeps the count, the host time (``time.perf_counter_ns``), the self
  time (the time minus what the span's child spans cover) and the counters
  attributed to the innermost open span: kernel launches
  (:func:`note_launch`) and operand copies (:func:`copied`). A kernel with
  two routes counts each dispatch in a row of the route's own
  (:func:`note_route`, ``nnaudio.route.K2.fft`` or ``.dense``), which holds
  a count and nothing else. A span opened on
  a thread with none open (autograd runs a backward on a thread of its own)
  is the child of the span opened last on any thread that is still open.

A session starts when the profiler enables itself (``torch.autograd.profiler.
_enable_profiler``, which this module wraps to see the session's activities):
:func:`span_sessions` counts them, :func:`span_table` reads one.
"""
from __future__ import annotations

import contextlib
import threading
import types
from time import perf_counter_ns
from typing import Mapping, NamedTuple

import torch
from torch.autograd import profiler as _profiler

_RecordFunction = getattr(torch._C._profiler, "_RecordFunctionFast",
                          _profiler.record_function)

class SpanRow(NamedTuple):
    """One span name's totals over a session."""
    count: int        # spans closed
    outer: int        # of them, those opened with no port span open
    total_ns: int     # host time from entry to exit
    self_ns: int      # the same less the time of the span's child spans
    launches: int     # kernel launches made while it was the innermost span
    copies: int       # operand copies made while it was the innermost span
    copy_bytes: int   # their bytes


_COUNT, _OUTER, _TOTAL, _SELF, _LAUNCHES, _COPIES, _COPY_BYTES = range(7)
#: the rows of :func:`note_route`
ROUTE_PREFIX = "nnaudio.route."
_OFF = contextlib.nullcontext()
_sessions: list[dict[str, list]] = []
_records_host = [True]        # whether the latest session keeps host operations
_local = threading.local()   # .top: the innermost open span of the thread
_local.top = None
_open = [None]                # the span opened last on any thread, still open


def _on_enable_profiler(config, activities=(), *args, enable=_profiler._enable_profiler,
                        **kwargs):
    _sessions.append({})
    # no activities at all: the NVTX and ITT modes, which emit every record
    _records_host[0] = not activities or torch._C._profiler.ProfilerActivity.CPU in activities
    return enable(config, activities, *args, **kwargs)


_on_enable_profiler.starts_span_sessions = True
if not getattr(_profiler._enable_profiler, "starts_span_sessions", False):
    _profiler._enable_profiler = _on_enable_profiler


class _Span:
    __slots__ = ("row", "rf", "below", "parent", "child_ns", "t0")

    def __enter__(self):
        if self.rf is not None:
            self.rf.__enter__()
        below = getattr(_local, "top", None)
        self.below = below
        self.parent = below if below is not None else _open[0]
        _local.top = _open[0] = self
        self.child_ns = 0
        self.t0 = perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ns = perf_counter_ns() - self.t0
        if self.rf is not None:
            self.rf.__exit__(*exc)
        row = self.row
        row[_COUNT] += 1
        row[_TOTAL] += ns
        row[_SELF] += ns - self.child_ns
        if self.parent is None:
            row[_OUTER] += 1
        else:
            self.parent.child_ns += ns
        _local.top = self.below
        if _open[0] is self:
            _open[0] = self.parent
        return False


_new_span = object.__new__


def span(name: str):
    """A context around one stretch of the port's host path, named by a
    constant (``nnaudio.<layer>.<what>``): the shared no-op context while no
    profiler runs, else a span in the profiler's trace and in the table."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    if not _sessions:  # a profiler started before this module was imported
        _sessions.append({})
    table = _sessions[-1]
    s = _new_span(_Span)
    s.row = table.get(name) or table.setdefault(name, [0] * len(SpanRow._fields))
    s.rf = _RecordFunction(name) if _records_host[0] else None
    return s


def note_route(name: str) -> None:
    """While tracing, count one dispatch that took the route ``name`` (of a
    kernel that has more than one: ``K2.fft``, ``K2.dense``) as the row
    ``nnaudio.route.<name>`` of the session's table, which holds that count
    alone."""
    if _profiler._is_profiler_enabled:
        if not _sessions:
            _sessions.append({})
        name = ROUTE_PREFIX + name
        table = _sessions[-1]
        (table.get(name) or table.setdefault(name, [0] * len(SpanRow._fields)))[_COUNT] += 1


def _innermost():
    return getattr(_local, "top", None) or _open[0]


def note_launch() -> None:
    """While tracing, count one kernel launch against the innermost open
    span, if any."""
    if _profiler._is_profiler_enabled:
        frame = _innermost()
        if frame is not None:
            frame.row[_LAUNCHES] += 1


def copied(out: torch.Tensor, src: torch.Tensor | None = None) -> torch.Tensor:
    """``out``; while tracing, if it is not ``src`` (a cast or
    ``.contiguous()`` that made a new tensor, or a new operand made from one),
    count one copy of its bytes against the innermost open span, if any."""
    if out is not src and _profiler._is_profiler_enabled:
        frame = _innermost()
        if frame is not None:
            frame.row[_COPIES] += 1
            frame.row[_COPY_BYTES] += out.nbytes
    return out


def span_sessions() -> int:
    """Profiler sessions started since this module was imported."""
    return len(_sessions)


def span_table(session: int = -1) -> Mapping[str, SpanRow]:
    """A read-only snapshot of one session's table, by span name (indexed
    as a list: 0 the first session, -1 the latest). Raises ``IndexError``
    where there is no such session."""
    return types.MappingProxyType(
        {name: SpanRow(*row) for name, row in _sessions[session].items()})
