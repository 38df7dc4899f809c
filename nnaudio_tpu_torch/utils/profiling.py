"""Profiling: the port's spans and counters, and ``torch.profiler`` traces
viewable in Perfetto or ``chrome://tracing``.

While a ``torch.profiler`` session is active (and only then), the port's host
path opens spans that sit in the profiler's trace beside the kernels they
launch, and keeps a table per session (:func:`span_table`):

==============================  =============================================
span                            where
==============================  =============================================
``nnaudio.transform.<Class>``   ``features.base.SpectralTransform.apply``
``nnaudio.wrap.K1`` .. ``K6``   each launcher in ``ops.framed_kernels``, and
                                K6's ranges pre-pass (``kchunk_ranges``)
``nnaudio.launch.K1`` .. ``K6`` the ``ctypes`` call of a kernel
``nnaudio.stream.step.<Class>`` ``streaming._StreamingFramed.step``
``nnaudio.stream.carry``        the carry of a stream step (``cat``, slice,
                                ``pad``)
``nnaudio.train.step``,         ``models.train_step`` and its phases
``.forward``, ``.backward``,
``.update``
``nnaudio.K5.backward``         the pair's backward (dW products, dx)
``nnaudio.db``                  ``features.mel.power_to_db`` (``MFCC``,
                                ``WhisperLogMel``, ``StreamingMFCC``)
``nnaudio.route.K2.fft``,       not a span: the count of K2's and K3's
``.dense``, ``K3.fft``,         dispatches by route, chosen from the operands
``K3.dense``                    (``ops.framed_kernels.fft_plan``,
                                ``synthesis_fft_plan``)
==============================  =============================================

Each row counts the spans, their host time and self time (less their child
spans'), and the kernel launches (:data:`ops.framed_kernels.LAUNCHES` is
kept as before) and operand copies (new tensors a wrapper made from its
operands: casts, ``.contiguous()``, K3's transposed kernels and padded
spectra) made while the span was the innermost open one. A route through
``ops.dispatch`` shows as the ``wrap`` span under the transform; a plain
route shows none.

:func:`trace` profiles a block, writes its Chrome trace and hands back its
span table.
"""
from __future__ import annotations

import contextlib
import logging
import os
import time
import types
from typing import Mapping

from .._spans import SpanRow, span, span_sessions, span_table

__all__ = ["trace", "format_span_table", "span", "span_table", "span_sessions", "SpanRow"]

log = logging.getLogger(__name__)


class TraceDir(str):
    """The directory :func:`trace` writes into; after the block,
    :attr:`spans` is the block's span table."""
    spans: Mapping[str, SpanRow] = types.MappingProxyType({})


def format_span_table(table: Mapping[str, SpanRow]) -> str:
    """One line per span, the largest self time first: count, self and total
    ms, launches, operand copies and their MB."""
    lines = [f"{'span':<36} {'count':>7} {'self ms':>10} {'total ms':>10} "
             f"{'launches':>8} {'copies':>6} {'copy MB':>9}"]
    for name, r in sorted(table.items(), key=lambda kv: -kv[1].self_ns):
        lines.append(f"{name:<36} {r.count:>7} {r.self_ns * 1e-6:>10.3f} "
                     f"{r.total_ns * 1e-6:>10.3f} {r.launches:>8} {r.copies:>6} "
                     f"{r.copy_bytes * 1e-6:>9.3f}")
    return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str = "nnaudio_tpu_torch_trace"):
    """Context manager capturing a CPU and CUDA trace of the enclosed
    computation, the port's spans included; on exit the Chrome trace is
    written into ``log_dir`` (one ``trace_<time>.json`` per block) and the
    block's span table is logged (``logging``, INFO) and set on the yielded
    directory's ``spans``. Yields ``log_dir`` (a ``str``).

    >>> with trace("traces") as where:
    ...     spec = stft(x)
    ...     torch.cuda.synchronize()
    >>> print(format_span_table(where.spans))
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    where = TraceDir(log_dir)
    with profile(activities=activities) as prof:
        session = span_sessions() - 1
        if torch.cuda.is_available():
            # the device tracer needs a moment before it records every
            # launch: without it a block's first kernels can be missing
            time.sleep(0.05)
        yield where
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    where.spans = span_table(session)
    log.info("span table of the traced block:\n%s", format_span_table(where.spans))
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{time.time_ns()}.json"))
