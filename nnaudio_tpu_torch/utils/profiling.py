"""Profiling hook: ``torch.profiler`` traces viewable in Perfetto or
``chrome://tracing``."""
from __future__ import annotations

import contextlib
import os
import time


@contextlib.contextmanager
def trace(log_dir: str = "nnaudio_tpu_torch_trace"):
    """Context manager capturing a CPU and CUDA trace of the enclosed
    computation; on exit the Chrome trace is written into ``log_dir`` (one
    ``trace_<time>.json`` per block). Yields ``log_dir``.

    >>> with trace("traces"):
    ...     spec = stft(x)
    ...     torch.cuda.synchronize()
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{time.time_ns()}.json"))
