"""stream_step_ms_p95: the 95th percentile of every step of the window, each timed by CUDA events from the hand-off of its chunks to its output being ready."""
import numpy as np


def read(ctx):
    lat = ctx.window.get("latencies_ms")
    return float(np.percentile(lat, 95)) if lat else None
