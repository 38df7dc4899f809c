"""idle_ms_per_step.port.train: device idle ms while the host was in a port span's own Python (an idle gap labelled nnaudio.*), per train step, in the host's traced stretch."""
from bench_port import spans


def read(ctx):
    return spans.idle_ms_per_call(ctx)
