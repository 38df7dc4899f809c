"""host_self_ms.wrap.stream: host self ms of the kernel wrappers (nnaudio.wrap.K*) per step, in the device's traced stretch."""
from bench_port import spans


def read(ctx):
    return spans.self_ms_per_call(spans.device_stretch_table(), "nnaudio.wrap.")
