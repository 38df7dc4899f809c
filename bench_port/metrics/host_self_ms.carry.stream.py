"""host_self_ms.carry.stream: host self ms of the stream step's carry (nnaudio.stream.carry: cat, tail slice, pad) per step, in the device's traced stretch."""
from bench_port import spans


def read(ctx):
    return spans.self_ms_per_call(spans.device_stretch_table(), "nnaudio.stream.carry")
