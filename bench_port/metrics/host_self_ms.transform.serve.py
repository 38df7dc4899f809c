"""host_self_ms.transform.serve: host self ms of the transform span (nnaudio.transform.*) per call: params merge, input cast, padding and epilogue ops, in the device's traced stretch."""
from bench_port import spans


def read(ctx):
    return spans.self_ms_per_call(spans.device_stretch_table(), "nnaudio.transform.")
