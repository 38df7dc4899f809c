"""operand_copy_mb_per_call.serve: MB of the new tensors the kernel wrappers made from their operands, per call, in the device's traced stretch."""
from bench_port import spans


def read(ctx):
    return spans.copy_mb_per_call(spans.device_stretch_table())
