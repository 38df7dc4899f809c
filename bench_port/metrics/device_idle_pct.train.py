"""device_idle_pct.train: the device's idle share of the traced stretch."""
from bench_port.reduce import idle_pct


def read(ctx):
    return idle_pct(ctx)
