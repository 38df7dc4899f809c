"""nnls_route_pct.invert: 100 x the inverse Mel's NNLS dispatches that took the NNLS kernel / all its dispatches (the kernel and the dense products), in the device's traced stretch (the port's nnaudio.route.NNLS.* rows)."""
from bench_port import spans

PREFIX = "nnaudio.route.NNLS."


def read(ctx):
    table = spans.device_stretch_table() or {}
    every = sum(r.count for name, r in table.items() if name.startswith(PREFIX))
    fused = table[PREFIX + "fused"].count if PREFIX + "fused" in table else 0
    return 100.0 * fused / every if every else None
