"""fft_route_pct.serve: 100 x K2's dispatches on its FFT route / all K2 dispatches, in the device's traced stretch (the port's nnaudio.route.K2.* rows)."""
from bench_port import spans

ROUTES = ("nnaudio.route.K2.fft", "nnaudio.route.K2.dense")


def read(ctx):
    table = spans.device_stretch_table() or {}
    fft, dense = (table[r].count if r in table else 0 for r in ROUTES)
    return 100.0 * fft / (fft + dense) if fft + dense else None
