"""gl_fft_route_pct.invert: 100 x K4's dispatches on its FFT route / all K4 dispatches (the Griffin-Lim steps: the FFT route, the tensor-core K4, the pair and the update), in the device's traced stretch (the port's nnaudio.route.K4.* rows)."""
from bench_port import spans

PREFIX = "nnaudio.route.K4."


def read(ctx):
    table = spans.device_stretch_table() or {}
    every = sum(r.count for name, r in table.items() if name.startswith(PREFIX))
    fft = table[PREFIX + "fft"].count if PREFIX + "fft" in table else 0
    return 100.0 * fft / every if every else None
