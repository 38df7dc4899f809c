"""The arithmetic that the per-layer readers share: a share of the least
time, a host time per call, the device's idle share."""
from __future__ import annotations


def roofline_pct(ctx, part: str, device_s: float, host_stretch: bool = False):
    """100 x the least time of ``part`` over the calls of a traced stretch
    (the device's, or the host's) / the device seconds it took there; None
    where nothing was traced or launched."""
    if ctx.trace is None or device_s <= 0:
        return None
    stats = ctx.trace.host_stats if host_stretch else ctx.trace.stats
    least = ctx.least_seconds(part, stats["shapes"])
    return None if least is None else 100.0 * least / device_s


def mfu_pct(ctx, part: str):
    """100 x the least time of the window's calls / the window's wall time."""
    least = ctx.least_seconds(part, ctx.window["shapes"])
    return None if least is None else 100.0 * least / ctx.window["seconds"]


def host_ms(ctx):
    """Host milliseconds from a call's start until it returns, before the
    synchronisation, averaged over the window's calls."""
    return 1e3 * ctx.window["host_s"] / ctx.window["attempted"]


def idle_pct(ctx):
    """The device's idle share of the device's traced stretch."""
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
