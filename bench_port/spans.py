"""What the readers of the port's own spans share.

While a profiler runs, ``nnaudio_tpu_torch`` opens spans on its host path
(``nnaudio.transform.*``, ``nnaudio.wrap.K*``, ``nnaudio.launch.K*``,
``nnaudio.stream.*``, ``nnaudio.train.*``) and keeps a table of them per
profiler session (``nnaudio_tpu_torch.utils.profiling.span_table``). The
table's readers read the device's traced stretch, the first of the two
sessions that ``trace.traced`` opens: it traces no host operations, so the
profiler's cost per operation is not in the self times. Each normalises by
the count of the session's outermost port spans (one per call or step).
The readers of the host's stretch read the idle gaps and the launching
chains there. A port without spans gives None throughout.
"""
from __future__ import annotations

PREFIX = "nnaudio."
#: the sessions of a traced run (``trace.traced``): the device's stretch,
#: then the host's
TRACED_SESSIONS = 2


def device_stretch_table():
    """The port's span table of the device's traced stretch, or None."""
    try:
        from nnaudio_tpu_torch.utils.profiling import span_sessions, span_table
    except ImportError:
        return None
    if span_sessions() < TRACED_SESSIONS:
        return None
    return span_table(-TRACED_SESSIONS)


def _calls(table) -> int:
    return sum(r.outer for r in table.values()) if table else 0


def self_ms_per_call(table, prefix: str):
    """Host self ms of the spans whose name starts with ``prefix``, per
    outermost port span."""
    calls = _calls(table)
    if not calls:
        return None
    return 1e-6 * sum(r.self_ns for name, r in table.items()
                      if name.startswith(prefix)) / calls


def copy_mb_per_call(table):
    """Operand-copy MB (1e6 bytes) per outermost port span."""
    calls = _calls(table)
    if not calls:
        return None
    return 1e-6 * sum(r.copy_bytes for r in table.values()) / calls


def _host_stretch(ctx):
    """The traced run's host stretch where its launches ran under port
    spans, else None."""
    t = ctx.trace
    if t is None or not t.host_stats.get("attempted"):
        return None
    if not any(c.startswith(PREFIX) for launch in t.launches for c in launch.chain):
        return None
    return t


def idle_ms_per_call(ctx):
    """Device idle ms of the host's stretch while the host's innermost
    operation was a port span (its own Python), per call."""
    t = _host_stretch(ctx)
    if t is None:
        return None
    idle = sum(s for label, s in t.idle_by_host if label.startswith(PREFIX))
    return 1e3 * idle / t.host_stats["attempted"]


def kernels_per_call(ctx, span_name: str):
    """Kernels of the host's stretch whose launching chain holds the span
    ``span_name``, per call."""
    t = _host_stretch(ctx)
    if t is None:
        return None
    return sum(span_name in launch.chain for launch in t.launches) / t.host_stats["attempted"]
