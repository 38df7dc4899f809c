"""db_ms_per_call.whisper: device ms per call of the kernels launched under the port's nnaudio.db span (power_to_db: the clamp, the log, the clip's max, the floor) and of nothing else, in the host's traced stretch; nothing where no launch ran under that span."""

SPAN = "nnaudio.db"


def read(ctx):
    t = ctx.trace
    if t is None or not t.host_stats.get("attempted"):
        return None
    seconds = sum(launch.seconds for launch in t.launches if SPAN in launch.chain)
    return 1e3 * seconds / t.host_stats["attempted"] if seconds > 0 else None
