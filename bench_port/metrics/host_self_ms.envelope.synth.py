"""host_self_ms.envelope.synth: host self ms of the synthesis stream's window envelope, recomputed each step (nnaudio.stream.envelope: window_sumsquare) per step, in the device's traced stretch; a step counts each outermost port span, the flush that ends a stream's last step included."""
from bench_port import spans

STEP = "nnaudio.stream.step.StreamingiSTFT"


def read(ctx):
    table = spans.device_stretch_table()
    if not table or STEP not in table:
        return None
    return spans.self_ms_per_call(table, "nnaudio.stream.envelope")
