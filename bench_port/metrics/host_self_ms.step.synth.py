"""host_self_ms.step.synth: host self ms of the synthesis stream's step's own Python (nnaudio.stream.step.StreamingiSTFT less its child spans: the checks, the dispatch to K3's wrapper, the envelope's division) per step, in the device's traced stretch; a step counts each outermost port span, the flush that ends a stream's last step included."""
from bench_port import spans

STEP = "nnaudio.stream.step.StreamingiSTFT"


def read(ctx):
    table = spans.device_stretch_table()
    if not table or STEP not in table:
        return None
    return spans.self_ms_per_call(table, "nnaudio.stream.step.StreamingiSTFT")
