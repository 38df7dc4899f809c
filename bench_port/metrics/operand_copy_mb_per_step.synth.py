"""operand_copy_mb_per_step.synth: MB of the new tensors that K3's wrapper made from its operands (the strided spectra made contiguous, the transposed bases), per step, in the device's traced stretch; a step counts each outermost port span."""
from bench_port import spans

STEP = "nnaudio.stream.step.StreamingiSTFT"


def read(ctx):
    table = spans.device_stretch_table()
    if not table or STEP not in table:
        return None
    return spans.copy_mb_per_call(table)
