"""kernels_per_step.synth: device kernels launched under the synthesis stream's step (nnaudio.stream.step.StreamingiSTFT in the launching chain: K3, the operand copies, the envelope, the carry, the division), per step, in the host's traced stretch; nothing where no launch ran under that span."""
from bench_port import spans

STEP = "nnaudio.stream.step.StreamingiSTFT"


def read(ctx):
    if ctx.trace is None or not any(STEP in launch.chain for launch in ctx.trace.launches):
        return None
    return spans.kernels_per_call(ctx, STEP)
