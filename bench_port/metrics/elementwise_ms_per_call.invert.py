"""elementwise_ms_per_call.invert: device ms per call in ATen's elementwise kernels (the Griffin-Lim update, the NNLS steps' subtraction, step and relu, the envelope's division), in the device's traced stretch; the copy kernels (direct_copy, such as K3's wrapper copying its spectra) are left out, since operand_copy_mb_per_call.serve reads those."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.stats.get("attempted"):
        return None
    seconds = sum(s for name, s in t.kernel_s.items()
                  if "elementwise_kernel" in name and "direct_copy" not in name)
    return 1e3 * seconds / t.stats["attempted"] if seconds > 0 else None
