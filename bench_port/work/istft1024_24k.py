"""Least work of the ``istft1024_24k`` cell's stream steps and kernels.

``least(part, loop, shape, s)`` gives ``(operations, bytes)`` of one step of
the synthesis stream, or None where the part does no work in that loop.
``s`` is the configuration's ``settings``; ``shape`` is ``(B, T, emitted,
first, last)``: ``B`` streams of ``T`` frames, ``emitted`` samples a stream
returned (the last step's ``flush`` included), and whether the step was a
stream's first (no tail to read) or its last (no tail to write). The work is
what any implementation needs:

- ``step``: an inverse real FFT of each frame (2.5 N log2 N), ``N`` adds of
  the overlap-add a frame, the envelope's division a sample emitted; the
  spectra read once, the samples written once, the overlap-add tail
  (``N - hop`` samples a stream) read and written once.
- ``K3``, one launch a step: the same inverse FFTs and overlap-add; its
  spectra in and its overlap-added block (``N + hop (T - 1)`` samples a
  stream) out.
"""
from __future__ import annotations

from .counts import FLOAT32, rfft_flops


def least(part: str, loop: str, shape: tuple, s: dict):
    if loop != "synth":
        return None
    b, t, emitted, first, last = shape
    n, hop = s["n_fft"], s["hop_length"]
    spectra = FLOAT32 * 2 * b * (n // 2 + 1) * t
    frames = b * t * (rfft_flops(n) + n)
    if part == "K3":
        return frames, spectra + FLOAT32 * b * (n + hop * (t - 1))
    if part == "step":
        tails = (not first) + (not last)
        return frames + b * emitted, spectra + FLOAT32 * b * (emitted + tails * (n - hop))
    return None
