"""Least work of the ``mel128_22k`` cells' calls, steps and kernels.

``least(part, loop, shape, s)`` gives ``(operations, bytes)`` for one call,
or None where the part does no work in that loop. ``s`` is the
configuration's ``settings``; ``shape`` is ``(B, L)`` for an offline call or
a train step and ``(B, C, carried)`` for a stream step of a ``C``-sample
chunk after ``carried`` samples were held over.

- ``call`` / ``K2`` (offline), ``step`` / ``K2`` (stream): a frozen Fourier
  basis (a real FFT of each frame), ``|X|^2`` (3 operations a bin) and the
  frozen mel filterbank's nonzero entries; the input signal (plus, for a
  stream, the carried samples) read once, the spectrogram written once, and
  for the step the new carry written.
- ``step`` (train): the dense products of a trainable basis: the pair
  forward (``2 x 2 B T F N``), its two weight gradients (the same), and the
  mel projection with its two gradients (``3 x 2 B T M F``); the batch, and
  the parameters read and written once. ``K5``: the pair; ``dw_gemm``: the
  two weight-gradient products, each with the operands and results it needs.
"""
from __future__ import annotations

import functools

from ..reference import builders
from .counts import FLOAT32, frames, nonzeros, rfft_flops


@functools.lru_cache(maxsize=None)
def _mel_nonzeros(sr, n_fft, n_mels, fmin, fmax, htk, norm) -> int:
    return nonzeros(builders.mel_filterbank(sr, n_fft, n_mels, fmin, fmax, htk, norm))


def _frozen_frame_flops(s) -> float:
    f = s["n_fft"] // 2 + 1
    nz = _mel_nonzeros(s["sr"], s["n_fft"], s["n_mels"], s["fmin"], s["fmax"],
                       s["htk"], s["norm"])
    return rfft_flops(s["n_fft"]) + 3 * f + 2 * nz


def least(part: str, loop: str, shape: tuple, s: dict):
    n, hop, m = s["n_fft"], s["hop_length"], s["n_mels"]
    f = n // 2 + 1
    if loop == "offline" and part in ("call", "K2"):
        b, length = shape
        t = frames(length, n, hop, s["center"])
        return b * t * _frozen_frame_flops(s), FLOAT32 * b * (length + m * t)
    if loop == "stream" and part in ("step", "K2"):
        b, c, carried = shape
        t = frames(carried + c, n, hop, False)
        carry_out = carried + c - t * hop
        nbytes = FLOAT32 * b * (carried + c + m * t)
        if part == "step":
            nbytes += FLOAT32 * b * carry_out
        return b * t * _frozen_frame_flops(s), nbytes
    if loop == "train":
        b, length = shape
        t = frames(length, n, hop, s["center"])
        pair = 2 * (2.0 * b * t * f * n)
        spectra = FLOAT32 * 2 * b * f * t  # re and im, or their cotangents
        if part == "K5":
            return pair, FLOAT32 * (b * length + 2 * f * n) + spectra
        if part == "dw_gemm":
            return pair, FLOAT32 * (b * length + 2 * f * n) + spectra
        if part == "step":
            c = s["n_classes"]
            mel = 3 * (2.0 * b * t * m * f)
            head = 3 * (2.0 * b * m * c)
            params = 2 * f * n + m * f + m * c + c
            return 2 * pair + mel + head, FLOAT32 * (b * length + 2 * params)
    return None
