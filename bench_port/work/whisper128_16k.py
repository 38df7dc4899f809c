"""Least work of the ``whisper128_16k`` cell's calls and kernels.

``least(part, loop, shape, s)`` gives ``(operations, bytes)`` of one offline
call of ``(B, L)`` samples, else None. ``s`` is the configuration's
``settings``.

- ``K2``: a frozen Fourier basis (a real FFT of each frame), ``|X|^2`` (3
  operations a bin) and the frozen mel filterbank's nonzero entries (a
  multiply and an add each); the signal read once and the ``(B, M, T)`` mel
  written once (at 32 x 30 s: 110.6 MB, 33 us at 3.35 TB/s: bytes bound it).
- ``call``: K2's operations and the epilogue's on the kept frames
  (:data:`EPILOGUE_FLOPS` an output entry: the clamp, the log, the max, the
  floor, the affine map); the signal read once and the kept log-Mel
  ``(B, M, T - 1)`` written once.
"""
from __future__ import annotations

import functools

from ..reference import builders
from .counts import FLOAT32, frames, nonzeros, rfft_flops

#: operations an output entry after the projection: clamp, log10, the clip's
#: max, the floor's maximum, + 4 and / 4
EPILOGUE_FLOPS = 6


@functools.lru_cache(maxsize=None)
def _mel_nonzeros(sr, n_fft, n_mels, fmin, fmax, htk, norm) -> int:
    return nonzeros(builders.mel_filterbank(sr, n_fft, n_mels, fmin, fmax, htk, norm))


def frame_flops(s) -> float:
    """Least operations of one frame: its real FFT, the power and the
    filterbank's nonzero entries."""
    nz = _mel_nonzeros(s["sr"], s["n_fft"], s["n_mels"], s["fmin"], s["fmax"], s["htk"],
                       s["norm"])
    return rfft_flops(s["n_fft"]) + 3 * (s["n_fft"] // 2 + 1) + 2 * nz


def least(part: str, loop: str, shape: tuple, s: dict):
    if loop != "offline" or part not in ("call", "K2"):
        return None
    b, length = shape
    m = s["n_mels"]
    t = frames(length, s["n_fft"], s["hop_length"], s["center"])
    if part == "K2":
        return b * t * frame_flops(s), FLOAT32 * b * (length + m * t)
    kept = b * m * (t - 1)
    return b * t * frame_flops(s) + EPILOGUE_FLOPS * kept, FLOAT32 * (b * length + kept)
