"""Least work of the ``cqt84_22k`` cells' calls and kernels.

``least(part, loop, shape, s)`` gives ``(operations, bytes)`` of one offline
call of ``(B, L)`` samples (``part`` ``call`` or ``K6``), else None. A frame
costs the lesser of two routes to its ``n_bins`` complex products:

- banded: a multiply and an add for each nonzero entry of the wavelet
  bank's real and imaginary parts;
- through the spectrum: a real FFT of the frame (``width`` samples), then a
  complex multiply-add (8 operations) for each nonzero entry of the sparse
  spectral kernel (``counts.sparse_spectral_nonzeros``);

then the magnitude and librosa's scale, 4 operations a bin. The signal is
read once and the magnitudes written once.
"""
from __future__ import annotations

import functools

from ..reference import builders
from .counts import FLOAT32, frames, nonzeros, rfft_flops, sparse_spectral_nonzeros


@functools.lru_cache(maxsize=None)
def frame_flops(sr, fmin, n_bins, bins_per_octave, filter_scale, norm, window):
    """(least operations of one frame, banded route's, spectral route's, width)."""
    kernels, _ = builders.cqt_bank(sr, fmin, n_bins, bins_per_octave,
                                   filter_scale, norm, window)
    width = kernels.shape[1]
    banded = 2.0 * (nonzeros(kernels.real) + nonzeros(kernels.imag))
    spectral = rfft_flops(width) + 8.0 * sparse_spectral_nonzeros(kernels)
    return min(banded, spectral) + 4 * n_bins, banded, spectral, width


def least(part: str, loop: str, shape: tuple, s: dict):
    if loop != "offline" or part not in ("call", "K6"):
        return None
    per_frame, _, _, width = frame_flops(s["sr"], s["fmin"], s["n_bins"],
                                         s["bins_per_octave"], s["filter_scale"],
                                         s["norm"], s["window"])
    b, length = shape
    t = frames(length, width, s["hop_length"], s["center"])
    return b * t * per_frame, FLOAT32 * b * (length + s["n_bins"] * t)
