"""Least operations and bytes, and the least time they take on the H100.

A count reads the work the transform itself needs, whatever implements it,
so that a change of algorithm cannot read above 100%:

- a frozen Fourier basis counts a real FFT of each frame, 2.5 N log2 N;
- a frozen filterbank counts its nonzero entries (a multiply and an add
  each);
- a trainable basis counts the dense products: no FFT stands in for a
  learned basis;
- the constant-Q bank counts the lesser of the banded product over its
  nonzero entries and an FFT of each frame followed by the product with the
  sparse spectral kernel (:func:`sparse_spectral_nonzeros`);
- bytes count each input byte read once and each output byte written once.

Peaks: NVIDIA's data sheet for the H100 SXM, dense, at 700 W: 495 TFLOP/s in
TF32, the fastest rate that a float32-accurate route can draw on, and
3.35 TB/s of HBM3.
"""
from __future__ import annotations

import math

import numpy as np

PEAK_FLOPS = 495e12
PEAK_BYTES = 3.35e12
FLOAT32 = 4


def least_seconds(flops: float, nbytes: float) -> float:
    """The larger of the operations' and the bytes' least times."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def rfft_flops(n: int) -> float:
    """Operations of a real FFT of ``n`` samples."""
    return 2.5 * n * math.log2(n)


def nonzeros(a: np.ndarray) -> int:
    return int(np.count_nonzero(a))


def frames(length: int, n: int, hop: int, center: bool) -> int:
    """Frames of a signal of ``length`` samples, centred by ``n // 2`` on each
    side or not."""
    padded = length + 2 * (n // 2) if center else length
    return max(0, (padded - n) // hop + 1)


def sparse_spectral_nonzeros(kernels: np.ndarray, quantile: float = 0.01) -> int:
    """Nonzero entries of the spectral kernel of a complex wavelet bank
    ``(n_bins, width)`` sparsified as librosa's ``util.sparsify_rows`` does
    for its CQT (``sparsity=0.01``): the one-sided FFT of each wavelet, in
    each row of which the smallest magnitudes whose running sum stays below
    ``quantile`` of the row's L1 norm are dropped."""
    width = kernels.shape[1]
    mags = np.abs(np.fft.fft(kernels, axis=1))[:, :width // 2 + 1]
    keep = 0
    for row in mags:
        order = np.sort(row)
        cum = np.cumsum(order) / order.sum()
        keep += row.size - int(np.searchsorted(cum, quantile, side="left"))
    return keep
