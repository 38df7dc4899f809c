"""Windowed Fourier (sin/cos) basis construction — host side, NumPy.

Builds the explicit-DFT bases every STFT-family transform applies on device.
Behavioral parity with ``create_fourier_kernels`` at
nnAudio's ``utils.py:241-393``: four frequency
scales (linear / log / log2 / no), fmin/fmax-controlled bin placement, and a
window mask padded (centered) to ``n_fft`` when ``win_length < n_fft``.

Implementation is vectorized (outer products over a frequency vector) rather
than the reference's per-bin Python loop — same math, matmul-shaped output.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .windows import pad_center, window_dispatch


@dataclass(frozen=True)
class FourierBasis:
    """Host-side result of Fourier basis construction.

    ``wsin``/``wcos`` have shape ``(freq_bins, n_fft)`` (no singleton conv
    channel axis — the device path is a matmul, not conv1d).
    """

    wsin: np.ndarray
    wcos: np.ndarray
    bins2freq: list = field(default_factory=list)
    binslist: list = field(default_factory=list)
    window_mask: np.ndarray | None = None


def fourier_bin_positions(
    n_fft: int,
    freq_bins: int,
    fmin: float,
    fmax: float,
    sr: float,
    freq_scale: str,
) -> np.ndarray:
    """Normalized DFT bin index ``k`` for each output bin, per frequency scale."""
    k = np.arange(freq_bins, dtype=np.float64)
    if freq_scale == "linear":
        start_bin = fmin * n_fft / sr
        scaling = (fmax - fmin) * (n_fft / sr) / freq_bins
        return k * scaling + start_bin
    if freq_scale == "log":
        start_bin = fmin * n_fft / sr
        scaling = np.log(fmax / fmin) / freq_bins
        return np.exp(k * scaling) * start_bin
    if freq_scale == "log2":
        start_bin = fmin * n_fft / sr
        scaling = np.log2(fmax / fmin) / freq_bins
        return 2 ** (k * scaling) * start_bin
    if freq_scale == "no":
        return k
    raise ValueError(
        f"freq_scale must be 'linear', 'log', 'log2' or 'no'; got {freq_scale!r}"
    )


def create_fourier_basis(
    n_fft: int,
    win_length: int | None = None,
    freq_bins: int | None = None,
    fmin: float = 50,
    fmax: float = 6000,
    sr: float = 44100,
    freq_scale: str = "no",
    window: str = "hann",
) -> FourierBasis:
    """Create sin/cos DFT bases of shape ``(freq_bins, n_fft)`` plus window mask.

    ``wcos[k, s] = cos(2*pi*pos_k*s/n_fft)`` and likewise for ``wsin`` —
    identical math to utils.py:319-384, with bins placed by ``freq_scale``.
    """
    if freq_bins is None:
        freq_bins = n_fft // 2 + 1
    if win_length is None:
        win_length = n_fft

    if window == "ones":
        # rectangular window used by the CQT1992/CQT2010 Fourier stage
        # (utils.py:241 called with window="ones"); explicit so we don't
        # depend on scipy's "ones" -> boxcar aliasing
        window_mask = np.ones(int(win_length), dtype=np.float64)
    else:
        window_mask = window_dispatch(window, int(win_length), fftbins=True)
    window_mask = pad_center(window_mask, n_fft)

    pos = fourier_bin_positions(n_fft, freq_bins, fmin, fmax, sr, freq_scale)
    s = np.arange(n_fft, dtype=np.float64)
    phase = 2 * np.pi * pos[:, None] * s[None, :] / n_fft
    wsin = np.sin(phase)
    wcos = np.cos(phase)

    bins2freq = (pos * sr / n_fft).tolist()
    return FourierBasis(
        wsin=wsin.astype(np.float32),
        wcos=wcos.astype(np.float32),
        bins2freq=bins2freq,
        binslist=pos.tolist(),
        window_mask=window_mask.astype(np.float32),
    )
