"""Chroma filterbank — host side, NumPy.

The reference vendors this filter code (nnAudio's ``librosa_functions.py:573-716``) but
never exposes a feature class for it; we build the bank here and expose a
``ChromaSTFT`` feature on top (a capability the reference left unplumbed).
"""
from __future__ import annotations

import numpy as np


def hz_to_octs(frequencies, tuning: float = 0.0, bins_per_octave: int = 12) -> np.ndarray:
    a440 = 440.0 * 2.0 ** (tuning / bins_per_octave)
    return np.log2(np.asanyarray(frequencies) / (a440 / 16))


def _lp_normalize(w: np.ndarray, norm, axis: int) -> np.ndarray:
    """librosa-style normalize with the default threshold semantics."""
    mag = np.abs(w).astype(np.float64)
    if norm is None:
        return w
    if norm == np.inf:
        length = mag.max(axis=axis, keepdims=True)
    elif norm == -np.inf:
        length = mag.min(axis=axis, keepdims=True)
    elif norm == 0:
        length = (mag > 0).sum(axis=axis, keepdims=True).astype(np.float64)
    elif np.issubdtype(type(norm), np.number) and norm > 0:
        length = (mag ** norm).sum(axis=axis, keepdims=True) ** (1.0 / norm)
    else:
        raise ValueError(f"Unsupported norm: {norm!r}")
    tiny = np.finfo(np.float32).tiny
    length = np.where(length < tiny, 1.0, length)
    return w / length


def chroma_filterbank(
    sr: float,
    n_fft: int,
    n_chroma: int = 12,
    tuning: float = 0.0,
    ctroct: float = 5.0,
    octwidth: float | None = 2,
    norm=2,
    base_c: bool = True,
    dtype=np.float32,
) -> np.ndarray:
    """Chroma projection matrix of shape ``(n_chroma, 1 + n_fft//2)``."""
    frequencies = np.linspace(0, sr, n_fft, endpoint=False)[1:]
    frqbins = n_chroma * hz_to_octs(frequencies, tuning=tuning, bins_per_octave=n_chroma)
    # synthetic 0 Hz bin 1.5 octaves below bin 1 so chroma is 50% rotated with
    # a broad bin width
    frqbins = np.concatenate(([frqbins[0] - 1.5 * n_chroma], frqbins))
    binwidthbins = np.concatenate((np.maximum(frqbins[1:] - frqbins[:-1], 1.0), [1]))

    d = (frqbins[None, :] - np.arange(n_chroma, dtype=np.float64)[:, None])
    n_chroma2 = np.round(n_chroma / 2.0)
    d = np.remainder(d + n_chroma2 + 10 * n_chroma, n_chroma) - n_chroma2

    wts = np.exp(-0.5 * (2 * d / binwidthbins[None, :]) ** 2)
    wts = _lp_normalize(wts, norm=norm, axis=0)

    if octwidth is not None:
        wts *= np.exp(-0.5 * (((frqbins / n_chroma - ctroct) / octwidth) ** 2))[None, :]
    if base_c:
        wts = np.roll(wts, -3 * (n_chroma // 12), axis=0)

    return np.ascontiguousarray(wts[:, : 1 + n_fft // 2], dtype=dtype)
