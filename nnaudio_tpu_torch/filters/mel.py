"""Mel filterbank construction — host side, NumPy.

Behavioral parity with the librosa-0.7 filter code vendored by the reference at
nnAudio's ``librosa_functions.py`` (``hz_to_mel:250``,
``mel_to_hz:201``, ``fft_frequencies:301``, ``mel_frequencies:323``,
``get_mel:375``): Slaney mel scale by default, HTK optional, area (norm=1)
normalization.
"""
from __future__ import annotations

import warnings

import numpy as np

# Slaney auditory-toolbox mel-scale constants
_F_SP = 200.0 / 3
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(frequencies, htk: bool = False) -> np.ndarray:
    f = np.asanyarray(frequencies, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    mels = f / _F_SP
    log_region = f >= _MIN_LOG_HZ
    mels = np.where(
        log_region,
        _MIN_LOG_MEL + np.log(np.maximum(f, _MIN_LOG_HZ) / _MIN_LOG_HZ) / _LOGSTEP,
        mels,
    )
    return mels


def mel_to_hz(mels, htk: bool = False) -> np.ndarray:
    m = np.asanyarray(mels, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    freqs = _F_SP * m
    log_region = m >= _MIN_LOG_MEL
    freqs = np.where(
        log_region,
        _MIN_LOG_HZ * np.exp(_LOGSTEP * (np.maximum(m, _MIN_LOG_MEL) - _MIN_LOG_MEL)),
        freqs,
    )
    return freqs


def fft_frequencies(sr: float = 22050, n_fft: int = 2048) -> np.ndarray:
    return np.linspace(0, float(sr) / 2, 1 + n_fft // 2, endpoint=True)


def mel_frequencies(
    n_mels: int = 128, fmin: float = 0.0, fmax: float = 11025.0, htk: bool = False
) -> np.ndarray:
    mels = np.linspace(hz_to_mel(fmin, htk), hz_to_mel(fmax, htk), n_mels)
    return mel_to_hz(mels, htk)


def mel_filterbank(
    sr: float,
    n_fft: int,
    n_mels: int = 128,
    fmin: float = 0.0,
    fmax: float | None = None,
    htk: bool = False,
    norm=1,
    dtype=np.float32,
) -> np.ndarray:
    """Triangular mel filterbank of shape ``(n_mels, 1 + n_fft//2)``."""
    if fmax is None:
        fmax = float(sr) / 2
    if norm is not None and norm != 1 and norm != np.inf:
        raise ValueError(f"Unsupported norm: {norm!r}")

    n_mels = int(n_mels)
    fftfreqs = fft_frequencies(sr=sr, n_fft=n_fft)
    mel_f = mel_frequencies(n_mels + 2, fmin=fmin, fmax=fmax, htk=htk)

    fdiff = np.diff(mel_f)
    # ramps[i, j] = mel_f[i] - fftfreqs[j]
    ramps = mel_f[:, None] - fftfreqs[None, :]

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    if norm == 1:
        # Slaney-style area normalization: constant energy per channel
        enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
        weights = weights * enorm[:, None]

    if not np.all((mel_f[:-2] == 0) | (weights.max(axis=1) > 0)):
        warnings.warn(
            "Empty filters detected in mel frequency basis. "
            "Some channels will produce empty responses. "
            "Try increasing your sampling rate (and fmax) or reducing n_mels."
        )
    return weights.astype(dtype)


def dct_matrix(n_out: int, n_in: int, norm: str | None = "ortho", dtype=np.float32) -> np.ndarray:
    """DCT-II basis of shape ``(n_out, n_in)`` applied as a matmul.

    Equivalent to the FFT-trick DCT in the reference MFCC (``mel.py:281-307``)
    but expressed as an explicit basis: one dense
    ``(n_mels, n_mels)`` product that makes the DCT trivially trainable.
    """
    n = np.arange(n_in, dtype=np.float64)
    k = np.arange(n_out, dtype=np.float64)
    basis = np.cos(np.pi * k[:, None] * (2 * n[None, :] + 1) / (2 * n_in))
    # mirror the reference normalization flow (mel.py:301-305): optional ortho
    # scaling followed by an unconditional factor of 2 — together this equals
    # the standard orthonormal DCT-II
    if norm == "ortho":
        basis[0] /= np.sqrt(n_in) * 2
        basis[1:] /= np.sqrt(n_in / 2) * 2
    basis = 2.0 * basis
    return basis.astype(dtype)
