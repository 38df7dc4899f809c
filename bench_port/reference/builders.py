"""Frozen copies of the basis builders, in float64 NumPy.

The reference builds its own bases from a configuration's settings with
these functions; it takes no basis from the program under test. They follow
the published definitions the program follows as well:

- the periodic Hann window (``scipy.signal.get_window('hann', n,
  fftbins=True)``), centred in ``n_fft`` when shorter;
- the windowed DFT basis ``w[k, s] = window[s] * cos / sin(2 pi k s / n_fft)``
  for ``k = 0 .. n_fft // 2`` (``freq_scale='no'``);
- the Slaney mel filterbank of librosa 0.7 (``htk=False``, area
  normalisation ``norm=1``) or the HTK mel scale;
- the constant-Q wavelet bank of nnAudio's ``create_cqt_kernels``:
  ``l_k = ceil(Q sr / f_k)``, a Hann window of ``l_k`` samples times
  ``exp(2 pi i f_k t / sr) / l_k``, L1-normalised, centred in a power-of-two
  width (odd lengths one sample left of centre).
"""
from __future__ import annotations

import numpy as np
from scipy.signal import get_window


def window(name: str, n: int) -> np.ndarray:
    return np.asarray(get_window(name, n, fftbins=True), dtype=np.float64)


def pad_center(data: np.ndarray, size: int) -> np.ndarray:
    lpad = (size - data.shape[-1]) // 2
    return np.pad(data, (lpad, size - data.shape[-1] - lpad))


def fourier_basis(n_fft: int, win: str = "hann", win_length: int | None = None):
    """``(wcos, wsin)``, each ``(n_fft // 2 + 1, n_fft)`` float64, windowed."""
    w = pad_center(window(win, win_length or n_fft), n_fft)
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)[:, None]
    s = np.arange(n_fft, dtype=np.float64)[None, :]
    phase = 2 * np.pi * k * s / n_fft
    return np.cos(phase) * w, np.sin(phase) * w


def _hz_to_mel(f, htk):
    f = np.asarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_hz / f_sp + np.log(np.maximum(f, min_log_hz) / min_log_hz) / logstep,
                    f / f_sp)


def _mel_to_hz(m, htk):
    m = np.asarray(m, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (np.maximum(m, min_log_mel) - min_log_mel)),
                    f_sp * m)


def mel_filterbank(sr: float, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: float | None = None, htk: bool = False, norm=1) -> np.ndarray:
    """``(n_mels, n_fft // 2 + 1)`` float64 triangular filters."""
    fmax = sr / 2 if fmax is None else fmax
    fftfreqs = np.linspace(0, sr / 2, 1 + n_fft // 2)
    mel_f = _mel_to_hz(np.linspace(_hz_to_mel(fmin, htk), _hz_to_mel(fmax, htk),
                                   n_mels + 2), htk)
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    if norm == 1:
        weights *= (2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels]))[:, None]
    return weights


def cqt_bank(sr: float, fmin: float, n_bins: int, bins_per_octave: int,
             filter_scale: float = 1.0, norm=1, win: str = "hann"):
    """``(kernels, lengths)``: complex128 ``(n_bins, width)`` wavelets and
    their float64 lengths; ``width`` is a power of two."""
    q = float(filter_scale) / (2 ** (1 / bins_per_octave) - 1)
    freqs = fmin * 2.0 ** (np.arange(n_bins) / float(bins_per_octave))
    if freqs.max() > sr / 2:
        raise ValueError("the top bin lies above the Nyquist frequency")
    lengths = np.ceil(q * sr / freqs)
    width = int(2 ** np.ceil(np.log2(int(lengths.max()))))
    kernels = np.zeros((n_bins, width), dtype=np.complex128)
    for k, (f, n) in enumerate(zip(freqs, lengths)):
        start = int(np.ceil(width / 2.0 - n / 2.0)) - (1 if n % 2 == 1 else 0)
        t = np.r_[-n // 2: n // 2]
        sig = window(win, int(n)) * np.exp(t * 1j * 2 * np.pi * f / sr) / n
        if norm:
            sig = sig / np.linalg.norm(sig, norm)
        kernels[k, start:start + int(n)] = sig
    return kernels, lengths
