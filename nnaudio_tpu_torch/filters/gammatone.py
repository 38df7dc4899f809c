"""Gammatone (ERB) filterbank construction — host side, NumPy.

Behavioral parity with the reference's vendored Ellis gammatone code at
nnAudio's ``librosa_functions.py:13-198``
(``fft2gammatonemx``, ``get_gammatone``): 4th-order gammatone magnitude
response sampled on the FFT bin unit circle, Slaney/MakeERBFilters constants.
"""
from __future__ import annotations

import numpy as np

# Slaney MakeERBFilters constants
_EAR_Q = 9.26449
_MIN_BW = 24.7
_ORDER = 1
_GT_ORD = 4


def gammatone_center_freqs(n_bins: int, fmin: float, fmax: float) -> np.ndarray:
    """ERB-spaced center frequencies, ascending, shape ``(n_bins,)``."""
    nfr = np.arange(n_bins, dtype=np.float64) + 1
    em = _EAR_Q * _MIN_BW
    cfreqs = (fmax + em) * np.exp(nfr * (-np.log(fmax + em) + np.log(fmin + em)) / n_bins) - em
    return cfreqs[::-1]


def fft_to_gammatone_weights(
    sr: float,
    n_fft: int,
    n_bins: int = 64,
    width: float = 1.0,
    fmin: float = 0.0,
    fmax: float = 11025,
    maxlen: int = 1024,
) -> tuple[np.ndarray, np.ndarray]:
    """Weights mapping FFT bins to gammatone bands, shape ``(n_bins, maxlen)``.

    Vectorized evaluation of the 4th-order gammatone transfer-function
    magnitude |H(e^{jw})| at each FFT bin frequency: poles at
    ``r*exp(±j*theta)`` (each repeated GTord times) and the four real zeros
    from the all-pole gammatone impulse-invariant discretization.
    """
    cfreqs = gammatone_center_freqs(n_bins, fmin, fmax)  # (n_bins,)

    n_half = n_fft // 2 + 1
    ucirc = np.exp(1j * 2 * np.pi * np.arange(n_half) / n_fft)  # (n_half,)

    erb = width * ((cfreqs / _EAR_Q) ** _ORDER + _MIN_BW ** _ORDER) ** (1.0 / _ORDER)
    b = 1.019 * 2 * np.pi * erb
    r = np.exp(-b / sr)
    theta = 2 * np.pi * cfreqs / sr
    pole = r * np.exp(1j * theta)  # (n_bins,)

    t = 1.0 / sr
    ebt = np.exp(b * t)
    cpt = 2 * cfreqs * np.pi * t
    ccpt = 2 * t * np.cos(cpt)
    scpt = 2 * t * np.sin(cpt)

    s_plus = np.sqrt(3 + 2 ** 1.5)
    s_minus = np.sqrt(3 - 2 ** 1.5)
    # the four real zeros of the impulse-invariant gammatone sections;
    # note the overall sign: librosa_functions.py:81 defines A1k as the
    # NEGATED half-sums and then zros = -A/T
    zros = np.stack(
        [
            (ccpt / ebt + s_plus * scpt / ebt) / 2,
            (ccpt / ebt - s_plus * scpt / ebt) / 2,
            (ccpt / ebt + s_minus * scpt / ebt) / 2,
            (ccpt / ebt - s_minus * scpt / ebt) / 2,
        ],
        axis=0,
    ) / t  # (4, n_bins)

    # DC gain of each band (product of the four first-order sections)
    ejw2 = np.exp(4j * cfreqs * np.pi * t)
    ejw = np.exp(-(b * t) + 2j * cfreqs * np.pi * t)
    cos_w = np.cos(2 * cfreqs * np.pi * t)
    sin_w = np.sin(2 * cfreqs * np.pi * t)
    sections = [
        -2 * ejw2 * t + 2 * ejw * t * (cos_w - s_minus * sin_w),
        -2 * ejw2 * t + 2 * ejw * t * (cos_w + s_minus * sin_w),
        -2 * ejw2 * t + 2 * ejw * t * (cos_w - s_plus * sin_w),
        -2 * ejw2 * t + 2 * ejw * t * (cos_w + s_plus * sin_w),
    ]
    denom = (
        -2 / np.exp(2 * b * t)
        - 2 * ejw2
        + 2 * (1 + ejw2) / np.exp(b * t)
    ) ** 4
    gain = np.abs(sections[0] * sections[1] * sections[2] * sections[3] / denom)

    pole_col = pole[:, None]
    zero_dists = np.prod(np.abs(ucirc[None, :] - zros[:, :, None]), axis=0)  # (n_bins, n_half)
    pole_factor = np.abs(
        ((pole_col - ucirc[None, :]) * (np.conj(pole_col) - ucirc[None, :])) ** -_GT_ORD
    )
    weights = (t ** 4 / gain[:, None]) * zero_dists * pole_factor  # (n_bins, n_half)

    full = np.zeros((n_bins, n_fft), dtype=np.float32)
    full[:, :n_half] = weights
    return full[:, :maxlen], cfreqs


def gammatone_filterbank(
    sr: float,
    n_fft: int,
    n_bins: int = 64,
    fmin: float = 20.0,
    fmax: float | None = None,
    dtype=np.float32,
) -> np.ndarray:
    """Gammatone filterbank of shape ``(n_bins, 1 + n_fft//2)``, scaled by 1/n_fft."""
    if fmax is None:
        fmax = float(sr) / 2
    weights, _ = fft_to_gammatone_weights(
        sr=sr, n_fft=n_fft, n_bins=int(n_bins), fmin=fmin, fmax=fmax,
        maxlen=n_fft // 2 + 1,
    )
    return ((1.0 / n_fft) * weights).astype(dtype)
