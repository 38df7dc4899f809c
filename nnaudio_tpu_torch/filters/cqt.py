"""CQT/VQT wavelet kernel construction and resampling calculus — host side, NumPy.

A copy of the JAX package's ``filters/cqt.py``, kept here so the port imports
nothing of ``nnaudio_tpu``. Behavioral parity with nnAudio's kernel generators:
- ``create_cqt_kernels`` (log-spaced complex wavelets, centered and zero-padded
  to a power-of-two length, L1/L2 normalized, variable-Q ``gamma``):
  nnAudio's ``utils.py:399-473``
- ``create_lowpass_filter`` (firwin2 FIR): ``utils.py:562-596``
- early-downsample arithmetic (from librosa CQT): ``utils.py:599-677``
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from scipy.signal import firwin2

from .windows import window_dispatch


@dataclass(frozen=True)
class CQTKernelBank:
    """Complex CQT wavelets: ``kernels`` shape ``(n_bins, fft_len)``."""

    kernels: np.ndarray  # complex64
    fft_len: int
    lengths: np.ndarray  # float32, per-bin window lengths
    freqs: np.ndarray  # float64, per-bin center frequencies (Hz)


def cqt_frequencies(fmin: float, n_bins: int, bins_per_octave: int) -> np.ndarray:
    return fmin * 2.0 ** (np.arange(n_bins) / float(bins_per_octave))


def create_cqt_kernels(
    Q: float,
    fs: float,
    fmin: float,
    n_bins: int = 84,
    bins_per_octave: int = 12,
    norm: float = 1,
    window="hann",
    fmax: float | None = None,
    topbin_check: bool = True,
    gamma: float = 0,
) -> CQTKernelBank:
    """Create time-domain complex CQT wavelets, centered in a pow2 FFT length.

    Per-bin length ``ceil(Q*fs/(freq + gamma/alpha))``; odd-length kernels are
    shifted one sample left of center (utils.py:458-461); each wavelet is
    ``window * exp(j*2*pi*freq*t/fs)/l``, optionally Lp-normalized.
    """
    if fmax is not None and n_bins is None:
        n_bins = int(np.ceil(bins_per_octave * np.log2(fmax / fmin)))
    elif fmax is not None and n_bins is not None:
        import warnings

        warnings.warn("If fmax is given, n_bins will be ignored", SyntaxWarning)
        n_bins = int(np.ceil(bins_per_octave * np.log2(fmax / fmin)))
    n_bins = int(n_bins)
    freqs = cqt_frequencies(fmin, n_bins, bins_per_octave)

    if topbin_check and np.max(freqs) > fs / 2:
        raise ValueError(
            f"The top bin {np.max(freqs)}Hz has exceeded the Nyquist frequency, "
            "please reduce the n_bins"
        )

    alpha = 2.0 ** (1.0 / bins_per_octave) - 1.0
    lengths = np.ceil(Q * fs / (freqs + gamma / alpha))
    fft_len = int(2 ** np.ceil(np.log2(int(max(lengths)))))

    kernels = np.zeros((n_bins, fft_len), dtype=np.complex64)
    for k in range(n_bins):
        freq = freqs[k]
        l = lengths[k]
        # Centering: odd lengths pad one more zero on the right-hand side
        if l % 2 == 1:
            start = int(np.ceil(fft_len / 2.0 - l / 2.0)) - 1
        else:
            start = int(np.ceil(fft_len / 2.0 - l / 2.0))
        win = window_dispatch(window, int(l), fftbins=True)
        t = np.r_[-l // 2 : l // 2]
        sig = win * np.exp(t * 1j * 2 * np.pi * freq / fs) / l
        if norm:
            sig = sig / np.linalg.norm(sig, norm)
        kernels[k, start : start + int(l)] = sig

    return CQTKernelBank(
        kernels=kernels,
        fft_len=fft_len,
        lengths=lengths.astype(np.float32),
        freqs=freqs,
    )


def create_lowpass_filter(
    band_center: float = 0.5,
    kernel_length: int = 256,
    transition_bandwidth: float = 0.03,
) -> np.ndarray:
    """Antialiasing FIR lowpass via ``firwin2`` (same spec as utils.py:562-596)."""
    passband_max = band_center / (1 + transition_bandwidth)
    stopband_min = band_center * (1 + transition_bandwidth)
    key_frequencies = [0.0, passband_max, stopband_min, 1.0]
    gain_at_key_frequencies = [1.0, 1.0, 0.0, 0.0]
    kernel = firwin2(kernel_length, key_frequencies, gain_at_key_frequencies)
    return kernel.astype(np.float32)


def next_pow2_exponent(a: float) -> int:
    """ceil(log2(a)) — the reference ``nextpow2`` (utils.py:128-148; its
    *floor* twin is ``prepow2``, utils.py:152-172). Feeds the
    early-downsample count (utils.py:657) — for power-of-2 hops ceil and
    floor agree, but e.g. hop=768 gives 10 vs 9, changing the downsample
    factor, so parity requires the ceil exactly."""
    return int(np.ceil(np.log2(a)))


def early_downsample_count(
    nyquist: float, filter_cutoff: float, hop_length: int, n_octaves: int
) -> int:
    c1 = max(0, int(np.ceil(np.log2(0.85 * nyquist / filter_cutoff)) - 1) - 1)
    c2 = max(0, next_pow2_exponent(hop_length) - n_octaves + 1)
    return min(c1, c2)


def early_downsample_params(
    sr: float, hop_length: int, fmax_t: float, Q: float, n_octaves: int
):
    """(new_sr, new_hop, factor, filter_or_None, active) for early downsampling.

    Mirrors ``get_early_downsample_params`` (utils.py:599-629) including the
    hann window-bandwidth constant 1.5.
    """
    window_bandwidth = 1.5
    filter_cutoff = fmax_t * (1 + 0.5 * window_bandwidth / Q)
    count = early_downsample_count(sr // 2, filter_cutoff, hop_length, n_octaves)
    factor = 2 ** count
    new_hop = hop_length // factor
    new_sr = sr / float(factor)
    if factor != 1:
        filt = create_lowpass_filter(
            band_center=1 / factor, kernel_length=256, transition_bandwidth=0.03
        )
        return new_sr, new_hop, factor, filt, True
    return new_sr, new_hop, factor, None, False
