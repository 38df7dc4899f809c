"""Reference-name compatibility layer for the function-level API.

nnAudio star-exports its kernel generators and vendored librosa helpers
through ``nnAudio.features``, so downstream code imports names like
``create_fourier_kernels`` or ``get_mel`` directly. This module maps those
names and signatures onto the port's builders (the same as
``nnaudio_tpu.compat``). The host builders return NumPy arrays; the tensor
helpers take and return torch tensors: a tensor stays on its device, an
array goes to ``device=`` (CUDA unless the caller passes ``device="cpu"``).
"""
from __future__ import annotations

import numpy as np
import torch

from .config import resolve_device
from .features.base import to_float32
from .filters.chroma import chroma_filterbank, hz_to_octs
from .filters.cqt import create_cqt_kernels as _create_cqt_kernels
from .filters.cqt import create_lowpass_filter as _create_lowpass_filter
from .filters.cqt import early_downsample_params, next_pow2_exponent
from .filters.fourier import create_fourier_basis
from .filters.gammatone import gammatone_filterbank
from .filters.mel import (fft_frequencies, hz_to_mel, mel_filterbank,
                          mel_frequencies, mel_to_hz)
from .filters.windows import pad_center, window_dispatch

__all__ = [
    "create_fourier_kernels",
    "create_cqt_kernels",
    "create_lowpass_filter",
    "get_window_dispatch",
    "get_mel",
    "get_gammatone",
    "chroma",
    "nextpow2",
    "prepow2",
    "hz_to_mel",
    "mel_to_hz",
    "mel_frequencies",
    "fft_frequencies",
    "hz_to_octs",
    "pad_center",
    "get_early_downsample_params",
    "early_downsample",
    "early_downsample_count",
    "fft2gammatonemx",
    "normalize",
    "tiny",
    # tensor helpers nnAudio leaks through nnAudio.features
    "broadcast_dim",
    "complex_mul",
    "extend_fbins",
    "overlap_add",
    "torch_window_sumsquare",
    "downsampling_by_2",
    "downsampling_by_n",
    "get_cqt_complex",
    "rfft_fn",
    "uniform_distribution",
    "epsilon",
    "sz_float",
]

epsilon = 1e-8  # nnAudio utils.py:20 fudge factor
sz_float = 4    # nnAudio utils.py:19 size of a float32


def create_fourier_kernels(n_fft, win_length=None, freq_bins=None, fmin=50,
                           fmax=6000, sr=44100, freq_scale="linear",
                           window="hann", verbose=True):
    """nnAudio utils.py:241: ``(wsin, wcos, bins2freq, binslist,
    window_mask)`` as float32 arrays, kernels shaped ``(freq_bins, 1, n_fft)``
    like the conv1d layout."""
    basis = create_fourier_basis(n_fft, win_length=win_length, freq_bins=freq_bins,
                                 fmin=fmin, fmax=fmax, sr=sr,
                                 freq_scale=freq_scale, window=window)
    return (basis.wsin[:, None, :], basis.wcos[:, None, :], basis.bins2freq,
            basis.binslist, basis.window_mask)


def create_cqt_kernels(Q, fs, fmin, n_bins=84, bins_per_octave=12, norm=1,
                       window="hann", fmax=None, topbin_check=True, gamma=0,
                       pad_fft=True):
    """nnAudio utils.py:399: ``(kernels, fftLen, lengths, freqs)``."""
    bank = _create_cqt_kernels(Q, fs, fmin, n_bins, bins_per_octave, norm, window,
                               fmax, topbin_check=topbin_check, gamma=gamma)
    return bank.kernels, bank.fft_len, bank.lengths, bank.freqs


def create_lowpass_filter(band_center=0.5, kernelLength=256, transitionBandwidth=0.03):
    """nnAudio utils.py:562, its camelCase arguments included."""
    return _create_lowpass_filter(band_center, kernelLength, transitionBandwidth)


def get_window_dispatch(window, N, fftbins=True):
    return window_dispatch(window, N, fftbins=fftbins)


def get_mel(sr, n_fft, n_mels=128, fmin=0.0, fmax=None, htk=False, norm=1,
            dtype=np.float32):
    """nnAudio librosa_functions.py:375."""
    return mel_filterbank(sr, n_fft, n_mels, fmin, fmax, htk=htk, norm=norm, dtype=dtype)


def get_gammatone(sr, n_fft, n_bins=64, fmin=20.0, fmax=None, htk=False, norm=1,
                  dtype=np.float32):
    """nnAudio librosa_functions.py:153."""
    return gammatone_filterbank(sr, n_fft, n_bins, fmin=fmin, fmax=fmax, dtype=dtype)


def chroma(sr, n_fft, n_chroma=12, tuning=0.0, ctroct=5.0, octwidth=2, norm=2,
           base_c=True, dtype=np.float32):
    """nnAudio librosa_functions.py:573 (``tuning``: deviation from A440 in
    fractional chroma bins)."""
    return chroma_filterbank(sr, n_fft, n_chroma=n_chroma, tuning=tuning,
                             ctroct=ctroct, octwidth=octwidth, norm=norm,
                             base_c=base_c, dtype=dtype)


def nextpow2(A):
    """nnAudio utils.py:128: ceil(log2(A)) (the floor twin is :func:`prepow2`)."""
    return next_pow2_exponent(A)


def prepow2(A):
    """nnAudio utils.py:152: floor(log2(A))."""
    return int(np.floor(np.log2(A)))


def get_early_downsample_params(sr, hop_length, fmax_t, Q, n_octaves, verbose=False):
    """nnAudio utils.py:599: (sr, hop_length, factor, filter, active)."""
    return tuple(early_downsample_params(sr, hop_length, fmax_t, Q, n_octaves))


def early_downsample(sr, hop_length, n_octaves, nyquist, filter_cutoff):
    """nnAudio utils.py:632: shrink (sr, hop) by the early-downsample factor."""
    factor = 2 ** early_downsample_count(nyquist, filter_cutoff, hop_length, n_octaves)
    return sr / factor, hop_length // factor, factor


def early_downsample_count(nyquist, filter_cutoff, hop_length, n_octaves):
    """nnAudio utils.py:650."""
    from .filters.cqt import early_downsample_count as _edc

    return _edc(nyquist, filter_cutoff, hop_length, n_octaves)


def fft2gammatonemx(sr=20000, n_fft=2048, n_bins=64, width=1.0, fmin=0.0, fmax=11025,
                    maxlen=1024):
    """nnAudio librosa_functions.py:13: (weights, gain) of an ERB gammatone bank."""
    from .filters.gammatone import fft_to_gammatone_weights

    return fft_to_gammatone_weights(sr, n_fft, n_bins, width, fmin, fmax, maxlen)


def normalize(S, norm=np.inf, axis=0, threshold=None, fill=None):
    """nnAudio librosa_functions.py:755 (librosa 0.7's normalize, numpy)."""
    S = np.asarray(S)
    if threshold is None:
        threshold = tiny(S)
    mag = np.abs(S).astype(np.double)
    if norm is None:
        return S
    if norm == np.inf:
        length = np.max(mag, axis=axis, keepdims=True)
        fill_norm = 1.0
    elif norm == -np.inf:
        length = np.min(mag, axis=axis, keepdims=True)
        fill_norm = 1.0
    elif norm == 0:
        if fill is True:
            raise ValueError("Cannot normalize with norm=0 and fill=True")
        length = np.sum(mag > 0, axis=axis, keepdims=True, dtype=mag.dtype)
        fill_norm = 1.0
    elif np.issubdtype(type(norm), np.number) and norm > 0:
        length = np.sum(mag ** norm, axis=axis, keepdims=True) ** (1.0 / norm)
        fill_norm = (mag.size if axis is None else mag.shape[axis]) ** (-1.0 / norm)
    else:
        raise ValueError(f"Unsupported norm: {norm!r}")
    small_idx = length < threshold
    Snorm = np.empty_like(S)  # dtype-preserving, as nnAudio's
    if fill is None:
        length[small_idx] = 1.0
        Snorm[:] = S / length
    elif fill:
        length[small_idx] = np.nan
        Snorm[:] = S / length
        Snorm[np.isnan(Snorm)] = fill_norm
    else:
        length[small_idx] = np.inf
        Snorm[:] = S / length
    return Snorm


def tiny(x):
    """nnAudio librosa_functions.py:983: smallest positive normal of x's dtype."""
    x = np.asarray(x)
    if np.issubdtype(x.dtype, np.floating) or np.issubdtype(x.dtype, np.complexfloating):
        return np.finfo(x.dtype).tiny
    return np.finfo(np.float32).tiny


# ------------------------------------------------------------ tensor helpers --
def _tensor(x, device) -> torch.Tensor:
    """A float32 tensor: a tensor stays on its device, an array goes to
    ``device`` (CUDA unless ``device="cpu"``)."""
    if isinstance(x, torch.Tensor):
        return x.float()
    return to_float32(x, resolve_device(device))


def broadcast_dim(x, device=None):
    """nnAudio utils.py:206: (L,) / (B, L) / (B, 1, L) -> (B, L) (the port's
    transforms work channel-less)."""
    from .core.frame import broadcast_dim as _bd

    return _bd(_tensor(x, device))


def complex_mul(cqt_filter, stft, device=None):
    """nnAudio utils.py:175: complex matmul of a (real, imag) kernel pair
    against a (real, imag) spectrum pair -> (real, imag)."""
    from .core.apply import complex_bank_mul

    kr, ki = (_tensor(t, device) for t in cqt_filter)
    fr, fi = (_tensor(t, kr.device) for t in stft)
    return complex_bank_mul(kr, ki, fr, fi)


def extend_fbins(X, device=None):
    """nnAudio utils.py:63: mirror the onesided (B, F, T, 2) spectrum to
    n_fft bins with conjugate symmetry."""
    from .core.overlap import extend_fbins as _ef

    return _ef(_tensor(X, device))


def overlap_add(X, stride, device=None):
    """nnAudio utils.py:52: (B, n_fft, T) frames -> overlap-added (B, L)."""
    from .core.frame import frames_to_signal

    frames = _tensor(X, device).transpose(-1, -2)  # (B, T, n_fft)
    return frames_to_signal(frames, stride, frames.shape[-1] + stride * (frames.shape[-2] - 1))


def torch_window_sumsquare(w, n_frames, stride, n_fft, power=2, device=None):
    """nnAudio utils.py:43 (the name kept verbatim for drop-in ports)."""
    from .core.overlap import window_sumsquare

    return window_sumsquare(_tensor(w, device), n_frames, stride, n_fft, power=power)


def downsampling_by_n(x, filterKernel, n, device=None):
    """nnAudio utils.py:73: lowpass + decimate by ``n``. Accepts nnAudio's
    (B, 1, L) layout or (B, L)."""
    from .core.resample import downsample_by_n

    x = _tensor(x, device)
    squeeze = x.ndim == 3
    if squeeze:
        x = x[:, 0, :]
    out = downsample_by_n(x, _tensor(filterKernel, x.device).reshape(-1), n)
    return out[:, None, :] if squeeze else out


def downsampling_by_2(x, filterKernel, device=None):
    """nnAudio utils.py:103."""
    return downsampling_by_n(x, filterKernel, 2, device=device)


def get_cqt_complex(x, cqt_kernels_real, cqt_kernels_imag, hop_length, padding,
                    device=None):
    """nnAudio utils.py:498: framed complex CQT product -> (B, n_bins, T, 2)
    with the (real, -imag) stack. ``padding`` is 'reflect' / 'constant' pad
    of kernel_width//2, or nnAudio's padding module (``nn.ReflectionPad1d`` /
    ``nn.ConstantPad1d``), mapped by type. The pair is one framed op (the K5
    kernel for CUDA tensors)."""
    from .core.frame import pad_signal
    from .ops.dispatch import framed_basis_pair

    x = _tensor(x, device)
    if x.ndim == 3:
        x = x[:, 0, :]
    kr, ki = _tensor(cqt_kernels_real, x.device), _tensor(cqt_kernels_imag, x.device)
    if kr.ndim == 3:  # nnAudio's conv1d layout (n_bins, 1, width)
        kr, ki = kr[:, 0, :], ki[:, 0, :]
    if isinstance(padding, str):
        mode = padding
    else:
        name = type(padding).__name__
        if "Reflection" in name:
            mode = "reflect"
        elif "Constant" in name or "ZeroPad" in name:
            mode = "constant"
        else:
            raise TypeError(
                f"unsupported padding {padding!r}: pass 'reflect'/'constant' "
                "or nnAudio's ReflectionPad1d/ConstantPad1d module")
    x = pad_signal(x, kr.shape[-1] // 2, mode)
    real, imag_raw = framed_basis_pair(x, kr, ki, hop_length)
    return torch.stack((real, -imag_raw), dim=-1)


def rfft_fn(x, n=None, onesided=False, device=None):
    """nnAudio utils.py:35: FFT returning a (..., 2) real/imag stack (torch's
    view_as_real convention)."""
    x = _tensor(x, device)
    y = torch.fft.rfft(x, n=n, dim=-1) if onesided else torch.fft.fft(x, n=n, dim=-1)
    return torch.view_as_real(y)


def uniform_distribution(r1, r2, *size, device=None, generator=None):
    """nnAudio utils.py:59 (nnAudio never calls it; kept for completeness):
    ``(r1 - r2) * U[0, 1) + r2``. Draws from ``generator`` (a
    ``torch.Generator``; one seeded 0 if None) on ``device``, where the JAX
    package takes a PRNG ``key``."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return (r1 - r2) * torch.rand(size, generator=generator, device=device) + r2
