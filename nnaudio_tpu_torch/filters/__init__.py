"""Host-side (NumPy/SciPy) basis and filterbank builders.

Copies of the JAX package's numpy builders, kept here so the PyTorch port
imports nothing of ``nnaudio_tpu``. They run once at transform
construction; the arrays become buffers or parameters on the device.
"""
from .fourier import FourierBasis, create_fourier_basis, fourier_bin_positions
from .mel import (
    dct_matrix,
    fft_frequencies,
    hz_to_mel,
    mel_filterbank,
    mel_frequencies,
    mel_to_hz,
)
from .gammatone import gammatone_filterbank, fft_to_gammatone_weights, gammatone_center_freqs
from .cqt import (
    CQTKernelBank,
    cqt_frequencies,
    create_cqt_kernels,
    create_lowpass_filter,
    early_downsample_count,
    early_downsample_params,
    next_pow2_exponent,
)
from .cfp import cfp_logfreq_matrices, log_central_freqs
from .chroma import chroma_filterbank, hz_to_octs
from .windows import pad_center, window_dispatch

__all__ = [
    "FourierBasis",
    "create_fourier_basis",
    "fourier_bin_positions",
    "dct_matrix",
    "fft_frequencies",
    "hz_to_mel",
    "mel_filterbank",
    "mel_frequencies",
    "mel_to_hz",
    "gammatone_filterbank",
    "fft_to_gammatone_weights",
    "gammatone_center_freqs",
    "CQTKernelBank",
    "cqt_frequencies",
    "create_cqt_kernels",
    "create_lowpass_filter",
    "early_downsample_count",
    "early_downsample_params",
    "next_pow2_exponent",
    "cfp_logfreq_matrices",
    "log_central_freqs",
    "chroma_filterbank",
    "hz_to_octs",
    "pad_center",
    "window_dispatch",
]
