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
from .cqt import (
    CQTKernelBank,
    cqt_frequencies,
    create_cqt_kernels,
    create_lowpass_filter,
    early_downsample_count,
    early_downsample_params,
    next_pow2_exponent,
)
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
    "CQTKernelBank",
    "cqt_frequencies",
    "create_cqt_kernels",
    "create_lowpass_filter",
    "early_downsample_count",
    "early_downsample_params",
    "next_pow2_exponent",
    "pad_center",
    "window_dispatch",
]
