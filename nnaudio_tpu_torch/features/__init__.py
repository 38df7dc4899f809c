"""Spectral feature transforms of the PyTorch port."""
from .base import SpectralTransform
from .griffin_lim import Griffin_Lim
from .inverse_mel import InverseMelSpectrogram, InverseMFCC
from .mel import MFCC, MelSpectrogram, mfcc_from_db, power_to_db
from .stft import STFT, hermitian_weights, iSTFT

__all__ = [
    "SpectralTransform",
    "STFT",
    "iSTFT",
    "hermitian_weights",
    "MelSpectrogram",
    "MFCC",
    "power_to_db",
    "mfcc_from_db",
    "Griffin_Lim",
    "InverseMelSpectrogram",
    "InverseMFCC",
]
