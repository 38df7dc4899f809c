"""Spectral feature transforms of the PyTorch port."""
from .base import SpectralTransform
from .cfp import CFP, Combined_Frequency_Periodicity
from .chroma import ChromaSTFT, normalize_frames
from .cqt import CQT, CQT1992, CQT1992v2, CQT2010, CQT2010v2
from .gammatone import Gammatonegram
from .griffin_lim import Griffin_Lim
from .inverse_cqt import GriffinLimCQT
from .inverse_mel import InverseMelSpectrogram, InverseMFCC
from .mel import MFCC, MelSpectrogram, mfcc_from_db, power_to_db
from .stft import STFT, hermitian_weights, iSTFT
from .time_stretch import PitchShift, TimeStretch, phase_vocoder, resample
from .vqt import VQT

__all__ = [
    "SpectralTransform",
    "STFT",
    "iSTFT",
    "hermitian_weights",
    "MelSpectrogram",
    "MFCC",
    "power_to_db",
    "mfcc_from_db",
    "Gammatonegram",
    "ChromaSTFT",
    "normalize_frames",
    "Griffin_Lim",
    "InverseMelSpectrogram",
    "InverseMFCC",
    "CQT1992",
    "CQT1992v2",
    "CQT",
    "CQT2010",
    "CQT2010v2",
    "VQT",
    "GriffinLimCQT",
    "CFP",
    "Combined_Frequency_Periodicity",
    "TimeStretch",
    "PitchShift",
    "phase_vocoder",
    "resample",
]
