"""Spectral feature transforms of the PyTorch port.

The namespace of ``nnaudio_tpu.features``: every transform, the ``STFTBase``
alias of the base class (nnAudio's name for it) and the function-level
``compat`` names nnAudio star-exports through ``nnAudio.features``. The
helpers ``hermitian_weights``, ``power_to_db``, ``mfcc_from_db`` and
``normalize_frames`` are importable here too, outside ``__all__`` as in the
JAX package, and so is ``WhisperLogMel``, the port's own (Whisper's log-Mel
front end), which the JAX package does not have.
"""
from .base import SpectralTransform
from .cfp import CFP, Combined_Frequency_Periodicity
from .chroma import ChromaSTFT, normalize_frames
from .cqt import CQT, CQT1992, CQT1992v2, CQT2010, CQT2010v2
from .gammatone import Gammatonegram
from .griffin_lim import Griffin_Lim
from .inverse_cqt import GriffinLimCQT
from .inverse_mel import InverseMelSpectrogram, InverseMFCC
from .mel import MFCC, MelSpectrogram, WhisperLogMel, mfcc_from_db, power_to_db
from .stft import STFT, hermitian_weights, iSTFT
from .time_stretch import PitchShift, TimeStretch, phase_vocoder, resample
from .vqt import VQT
from ..compat import *  # noqa: F401,F403
from ..compat import __all__ as _compat_all

# nnAudio exposes its nn.Module base as STFTBase; the alias keeps isinstance
# checks and subclass imports working
STFTBase = SpectralTransform

__all__ = [
    "SpectralTransform",
    "STFTBase",
    "STFT",
    "iSTFT",
    "MelSpectrogram",
    "MFCC",
    "Gammatonegram",
    "ChromaSTFT",
    "CQT",
    "CQT1992",
    "CQT1992v2",
    "CQT2010",
    "CQT2010v2",
    "VQT",
    "CFP",
    "Combined_Frequency_Periodicity",
    "Griffin_Lim",
    "GriffinLimCQT",
    "InverseMelSpectrogram",
    "InverseMFCC",
    "PitchShift",
    "TimeStretch",
    "resample",
    "phase_vocoder",
] + list(_compat_all)
