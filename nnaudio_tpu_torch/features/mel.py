"""Mel-filterbank composites: MelSpectrogram, MFCC and WhisperLogMel.

The STFT power and the mel projection run as one framed filterbank op (the
K2 CUDA kernel for CUDA tensors); the MFCC's DCT-II is an explicit
orthonormal basis matmul; WhisperLogMel is Whisper's log-Mel front end.
"""
from __future__ import annotations

import math

import torch

from .._spans import span
from ..core.apply import project
from ..core.frame import broadcast_dim
from ..filters.mel import dct_matrix, mel_filterbank
from .base import SpectralTransform, adopt_state
from .stft import STFT


def power_to_db(S, amin, ref, top_db):
    """librosa-convention dB scaling. ``top_db`` (if given) clamps each
    item of the batch against its own max. ``amin`` and ``ref`` stay Python
    numbers: a tensor made of one on the card copies from host memory and
    waits for the stream. While a profiler runs, the span ``nnaudio.db``."""
    with span("nnaudio.db"):
        amin, ref = float(amin), float(ref)
        log_spec = 10.0 * torch.log10(torch.clamp(S, min=amin))
        log_spec = log_spec - 10.0 * math.log10(max(amin, ref))
        if top_db is not None:
            batch_max = torch.amax(log_spec.reshape(log_spec.shape[0], -1), dim=1)
            log_spec = torch.maximum(log_spec, batch_max[:, None, None] - top_db)
        return log_spec


def mfcc_from_db(dct_basis, db, n_mfcc):
    """Full-square DCT-II projection, then crop to ``n_mfcc``."""
    return project(dct_basis, db)[:, :n_mfcc, :]


class MelSpectrogram(SpectralTransform):
    """Mel spectrogram: STFT magnitude^power projected onto a mel filterbank.

    Parameters are those of ``nnaudio_tpu.features.MelSpectrogram``, plus
    ``device`` (``None`` means CUDA; pass ``device="cpu"`` for the CPU).
    The state holds the flat keys ``wsin``, ``wcos`` and ``mel_basis``: the
    STFT's kernels are this transform's own tensors, shared, not copied.

    Returns ``(num_audio, n_mels, time_steps)``.
    """

    def __init__(
        self,
        sr: float = 22050,
        n_fft: int = 2048,
        win_length: int | None = None,
        n_mels: int = 128,
        hop_length: int = 512,
        window: str = "hann",
        center: bool = True,
        pad_mode: str = "reflect",
        power: float = 2.0,
        htk: bool = False,
        fmin: float = 0.0,
        fmax: float | None = None,
        norm=1,
        trainable_mel: bool = False,
        trainable_STFT: bool = False,
        verbose: bool = True,
        device=None,
        **kwargs,
    ):
        super().__init__(device)
        self.power = power
        self.trainable_mel = trainable_mel
        self.trainable_STFT = trainable_STFT

        self._hold("stft", STFT(
            n_fft=n_fft,
            win_length=win_length,
            freq_bins=None,
            hop_length=hop_length,
            window=window,
            freq_scale="no",
            center=center,
            pad_mode=pad_mode,
            sr=sr,
            trainable=trainable_STFT,
            output_format="Magnitude",
            verbose=verbose,
            device=self._init_device,
            **kwargs,
        ))
        adopt_state(self, self.stft, names=("wsin", "wcos"))

        basis = mel_filterbank(sr, n_fft, n_mels, fmin, fmax, htk=htk, norm=norm)
        self._register("mel_basis", basis, trainable=trainable_mel)
        self._verbose_print(
            verbose, f"Mel filter created: {basis.shape} (n_mels={n_mels})"
        )

    def _forward(self, params, x):
        return self.stft._filterbank_spectrogram(
            params, broadcast_dim(x), params["mel_basis"], self.power,
            eps=1e-8 if self.trainable_STFT else 0.0,
        )

    def extra_repr(self) -> str:
        return "Mel filter banks size = {}, trainable_mel={}".format(
            tuple(self.mel_basis.shape), self.trainable_mel
        )


class MFCC(SpectralTransform):
    """Mel-frequency cepstral coefficients:
    MelSpectrogram -> power-to-dB -> DCT-II basis matmul -> top ``n_mfcc``.

    Parameters are those of ``nnaudio_tpu.features.MFCC``; ``device`` and
    the rest go to the underlying :class:`MelSpectrogram`. The ``top_db``
    clamp takes each item's own max, as :func:`power_to_db` does.

    Returns ``(num_audio, n_mfcc, time_steps)``.
    """

    def __init__(
        self,
        sr: float = 22050,
        n_mfcc: int = 20,
        norm: str = "ortho",
        verbose: bool = True,
        ref: float = 1.0,
        amin: float = 1e-10,
        top_db: float | None = 80.0,
        device=None,
        **kwargs,
    ):
        super().__init__(device)
        if amin <= 0:
            raise ValueError("amin must be strictly positive")
        if top_db is not None and top_db < 0:
            raise ValueError("top_db must be non-negative")
        self.n_mfcc = n_mfcc
        self.amin = float(amin)
        self.ref = abs(float(ref))
        self.top_db = top_db

        self._hold("melspec_layer", MelSpectrogram(
            sr=sr, verbose=verbose, device=self._init_device, **kwargs))
        adopt_state(self, self.melspec_layer)

        n_mels = self.melspec_layer.mel_basis.shape[0]
        # full square DCT basis: the reference computes all n_mels
        # coefficients then crops
        self._register("dct_basis", dct_matrix(n_mels, n_mels, norm=norm))

    def _power_to_db(self, S):
        return power_to_db(S, self.amin, self.ref, self.top_db)

    def _forward(self, params, x):
        mel = self.melspec_layer._forward(params, x)
        db = self._power_to_db(mel)
        return mfcc_from_db(params["dct_basis"], db, self.n_mfcc)

    def extra_repr(self) -> str:
        return f"n_mfcc = {self.n_mfcc}"


class WhisperLogMel(SpectralTransform):
    """Whisper's log-Mel front end (``log_mel_spectrogram`` of openai's
    ``whisper/audio.py``): a :class:`MelSpectrogram` at 16 kHz with n_fft
    400, hop 160, a periodic Hann window, centred with reflect padding,
    power 2 and ``n_mels`` Slaney mels over 0-8000 Hz; the last frame
    dropped; then ``log10`` of the power clamped at 1e-10, floored 8 below
    its max and mapped by ``(x + 4) / 4``, which is ``power_to_db(mel, 1e-10,
    1, 80) / 40 + 1``. The max is each clip's own, as Hugging Face's
    ``WhisperFeatureExtractor`` takes it over a batch (openai's takes it over
    what it is handed, one file).

    Takes ``(B, L)`` or ``(L,)`` audio of any length: trimming or padding to
    Whisper's 30 s windows (480,000 samples, 3,000 frames) is the caller's.
    ``n_mels`` is 128 for large-v3, 80 for the earlier models. The state
    holds the flat keys ``wsin``, ``wcos`` and ``mel_basis`` of the held
    layer, as :class:`MFCC`'s does. In fp32 (``highest``) a CUDA call takes
    K2's FFT route at n_fft 400.

    Returns ``(num_audio, n_mels, time_steps)``, ``time_steps = L // 160``.
    """

    SR, N_FFT, HOP_LENGTH = 16000, 400, 160

    def __init__(self, n_mels: int = 128, device=None):
        super().__init__(device)
        self._hold("melspec_layer", MelSpectrogram(
            sr=self.SR, n_fft=self.N_FFT, hop_length=self.HOP_LENGTH, n_mels=n_mels,
            window="hann", center=True, pad_mode="reflect", power=2.0, htk=False,
            fmin=0.0, fmax=self.SR / 2, norm=1, verbose=False, device=self._init_device))
        adopt_state(self, self.melspec_layer)

    def _forward(self, params, x):
        mel = self.melspec_layer._forward(params, x)[..., :-1]
        return power_to_db(mel, 1e-10, 1.0, 80.0) / 40.0 + 1.0

    def extra_repr(self) -> str:
        return f"n_mels = {self.melspec_layer.mel_basis.shape[0]}"
