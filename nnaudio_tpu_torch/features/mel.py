"""Mel-filterbank composites: MelSpectrogram and MFCC.

The STFT power and the mel projection run as one framed filterbank op (the
K2 CUDA kernel for CUDA tensors); the MFCC's DCT-II is an explicit
orthonormal basis matmul.
"""
from __future__ import annotations

import torch

from ..core.apply import project
from ..core.frame import broadcast_dim
from ..filters.mel import dct_matrix, mel_filterbank
from .base import SpectralTransform, adopt_state
from .stft import STFT


def power_to_db(S, amin, ref, top_db):
    """librosa-convention dB scaling. ``top_db`` (if given) clamps against
    the whole-batch max."""
    amin = torch.as_tensor(amin, dtype=S.dtype, device=S.device)
    log_spec = 10.0 * torch.log10(torch.maximum(S, amin))
    log_spec = log_spec - 10.0 * torch.log10(
        torch.maximum(amin, torch.as_tensor(ref, dtype=S.dtype, device=S.device)))
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
    clamp takes its max over the whole batch, as the reference does.

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
