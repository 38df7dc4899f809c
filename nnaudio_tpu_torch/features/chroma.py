"""ChromaSTFT: STFT magnitude^power projected onto a 12-class chroma bank.

nnAudio vendors the chroma filterbank code but exposes no feature class for
it; this one follows librosa's ``feature.chroma_stft`` (the per-frame norm
applies to the projection). The projection is one framed filterbank op (the
K2 CUDA kernel for CUDA tensors at the default ``power=2``).
"""
from __future__ import annotations

import math

import torch

from ..core.frame import broadcast_dim
from ..filters.chroma import chroma_filterbank
from .base import SpectralTransform, adopt_state
from .stft import STFT


def normalize_frames(chroma, norm):
    """librosa-convention per-frame norm over the chroma axis (``inf`` = the
    frame's max, a number = Lp norm, ``None`` = off)."""
    if norm is None:
        return chroma
    if norm == math.inf:
        scale = torch.amax(chroma.abs(), dim=1, keepdim=True)
    else:
        scale = torch.sum(chroma.abs() ** norm, dim=1,
                          keepdim=True) ** (1.0 / norm)
    tiny = torch.finfo(chroma.dtype).tiny
    return chroma / torch.where(scale < tiny, torch.ones_like(scale), scale)


class ChromaSTFT(SpectralTransform):
    """Chromagram: STFT magnitude^power folded onto pitch classes through a
    chroma filterbank.

    Parameters are those of ``nnaudio_tpu.features.ChromaSTFT`` (``sr``,
    ``n_fft``, ``win_length``, ``n_chroma``, ``hop_length``, ``window``,
    ``center``, ``pad_mode``, ``power``, ``tuning``, ``norm`` (default
    ``math.inf``, the per-frame max), ``trainable_chroma``,
    ``trainable_STFT``, ``verbose``), plus ``device`` (``None`` means CUDA;
    pass ``device="cpu"`` for the CPU). The state holds the flat keys
    ``wsin``, ``wcos`` and ``chroma_basis``.

    Returns ``(num_audio, n_chroma, time_steps)``.
    """

    def __init__(
        self,
        sr: float = 22050,
        n_fft: int = 2048,
        win_length: int | None = None,
        n_chroma: int = 12,
        hop_length: int = 512,
        window: str = "hann",
        center: bool = True,
        pad_mode: str = "reflect",
        power: float = 2.0,
        tuning: float = 0.0,
        norm=math.inf,
        trainable_chroma: bool = False,
        trainable_STFT: bool = False,
        verbose: bool = True,
        device=None,
        **kwargs,
    ):
        super().__init__(device)
        self.power = power
        self.norm = norm
        self.trainable_chroma = trainable_chroma
        self.trainable_STFT = trainable_STFT

        self._hold("stft", STFT(
            n_fft=n_fft, win_length=win_length, freq_bins=None,
            hop_length=hop_length, window=window, freq_scale="no",
            center=center, pad_mode=pad_mode, sr=sr, trainable=trainable_STFT,
            output_format="Magnitude", verbose=verbose,
            device=self._init_device, **kwargs,
        ))
        adopt_state(self, self.stft, names=("wsin", "wcos"))

        basis = chroma_filterbank(sr, n_fft, n_chroma=n_chroma, tuning=tuning)
        self._register("chroma_basis", basis, trainable=trainable_chroma)
        self._verbose_print(
            verbose, f"Chroma filter created: {basis.shape} (n_chroma={n_chroma})"
        )

    def _forward(self, params, x):
        chroma = self.stft._filterbank_spectrogram(
            params, broadcast_dim(x), params["chroma_basis"], self.power,
            eps=1e-8 if self.trainable_STFT else 0.0,
        )
        return normalize_frames(chroma, self.norm)
