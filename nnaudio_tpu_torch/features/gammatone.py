"""Gammatonegram: STFT magnitude^power projected onto an ERB gammatone bank.

The composite of ``MelSpectrogram`` with the 4th-order gammatone filterbank:
one framed filterbank op (the K2 CUDA kernel for CUDA tensors at the default
``power=2``). The default ``n_bins=64`` is nnAudio's actual value.
"""
from __future__ import annotations

from ..core.frame import broadcast_dim
from ..filters.gammatone import gammatone_filterbank
from .base import SpectralTransform, adopt_state
from .stft import STFT


class Gammatonegram(SpectralTransform):
    """Gammatonegram: STFT magnitude^power projected onto a 4th-order
    gammatone (ERB-scale) filterbank, the auditory-model analogue of the mel
    spectrogram.

    Parameters are those of ``nnaudio_tpu.features.Gammatonegram`` (``sr``,
    ``n_fft``, ``win_length``, ``n_bins``, ``hop_length``, ``window``,
    ``center``, ``pad_mode``, ``power``, ``htk``, ``fmin``, ``fmax``,
    ``norm``, ``trainable_bins``, ``trainable_STFT``, ``verbose``; ``htk``
    and ``norm`` are accepted for signature parity with MelSpectrogram), plus
    ``device`` (``None`` means CUDA; pass ``device="cpu"`` for the CPU). The
    state holds the flat keys ``wsin``, ``wcos`` and ``gammatone_basis``.

    Returns ``(num_audio, n_bins, time_steps)``.
    """

    def __init__(
        self,
        sr: float = 22050,
        n_fft: int = 2048,
        win_length: int | None = None,
        n_bins: int = 64,
        hop_length: int = 512,
        window: str = "hann",
        center: bool = True,
        pad_mode: str = "reflect",
        power: float = 2.0,
        htk: bool = False,
        fmin: float = 0.0,
        fmax: float | None = None,
        norm=1,
        trainable_bins: bool = False,
        trainable_STFT: bool = False,
        verbose: bool = True,
        device=None,
        **kwargs,
    ):
        super().__init__(device)
        self.power = power
        self.trainable_bins = trainable_bins
        self.trainable_STFT = trainable_STFT

        self._hold("stft", STFT(
            n_fft=n_fft, win_length=win_length, freq_bins=None,
            hop_length=hop_length, window=window, freq_scale="no",
            center=center, pad_mode=pad_mode, sr=sr, trainable=trainable_STFT,
            output_format="Magnitude", verbose=verbose,
            device=self._init_device, **kwargs,
        ))
        adopt_state(self, self.stft, names=("wsin", "wcos"))

        basis = gammatone_filterbank(sr, n_fft, n_bins, fmin=fmin, fmax=fmax)
        self._register("gammatone_basis", basis, trainable=trainable_bins)
        self._verbose_print(
            verbose, f"Gammatone filter created: {basis.shape} (n_bins={n_bins})"
        )

    def _forward(self, params, x):
        return self.stft._filterbank_spectrogram(
            params, broadcast_dim(x), params["gammatone_basis"], self.power,
            eps=1e-8 if self.trainable_STFT else 0.0,
        )

    def extra_repr(self) -> str:
        return "Gammatone filter banks size = {}, trainable_bins={}".format(
            tuple(self.gammatone_basis.shape), self.trainable_bins
        )
