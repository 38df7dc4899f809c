"""Vocoder-free mel -> audio: NNLS mel pseudo-inversion + Griffin-Lim.

A TTS or enhancement model emits mels; :class:`InverseMelSpectrogram`
recovers a power spectrogram with a batched projected-gradient NNLS (every
(batch, time) column at once, fixed step ``1/sigma_max(M)^2`` computed in
fp64 at init) and then the phase with :class:`Griffin_Lim`.
:class:`InverseMFCC` undoes the MFCC's DCT and dB stages first.

    inv = InverseMelSpectrogram(sr=22050, n_fft=1024, hop_length=256, n_mels=80)
    audio = inv(mel)                       # (B, n_mels, T) -> (B, L)
"""
from __future__ import annotations

import numpy as np
import torch.nn.functional as F

from ..core.apply import project
from ..filters.mel import dct_matrix, mel_filterbank
from ..ops.dispatch import nnls
from .base import SpectralTransform, adopt_state
from .griffin_lim import Griffin_Lim


class InverseMelSpectrogram(SpectralTransform):
    """Mel spectrogram -> waveform: batched NNLS + Griffin-Lim.

    Parameters are those of ``nnaudio_tpu.features.InverseMelSpectrogram``
    (``sr, n_fft, n_mels, hop_length, window, fmin, fmax, htk, norm, power,
    n_iter_nnls=64, n_iter=32, center, pad_mode, momentum, iter_precision,
    verbose``), plus ``device`` (``None`` means CUDA; pass ``device="cpu"``
    for the CPU). The state holds ``mel_basis``, ``mel_pinv`` and the
    Griffin-Lim tensors under their flat names.

    Call as ``inv(mel)``, ``inv(mel, rand_phase=phase)`` or
    ``inv(mel, generator=g)`` (see :class:`Griffin_Lim`); ``mel`` is
    ``(num_audio, n_mels, time_steps)``. Returns ``(num_audio, samples)``.
    """

    def __init__(
        self,
        sr: float = 22050,
        n_fft: int = 2048,
        n_mels: int = 128,
        hop_length: int = 512,
        window: str = "hann",
        fmin: float = 0.0,
        fmax: float | None = None,
        htk: bool = False,
        norm=1,
        power: float = 2.0,
        n_iter_nnls: int = 64,
        n_iter: int = 32,
        center: bool = True,
        pad_mode: str = "reflect",
        momentum: float = 0.99,
        iter_precision: str = "default",
        verbose: bool = True,
        device=None,
    ):
        super().__init__(device)
        if power <= 0:
            raise ValueError("power must be positive")
        self.power = power
        self.n_iter_nnls = n_iter_nnls

        basis = mel_filterbank(sr, n_fft, n_mels, fmin, fmax, htk=htk,
                               norm=norm).astype(np.float64)  # (n_mels, F)
        self._register("mel_basis", basis.astype(np.float32))
        # the gradient of 1/2 ||M s - mel||^2 is sigma_max(M)^2-Lipschitz;
        # the pseudo-inverse seeds the iteration near the solution
        sigma_max = np.linalg.svd(basis, compute_uv=False)[0]
        self._step = float(1.0 / (sigma_max**2))
        self._register("mel_pinv", np.linalg.pinv(basis).astype(np.float32))

        self._hold("griffin_lim", Griffin_Lim(
            n_fft=n_fft, n_iter=n_iter, hop_length=hop_length,
            win_length=None, window=window, center=center,
            pad_mode=pad_mode, momentum=momentum,
            iter_precision=iter_precision, device=self._init_device,
        ))
        adopt_state(self, self.griffin_lim)
        self._verbose_print(
            verbose,
            f"InverseMel solver ready: basis {basis.shape}, "
            f"PG step {self._step:.3e}, {n_iter_nnls} NNLS + {n_iter} GL "
            "iterations",
        )

    def mel_to_power(self, params, mel):
        """Batched NNLS: the |STFT|^power estimate ``s >= 0`` minimising
        ``||M s - mel||^2`` for every (batch, time) column, by projected
        gradient with the fixed step ``1/sigma_max(M)^2`` (``ops.nnls``: one
        kernel on the card for the transform's own basis outside autograd,
        else dense products)."""
        return nnls(params["mel_basis"], params["mel_pinv"], mel, self._step,
                    self.n_iter_nnls)

    def _forward(self, params, mel, rand_phase=None, generator=None):
        if mel.ndim != 3:
            raise AssertionError(
                "Please make sure your input is in the shape of "
                "(batch, n_mels, timesteps)"
            )
        magnitude = self.mel_to_power(params, mel) ** (1.0 / self.power)
        return self.griffin_lim._forward(params, magnitude,
                                         rand_phase=rand_phase,
                                         generator=generator)

    def forward(self, mel, rand_phase=None, generator=None):
        return self.apply(None, mel, rand_phase=rand_phase, generator=generator)

    def apply(self, params, mel, rand_phase=None, generator=None):
        return super().apply(params, mel, rand_phase=rand_phase,
                             generator=generator)

    def extra_repr(self) -> str:
        return (f"mel basis = {tuple(self.mel_basis.shape)}, "
                f"nnls_iters = {self.n_iter_nnls}")


class InverseMFCC(SpectralTransform):
    """MFCC -> waveform: the least-squares inverse of the orthonormal DCT
    (zero-pad the ``n_mfcc`` coefficients to ``n_mels``, apply the
    transpose), ``mel = ref * 10^(db/10)``, then
    :class:`InverseMelSpectrogram`.

    Parameters are those of ``nnaudio_tpu.features.InverseMFCC``, plus
    ``device``. An MFCC made with a ``top_db`` clamp does not invert below
    the clamp: make the input with ``MFCC(top_db=None)``. The state adds
    ``dct_basis`` to the inverse mel's.
    """

    def __init__(
        self,
        sr: float = 22050,
        n_mfcc: int = 20,
        norm: str = "ortho",
        ref: float = 1.0,
        n_fft: int = 2048,
        n_mels: int = 128,
        hop_length: int = 512,
        window: str = "hann",
        fmin: float = 0.0,
        fmax: float | None = None,
        htk: bool = False,
        mel_norm=1,
        power: float = 2.0,
        n_iter_nnls: int = 64,
        n_iter: int = 32,
        center: bool = True,
        pad_mode: str = "reflect",
        momentum: float = 0.99,
        iter_precision: str = "default",
        verbose: bool = True,
        device=None,
    ):
        super().__init__(device)
        if norm != "ortho":
            raise ValueError(
                "InverseMFCC requires norm='ortho': only the orthonormal "
                "DCT-II inverts by its transpose")
        self.n_mfcc = n_mfcc
        self.ref = abs(float(ref))
        self._hold("inverse_mel", InverseMelSpectrogram(
            sr=sr, n_fft=n_fft, n_mels=n_mels, hop_length=hop_length,
            window=window, fmin=fmin, fmax=fmax, htk=htk, norm=mel_norm,
            power=power, n_iter_nnls=n_iter_nnls, n_iter=n_iter,
            center=center, pad_mode=pad_mode, momentum=momentum,
            iter_precision=iter_precision, verbose=verbose,
            device=self._init_device,
        ))
        adopt_state(self, self.inverse_mel)
        self._register("dct_basis", dct_matrix(n_mels, n_mels, norm=norm))

    def mfcc_to_mel(self, params, mfcc):
        """Zero-pad the coefficients to ``n_mels``, apply the orthonormal
        DCT's transpose, then ``mel = ref * 10^(db/10)``."""
        n_mels = params["dct_basis"].shape[0]
        padded = F.pad(mfcc, (0, 0, 0, n_mels - mfcc.shape[1]))
        db = project(params["dct_basis"].t(), padded)
        return self.ref * 10.0 ** (db / 10.0)

    def _forward(self, params, mfcc, rand_phase=None, generator=None):
        if mfcc.ndim != 3 or mfcc.shape[1] > params["dct_basis"].shape[0]:
            raise AssertionError(
                "Please make sure your input is in the shape of "
                "(batch, n_mfcc, timesteps) with n_mfcc <= n_mels"
            )
        return self.inverse_mel._forward(params, self.mfcc_to_mel(params, mfcc),
                                         rand_phase=rand_phase,
                                         generator=generator)

    def forward(self, mfcc, rand_phase=None, generator=None):
        return self.apply(None, mfcc, rand_phase=rand_phase, generator=generator)

    def apply(self, params, mfcc, rand_phase=None, generator=None):
        return super().apply(params, mfcc, rand_phase=rand_phase,
                             generator=generator)

    def extra_repr(self) -> str:
        return f"n_mfcc = {self.n_mfcc}"
