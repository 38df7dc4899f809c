"""STFT and inverse STFT transforms.

The forward is an explicit windowed-DFT basis matmul over framed audio; the
inverse is an IDFT basis matmul + overlap-add with window-sumsquare
normalisation computed per call (no stateful ``w_sum`` cache).

Conventions kept from the reference:
- ``Complex`` output stacks ``(real, -imag)``.
- ``Phase`` is scalar ``atan2(-imag + 0.0, real)``.
- ``Magnitude`` adds 1e-8 under the sqrt only when trainable.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.apply import phase_atan, project
from ..core.frame import broadcast_dim, pad_signal
from ..core.overlap import (
    extend_fbins,
    normalize_by_window_envelope,
    window_sumsquare,
)
from ..filters.fourier import create_fourier_basis
from ..filters.windows import pad_center, window_dispatch
from ..ops.dispatch import (
    framed_basis_pair,
    framed_complex,
    framed_filterbank,
    framed_magnitude,
    framed_power,
    synthesis_ola,
)
from ..ops.framed_kernels import hermitian_weights, synthesis_kernels  # noqa: F401
from .base import SpectralTransform


def _inverse_stft_graph(
    X,
    kernel_cos,
    kernel_sin,
    window_mask,
    n_fft: int,
    hop: int,
    onesided: bool,
    length: int | None,
    center: bool,
    pad_amount: int,
    fold_onesided: bool = True,
):
    """Shared iSTFT math (reference ``STFTBase.inverse_stft``).

    ``X``: (B, F, T, 2) complex stack; kernels: (n_fft, n_fft) IDFT bases with
    frequency as the leading axis (rows [:n_fft//2+1] are the onesided bins).
    With frozen kernels the onesided path folds Hermitian symmetry into bin
    weights instead of mirroring the spectrum (``fold_onesided=False`` keeps
    the explicit mirror, which a trainable full kernel bank needs so that its
    upper-half rows receive gradients). The window and 1/n_fft are
    per-output-sample scales, folded into the kernel columns so that
    synthesis + overlap-add runs as one op; the folded products
    (``synthesis_kernels``) may take K3's FFT route.
    """
    if onesided and fold_onesided and X.shape[1] == n_fft // 2 + 1:
        kc, ks = synthesis_kernels(kernel_cos, kernel_sin, window_mask)
    else:
        if onesided:
            X = extend_fbins(X)
        kc = kernel_cos * window_mask[None, :] / n_fft
        ks = kernel_sin * window_mask[None, :] / n_fft
    signal = synthesis_ola(X[..., 0], X[..., 1], kc, ks, hop)
    w_sum = window_sumsquare(window_mask, X.shape[2], hop, n_fft)
    signal = normalize_by_window_envelope(signal, w_sum)
    if length is None:
        if center:
            signal = signal[:, pad_amount:-pad_amount]
    else:
        if center:
            signal = signal[:, pad_amount : pad_amount + length]
        else:
            signal = signal[:, :length]
        if signal.shape[1] < length:
            # librosa istft(length=...) semantics: pad a shortfall with zeros
            signal = F.pad(signal, (0, length - signal.shape[1]))
    return signal


def _check_complex(X: torch.Tensor) -> None:
    if X.ndim != 4:
        raise AssertionError(
            "Inverse iSTFT only works for complex numbers; expected shape "
            "(batch, freq_bins, timesteps, 2). For magnitude spectrograms "
            "use Griffin-Lim."
        )


class STFT(SpectralTransform):
    """Short-time Fourier transform as a (trainable) basis matmul.

    Accepted input shapes: ``(len_audio,)``, ``(num_audio, len_audio)`` or
    ``(num_audio, 1, len_audio)``. Arguments follow the JAX package's
    ``STFT`` (and librosa). ``Magnitude`` output runs on the K1 CUDA kernel
    (frame + both basis products + magnitude in one pass) for CUDA tensors.

    Parameters
    ----------
    n_fft, win_length, freq_bins, hop_length, window, freq_scale, center,
    pad_mode, iSTFT, fmin, fmax, sr, trainable, output_format, verbose
        As in ``nnaudio_tpu.features.STFT``.
    device : str or torch.device or None
        Where the kernels live. ``None`` means CUDA, and raises when no CUDA
        device exists; pass ``device="cpu"`` to run on the CPU.

    Returns
    -------
    ``(num_audio, freq_bins, time_steps)`` for ``'Magnitude'`` / ``'Phase'``;
    ``(num_audio, freq_bins, time_steps, 2)`` for ``'Complex'``, the last axis
    stacking ``(real, -imag)``.
    """

    def __init__(
        self,
        n_fft: int = 2048,
        win_length: int | None = None,
        freq_bins: int | None = None,
        hop_length: int | None = None,
        window: str = "hann",
        freq_scale: str = "no",
        center: bool = True,
        pad_mode: str = "reflect",
        iSTFT: bool = False,
        fmin: float = 50,
        fmax: float = 6000,
        sr: float = 22050,
        trainable: bool = False,
        output_format: str = "Complex",
        verbose: bool = True,
        device=None,
    ):
        super().__init__(device)
        if win_length is None:
            win_length = n_fft
        if hop_length is None:
            hop_length = int(win_length // 4)

        self.n_fft = n_fft
        self.win_length = win_length
        self.freq_bins = freq_bins
        self.stride = hop_length
        self.center = center
        self.pad_mode = pad_mode
        self.pad_amount = n_fft // 2
        self.trainable = trainable
        self.output_format = output_format
        self.iSTFT = iSTFT

        basis = create_fourier_basis(
            n_fft,
            win_length=win_length,
            freq_bins=freq_bins,
            window=window,
            freq_scale=freq_scale,
            fmin=fmin,
            fmax=fmax,
            sr=sr,
        )
        self.bins2freq = basis.bins2freq
        self.bin_list = basis.binslist

        window_mask = basis.window_mask  # (n_fft,)
        self._register("wsin", basis.wsin * window_mask[None, :], trainable=trainable)
        self._register("wcos", basis.wcos * window_mask[None, :], trainable=trainable)
        self._register("window_mask", window_mask)

        if iSTFT:
            # full-bin IDFT bases by mirroring: rows k and n_fft-k carry
            # cos / -sin symmetry, so the bank is the dense DFT matrix
            ksin, kcos = basis.wsin, basis.wcos
            self._register("kernel_sin_inv",
                           np.concatenate((ksin, -ksin[1:-1][::-1]), axis=0))
            self._register("kernel_cos_inv",
                           np.concatenate((kcos, kcos[1:-1][::-1]), axis=0))

        self._verbose_print(verbose, f"STFT basis created: n_fft={n_fft}, freq_bins={basis.wsin.shape[0]}")

    # ------------------------------------------------------------ forward --
    def _padded(self, x):
        x = broadcast_dim(x)
        if self.center:
            x = pad_signal(x, self.pad_amount, self.pad_mode)
        return x

    def _forward(self, params, x, output_format="Complex"):
        x = self._padded(x)
        if output_format == "Magnitude":
            # the basis has exactly freq_bins rows, so no truncation is due
            return framed_magnitude(
                x, params["wcos"], params["wsin"], self.stride,
                eps=1e-8 if self.trainable else 0.0,
            )
        if output_format == "Complex":
            return framed_complex(x, params["wcos"], params["wsin"], None, self.stride)
        spec_real, spec_imag = framed_basis_pair(
            x, params["wcos"], params["wsin"], self.stride
        )
        if self.freq_bins is not None:
            spec_real = spec_real[:, : self.freq_bins]
            spec_imag = spec_imag[:, : self.freq_bins]
        if output_format == "Phase":
            return phase_atan(spec_real, -spec_imag)
        raise ValueError(f"unknown output_format {output_format!r}")

    def _power_spectrogram(self, params, x, power: float):
        """|STFT|^power for the filterbank composites. ``power == 2`` with a
        frozen basis takes the power kernel directly; a trainable basis keeps
        the magnitude path so the 1e-8 under the sqrt survives the exponent."""
        x = self._padded(x)
        if power == 2.0 and not self.trainable:
            return framed_power(x, params["wcos"], params["wsin"], self.stride)
        mag = framed_magnitude(
            x, params["wcos"], params["wsin"], self.stride,
            eps=1e-8 if self.trainable else 0.0,
        )
        if power == 1.0:
            return mag
        return mag ** power

    def _filterbank_spectrogram(self, params, x, basis, power: float, eps: float):
        """Shared composite forward of Mel-type transforms: at ``power=2`` the
        frame + DFT pair + power + filterbank projection is one op (the K2
        kernel for CUDA tensors); other powers take ``|STFT|^p`` then
        project. A trainable STFT passes ``eps=1e-8``, the reference's
        under-the-sqrt epsilon, an additive power offset at p=2."""
        if power == 2.0:
            return framed_filterbank(self._padded(x), params["wcos"],
                                     params["wsin"], basis, self.stride, eps=eps)
        return project(basis, self._power_spectrogram(params, x, power))

    def forward(self, x, output_format=None):
        return self.apply(None, x, output_format=output_format)

    def apply(self, params, x, output_format=None):
        return super().apply(params, x, output_format=output_format or self.output_format)

    # ------------------------------------------------------------ inverse --
    def inverse(self, X, onesided=True, length=None, refresh_win=True):
        """Spectrogram -> waveform with the frozen mirrored kernels.
        ``refresh_win`` is accepted for API parity and has no effect: the
        window envelope is recomputed on every call."""
        params = self.params
        if "kernel_cos_inv" not in params:
            raise NameError(
                "Please activate the iSTFT module by setting `iSTFT=True` "
                "if you want to use `inverse`"
            )
        X = self._input(X)
        _check_complex(X)
        return _inverse_stft_graph(
            X, params["kernel_cos_inv"], params["kernel_sin_inv"],
            params["window_mask"], self.n_fft, self.stride, onesided, length,
            self.center, self.pad_amount,
        )

    def extra_repr(self) -> str:
        return "n_fft={}, Fourier Kernel size={}, iSTFT={}, trainable={}".format(
            self.n_fft, tuple(self.wsin.shape), self.iSTFT, self.trainable
        )


class iSTFT(SpectralTransform):
    """Standalone inverse STFT with separately trainable kernels and window.

    Reconstructs a waveform from a ``(B, F, T, 2)`` complex stack by an IDFT
    basis matmul + overlap-add (the K3 CUDA kernel for CUDA tensors) and
    window-sumsquare normalisation. With onesided frozen kernels the
    Hermitian symmetry is folded into per-bin weights.

    Parameters are those of ``nnaudio_tpu.features.iSTFT``, plus ``device``
    (``None`` means CUDA; pass ``device="cpu"`` for the CPU). Call as
    ``layer(X, onesided=True, length=L)``.
    """

    def __init__(
        self,
        n_fft: int = 2048,
        win_length: int | None = None,
        freq_bins: int | None = None,
        hop_length: int | None = None,
        window: str = "hann",
        freq_scale: str = "no",
        center: bool = True,
        fmin: float = 50,
        fmax: float = 6000,
        sr: float = 22050,
        trainable_kernels: bool = False,
        trainable_window: bool = False,
        verbose: bool = True,
        refresh_win: bool = True,
        device=None,
    ):
        super().__init__(device)
        if win_length is None:
            win_length = n_fft
        if hop_length is None:
            hop_length = int(win_length // 4)

        self.n_fft = n_fft
        self.win_length = win_length
        self.stride = hop_length
        self.center = center
        self.pad_amount = n_fft // 2
        self.refresh_win = refresh_win

        # full-resolution (n_fft-bin) unwindowed Fourier kernels
        basis = create_fourier_basis(
            n_fft,
            win_length=win_length,
            freq_bins=n_fft,
            window=window,
            freq_scale=freq_scale,
            fmin=fmin,
            fmax=fmax,
            sr=sr,
        )
        window_mask = pad_center(
            window_dispatch(window, int(win_length), fftbins=True), n_fft
        ).astype(np.float32)

        self._register("kernel_sin", basis.wsin, trainable=trainable_kernels)
        self._register("kernel_cos", basis.wcos, trainable=trainable_kernels)
        self._register("window_mask", window_mask, trainable=trainable_window)
        self.trainable_kernels = trainable_kernels
        self._verbose_print(verbose, f"iSTFT kernels created: n_fft={n_fft}")

    def _forward(self, params, X, onesided=False, length=None):
        _check_complex(X)
        return _inverse_stft_graph(
            X,
            params["kernel_cos"],
            params["kernel_sin"],
            params["window_mask"],
            self.n_fft,
            self.stride,
            onesided,
            length,
            self.center,
            self.pad_amount,
            # trainable full banks keep the explicit mirror so the upper-half
            # kernel rows receive gradients
            fold_onesided=not self.trainable_kernels,
        )

    def forward(self, X, onesided=False, length=None, refresh_win=None):
        return self.apply(None, X, onesided=onesided, length=length)

    def apply(self, params, X, onesided=False, length=None, refresh_win=None):
        return super().apply(params, X, onesided=onesided, length=length)
