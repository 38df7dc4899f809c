"""Combined Frequency & Periodicity (CFP) multipitch features (Su & Yang).

A long-window STFT magnitude feeds alternating spectral / cepstral layers,
``relu(x)^g`` nonlinearities with index cutoffs and real transforms; the
final spectral and quefrency maps are projected onto a log-frequency axis and
multiplied (``Z = tfrLF * tfrLQ``). No kernel of the port is involved: the
transforms are ``torch.fft.rfft`` (cuFFT on the card), or
:func:`~nnaudio_tpu_torch.ops.mxu_fft.rfft_mxu` when
``config.use_mxu_fft`` is on, and matmuls.

As in the JAX package:
- every vector of the chain is even-symmetric (the STFT magnitude is,
  pointwise nonlinearities keep it, the cutoff masks are symmetric, and the
  real part of the DFT of a symmetric real vector is symmetric), so the chain
  runs on half spectra (``N//2 + 1`` bins); the interior transforms
  symmetrize and take an rfft, the final one is a matmul against a folded
  real-DFT basis (``dft_final``) cut to the rows the caller keeps;
- the cutoff zeroing is a precomputed mask; nnAudio's
  ``X[:, :, -0:] = 0`` quirk at ``cutoff == 0`` (zeroing everything) is not
  replicated: a zero cutoff masks nothing.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from scipy.signal.windows import blackmanharris

from ..config import matmul_numerics, round_to_storage
from ..core.apply import project
from ..core.frame import broadcast_dim, frame_signal
from ..filters.cfp import cfp_logfreq_matrices
from ..filters.windows import pad_center
from ..ops.mxu_fft import mxu_fft_enabled, rfft_mxu
from .base import SpectralTransform

_EPSILON = 1e-8  # nnAudio's fudge factor


def _folded_dft_basis(n: int, rows: int) -> np.ndarray:
    """(rows, n//2+1) real-DFT basis over a half-spectrum input: for an
    even-symmetric full vector v (v[m] = v[n-m]),
    ``Re(FFT_n(v))[k] == basis @ v[:n//2+1]`` with Hermitian fold weights."""
    half = n // 2 + 1
    kk = np.arange(rows)[:, None]
    mm = np.arange(half)[None, :]
    fold = np.full(half, 2.0)
    fold[0] = 1.0
    if n % 2 == 0:
        fold[-1] = 1.0
    return (np.cos(2 * np.pi * kk * mm / n) * fold[None, :]).astype(np.float32)


class Combined_Frequency_Periodicity(SpectralTransform):
    """Combined frequency & periodicity multipitch feature.

    Parameters are those of
    ``nnaudio_tpu.features.Combined_Frequency_Periodicity``: ``fr=2`` (Hz;
    the transform length is ``N = fs/fr``), ``fs=16000``,
    ``hop_length=320``, ``window_size=2049`` (Blackman-Harris, zero-padded
    to ``N``), ``fc=80`` (Hz), ``tc=1/1000`` (s), ``g=(0.24, 0.6, 1)``
    (per-layer exponents; 0 means ``log``) and ``NumPerOct=48``; plus
    ``device`` (``None`` means CUDA; pass ``device="cpu"`` for the CPU).

    Returns ``(Z, tfrL0, tfrLF, tfrLQ)``, each ``(num_audio, n_log_bins,
    time_steps)``: the combined map, and the log-frequency projections of
    the raw spectrogram, the final spectral layer and the final cepstral
    layer. The first and last frames are trimmed, as nnAudio does.
    """

    _trim_edge_frames = True

    def __init__(
        self,
        fr: float = 2,
        fs: float = 16000,
        hop_length: int = 320,
        window_size: int = 2049,
        fc: float = 80,
        tc: float = 1 / 1000,
        g=(0.24, 0.6, 1),
        NumPerOct: int = 48,
        device=None,
    ):
        super().__init__(device)
        self.window_size = window_size
        self.hop_length = hop_length

        self.N = int(fs / float(fr))
        self.half = self.N // 2 + 1
        self.f = fs * np.linspace(0, 0.5, self.N // 2, endpoint=True)
        h = blackmanharris(window_size)
        self._register("h", pad_center(h.astype(np.float32), self.N))
        self.h_norm = float(np.linalg.norm(h))

        self.g = list(g)
        self.NumofLayer = len(self.g)
        self.tc_idx = round(fs * tc)
        self.fc_idx = round(fc / fr)
        self.HighFreqIdx = int(round((1 / tc) / fr) + 1)
        self.HighQuefIdx = int(round(fs / fc) + 1)

        self.f = self.f[: self.HighFreqIdx]
        self.q = np.arange(self.HighQuefIdx) / float(fs)

        freq_mat, quef_mat = cfp_logfreq_matrices(
            self.f, self.q, fr, fc, tc, NumPerOct, fs
        )
        self._register("freq2logfreq_matrix", freq_mat.astype(np.float32))
        self._register("quef2logfreq_matrix", quef_mat.astype(np.float32))

        if self.NumofLayer >= 2:
            # the final layer's output is cropped to HighFreqIdx /
            # HighQuefIdx bins right after: keep only those DFT rows
            final_is_spec = (self.NumofLayer - 1) % 2 == 0
            k = self.HighFreqIdx if final_is_spec else self.HighQuefIdx
            self._register("dft_final",
                           _folded_dft_basis(self.N, min(k, self.half)))

    # ------------------------------------------------------------- helpers --
    def _nonlinear(self, X, g: float, cutoff: int):
        """relu^g (or log) with nnAudio's cutoff mask in half-spectrum space:
        full bin ``m`` is zeroed when ``m < cutoff`` or ``m >= N - cutoff``.
        The trailing zeros are mirrors of bins ``[1, cutoff]`` handled by the
        fold, except that for ``cutoff >= N/2`` the trailing range reaches
        into the stored half, so the exact membership test is used."""
        c = int(cutoff)
        m = np.arange(X.shape[-1])
        if c > 0:
            mask = ((m >= c) & (m < self.N - c)).astype(np.float32)
        else:
            mask = np.ones(X.shape[-1], dtype=np.float32)
        mask = torch.as_tensor(mask, dtype=X.dtype, device=X.device)
        if g != 0:
            return (torch.clamp(X, min=0.0) * mask) ** g * mask
        return torch.log(torch.clamp(X, min=0.0) + _EPSILON) * mask

    def _cfp_layers(self, spec, params):
        """The alternating cepstral / spectral layers on half spectra.

        nnAudio's cutoff mask zeros full bins ``[0, c)`` and ``[N-c, N)``,
        which is not a symmetric set: bin ``c``'s mirror ``N-c`` is zeroed
        while ``c`` survives. The fold counts ``v[c]`` twice, so each
        transform whose input carried a cutoff subtracts the one phantom
        contribution ``v[c] cos(2 pi k c / N)``, which keeps the half-space
        chain equal to nnAudio's full-length recursion."""
        spec = torch.clamp(spec, min=0.0) ** self.g[0]
        ceps = torch.zeros_like(spec)
        sqrt_n = np.sqrt(self.N)

        def phantom(v, out, c):
            c = int(c)
            if 0 < c < self.half - 1:
                cos_k = np.cos(2 * np.pi * np.arange(out.shape[-1]) * c
                               / self.N).astype(np.float32)
                out = out - v[..., c:c + 1] * torch.as_tensor(cos_k, device=v.device)
            return out

        def dft_interior(v, in_cutoff):
            # symmetrize, rfft, keep the real half
            if self.N % 2 == 0:
                full = torch.cat((v, v[..., 1:-1].flip(-1)), dim=-1)
            else:
                full = torch.cat((v, v[..., 1:].flip(-1)), dim=-1)
            out = None
            if mxu_fft_enabled():
                pair = rfft_mxu(full)
                if pair is not None:
                    out = pair[0]
            if out is None:
                out = torch.fft.rfft(full, dim=-1).real
            return phantom(v, out, in_cutoff) / sqrt_n

        def dft_final(v, in_cutoff):
            with matmul_numerics():
                out = torch.matmul(round_to_storage(v),
                                   round_to_storage(params["dft_final"]).t())
            return phantom(v, out, in_cutoff) / sqrt_n

        in_cutoff = 0  # layer 0's relu^g carries no mask
        for gc in range(1, self.NumofLayer):
            dft = dft_final if gc == self.NumofLayer - 1 else dft_interior
            if gc % 2 == 1:
                ceps = self._nonlinear(dft(spec, in_cutoff), self.g[gc], self.tc_idx)
                in_cutoff = self.tc_idx
            else:
                spec = self._nonlinear(dft(ceps, in_cutoff), self.g[gc], self.fc_idx)
                in_cutoff = self.fc_idx
        return spec, ceps

    def _stft_mag(self, params, x):
        """nnAudio's ``torch.stft(N, hop, blackmanharris(window_size),
        center=True, pad_mode='constant')`` magnitude as (B, T, N//2+1) half
        spectra, normalized by ||h||; the mirrored full spectrum is never
        built."""
        x = F.pad(x, (self.N // 2, self.N // 2))
        windowed = frame_signal(x, self.N, self.hop_length) * params["h"]
        if mxu_fft_enabled():
            pair = rfft_mxu(windowed)
            if pair is not None:
                re, im = pair
                return torch.sqrt(re * re + im * im) / self.h_norm
        return torch.fft.rfft(windowed, dim=-1).abs() / self.h_norm

    # ------------------------------------------------------------- forward --
    def _forward(self, params, x):
        x = broadcast_dim(x)
        tfr0 = self._stft_mag(params, x)  # (B, T, N//2+1)
        if self._trim_edge_frames:
            tfr0 = tfr0[:, 1:-1]
        tfr, ceps = self._cfp_layers(tfr0, params)

        tfr0 = tfr0[:, :, : self.HighFreqIdx]
        tfr = tfr[:, :, : self.HighFreqIdx]
        ceps = ceps[:, :, : self.HighQuefIdx]

        tfrL0 = project(params["freq2logfreq_matrix"], tfr0.transpose(1, 2))
        tfrLF = project(params["freq2logfreq_matrix"], tfr.transpose(1, 2))
        tfrLQ = project(params["quef2logfreq_matrix"], ceps.transpose(1, 2))
        return tfrLF * tfrLQ, tfrL0, tfrLF, tfrLQ

    def forward(self, x):
        out = self.apply(None, x)
        # nnAudio's host-side frame times
        length = np.shape(x)[-1]
        self.t = np.arange(
            self.hop_length,
            np.ceil(length / float(self.hop_length)) * self.hop_length,
            self.hop_length,
        )
        return out


class CFP(Combined_Frequency_Periodicity):
    """Combined Frequency & Periodicity, single output: returns only ``Z``
    and keeps the edge frames, so its time steps align with the other
    transforms of the package. Same parameters as
    :class:`Combined_Frequency_Periodicity`."""

    _trim_edge_frames = False

    def _forward(self, params, x):
        return super()._forward(params, x)[0]
