"""Constant-Q transform family: CQT1992, CQT1992v2 (= CQT), CQT2010, CQT2010v2.

Every variant is one or more framed basis products of the signal against
wavelet banks; the 2010 pyramid runs one per octave, with FIR downsampling by
2 between octaves. ``CQT1992v2`` Magnitude against its frozen bank is one
``framed_magnitude`` (the K6 CUDA kernel for CUDA tensors at the default
84 x 16384 bank); the other outputs and every pyramid octave go through the
pair (K5).

Conventions kept from the JAX package (and nnAudio):
- the 1992 family pads ``kernel_width // 2`` only when ``center=True``; the
  2010 pyramid always pads ``n_fft // 2`` per octave.
- Sign conventions differ per variant: CQT1992 stacks ``(real, -imag)`` after
  the complex product but computes Phase from the un-negated,
  un-normalized pair; CQT1992v2 and CQT2010v2 negate at the analysis;
  CQT2010 stacks the complex product without negation.
- ``normalization_type`` in {librosa, convolutional, wrap} on every variant.
- Magnitude adds 1e-8 under the sqrt only when trainable.

The pyramid has two switches of the JAX package (``config``): the fused
pyramid (``ops/pyramid``, every octave in one batched matmul) and the
parallel decimation chain (every level from the top-rate signal through a
composed cascade filter). Both are off by default.

Every class has an approximate ``.inverse`` through canonical-dual
synthesis kernels and ``synthesis_ola`` (K3); the pyramid's collapses the
whole multirate analysis into one single-rate dual bank.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch
import torch.nn.functional as F

from ..core.apply import complex_bank_mul, phase_unit_stack
from ..core.frame import broadcast_dim, pad_signal
from ..config import parallel_chain_enabled
from ..core.resample import compose_cascade, compose_cascade_torch, downsample_by_n
from ..filters.cqt import create_cqt_kernels, create_lowpass_filter, early_downsample_params
from ..filters.fourier import create_fourier_basis
from ..ops.dispatch import (framed_basis_pair, framed_complex, framed_magnitude,
                            synthesis_ola)
from ..ops.pyramid import pyramid_basis_pair, pyramid_enabled
from .base import SpectralTransform, to_float32


def _center_pad(x, pad_amount: int, pad_mode: str):
    """Reflect padding with nnAudio's constant-pad fallback for signals
    shorter than the pad."""
    if pad_mode == "reflect" and x.shape[-1] < pad_amount + 1:
        warnings.warn(
            f"input size = {tuple(x.shape)}\tkernel pad = {pad_amount}\n"
            "padding with reflection mode might not be the best choice, "
            "try using constant padding",
            UserWarning,
        )
        pad_mode = "constant"
    return pad_signal(x, pad_amount, pad_mode)


def _cqt_output(real, imag, output_format: str, trainable: bool):
    """Shared Magnitude/Complex/Phase heads."""
    if output_format == "Magnitude":
        power = real * real + imag * imag
        if trainable:
            return torch.sqrt(power + 1e-8)
        return torch.sqrt(power)
    if output_format == "Complex":
        return torch.stack((real, imag), dim=-1)
    if output_format == "Phase":
        return phase_unit_stack(real, imag)
    raise ValueError(f"unknown output_format {output_format!r}")


def _dual_synthesis_bank(atoms: np.ndarray, hop: int, band_eta: float):
    """Canonical-dual synthesis kernels (fp64 numpy) for a frame of complex
    analysis atoms (rows of ``atoms``; ``X = x.A`` at stride ``hop``).

    The frame operator of a band-limited multi-bin frame is diagonal in
    frequency, so the duals divide by ``G(w) = sum_f |B_f(w)|^2`` on the
    covered band: ``D_f = hop conj(B_f) [G > eta Gmax] / max(G, eta Gmax)``
    with ``B_f(w) = sum_s A_f[s] e^{+iws}``. The eta floor keeps the ratio
    from amplifying 0/0 noise at band edges and mirror frequencies.

    Returns float32 numpy ``(kc, ks)`` such that ``x^ = OLA(kc^T Xr - ks^T
    Xi)`` (``ops.dispatch.synthesis_ola``'s convention); the factor 2 folded
    in recovers the real signal from its positive-band analytic part."""
    B = np.conj(np.fft.fft(np.conj(atoms), axis=1))
    G = (np.abs(B) ** 2).sum(0)
    g0 = G.max() * band_eta
    Dh = hop * np.conj(B) * (G > g0) / np.maximum(G, g0)
    d = np.fft.ifft(Dh, axis=1)
    return (2.0 * d.real).astype(np.float32), (2.0 * d.imag).astype(np.float32)


def _warn_undersampled_hop(hop: int, lengths, context: str) -> None:
    """One warning for every inverse entry point: when ``hop`` exceeds half
    the shortest analysis atom, the top-octave subband envelopes are sampled
    below their bandwidth; the loss is the forward operator's and no inverse
    can recover it."""
    lmin = float(np.min(np.asarray(lengths)))
    if hop > lmin / 2:
        warnings.warn(
            f"{context}: hop_length={hop} exceeds half the shortest atom "
            f"({lmin:.0f}); top-octave envelopes are under-sampled and "
            "reconstruction quality degrades — use a smaller hop or fewer "
            "top bins"
        )


def _check_norm_type(normalization_type: str):
    if normalization_type not in ("librosa", "convolutional", "wrap"):
        raise ValueError(
            "The normalization_type %r is not part of our current options."
            % normalization_type
        )


def _np64(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float64)


class _CQTCall:
    """The call signature the CQT family shares: ``layer(x, output_format=,
    normalization_type=)`` and its functional form ``apply(params, x, ...)``."""

    def forward(self, x, output_format=None, normalization_type="librosa"):
        return self.apply(None, x, output_format=output_format,
                          normalization_type=normalization_type)

    def apply(self, params, x, output_format=None, normalization_type="librosa"):
        return super().apply(params, x,
                             output_format=output_format or self.output_format,
                             normalization_type=normalization_type)


class _FlatCQTInverse:
    """Mixin: canonical-dual inverse for the single-rate (flat-bank) CQT
    classes. The host class provides ``_inverse_atoms_flat(norm_type)`` (the
    scaled complex analysis atoms such that ``X = x.A``), the names of the
    tensors those atoms are built from (``_atom_tensors``), ``hop_length`` /
    ``kernel_width`` / ``center`` and a ``_dual_cache`` dict."""

    def _dual_kernels(self, normalization_type, band_eta):
        """Canonical-dual synthesis kernels (fp64 numpy at build, float32 on
        the transform's device), cached until a kernel changes: the key holds
        the tensors' versions, so an optimizer's in-place step misses the
        cache like ``update_params`` and ``load_state_dict``, which clear it."""
        params = self.params
        key = (normalization_type, band_eta, str(self.device),
               tuple(params[k]._version for k in self._atom_tensors
                     if k in params))
        cached = self._dual_cache.get(key)
        if cached is not None:
            return cached
        kc, ks = _dual_synthesis_bank(
            self._inverse_atoms_flat(normalization_type),
            self.hop_length, band_eta)
        self._dual_cache[key] = (to_float32(kc, self.device),
                                 to_float32(ks, self.device))
        return self._dual_cache[key]

    def _refresh_derived(self, changed):
        # the dual bank is a function of the kernels and lenghts: any
        # persistent change of a tensor invalidates it
        self._dual_cache.clear()

    def inverse(self, X, normalization_type="librosa", length=None,
                band_eta=1e-3):
        """Approximate inverse CQT.

        Takes ``Complex``-format output ``(B, n_bins, T, 2)`` produced with
        the same ``normalization_type`` and reconstructs a waveform with
        canonical-dual synthesis atoms: one synthesis + overlap-add
        (``ops.dispatch.synthesis_ola``, the K3 kernel for CUDA tensors).

        Two limits belong to the operator, not the implementation: energy
        outside the covered band was never captured by the forward; and the
        top-octave subbands are sampled at ``sr/hop``, so if ``hop`` exceeds
        half the shortest atom (``lenghts.min()/2``) their envelopes alias
        irrecoverably. A warning fires in that regime.

        Uses the stored kernels (like ``STFT.inverse``); ``length``
        trims/pads the output."""
        X = self._input(X)
        if X.ndim != 4 or X.shape[-1] != 2:
            raise AssertionError(
                "inverse expects Complex format (batch, n_bins, time, 2); "
                "for magnitude CQTs use GriffinLimCQT."
            )
        _check_norm_type(normalization_type)
        _warn_undersampled_hop(self.hop_length, _np64(self.lenghts),
                               "inverse CQT")
        kc, ks = self._dual_kernels(normalization_type, band_eta)
        # frames_t[s] = 2 Re{sum_f X[f,t] d_f[s]} = sum_f (2dr Xr - 2di Xi):
        # exactly OLA(kc^T Xr - ks^T Xi)
        out = synthesis_ola(X[..., 0], X[..., 1], kc, ks, self.hop_length)
        if self.center:
            pad = self.kernel_width // 2
            out = out[:, pad: out.shape[-1] - pad]
        if length is not None:
            out = out[:, :length]
            if out.shape[-1] < length:
                out = F.pad(out, (0, length - out.shape[-1]))
        return out


class CQT1992(_CQTCall, _FlatCQTInverse, SpectralTransform):
    """Original Brown-Puckette constant-Q transform: a rectangular-window
    Fourier stage followed by a frequency-domain complex product with FFT'd
    CQT kernels. When neither stage is trainable, both linear maps are
    composed once at init (in fp64) into a single time-domain basis pair:
    one framed product instead of two.

    Parameters are those of ``nnaudio_tpu.features.CQT1992`` (``sr``,
    ``hop_length``, ``fmin``, ``fmax``, ``n_bins``, ``trainable_STFT``,
    ``trainable_CQT``, ``bins_per_octave``, ``filter_scale``,
    ``output_format``, ``norm``, ``window``, ``center``, ``pad_mode``), plus
    ``device`` (``None`` means CUDA; pass ``device="cpu"`` for the CPU).

    Returns ``(num_audio, n_bins, time_steps)`` for Magnitude and
    ``(num_audio, n_bins, time_steps, 2)`` for Complex/Phase. The Phase
    output uses the raw un-negated, un-normalized pair, a quirk of nnAudio
    kept for parity.
    """

    _atom_tensors = ("combined_real", "combined_imag", "lenghts")

    def __init__(
        self,
        sr: float = 22050,
        hop_length: int = 512,
        fmin: float = 220,
        fmax: float | None = None,
        n_bins: int = 84,
        trainable_STFT: bool = False,
        trainable_CQT: bool = False,
        bins_per_octave: int = 12,
        filter_scale: float = 1,
        output_format: str = "Magnitude",
        norm: float = 1,
        window: str = "hann",
        center: bool = True,
        pad_mode: str = "reflect",
        device=None,
    ):
        super().__init__(device)
        self.hop_length = hop_length
        self.center = center
        self.pad_mode = pad_mode
        self.output_format = output_format
        self.trainable = trainable_STFT or trainable_CQT
        self._dual_cache: dict = {}

        Q = float(filter_scale) / (2 ** (1 / bins_per_octave) - 1)
        bank = create_cqt_kernels(
            Q, sr, fmin, n_bins, bins_per_octave, norm, window, fmax
        )
        self.kernel_width = bank.fft_len
        self.frequencies = bank.freqs
        self._register("lenghts", bank.lengths)

        # kernels to the frequency domain, keep the onesided half
        fft_kernels = np.fft.fft(bank.kernels, axis=1)[:, : self.kernel_width // 2 + 1]
        self._register("cqt_kernels_real", fft_kernels.real.astype(np.float32),
                       trainable=trainable_CQT)
        self._register("cqt_kernels_imag", fft_kernels.imag.astype(np.float32),
                       trainable=trainable_CQT)

        fourier = create_fourier_basis(
            self.kernel_width, window="ones", freq_scale="no"
        )
        self.bins2freq = fourier.bins2freq
        self._register("wsin", fourier.wsin * fourier.window_mask[None, :],
                       trainable=trainable_STFT)
        self._register("wcos", fourier.wcos * fourier.window_mask[None, :],
                       trainable=trainable_STFT)

        if not self.trainable:
            # both stages are linear maps: compose them once at init (in
            # fp64) into a single (n_bins, kernel_width) time-domain basis
            # pair: real = (kr Wcos - ki Wsin) x, imag = (kr Wsin + ki Wcos) x
            kr = fft_kernels.real.astype(np.float64)
            ki = fft_kernels.imag.astype(np.float64)
            wc = (fourier.wcos * fourier.window_mask[None, :]).astype(np.float64)
            ws = (fourier.wsin * fourier.window_mask[None, :]).astype(np.float64)
            self._register("combined_real", (kr @ wc - ki @ ws).astype(np.float32))
            self._register("combined_imag", (kr @ ws + ki @ wc).astype(np.float32))

    def _forward(self, params, x, output_format=None, normalization_type="librosa"):
        output_format = output_format or self.output_format
        _check_norm_type(normalization_type)
        x = broadcast_dim(x)
        if self.center:
            x = _center_pad(x, self.kernel_width // 2, self.pad_mode)

        if not self.trainable:
            if output_format == "Magnitude":
                mag = framed_magnitude(
                    x, params["combined_real"], params["combined_imag"],
                    self.hop_length,
                )
                if normalization_type == "librosa":
                    return mag * (torch.sqrt(params["lenghts"])[None, :, None]
                                  / self.kernel_width)
                if normalization_type == "wrap":
                    return mag * (2 / self.kernel_width)
                return mag
            cqt_real, cqt_imag = framed_basis_pair(
                x, params["combined_real"], params["combined_imag"],
                self.hop_length,
            )
        else:
            fourier_real, fourier_imag = framed_basis_pair(
                x, params["wcos"], params["wsin"], self.hop_length
            )
            cqt_real, cqt_imag = complex_bank_mul(
                params["cqt_kernels_real"],
                params["cqt_kernels_imag"],
                fourier_real,
                fourier_imag,
            )

        # normalized components carry nnAudio's (real, -imag) stack
        real_n, imag_n = cqt_real, -cqt_imag
        if normalization_type == "librosa":
            scale = torch.sqrt(params["lenghts"])[None, :, None] / self.kernel_width
            real_n, imag_n = real_n * scale, imag_n * scale
        elif normalization_type == "wrap":
            real_n, imag_n = real_n * (2 / self.kernel_width), imag_n * (2 / self.kernel_width)

        if output_format == "Phase":
            # quirk: Phase uses the raw, un-negated, un-normalized pair
            return phase_unit_stack(cqt_real, cqt_imag)
        return _cqt_output(real_n, imag_n, output_format, trainable=False)

    def _norm_scale_np(self, normalization_type):
        n = self.lenghts.shape[0]
        if normalization_type == "librosa":
            return np.sqrt(_np64(self.lenghts)) / self.kernel_width
        if normalization_type == "wrap":
            return np.full((n,), 2.0 / self.kernel_width)
        return np.ones((n,))

    def _inverse_atoms_flat(self, normalization_type):
        # the composed frozen basis keeps the negated-imag Complex
        # convention: X = s (x.Cr) - i s (x.Ci)
        params = self.params
        if "combined_real" not in params:
            raise NotImplementedError(
                "CQT1992.inverse needs the frozen composed basis "
                "(trainable_STFT=trainable_CQT=False)")
        cr, ci = _np64(params["combined_real"]), _np64(params["combined_imag"])
        return self._norm_scale_np(normalization_type)[:, None] * (cr - 1j * ci)

    def extra_repr(self) -> str:
        return "STFT kernel size = {}, CQT kernel size = {}".format(
            tuple(self.wcos.shape), tuple(self.cqt_kernels_real.shape),
        )


class CQT1992v2(_CQTCall, _FlatCQTInverse, SpectralTransform):
    """Direct time-domain constant-Q transform: one framed product of the
    signal against complex log-spaced wavelets (this is what the :class:`CQT`
    alias resolves to). Magnitude with a frozen bank is one
    ``framed_magnitude``: for CUDA tensors the K6 kernel at the default
    84 x 16384 bank.

    Parameters are those of ``nnaudio_tpu.features.CQT1992v2`` (``sr``,
    ``hop_length``, ``fmin``, ``fmax``, ``n_bins``, ``bins_per_octave``,
    ``filter_scale``, ``norm``, ``window``, ``center``, ``pad_mode``,
    ``trainable``, ``output_format``, ``verbose``), plus ``device`` (``None``
    means CUDA; pass ``device="cpu"`` for the CPU).

    Returns ``(num_audio, n_bins, time_steps)`` for Magnitude and
    ``(num_audio, n_bins, time_steps, 2)`` for Complex/Phase.
    ``forward_manual(x)`` is nnAudio's manual-normalization variant
    (``* sqrt(lenghts)``, un-negated imag).
    """

    _atom_tensors = ("cqt_kernels_real", "cqt_kernels_imag", "lenghts")

    def __init__(
        self,
        sr: float = 22050,
        hop_length: int = 512,
        fmin: float = 32.70,
        fmax: float | None = None,
        n_bins: int = 84,
        bins_per_octave: int = 12,
        filter_scale: float = 1,
        norm: float = 1,
        window="hann",
        center: bool = True,
        pad_mode: str = "reflect",
        trainable: bool = False,
        output_format: str = "Magnitude",
        verbose: bool = True,
        device=None,
    ):
        super().__init__(device)
        self.trainable = trainable
        self.hop_length = hop_length
        self.center = center
        self.pad_mode = pad_mode
        self.output_format = output_format
        #: lazily-built canonical-dual synthesis kernels for inverse()
        self._dual_cache: dict = {}

        Q = float(filter_scale) / (2 ** (1 / bins_per_octave) - 1)
        bank = create_cqt_kernels(
            Q, sr, fmin, n_bins, bins_per_octave, norm, window, fmax
        )
        self.kernel_width = bank.fft_len
        self.frequencies = bank.freqs
        self._register("lenghts", bank.lengths)
        self._register("cqt_kernels_real", bank.kernels.real.astype(np.float32),
                       trainable=trainable)
        self._register("cqt_kernels_imag", bank.kernels.imag.astype(np.float32),
                       trainable=trainable)
        self._verbose_print(
            verbose,
            f"CQT kernels created: {bank.kernels.shape} (width={self.kernel_width})",
        )

    def _forward(self, params, x, output_format=None, normalization_type="librosa"):
        output_format = output_format or self.output_format
        _check_norm_type(normalization_type)
        x = broadcast_dim(x)
        if self.center:
            x = _center_pad(x, self.kernel_width // 2, self.pad_mode)

        if output_format == "Magnitude" and not self.trainable:
            # |(r, -i)| == |(r, i)| and the normalizations are positive
            # per-bin scales, so the magnitude op applies directly
            mag = framed_magnitude(
                x, params["cqt_kernels_real"], params["cqt_kernels_imag"],
                self.hop_length,
            )
            if normalization_type == "librosa":
                return mag * torch.sqrt(params["lenghts"])[None, :, None]
            if normalization_type == "wrap":
                return mag * 2
            return mag

        if output_format == "Complex":
            # the stacked Complex with the normalization scale folded in
            if normalization_type == "librosa":
                scale = torch.sqrt(params["lenghts"])
            elif normalization_type == "wrap":
                scale = torch.full_like(params["lenghts"], 2.0)
            else:
                scale = None
            return framed_complex(
                x, params["cqt_kernels_real"], params["cqt_kernels_imag"],
                scale, self.hop_length,
            )

        real, imag_raw = framed_basis_pair(
            x, params["cqt_kernels_real"], params["cqt_kernels_imag"], self.hop_length
        )
        imag = -imag_raw

        if normalization_type == "librosa":
            scale = torch.sqrt(params["lenghts"])[None, :, None]
            real, imag = real * scale, imag * scale
        elif normalization_type == "wrap":
            real, imag = real * 2, imag * 2

        return _cqt_output(real, imag, output_format, trainable=self.trainable)

    def _norm_scale_np(self, normalization_type):
        n = self.lenghts.shape[0]
        if normalization_type == "librosa":
            return np.sqrt(_np64(self.lenghts))
        if normalization_type == "wrap":
            return np.full((n,), 2.0)
        return np.ones((n,))

    def _inverse_atoms_flat(self, normalization_type):
        # time-domain bank with the negated-imag convention:
        # X = s (x.Kr) - i s (x.Ki), so A = s (Kr - i Ki)
        kr, ki = _np64(self.cqt_kernels_real), _np64(self.cqt_kernels_imag)
        return self._norm_scale_np(normalization_type)[:, None] * (kr - 1j * ki)

    def forward_manual(self, x):
        """nnAudio's debug path: un-negated imag, magnitude scaled by
        sqrt(lengths)."""
        x = broadcast_dim(self._input(x))
        if self.center:
            x = _center_pad(x, self.kernel_width // 2, self.pad_mode)
        real, imag = framed_basis_pair(
            x, self.cqt_kernels_real, self.cqt_kernels_imag, self.hop_length,
        )
        mag = torch.sqrt(real * real + imag * imag)
        return mag * torch.sqrt(self.lenghts)[None, :, None]

    def extra_repr(self) -> str:
        return "CQT kernel size = {}, trainable = {}".format(
            tuple(self.cqt_kernels_real.shape), self.trainable
        )


class CQT(CQT1992v2):
    """Alias of :class:`CQT1992v2`."""


class _PyramidCQT(_CQTCall, SpectralTransform):
    """Shared init machinery, decimation chain and inverse of the 2010
    multi-octave pyramid: octave count, top-octave band placement,
    early-downsample calculus, lowpass FIR, per-bin lengths.

    Subclasses provide ``_octave_cqt(params, x, hop, octave)`` (one octave's
    pair), ``_fused_banks(params)`` (the per-octave banks, center pads and
    the sign of the imaginary part for the fused pyramid, or ``None``) and
    ``_inverse_atoms()`` (the per-level complex analysis atoms)."""

    def __init__(self, device=None):
        super().__init__(device)
        #: the parallel chain's composed cascade filters, a pure function of
        #: ``lowpass_filter`` rebuilt in fp64 whenever it changes (never in
        #: the state), keyed on the filter's version and device
        self._cascades: dict[int, torch.Tensor] = {}
        self._cascade_key = None
        #: the pyramid inverse's dual synthesis banks, cached until a tensor
        #: changes (their key holds every tensor's version)
        self._dual_cache: dict = {}

    def _init_pyramid(
        self,
        sr,
        hop_length,
        fmin,
        fmax,
        n_bins,
        bins_per_octave,
        filter_scale,
        earlydownsample,
        verbose,
    ):
        Q = float(filter_scale) / (2 ** (1 / bins_per_octave) - 1)
        lowpass = create_lowpass_filter(
            band_center=0.5, kernel_length=256, transition_bandwidth=0.001
        )
        self._register("lowpass_filter", lowpass)
        self._lowpass_pad = (lowpass.shape[-1] - 1) // 2

        n_filters = min(bins_per_octave, n_bins)
        self.n_octaves = int(np.ceil(float(n_bins) / bins_per_octave))
        self._verbose_print(verbose, f"num_octave = {self.n_octaves}")

        self.fmin_t = fmin * 2 ** (self.n_octaves - 1)
        remainder = n_bins % bins_per_octave
        if remainder == 0:
            fmax_t = self.fmin_t * 2 ** ((bins_per_octave - 1) / bins_per_octave)
        else:
            fmax_t = self.fmin_t * 2 ** ((remainder - 1) / bins_per_octave)
        self.fmin_t = fmax_t / 2 ** (1 - 1 / bins_per_octave)
        if fmax_t > sr / 2:
            raise ValueError(
                f"The top bin {fmax_t}Hz has exceeded the Nyquist frequency, "
                "please reduce the n_bins"
            )

        if earlydownsample:
            new_sr, new_hop, factor, filt, active = early_downsample_params(
                sr, hop_length, fmax_t, Q, self.n_octaves
            )
            self.earlydownsample = active
            self.downsample_factor = factor
            if active:
                self._verbose_print(
                    verbose, f"Early downsample active, factor = {factor}"
                )
                sr, hop_length = new_sr, new_hop
                self._register("early_downsample_filter", filt)
        else:
            self.earlydownsample = False
            self.downsample_factor = 1.0

        self.hop_length = hop_length
        if hop_length % 2 ** (self.n_octaves - 1):
            # the per-octave chain floor-divides the hop: deep octaves then
            # disagree on frame counts for most signal lengths or silently
            # time-misalign. Surface it at construction; behavior is
            # unchanged (parity).
            warnings.warn(
                f"hop_length={hop_length} (after early downsampling) is not "
                f"a multiple of 2**(n_octaves-1) = {2 ** (self.n_octaves - 1)}"
                "; per-octave hops will floor-divide, which breaks or "
                "misaligns the deepest octaves for most input lengths"
            )
        return Q, sr, n_filters

    def _derived_state_key(self, key: str) -> bool:
        # older JAX snapshots stored the parallel chain's composed cascade
        # filters, which are a function of lowpass_filter
        return key.startswith("lowpass_cascade_")

    def _refresh_derived(self, changed):
        # the caches key on the tensors' versions, which an in-place change
        # bumps; a tensor replaced by load_state_dict(assign=True) may carry
        # the old one's version, so drop the duals and cascades of old values
        self._dual_cache.clear()
        self._cascade_key = None

    def _cascade(self, params, k: int) -> torch.Tensor:
        """The composed filter of ``k`` chain stages: fp64-built from the
        stored ``lowpass_filter`` (rebuilt when it changed, also in place),
        or composed in torch from a filter passed to ``apply``, so that
        gradients reach it."""
        fir = params["lowpass_filter"]
        if fir is not self.lowpass_filter:
            return compose_cascade_torch(fir, k)
        key = (id(fir), fir._version, str(fir.device))
        if self._cascade_key != key:
            h = _np64(fir)
            self._cascades = {
                j: to_float32(compose_cascade(h, j), fir.device)
                for j in range(2, self.n_octaves)}
            self._cascade_key = key
        return self._cascades[k]

    def _early_downsample(self, params, x):
        x = broadcast_dim(x)
        if self.earlydownsample:
            x = downsample_by_n(
                x, params["early_downsample_filter"], int(self.downsample_factor)
            )
        return x

    def _pyramid_chain(self, params, x):
        """Downsampled signal and hop per octave, top octave first. Two
        implementations of the same sums (``config.use_parallel_chain``):
        nnAudio's serial lowpass + decimate per octave, or every level
        computed from ``x`` through a composed cascade filter."""
        hop = self.hop_length
        hops = [hop]
        for _ in range(self.n_octaves - 1):
            hop //= 2
            hops.append(hop)
        if parallel_chain_enabled() and self.n_octaves > 1:
            return self._parallel_levels(params, x), hops
        levels, x_down = [x], x
        for _ in range(self.n_octaves - 1):
            x_down = downsample_by_n(x_down, params["lowpass_filter"], 2)
            levels.append(x_down)
        return levels, hops

    # The serial chain zero-pads each stage by p = 127 and truncates each
    # stage's output to floor(L/2) before the next stage reads it, so the
    # first and last <= 127 samples of every level are functions of injected
    # zeros, not of the composed operator on x. The composed products are
    # exact in the interior; both edges are derived again serially from the
    # previous corrected level, _EDGE_FIX outputs each.
    _EDGE_FIX = 192  # > the 127-sample fixed point of the edge recursion

    def _parallel_levels(self, params, x):
        """Every pyramid level from the top-rate signal: one strided product
        per level against its composed cascade filter, plus the serial
        head and tail corrections. Equal to the serial chain up to fp32
        reassociation."""
        fir = params["lowpass_filter"]
        taps = fir.shape[-1]
        p = self._lowpass_pad
        e0 = self._EDGE_FIX
        comp = [x]
        for k in range(1, self.n_octaves):
            firk = fir if k == 1 else self._cascade(params, k)
            comp.append(downsample_by_n(x, firk, 2**k, pad=p * (2**k - 1)))
        levels = [x]
        for k in range(1, self.n_octaves):
            if k == 1:
                # comp[1] (the base filter, pad p) is the serial stage itself
                levels.append(comp[1])
                continue
            prev, lc = levels[k - 1], comp[k].shape[-1]
            if lc == 0 or 2 * min(e0, lc) >= lc:
                # the level lies (nearly) inside the correction window
                levels.append(downsample_by_n(prev, fir, 2))
                continue
            e = min(e0, lc)
            # head: the standard stage needs only prev's prefix
            head = downsample_by_n(prev[:, : 2 * (e - 1) + p + 2], fir, 2)[:, :e]
            # tail: a valid product over prev's suffix, with the serial
            # chain's zero extension past len(prev) written out
            start = lc - e
            a = 2 * start - p
            need = 2 * (e - 1) + taps
            w = prev[:, max(a, 0):]
            lpad = max(0, -a)
            rpad = need - lpad - w.shape[-1]
            w = F.pad(w, (lpad, max(rpad, 0)))
            if rpad < 0:
                w = w[:, :need]
            tail = downsample_by_n(w, fir, 2, pad=0)
            levels.append(torch.cat([head, comp[k][:, e:start], tail], dim=-1))
        return levels

    def _fused_pyramid(self, params, levels, hops):
        """Every octave in one batched matmul (``ops/pyramid``), deepest
        level first as the loop assembles the bins; ``None`` when the switch
        is off, the class has no fused form or the levels' frame counts
        disagree."""
        if not pyramid_enabled():
            return None
        fused = self._fused_banks(params)
        if fused is None:
            return None
        banks, negate = fused
        padded = [_center_pad(lv, pad, self.pad_mode)
                  for lv, (_, _, pad) in zip(levels, banks)]
        out = pyramid_basis_pair(padded[::-1], [b[0] for b in banks[::-1]],
                                 [b[1] for b in banks[::-1]], hops[::-1])
        if out is None:
            return None
        real, imag = out
        return real, (-imag if negate else imag)

    def _fused_banks(self, params):
        return None

    def _octave_loop(self, params, x):
        """The per-octave transforms stacked along the bin axis, deepest
        octave first, cut to the top ``n_bins``."""
        levels, hops = self._pyramid_chain(params, x)
        fused = self._fused_pyramid(params, levels, hops)
        if fused is not None:
            real, imag = fused
        else:
            real, imag = self._octave_cqt(params, levels[0], hops[0], 0)
            for i in range(1, self.n_octaves):
                r1, i1 = self._octave_cqt(params, levels[i], hops[i], i)
                real = torch.cat((r1, real), dim=1)
                imag = torch.cat((i1, imag), dim=1)
        return real[:, -self.n_bins:], imag[:, -self.n_bins:]

    def _forward_time_domain(self, params, x, output_format, normalization_type):
        """The forward CQT2010v2 and VQT share: the octave loop on negated
        time-domain banks, the ``downsample_factor`` scale, the
        normalization and the output head."""
        output_format = output_format or self.output_format
        _check_norm_type(normalization_type)
        real, imag = self._octave_loop(params, self._early_downsample(params, x))
        real = real * self.downsample_factor
        imag = imag * self.downsample_factor

        if normalization_type == "librosa":
            scale = torch.sqrt(params["lenghts"])[None, :, None]
            real, imag = real * scale, imag * scale
        elif normalization_type == "wrap":
            real, imag = real * 2, imag * 2

        return _cqt_output(real, imag, output_format, trainable=self.trainable)

    # ------------------------------------------------------------ inverse --
    def _inverse_atoms(self):
        """Per-level complex analysis atoms ``A`` (``X_level = x_level.A``)
        and per-level center pads."""
        raise NotImplementedError

    def _inverse_scale(self, normalization_type):
        """Per-bin output scale of the forward (fp64 numpy): the CQT2010v2 /
        VQT convention, the downsample_factor times the normalization's
        scale. CQT2010 overrides it."""
        f = float(self.downsample_factor)
        if normalization_type == "librosa":
            return f * np.sqrt(_np64(self.lenghts))
        if normalization_type == "wrap":
            return np.full(self.n_bins, 2.0 * f)
        return np.full(self.n_bins, f)

    def _pyramid_dual_kernels(self, normalization_type, band_eta):
        """Canonical-dual synthesis bank for the whole pyramid, built by
        collapsing the multirate analysis to a single-rate frame: octave
        ``j`` analyzes the 2^j-decimated signal at hop ``hop/2^j``, which in
        original-rate terms is a frame at the original hop whose effective
        atom is ``H_j * up_{2^j}(A_f)`` (the composed decimation cascade
        convolved with the zero-stuffed bank atom), shifted by the
        accumulated pads ``c_j = 2^j P_j + p (2^j - 1)`` (and the early
        downsampling stage when it is active). One dual construction over
        the embedded effective bank then inverts every octave at once.

        Returns ``(kc, ks, start, hop_top)``: float32 tensors on the
        transform's device, the offset of the signal in the synthesis, and
        the synthesis hop. Built in fp64 on the host and cached until a
        tensor changes."""
        from scipy.signal import fftconvolve

        params = self.params
        key = (normalization_type, band_eta, str(self.device),
               tuple((k, v._version) for k, v in sorted(params.items())))
        cached = self._dual_cache.get(key)
        if cached is not None:
            return cached
        level_atoms, level_pads = self._inverse_atoms()
        lowpass = _np64(params["lowpass_filter"])
        p = self._lowpass_pad
        early = self.earlydownsample
        f_early = int(self.downsample_factor) if early else 1
        eff, offs = [], []
        for j in range(self.n_octaves):
            a = level_atoms[j]
            if j == 0:
                e, c = a, int(level_pads[0])
            else:
                h = compose_cascade(lowpass, j)
                up = np.zeros((a.shape[0], (a.shape[1] - 1) * 2 ** j + 1),
                              np.complex128)
                up[:, :: 2 ** j] = a
                e = fftconvolve(up, h[None, :], mode="full", axes=1)
                c = 2 ** j * int(level_pads[j]) + p * (2 ** j - 1)
            if early:
                ef = _np64(params["early_downsample_filter"])
                up = np.zeros((e.shape[0], (e.shape[1] - 1) * f_early + 1),
                              np.complex128)
                up[:, ::f_early] = e
                e = fftconvolve(up, ef[None, :], mode="full", axes=1)
                c = f_early * c + (ef.shape[-1] - 1) // 2
            eff.append(e)
            offs.append(c)
        hop_top = self.hop_length * f_early
        start = max(offs)
        w_eff = max(start - c + e.shape[1] for e, c in zip(eff, offs))
        rows = []  # deepest octave first, as the forward stacks its bins
        for j in reversed(range(self.n_octaves)):
            full = np.zeros((eff[j].shape[0], w_eff), np.complex128)
            s0 = start - offs[j]
            full[:, s0: s0 + eff[j].shape[1]] = eff[j]
            rows.append(full)
        atoms = np.concatenate(rows, axis=0)[-self.n_bins:]
        atoms = atoms * self._inverse_scale(normalization_type)[:, None]
        kc, ks = _dual_synthesis_bank(atoms, hop_top, band_eta)
        out = (to_float32(kc, self.device), to_float32(ks, self.device),
               start, hop_top)
        self._dual_cache[key] = out
        return out

    def _inverse_graph(self, X, kc, ks, start, hop_top, length):
        out = synthesis_ola(X[..., 0], X[..., 1], kc, ks, hop_top)
        want = hop_top * (X.shape[2] - 1) if length is None else length
        out = out[:, start: start + want]
        if out.shape[-1] < want:
            out = F.pad(out, (0, want - out.shape[-1]))
        return out

    def inverse(self, X, normalization_type="librosa", length=None,
                band_eta=1e-3):
        """Approximate inverse of the multi-octave pyramid.

        Takes ``Complex``-format output ``(B, n_bins, T, 2)`` produced with
        the same ``normalization_type``. The whole multirate pyramid is
        collapsed into one single-rate dual synthesis + overlap-add
        (:meth:`_pyramid_dual_kernels`; the K3 kernel for CUDA tensors); the
        reconstruction is at the original sample rate also when early
        downsampling was active (the early FIR is part of the composed
        atoms). Keep the (post-early-downsample) hop at or below half the
        shortest atom, or the top octave aliases (a warning fires). Exact in
        the interior up to the serial chain's edge effects (<= 127 samples
        per level edge)."""
        X = self._input(X)
        if X.ndim != 4 or X.shape[-1] != 2:
            raise AssertionError(
                "inverse expects Complex format (batch, n_bins, time, 2)"
            )
        _check_norm_type(normalization_type)
        _warn_undersampled_hop(self.hop_length, _np64(self.lenghts),
                               "inverse CQT (post early downsampling)")
        kc, ks, start, hop_top = self._pyramid_dual_kernels(
            normalization_type, band_eta)
        return self._inverse_graph(X, kc, ks, start, hop_top, length)


class CQT2010(_PyramidCQT):
    """Schörkhuber-Klapuri multi-octave CQT with a frequency-domain
    top-octave bank: per octave, a rectangular-window Fourier stage and a
    complex product with the FFT'd kernels; between octaves the signal is
    lowpass-filtered and downsampled by 2, halving the effective hop. Frozen
    stages are composed into a single per-octave basis at init. There is no
    ``center`` switch: the signal is always padded by ``n_fft // 2`` per
    octave.

    Parameters are those of ``nnaudio_tpu.features.CQT2010``, plus ``device``
    (``None`` means CUDA; pass ``device="cpu"`` for the CPU). Returns
    ``(num_audio, n_bins, time_steps)`` Magnitude or ``(num_audio, n_bins,
    time_steps, 2)`` Complex/Phase.
    """

    def __init__(
        self,
        sr: float = 22050,
        hop_length: int = 512,
        fmin: float = 32.70,
        fmax: float | None = None,
        n_bins: int = 84,
        bins_per_octave: int = 12,
        norm: bool = True,
        basis_norm: float = 1,
        window: str = "hann",
        pad_mode: str = "reflect",
        trainable_STFT: bool = False,
        filter_scale: float = 1,
        trainable_CQT: bool = False,
        output_format: str = "Magnitude",
        earlydownsample: bool = True,
        verbose: bool = True,
        device=None,
    ):
        super().__init__(device)
        self.norm = norm
        self.pad_mode = pad_mode
        self.n_bins = n_bins
        self.output_format = output_format
        self.trainable = trainable_STFT or trainable_CQT

        Q, sr_eff, n_filters = self._init_pyramid(
            sr, hop_length, fmin, fmax, n_bins, bins_per_octave, filter_scale,
            earlydownsample, verbose,
        )

        bank = create_cqt_kernels(
            Q, sr_eff, self.fmin_t, n_filters, bins_per_octave,
            norm=basis_norm, topbin_check=False,
        )
        self.n_fft = bank.fft_len

        freqs = fmin * 2.0 ** (np.arange(n_bins) / np.double(bins_per_octave))
        self.frequencies = freqs
        self._register("lenghts", np.ceil(Q * sr_eff / freqs).astype(np.float32))

        fft_basis = np.fft.fft(bank.kernels, axis=1)[:, : self.n_fft // 2 + 1]
        self._register("cqt_kernels_real", fft_basis.real.astype(np.float32),
                       trainable=trainable_CQT)
        self._register("cqt_kernels_imag", fft_basis.imag.astype(np.float32),
                       trainable=trainable_CQT)

        fourier = create_fourier_basis(self.n_fft, window="ones", freq_scale="no")
        self.bins2freq = fourier.bins2freq
        self._register("wsin", fourier.wsin * fourier.window_mask[None, :],
                       trainable=trainable_STFT)
        self._register("wcos", fourier.wcos * fourier.window_mask[None, :],
                       trainable=trainable_STFT)

        if not self.trainable:
            # compose the per-octave Fourier stage and complex product into
            # one time-domain basis pair (fp64 at init), as CQT1992 does
            kr = fft_basis.real.astype(np.float64)
            ki = fft_basis.imag.astype(np.float64)
            wc = (fourier.wcos * fourier.window_mask[None, :]).astype(np.float64)
            ws = (fourier.wsin * fourier.window_mask[None, :]).astype(np.float64)
            self._register("combined_real", (kr @ wc - ki @ ws).astype(np.float32))
            self._register("combined_imag", (kr @ ws + ki @ wc).astype(np.float32))

    def _octave_cqt(self, params, x, hop, octave):
        """Fourier stage + frequency-domain complex product; note the
        un-negated stack."""
        x = _center_pad(x, self.n_fft // 2, self.pad_mode)
        if not self.trainable:
            return framed_basis_pair(
                x, params["combined_real"], params["combined_imag"], hop
            )
        fr, fi = framed_basis_pair(x, params["wcos"], params["wsin"], hop)
        return complex_bank_mul(
            params["cqt_kernels_real"], params["cqt_kernels_imag"], fr, fi
        )

    def _fused_banks(self, params):
        # the composed frozen basis, un-negated; a trainable stage keeps the
        # two-stage per-octave loop
        if self.trainable:
            return None
        bank = (params["combined_real"], params["combined_imag"], self.n_fft // 2)
        return [bank] * self.n_octaves, False

    def _forward(self, params, x, output_format=None, normalization_type="librosa"):
        output_format = output_format or self.output_format
        _check_norm_type(normalization_type)
        real, imag = self._octave_loop(params, self._early_downsample(params, x))

        if normalization_type == "librosa":
            scale = torch.sqrt(params["lenghts"])[None, :, None] / self.n_fft
            real, imag = real * scale, imag * scale
        elif normalization_type == "wrap":
            real, imag = real * (2 / self.n_fft), imag * (2 / self.n_fft)

        return _cqt_output(real, imag, output_format, trainable=False)

    def _inverse_atoms(self):
        # the composed frozen basis carries the un-negated convention:
        # X = x.Cr + i (x.Ci), so the atom is Cr + i Ci
        params = self.params
        if "combined_real" not in params:
            raise NotImplementedError(
                "CQT2010.inverse needs the frozen composed basis "
                "(trainable=False)")
        cr, ci = _np64(params["combined_real"]), _np64(params["combined_imag"])
        return ([cr + 1j * ci] * self.n_octaves,
                [self.n_fft // 2] * self.n_octaves)

    def _inverse_scale(self, normalization_type):
        # nnAudio's conventions for this class: no downsample_factor fold,
        # and the 1/n_fft Fourier-stage normalization on librosa and wrap
        if normalization_type == "librosa":
            return np.sqrt(_np64(self.lenghts)) / self.n_fft
        if normalization_type == "wrap":
            return np.full(self.n_bins, 2.0 / self.n_fft)
        return np.ones(self.n_bins)

    def extra_repr(self) -> str:
        return "STFT kernel size = {}, CQT kernel size = {}".format(
            tuple(self.wcos.shape), tuple(self.cqt_kernels_real.shape),
        )


class CQT2010v2(_PyramidCQT):
    """Multi-octave CQT pyramid with time-domain top-octave kernels: each
    octave applies a direct framed product with the complex wavelets of the
    top octave (the bank is shared: deeper octaves reuse it on the
    downsampled signal), with lowpass decimation by 2 between octaves and
    optional early downsampling of the input. This is the librosa-equivalent
    fast CQT and the engine behind :class:`~nnaudio_tpu_torch.features.VQT`.

    Parameters are those of ``nnaudio_tpu.features.CQT2010v2``, plus
    ``device`` (``None`` means CUDA; pass ``device="cpu"`` for the CPU).
    Returns ``(num_audio, n_bins, time_steps)`` Magnitude or ``(num_audio,
    n_bins, time_steps, 2)`` Complex/Phase.
    """

    def __init__(
        self,
        sr: float = 22050,
        hop_length: int = 512,
        fmin: float = 32.70,
        fmax: float | None = None,
        n_bins: int = 84,
        filter_scale: float = 1,
        bins_per_octave: int = 12,
        norm: bool = True,
        basis_norm: float = 1,
        window: str = "hann",
        pad_mode: str = "reflect",
        earlydownsample: bool = True,
        trainable: bool = False,
        output_format: str = "Magnitude",
        verbose: bool = True,
        device=None,
    ):
        super().__init__(device)
        self.norm = norm
        self.pad_mode = pad_mode
        self.n_bins = n_bins
        self.output_format = output_format
        self.trainable = trainable

        Q, sr_eff, n_filters = self._init_pyramid(
            sr, hop_length, fmin, fmax, n_bins, bins_per_octave, filter_scale,
            earlydownsample, verbose,
        )

        bank = create_cqt_kernels(
            Q, sr_eff, self.fmin_t, n_filters, bins_per_octave,
            norm=basis_norm, topbin_check=False,
        )
        self.n_fft = bank.fft_len

        freqs = fmin * 2.0 ** (np.arange(n_bins) / np.double(bins_per_octave))
        self.frequencies = freqs
        self._register("lenghts", np.ceil(Q * sr_eff / freqs).astype(np.float32))
        self._register("cqt_kernels_real", bank.kernels.real.astype(np.float32),
                       trainable=trainable)
        self._register("cqt_kernels_imag", bank.kernels.imag.astype(np.float32),
                       trainable=trainable)

    def _octave_cqt(self, params, x, hop, octave):
        """Time-domain octave CQT on the shared bank: real = x.kr,
        imag = -(x.ki)."""
        x = _center_pad(x, self.n_fft // 2, self.pad_mode)
        real, imag_raw = framed_basis_pair(
            x, params["cqt_kernels_real"], params["cqt_kernels_imag"], hop
        )
        return real, -imag_raw

    def _fused_banks(self, params):
        bank = (params["cqt_kernels_real"], params["cqt_kernels_imag"],
                self.n_fft // 2)
        return [bank] * self.n_octaves, True

    def _forward(self, params, x, output_format=None, normalization_type="librosa"):
        return self._forward_time_domain(params, x, output_format,
                                         normalization_type)

    def _inverse_atoms(self):
        # every octave reuses the shared top-octave bank, and the octave's
        # product negates the imag: the atom is Kr - i Ki, as in CQT1992v2
        kr, ki = _np64(self.cqt_kernels_real), _np64(self.cqt_kernels_imag)
        return ([kr - 1j * ki] * self.n_octaves,
                [self.n_fft // 2] * self.n_octaves)

    def extra_repr(self) -> str:
        return "CQT kernel size = {}, octaves = {}, trainable = {}".format(
            tuple(self.cqt_kernels_real.shape), self.n_octaves, self.trainable,
        )
