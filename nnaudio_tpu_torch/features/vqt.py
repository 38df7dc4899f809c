"""Variable-Q transform: the 2010v2 pyramid with gamma-widened low bins.

``gamma > 0`` shortens the low-frequency windows
(``lengths = ceil(Q*fs/(freqs + gamma/alpha))``), so unlike CQT2010v2 each
octave gets its own kernel bank built at that octave's rate.
``VQT(gamma=0)`` equals ``CQT2010v2`` bit for bit, which the tests enforce.

Quirks of nnAudio kept, as in the JAX package:
- the per-octave kernels are built from the **original** ``sr`` even when
  early downsampling rescaled the signal, whereas the normalization
  ``lenghts`` use the downsampled rate; with default parameters early
  downsampling is inactive and the two agree.
- the ``trainable`` flag only toggles the magnitude epsilon; the kernels are
  always frozen buffers.
"""
from __future__ import annotations

import numpy as np

from ..filters.cqt import create_cqt_kernels
from ..ops.dispatch import framed_basis_pair
from .cqt import _PyramidCQT, _center_pad, _np64


class VQT(_PyramidCQT):
    """Variable-Q transform: the CQT2010v2 pyramid with a per-octave kernel
    bank whose bandwidths are broadened by ``gamma``. At ``gamma=0`` the
    output is bit-identical to :class:`~nnaudio_tpu_torch.features.CQT2010v2`;
    ``gamma > 0`` shortens the low-frequency wavelets, trading frequency
    resolution for time resolution like ``librosa.vqt``.

    Parameters are those of ``nnaudio_tpu.features.VQT`` (``sr``,
    ``hop_length``, ``fmin``, ``fmax``, ``n_bins``, ``filter_scale``,
    ``bins_per_octave``, ``norm``, ``basis_norm``, ``gamma``, ``window``,
    ``pad_mode``, ``earlydownsample``, ``trainable``, ``output_format``,
    ``verbose``), plus ``device`` (``None`` means CUDA; pass ``device="cpu"``
    for the CPU). Returns ``(num_audio, n_bins, time_steps)`` Magnitude or
    ``(num_audio, n_bins, time_steps, 2)`` Complex/Phase.
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
        gamma: float = 0,
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
        self.trainable = trainable
        self.output_format = output_format
        self.sr = sr
        self.gamma = gamma

        Q, sr_eff, n_filters = self._init_pyramid(
            sr, hop_length, fmin, fmax, n_bins, bins_per_octave,
            filter_scale, earlydownsample, verbose,
        )

        alpha = 2.0 ** (1.0 / bins_per_octave) - 1.0
        freqs = fmin * 2.0 ** (np.arange(n_bins) / np.double(bins_per_octave))
        self.frequencies = freqs
        lengths = np.ceil(Q * sr_eff / (freqs + gamma / alpha))
        self._register("lenghts", lengths.astype(np.float32))

        # one kernel bank per octave at successively halved rates, seeded
        # from the original sr (the quirk above)
        self._octave_widths: list[int] = []
        my_sr = float(self.sr)
        for i in range(self.n_octaves):
            if i > 0:
                my_sr /= 2
            bank = create_cqt_kernels(
                Q,
                my_sr,
                self.fmin_t * 2 ** -i,
                n_filters,
                bins_per_octave,
                norm=basis_norm,
                topbin_check=False,
                gamma=gamma,
            )
            self._octave_widths.append(bank.fft_len)
            self._register(f"cqt_kernels_real_{i}", bank.kernels.real.astype(np.float32))
            self._register(f"cqt_kernels_imag_{i}", bank.kernels.imag.astype(np.float32))

    def _octave_cqt(self, params, x, hop, octave):
        """Time-domain octave CQT on the octave's own bank, center-padded at
        that bank's width."""
        x = _center_pad(x, self._octave_widths[octave] // 2, self.pad_mode)
        real, imag_raw = framed_basis_pair(
            x, params[f"cqt_kernels_real_{octave}"],
            params[f"cqt_kernels_imag_{octave}"], hop
        )
        return real, -imag_raw

    def _fused_banks(self, params):
        banks = [(params[f"cqt_kernels_real_{i}"], params[f"cqt_kernels_imag_{i}"],
                  self._octave_widths[i] // 2) for i in range(self.n_octaves)]
        return banks, True

    def _forward(self, params, x, output_format=None, normalization_type="librosa"):
        return self._forward_time_domain(params, x, output_format,
                                         normalization_type)

    def _inverse_atoms(self):
        # per-octave banks (gamma widens the deep octaves' bandwidths, so
        # each level has its own kernels and width); the imag is negated at
        # the product, so the atom is Kr - i Ki per level
        atoms = [_np64(getattr(self, f"cqt_kernels_real_{i}"))
                 - 1j * _np64(getattr(self, f"cqt_kernels_imag_{i}"))
                 for i in range(self.n_octaves)]
        return atoms, [w // 2 for w in self._octave_widths]

    def extra_repr(self) -> str:
        return "VQT octaves = {}, gamma = {}, widths = {}".format(
            self.n_octaves, self.gamma, self._octave_widths
        )
