"""Magnitude CQT -> waveform: Griffin-Lim over the CQT frame.

librosa has ``griffinlim_cqt``; nnAudio has no way back from a CQT. The loop
mirrors :class:`~nnaudio_tpu_torch.features.Griffin_Lim`: each iteration is
the canonical-dual synthesis (one ``synthesis_ola``, the K3 kernel for CUDA
tensors), the re-analysis (the pair, K5: one launch for ``1992v2``, one per
octave for the pyramid families, which run their full forward) and the
momentum phase update, on planar (B, F, T) carries. There is no
window-sumsquare step: the dual synthesis kernels absorb the frame
operator's inverse.

The reconstruction's limits are the inverse's (see ``CQT1992v2.inverse``):
keep ``hop_length`` at or below half the shortest atom.

Randomness: the JAX package draws the initial phase with
``jax.random.normal(key, S.shape)``; the port takes the drawn phase itself
(``rand_phase``) or a ``torch.Generator``, and without either draws from a
generator seeded 0 on the input's device.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..config import get_config, set_matmul_precision
from ..ops.dispatch import framed_basis_pair, synthesis_ola
from .base import SpectralTransform, adopt_state, to_float32
from .cqt import (CQT1992v2, CQT2010v2, _center_pad, _check_norm_type, _np64,
                  _warn_undersampled_hop)
from .vqt import VQT


class GriffinLimCQT(SpectralTransform):
    """Griffin-Lim phase recovery from a magnitude CQT.

    Parameters are those of ``nnaudio_tpu.features.GriffinLimCQT``: the
    parameters the magnitude CQT was made with (``sr``, ``hop_length``,
    ``fmin``, ``fmax``, ``n_bins``, ``bins_per_octave``, ``filter_scale``,
    ``norm``, ``window``, ``pad_mode``), the loop's ``n_iter=32``,
    ``momentum=0.99``, ``normalization_type='librosa'``, ``band_eta=1e-3``
    and ``iter_precision='default'`` (bf16 carries and operands; the loop
    never runs above the ambient precision), ``family`` in ``'1992v2'``,
    ``'2010v2'``, ``'vqt'`` (the pyramid families take further arguments
    such as ``gamma`` and ``earlydownsample``) and ``verbose``; plus
    ``device`` (``None`` means CUDA; pass ``device="cpu"`` for the CPU).

    The state is the analysis CQT's (the same tensors, under the same keys).
    ``update_params`` changes both halves of the loop: the analysis bank and
    the synthesis duals built from it. ``apply`` rejects overrides of the
    bank's tensors, whose duals are built on the host.

    Call as ``gl(S)``, ``gl(S, rand_phase=phase)`` or ``gl(S, generator=g)``
    with ``S`` of shape ``(num_audio, n_bins, time_steps)``; ``length=``
    trims or pads the output. Returns ``(num_audio, hop_length *
    (time_steps - 1))``.
    """

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
        pad_mode: str = "reflect",
        n_iter: int = 32,
        momentum: float = 0.99,
        normalization_type: str = "librosa",
        band_eta: float = 1e-3,
        iter_precision: str = "default",
        family: str = "1992v2",
        verbose: bool = True,
        device=None,
        **family_kwargs,
    ):
        super().__init__(device)
        if iter_precision not in ("default", "highest"):
            raise ValueError(f"unknown iter_precision {iter_precision!r}")
        _check_norm_type(normalization_type)
        self.iter_precision = iter_precision
        self.n_iter = n_iter
        self.momentum = momentum
        self.hop_length = hop_length
        self.pad_mode = pad_mode
        self.normalization_type = normalization_type
        self.family = family
        self._band_eta = band_eta

        common = dict(sr=sr, hop_length=hop_length, fmin=fmin, fmax=fmax,
                      n_bins=n_bins, bins_per_octave=bins_per_octave,
                      filter_scale=filter_scale, output_format="Complex",
                      verbose=verbose, pad_mode=pad_mode,
                      device=self._init_device, **family_kwargs)
        if family == "1992v2":
            cqt = CQT1992v2(norm=norm, window=window, center=True, **common)
        elif family in ("2010v2", "vqt"):
            # the pyramid classes take `norm` as a bool and `basis_norm` as
            # the Lp construction norm
            cls = CQT2010v2 if family == "2010v2" else VQT
            cqt = cls(basis_norm=norm, window=window, **common)
        else:
            raise ValueError(
                f"unknown family {family!r}: '1992v2', '2010v2' or 'vqt'")
        self._hold("_cqt", cqt)
        adopt_state(self, cqt)
        self._rebuild_duals()
        _warn_undersampled_hop(cqt.hop_length, _np64(cqt.lenghts),
                               "GriffinLimCQT")

    def _rebuild_duals(self):
        """The synthesis duals (and, for 1992v2, the analysis scale) from the
        analysis CQT's current tensors; the CQT caches them until one of its
        tensors changes."""
        if self.family == "1992v2":
            self.pad_amount = self._cqt.kernel_width // 2
            self._dual_kc, self._dual_ks = self._cqt._dual_kernels(
                self.normalization_type, self._band_eta)
            self._ascale = to_float32(
                self._cqt._norm_scale_np(self.normalization_type), self.device)
            self._hop_syn = self._cqt.hop_length
        else:
            (self._dual_kc, self._dual_ks, self._syn_start,
             self._hop_syn) = self._cqt._pyramid_dual_kernels(
                self.normalization_type, self._band_eta)

    def _refresh_derived(self, changed):
        # the tensors are the analysis CQT's own: let it drop its caches,
        # then rebuild the synthesis half from the new values
        if not changed:
            return
        self._cqt._refresh_derived(changed)
        self._rebuild_duals()

    def _derived_state_key(self, key: str) -> bool:
        return self._cqt._derived_state_key(key)

    def _synthesize(self, c_re, c_im, t):
        """Dual synthesis and trim: (B, F, T) carries -> (B, hop*(T-1))."""
        sig = synthesis_ola(c_re, c_im, self._dual_kc, self._dual_ks,
                            self._hop_syn)
        if self.family == "1992v2":
            return sig[:, self.pad_amount: sig.shape[-1] - self.pad_amount]
        return sig[:, self._syn_start: self._syn_start + self._hop_syn * (t - 1)]

    def _forward(self, params, S, rand_phase=None, generator=None):
        if S.ndim != 3:
            raise AssertionError(
                "Please make sure your input is in the shape of "
                "(num_audio, n_bins, time_steps)"
            )
        if rand_phase is None:
            if generator is None:
                generator = torch.Generator(device=S.device).manual_seed(0)
            rand_phase = torch.randn(S.shape, generator=generator,
                                     device=S.device)
        else:
            rand_phase = to_float32(rand_phase, S.device)
            if rand_phase.shape != S.shape:
                raise ValueError(f"rand_phase {tuple(rand_phase.shape)} and S "
                                 f"{tuple(S.shape)} differ")
        # the duals follow the bank, also after an in-place step
        self._rebuild_duals()
        t = S.shape[-1]
        mom = self.momentum / (1 + self.momentum)

        # the re-analysis reproduces the Complex forward's convention, so
        # the carries stay in the frame of the dual synthesis kernels
        if self.family == "1992v2":
            s = self._ascale[:, None]
            akr = params["cqt_kernels_real"] * s
            aki = params["cqt_kernels_imag"] * s

            def analyze(sig):
                # the forward's constant-pad fallback: a short synthesis must
                # still be re-analyzable
                sig = _center_pad(sig, self.pad_amount, self.pad_mode)
                r_re, r_im_raw = framed_basis_pair(sig, akr, aki, self.hop_length)
                return r_re, -r_im_raw
        else:
            def analyze(sig):
                c = self._cqt._forward(params, sig, output_format="Complex",
                                       normalization_type=self.normalization_type)
                return c[..., 0], c[..., 1]

        cfg = get_config()
        prev = cfg.matmul_precision
        carry = torch.bfloat16 if self.iter_precision == "default" else torch.float32
        c_re = (S * torch.cos(2 * np.pi * rand_phase)).to(carry)
        c_im = (S * torch.sin(2 * np.pi * rand_phase)).to(carry)
        p_re, p_im = torch.zeros_like(c_re), torch.zeros_like(c_im)
        if prev == "highest" and self.iter_precision == "default":
            set_matmul_precision("default")
        try:
            for _ in range(self.n_iter):
                r_re, r_im = analyze(self._synthesize(c_re, c_im, t))
                n_re = r_re - mom * p_re.float()
                n_im = r_im - mom * p_im.float()
                scale = S * torch.rsqrt(n_re * n_re + n_im * n_im + 1e-32)
                c_re, c_im = (n_re * scale).to(carry), (n_im * scale).to(carry)
                p_re, p_im = r_re.to(carry), r_im.to(carry)
        finally:
            set_matmul_precision(prev)
        # the final synthesis at the ambient precision
        return self._synthesize(c_re.float(), c_im.float(), t)

    def forward(self, S, rand_phase=None, generator=None, length=None):
        out = self.apply(None, S, rand_phase=rand_phase, generator=generator)
        if length is not None:
            out = out[:, :length]
            if out.shape[-1] < length:
                out = F.pad(out, (0, length - out.shape[-1]))
        return out

    def apply(self, params, S, rand_phase=None, generator=None):
        if params:
            # overrides reach only the re-analysis; the duals are built on
            # the host from the stored bank, so an override of the bank
            # would iterate between two different frames
            shared = sorted(k for k in params if k in self._cqt.params)
            if shared:
                raise ValueError(
                    "GriffinLimCQT.apply() cannot take overrides for "
                    f"analysis-bank parameters {shared}: the synthesis "
                    "duals are derived from them outside the graph. Use "
                    "update_params({...}) to change the bank (it rebuilds "
                    "the duals), then call apply(None, S)."
                )
        return super().apply(params, S, rand_phase=rand_phase,
                             generator=generator)

    def extra_repr(self) -> str:
        return f"n_iter = {self.n_iter}, momentum = {self.momentum}"
