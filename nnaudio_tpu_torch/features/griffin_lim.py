"""Fast Griffin-Lim phase recovery.

Each iteration synthesises the carried spectrum (iSTFT: the K3 kernel for
CUDA tensors, on its FFT route for the transform's own factors in fp32
storage), analyses the signal again, and takes a momentum step towards
the target magnitudes. The loop carries the magnitude-imposed spectrum ``c``
and the last analysis ``r`` as planar (B, F, T) re/im tensors, in bf16 for
``iter_precision='default'`` and fp32 for ``'highest'``.

The analysis half of each iteration is one step of the ops layer
(``gl_step``), which picks its route from the operands: for fp32 carries on
the transform's own frozen Fourier basis in fp32 storage, K4's FFT route
(the real FFT of each frame and the update in one kernel); for bf16 carries
outside ``tensorfloat32``, the tensor-core K4, as the JAX package fuses its
loop; else the pair (K5) followed by the elementwise update. All run on the
true (B, F, T) shapes.

Randomness: the JAX package draws the initial phase with
``jax.random.normal(key, (b, f, t))``. The port takes the drawn phase itself
(``rand_phase``) or a ``torch.Generator``; without either it draws from a
generator seeded 0 on the input's device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import get_config, set_matmul_precision
from ..core.frame import pad_signal
from ..core.overlap import normalize_by_window_envelope, window_sumsquare
from ..filters.fourier import create_fourier_basis
from ..filters.windows import pad_center, window_dispatch
from ..ops.dispatch import gl_step, synthesis_ola
from ..ops.framed_kernels import hermitian_weights, synthesis_kernels
from .base import SpectralTransform, to_float32


class Griffin_Lim(SpectralTransform):
    """Fast Griffin-Lim phase recovery from a magnitude spectrogram.

    Parameters are those of ``nnaudio_tpu.features.Griffin_Lim``:
    ``n_fft, n_iter=32, hop_length=None, win_length=None, window='hann',
    center=True, pad_mode='reflect', momentum=0.99,
    iter_precision='default'``. ``device`` says where the kernels live:
    ``None`` means CUDA (and raises without it); pass ``device="cpu"`` for
    the CPU.

    ``iter_precision='default'`` iterates with bf16 carries and bf16 operand
    storage; ``'highest'`` with fp32 carries at the ambient precision. The
    loop never runs above the ambient precision, and the final synthesis
    runs at it.

    Call as ``gl(S)``, ``gl(S, rand_phase=phase)`` or
    ``gl(S, generator=g)`` with ``S`` of shape ``(num_audio, n_fft//2 + 1,
    time_steps)`` and ``phase`` of the same shape (the initial phase is
    ``2*pi*phase``). Returns ``(num_audio, (time_steps - 1) * hop_length)``
    when centered.
    """

    def __init__(
        self,
        n_fft: int,
        n_iter: int = 32,
        hop_length: int | None = None,
        win_length: int | None = None,
        window: str = "hann",
        center: bool = True,
        pad_mode: str = "reflect",
        momentum: float = 0.99,
        device=None,
        iter_precision: str = "default",
    ):
        super().__init__(device)
        if iter_precision not in ("default", "highest"):
            raise ValueError(f"unknown iter_precision {iter_precision!r}")
        self.iter_precision = iter_precision
        self.n_fft = n_fft
        self.n_iter = n_iter
        self.center = center
        self.pad_mode = pad_mode
        self.momentum = momentum
        self.win_length = n_fft if win_length is None else win_length
        self.hop_length = n_fft // 4 if hop_length is None else hop_length
        self.pad_amount = n_fft // 2

        basis = create_fourier_basis(n_fft, win_length=self.win_length,
                                     freq_bins=None, window=window)
        w = pad_center(
            window_dispatch(window, int(self.win_length), fftbins=True), n_fft
        ).astype(np.float32)
        self._register("wsin", basis.wsin * w[None, :])
        self._register("wcos", basis.wcos * w[None, :])
        # onesided IDFT kernels with the Hermitian fold weights
        wt = hermitian_weights(n_fft, basis.wcos.shape[0]).numpy()[:, None]
        self._register("kernel_sin_inv", basis.wsin * wt)
        self._register("kernel_cos_inv", basis.wcos * wt)
        self._register("window_mask", w)

    def _synthesize(self, spec_re, spec_im, kc, ks, w_sum):
        """Planar iSTFT: synthesis + overlap-add, envelope, center trim."""
        signal = normalize_by_window_envelope(
            synthesis_ola(spec_re, spec_im, kc, ks, self.hop_length), w_sum)
        if self.center:
            return signal[:, self.pad_amount:-self.pad_amount]
        return signal

    def _forward(self, params, S, rand_phase=None, generator=None):
        if S.ndim != 3:
            raise AssertionError(
                "Please make sure your input is in the shape of "
                "(batch, freq_bins, timesteps)"
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
        _, _, t = S.shape
        hop = self.hop_length
        mom = self.momentum / (1 + self.momentum)
        cfg = get_config()
        carry = torch.bfloat16 if self.iter_precision == "default" else torch.float32

        w_sum = window_sumsquare(params["window_mask"], t, hop, self.n_fft)
        kc, ks = synthesis_kernels(params["kernel_cos_inv"], params["kernel_sin_inv"],
                                   params["window_mask"], weighted=True)
        wcos, wsin = params["wcos"], params["wsin"]
        c_re = (S * torch.cos(2 * np.pi * rand_phase)).to(carry)
        c_im = (S * torch.sin(2 * np.pi * rand_phase)).to(carry)
        p_re, p_im = torch.zeros_like(c_re), torch.zeros_like(c_im)

        prev = cfg.matmul_precision
        if prev == "highest" and self.iter_precision == "default":
            set_matmul_precision("default")
        try:
            for _ in range(self.n_iter):
                signal = self._synthesize(c_re, c_im, kc, ks, w_sum)
                if self.center:
                    signal = pad_signal(signal, self.pad_amount, self.pad_mode)
                c_re, c_im, p_re, p_im = gl_step(signal, wcos, wsin, S, p_re, p_im,
                                                 hop, mom)
        finally:
            set_matmul_precision(prev)
        return self._synthesize(c_re.float(), c_im.float(), kc, ks, w_sum)

    def forward(self, S, rand_phase=None, generator=None):
        return self.apply(None, S, rand_phase=rand_phase, generator=generator)

    def apply(self, params, S, rand_phase=None, generator=None):
        return super().apply(params, S, rand_phase=rand_phase,
                             generator=generator)
