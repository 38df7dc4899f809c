"""The framed ops, with the JAX package's signatures.

All compute ``Y[b,f,t] = sum_s x[b, t*hop+s] * W[f,s]`` for the cos and sin
bases and differ in what they do with the pair. Each goes to a hand-written
kernel of :mod:`.framed_kernels` (which takes the plain version for CPU
tensors), unless the user turned the kernels off (``config.set_use_kernels*``),
in which case it takes the plain version on every device:

- ``framed_basis_pair`` and ``framed_complex``: the pair kernel (K5), whose
  backward is the JAX package's ``_bwd``;
- ``framed_magnitude``, ``framed_power``: K6, the split-K form of K1, for a
  bank of at most 128 bins and at least :data:`KCHUNK_MIN_N` samples (the CQT
  family's wavelet banks), else K1; ``framed_filterbank``: K2;
- ``synthesis_ola``: K3;
- ``gl_step``: K4, one Griffin-Lim analysis step (its route chosen in
  :mod:`.framed_kernels`: the FFT route, the tensor-core K4, or the pair and
  the update).
- ``nnls``: the inverse Mel's NNLS, one launch of ``nnls_banded.cu`` for a
  transform's own basis (:func:`.framed_kernels.nnls_plan`), else the dense
  products.

Under autograd (grad enabled and an operand that requires grad) the
magnitude, power and filterbank wrappers take the pair (K5) and compute their
epilogue in PyTorch, as the JAX package's differentiated forwards do; the
route is decided in :mod:`.framed_kernels`, so no caller records a K1, K2 or
K6 forward. K2's, K3's and K4's FFT routes are chosen there too, from the
operands (``framed_kernels.fft_plan``, ``synthesis_fft_plan``,
``gl_step_fft_plan``).

K1, K2, K4 and K5 are one tensor-core kernel (``csrc/framed_tc.cu``) with
four epilogues; K3 and K6 have sources of their own.

:func:`force_fuse` overrides the switches inside a block (the counterpart of
the JAX package's ``framed_matmul.force_fuse``; the streaming classes' ``fuse=``
argument): ``True`` takes the kernels, ``False`` the plain versions, ``None``
leaves ``config`` in charge. A CPU tensor takes the plain version whatever the
override says, as always.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

from ..config import analysis_kernel_enabled, synthesis_kernel_enabled
from . import framed_kernels as fk


#: least contraction length (samples per frame) at which the magnitude ops
#: take K6 instead of K1, from the H100 sweep of both kernels over B = 1-32
#: on the CQT banks and dense banks of 64-128 bins x 2048-16384 samples
#: (``chip_smoke.py`` ``[sweep]`` lines, ``PERF.md``): K6 fills the card at
#: small batches where K1 leaves it idle and skips the zero columns of the
#: CQT's wavelets; it was the slower of the two in at most 3 of 180 swept
#: cases (dense banks of 128 bins at B >= 16), by at most 0.005 ms. The
#: dispatch does not read the bank, so the banded and the dense bank of one
#: shape go the same way.
KCHUNK_MIN_N = 2048

_FORCE_FUSE: contextvars.ContextVar = contextvars.ContextVar("force_fuse", default=None)


@contextlib.contextmanager
def force_fuse(flag: bool | None):
    """Inside the block, ``True`` launches the kernels for CUDA tensors even
    where ``config.set_use_kernels*(False)`` turned them off, ``False`` takes
    the plain versions, ``None`` leaves ``config`` in charge."""
    token = _FORCE_FUSE.set(flag)
    try:
        yield
    finally:
        _FORCE_FUSE.reset(token)


def _analysis_on() -> bool:
    forced = _FORCE_FUSE.get()
    return analysis_kernel_enabled() if forced is None else forced


def _synthesis_on() -> bool:
    forced = _FORCE_FUSE.get()
    return synthesis_kernel_enabled() if forced is None else forced


def kchunk_envelope(f: int, n: int) -> bool:
    """Whether a bank of ``f`` bins of ``n`` samples goes to K6."""
    return f <= fk.KCHUNK_MAX_F and n >= KCHUNK_MIN_N


def _magnitude(x, wcos, wsin, hop, eps, square):
    if not _analysis_on():
        return fk.framed_magnitude_plain(x, wcos, wsin, hop, eps=eps, square=square)
    if kchunk_envelope(*wcos.shape):
        return fk.framed_magnitude_kchunk(x, wcos, wsin, hop, eps=eps, square=square)
    return fk.framed_magnitude(x, wcos, wsin, hop, eps=eps, square=square)


def framed_basis_pair(x, wcos, wsin, hop):
    """Signal (B, L) x bases (F, n_fft) -> (real, imag_raw), each (B, F, T).
    ``imag_raw`` is the un-negated sin projection."""
    if _analysis_on():
        return fk.framed_pair(x, wcos, wsin, hop)
    return fk.framed_pair_plain(x, wcos, wsin, hop)


def framed_complex(x, wcos, wsin, scale, hop):
    """Reference-convention Complex stack: ``out[..., 0] = real * s_f``,
    ``out[..., 1] = -imag_raw * s_f``; ``scale`` may be None."""
    real, imag = framed_basis_pair(x, wcos, wsin, hop)
    if scale is not None:
        s = scale.reshape(1, -1, 1)
        real, imag = real * s, imag * s
    return torch.stack((real, -imag), dim=-1)


def framed_magnitude(x, wcos, wsin, hop, eps=0.0):
    """``sqrt((x*wcos)^2 + (x*wsin)^2 + eps)`` -> (B, F, T)."""
    return _magnitude(x, wcos, wsin, hop, eps, False)


def framed_power(x, wcos, wsin, hop):
    """Power spectrum ``(x*wcos)^2 + (x*wsin)^2`` -> (B, F, T)."""
    return _magnitude(x, wcos, wsin, hop, 0.0, True)


def framed_filterbank(x, wcos, wsin, fb, hop, eps=0.0):
    """``fb @ (|STFT|^2 + eps)`` -> (B, n_mels, T); the (B, F, T) power never
    reaches device memory on the kernel path."""
    if _analysis_on():
        return fk.framed_filterbank(x, wcos, wsin, fb, hop, eps=eps)
    return fk.framed_filterbank_plain(x, wcos, wsin, fb, hop, eps=eps)


def synthesis_ola(spec_re, spec_im, kc, ks, hop):
    """iSTFT synthesis: (B, F, T) spectra x (F, n_fft) fully weighted kernels
    -> (B, n_fft + hop*(T-1)) overlap-added signal, ``OLA(kc^T Re - ks^T Im)``;
    ``framed_kernels.synthesis_kernels`` makes the kernels of a Fourier
    basis."""
    if _synthesis_on():
        return fk.synthesis_ola(spec_re, spec_im, kc, ks, hop)
    return fk.synthesis_ola_plain(spec_re, spec_im, kc, ks, hop)


def gl_step(x, wcos, wsin, S, p_re, p_im, hop, mom):
    """One Griffin-Lim analysis step on the signal ``x``: the pair, then
    ``n = (re, -imag_raw) - mom * p`` and ``c = S * n / |n|``. Returns the
    next carries ``(c_re, c_im, r_re, r_im)`` in ``p_re``'s dtype."""
    if _analysis_on():
        return fk.gl_step(x, wcos, wsin, S, p_re, p_im, hop, mom)
    return fk.gl_step_plain(x, wcos, wsin, S, p_re, p_im, hop, mom)


def nnls(mel_basis, mel_pinv, mel, step, n_iter):
    """The inverse Mel's NNLS: ``s = relu(pinv(M) mel)``, then ``n_iter``
    projected-gradient steps ``s = relu(s - step M^T (M s - mel))``; (B, M, T)
    mels -> (B, F, T)."""
    if _analysis_on():
        return fk.nnls(mel_basis, mel_pinv, mel, step, n_iter)
    return fk.nnls_plain(mel_basis, mel_pinv, mel, step, n_iter)
