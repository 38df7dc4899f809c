"""Real FFT as matmul stages and radix-2 butterflies (CFP's transforms).

A four-step Cooley-Tukey split sized for a matrix unit:

  n-point real FFT
    -> pack even/odd samples into an m = n/2 complex FFT
    -> factor m = m1 * m2 with m2 a power of two and m1 nearest 128: the
       m1-point DFT stage is one planar complex matmul with an (m1, m1) basis
    -> twiddle by W_m^(n2*k1) on the (m2, m1) grid
    -> the m2-point DFT as log2(m2) radix-2 butterfly levels
    -> the Hermitian unpack to the n/2+1 one-sided spectrum.

The twiddles and bases are fp64-built numpy constants; the matmul stage runs
in fp32 whatever the precision mode (an FFT's error compounds along CFP's
layers). It is plain PyTorch, as the JAX module is plain ``jnp``.
``config.use_mxu_fft`` selects it for CFP (``None`` = auto = off until an
H100 A/B: there ``torch.fft.rfft`` is cuFFT).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..config import get_config


def mxu_fft_enabled() -> bool:
    """Whether CFP takes :func:`rfft_mxu` (auto: off)."""
    return bool(get_config().use_mxu_fft)


def _split_factors(m: int) -> tuple[int, int] | None:
    """m = m1 * m2 with m2 = 2**k and m1 nearest 128 (the matmul stage).
    None when no factorization keeps the matmul stage at most 640 wide."""
    best = None
    m2 = 1
    while True:
        m1 = m // m2
        if 2 <= m1 <= 640:
            score = abs(m1 - 128)
            if best is None or score < best[0]:
                best = (score, m1, m2)
        if m % (2 * m2) != 0:
            break
        m2 *= 2
    if best is None:
        return None
    return best[1], best[2]


@lru_cache(maxsize=16)
def _stage_constants(n: int):
    """fp64-built numpy constants of the n-point real FFT plan."""
    m = n // 2
    m1, m2 = _split_factors(m)
    n1 = np.arange(m1)
    basis = np.exp(-2j * np.pi * np.outer(n1, n1) / m1)
    tw = np.exp(-2j * np.pi * np.outer(np.arange(m2), np.arange(m1)) / m)
    rot = np.exp(-2j * np.pi * np.arange(m + 1) / n)
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    return (m1, m2, f32(basis.real), f32(basis.imag), f32(tw.real),
            f32(tw.imag), f32(rot.real), f32(rot.imag))


@lru_cache(maxsize=64)
def _butterfly_twiddles(size: int):
    w = np.exp(-2j * np.pi * np.arange(size // 2) / size)
    return w.real.astype(np.float32), w.imag.astype(np.float32)


def _fft_pow2_axis(zr, zi):
    """Power-of-two DFT along axis -2: radix-2 decimation in time."""
    size = zr.shape[-2]
    if size == 1:
        return zr, zi
    er, ei = _fft_pow2_axis(zr[..., 0::2, :], zi[..., 0::2, :])
    our, oui = _fft_pow2_axis(zr[..., 1::2, :], zi[..., 1::2, :])
    wr, wi = (torch.as_tensor(w, device=zr.device)[:, None]
              for w in _butterfly_twiddles(size))
    tr = our * wr - oui * wi
    ti = our * wi + oui * wr
    return (torch.cat((er + tr, er - tr), dim=-2),
            torch.cat((ei + ti, ei - ti), dim=-2))


def rfft_mxu(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor] | None:
    """One-sided DFT of a real signal: (..., n) -> planar ``(re, im)``, each
    (..., n//2 + 1), the fp32 image of ``np.fft.rfft``. ``None`` when ``n``
    has no plan (odd n, or an odd part too large for one matmul stage)."""
    n = x.shape[-1]
    if n % 2 or _split_factors(n // 2) is None:
        return None
    m = n // 2
    m1, m2, *consts = _stage_constants(n)
    br, bi, twr, twi, rotr, roti = (torch.as_tensor(c, device=x.device)
                                    for c in consts)

    # pack z[j] = x[2j] + i x[2j+1], then (..., m) -> (..., m2, m1): the flat
    # index is j = n1*m2 + n2 and the matmul stage contracts n1
    lead = x.shape[:-1]
    zr = x[..., 0::2].reshape(*lead, m1, m2).transpose(-1, -2)
    zi = x[..., 1::2].reshape(*lead, m1, m2).transpose(-1, -2)

    # the m1-point DFT over the minor axis, one planar complex matmul in fp32
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ar = zr @ br - zi @ bi
        ai = zr @ bi + zi @ br
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev

    # the four-step twiddle, then the m2-point DFT along axis -2; rows are
    # k2, so (k2, k1) flattens to the output index k = k2*m1 + k1
    tr = ar * twr - ai * twi
    ti = ar * twi + ai * twr
    cr, ci = _fft_pow2_axis(tr, ti)
    zr_full = cr.reshape(*lead, m)
    zi_full = ci.reshape(*lead, m)

    # Hermitian unpack: X[k] = E[k] + W_n^k O[k] with
    # E = (Z[k] + conj(Z[m-k]))/2, O = -i (Z[k] - conj(Z[m-k]))/2, Z[m] = Z[0]
    zr_ext = torch.cat((zr_full, zr_full[..., :1]), dim=-1)
    zi_ext = torch.cat((zi_full, zi_full[..., :1]), dim=-1)
    zr_rev = torch.flip(zr_ext, dims=(-1,))
    zi_rev = torch.flip(zi_ext, dims=(-1,))
    er = 0.5 * (zr_ext + zr_rev)
    ei = 0.5 * (zi_ext - zi_rev)
    our = 0.5 * (zi_ext + zi_rev)
    oui = -0.5 * (zr_ext - zr_rev)
    re = er + our * rotr - oui * roti
    im = ei + our * roti + oui * rotr
    return re, im
