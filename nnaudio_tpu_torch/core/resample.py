"""FIR anti-aliased downsampling (the CQT2010 / VQT octave pyramid) and
rational-rate resampling.

``downsample_by_n`` is the arithmetic of nnAudio's ``downsampling_by_n``: a
symmetric zero pad of ``(len(fir) - 1) // 2`` and stride-``n`` valid
windows, here one strided ``F.conv1d``. ``compose_cascade`` folds ``k``
serial lowpass + decimate stages into one filter (the pyramid's parallel
chain), and ``resample_poly`` is ``scipy.signal.resample_poly`` as a banded
framed matmul. The JAX package computes these in plain ``einsum``s outside
any Pallas kernel.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ..config import matmul_numerics, round_to_storage


def compose_cascade(fir: np.ndarray, k: int) -> np.ndarray:
    """The single filter (fp64) equivalent to ``k`` serial (fir, decimate by
    2) stages: ``H_k = h * up2(h) * up4(h) * ... * up_{2^(k-1)}(h)``.

    With it every pyramid level is computed straight from the top-rate
    signal, ``downsample_by_n(x, H_k, 2**k, pad=p*(2**k - 1))``, which
    reproduces the nested stages' sums (and their floor truncation,
    ``floor(floor(L/2)/2)... = floor(L/2^k)``) up to fp32 reassociation
    away from the levels' edges."""
    h = np.asarray(fir, np.float64)
    out = h
    for i in range(1, k):
        up = np.zeros(((h.shape[-1] - 1) * 2**i + 1,), np.float64)
        up[:: 2**i] = h
        out = np.convolve(out, up)
    return out


def compose_cascade_torch(fir: torch.Tensor, k: int) -> torch.Tensor:
    """Differentiable fp32 twin of :func:`compose_cascade`, for a
    ``lowpass_filter`` passed to ``apply``: the same compositions as full
    convolutions (``F.conv1d`` against the flipped, zero-stuffed filter)."""
    out = fir
    for i in range(1, k):
        up = fir.new_zeros(((fir.shape[-1] - 1) * 2**i + 1,))
        up[:: 2**i] = fir
        with matmul_numerics():
            out = F.conv1d(out.reshape(1, 1, -1), up.flip(0).reshape(1, 1, -1),
                           padding=up.shape[0] - 1).reshape(-1)
    return out


def downsample_by_n(x: torch.Tensor, fir: torch.Tensor, n: int,
                    pad: int | None = None) -> torch.Tensor:
    """(B, L) -> (B, floor((L + 2p - K)/n) + 1) with p = (K-1)//2. ``pad``
    overrides p (for composed-cascade filters, whose group delay is set by
    the base stage's pad, not their own length)."""
    taps = fir.shape[-1]
    if pad is None:
        pad = (taps - 1) // 2
    out_len = (x.shape[-1] + 2 * pad - taps) // n + 1
    if out_len <= 0:
        # a signal shorter than the FIR: nnAudio's conv1d raises here; an
        # empty level degrades gracefully at the deepest octave of a very
        # short input instead (the pyramid's _center_pad turns it into an
        # all-zero padded frame)
        return x[:, :0]
    with matmul_numerics():
        out = F.conv1d(round_to_storage(x)[:, None, :],
                       round_to_storage(fir).reshape(1, 1, taps),
                       stride=n, padding=pad)
    return out[:, 0, :]


def downsample_by_2(x: torch.Tensor, fir: torch.Tensor) -> torch.Tensor:
    return downsample_by_n(x, fir, 2)


def _resample_fir(up: int, down: int) -> np.ndarray:
    """``scipy.signal.resample_poly``'s default FIR (Kaiser beta 5, half
    length 10 x the larger rate, gain ``up``), in fp64."""
    from scipy import signal

    max_rate = max(up, down)
    half_len = 10 * max_rate
    return signal.firwin(2 * half_len + 1, 1.0 / max_rate,
                         window=("kaiser", 5.0)) * up


def _resample_plan(h: np.ndarray, up: int, down: int):
    """The banded matrix (fp64) of a tile of ``r`` outputs, with ``up``
    dividing ``r``, and where its input window lies:
    ``(banded (r, width), i_lo, hop_in)``. A tile of outputs r0 = 0..r-1
    reads inputs ``i_lo .. i_lo + width - 1``; the next tile's window lies
    ``hop_in = r*down/up`` samples further."""
    taps = h.shape[-1]
    half = (taps - 1) // 2
    r = up * max(1, round(128 / up)) if up <= 512 else up
    c = np.arange(r) * down + half
    i_lo = int(np.ceil((c[0] - taps + 1) / up))
    width = int(c[-1] // up) - i_lo + 1
    j = c[:, None] - (i_lo + np.arange(width))[None, :] * up
    valid = (j >= 0) & (j < taps)
    banded = np.where(valid, h[np.where(valid, j, 0)], 0.0)
    return banded, i_lo, (r * down) // up


@lru_cache(maxsize=32)
def _default_plan(up: int, down: int):
    """:func:`_resample_plan` of the default FIR, built once per ratio, as
    the JAX package builds it once per traced shape."""
    return _resample_plan(_resample_fir(up, down), up, down)


def resample_poly(x: torch.Tensor, up: int, down: int,
                  fir: np.ndarray | None = None) -> torch.Tensor:
    """Rational-rate polyphase resampling of a ``(B, L)`` signal, equal to
    ``scipy.signal.resample_poly(x, up, down, window=('kaiser', 5.0))`` up to
    fp32 rounding.

    Upsampling, filtering and decimating collapse to
    ``y[n] = sum_i x[i] h[n*down + half - i*up]``, a band of taps whose
    phase pattern repeats every ``up`` outputs. A tile of ``R`` outputs with
    ``up | R`` then has the same banded matrix at every tile (the input
    window slides by ``R*down/up``), so the resample is one matmul of the
    frames (``unfold``) against a host-built fp64 banded matrix, cached per
    ratio for the default FIR. Gradients flow to ``x``."""
    g = int(np.gcd(up, down))
    up, down = up // g, down // g
    if up == down:
        return x
    if fir is None:
        banded, i_lo, hop_in = _default_plan(up, down)
    else:
        banded, i_lo, hop_in = _resample_plan(np.asarray(fir), up, down)
    r, width = banded.shape
    length = x.shape[-1]
    n_out = -(-length * up // down)  # exact integer ceil (scipy's length)

    n_tiles = -(-n_out // r)
    lpad = max(0, -i_lo)
    need = (n_tiles - 1) * hop_in + width
    xp = F.pad(x, (lpad, max(0, need - length - lpad)))
    start = i_lo + lpad  # >= 0 by the choice of lpad
    frames = xp[:, start:start + need].unfold(-1, width, hop_in)
    banded_t = torch.as_tensor(banded, dtype=torch.float32, device=x.device)
    with matmul_numerics():
        out = torch.matmul(round_to_storage(frames),
                           round_to_storage(banded_t).t())
    return out.reshape(x.shape[0], n_tiles * r)[:, :n_out].to(x.dtype)
