"""FIR anti-aliased downsampling (the CQT2010 / VQT octave pyramid).

The arithmetic of nnAudio's ``downsampling_by_n``: a symmetric zero pad of
``(len(fir) - 1) // 2`` and stride-``n`` valid windows, here one strided
``F.conv1d``. The JAX package computes the same sums as a banded framed
matmul, a shape chosen for the TPU's matrix unit; no Pallas kernel is
involved. ``compose_cascade`` and ``resample_poly`` come with the parallel
chain and the time-stretch module.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import matmul_numerics, round_to_storage


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
