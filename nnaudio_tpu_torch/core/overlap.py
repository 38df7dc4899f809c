"""Overlap-add synthesis helpers (iSTFT path)."""
from __future__ import annotations

import torch

from .frame import frames_to_signal


def window_sumsquare(
    window: torch.Tensor, n_frames: int, hop: int, n_fft: int, power: int = 2
) -> torch.Tensor:
    """Sum of squared (or ``power``-ed) windows under overlap-add, shape
    ``(n_fft + hop*(n_frames-1),)``."""
    length = n_fft + hop * (n_frames - 1)
    tiles = (window[None, :] ** power).expand(n_frames, n_fft)
    return frames_to_signal(tiles, hop, length)


def normalize_by_window_envelope(
    signal: torch.Tensor, w_sum: torch.Tensor, eps: float = 1e-10
) -> torch.Tensor:
    """Divide by window-sumsquare where it is numerically nonzero."""
    ok = w_sum > eps
    return torch.where(ok, signal / torch.where(ok, w_sum, torch.ones_like(w_sum)), signal)


def extend_fbins(spec_ri: torch.Tensor) -> torch.Tensor:
    """Mirror ``n_fft//2+1`` onesided bins back to ``n_fft`` full bins.

    ``spec_ri``: (B, F, T, 2). Upper bins are the reversed interior with
    negated imaginary part (odd symmetry).
    """
    interior = spec_ri[:, 1:-1]
    sign = torch.tensor([1.0, -1.0], dtype=spec_ri.dtype, device=spec_ri.device)
    upper = torch.flip(interior, dims=(1,)) * sign
    return torch.cat((spec_ri, upper), dim=1)
