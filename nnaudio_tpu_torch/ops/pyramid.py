"""Whole-pyramid contraction for CQT2010 / CQT2010v2 / VQT.

The per-octave loop runs one framed pair (K5) per octave on a successively
decimated signal: seven launches of 12-bin banks at the defaults. This module
computes every octave in one batched matmul instead:

1. each level's frames at the widest bank's width (``unfold`` views, copied
   once by the stack),
2. each level's (real, imag) bank stacked into rows of one ``(2F, W_max)``
   matrix, zero past the level's true width (the padding multiplies real
   samples by 0.0, which is exact),
3. one ``torch.matmul`` ``(L, B*T, W) x (L, W, 2F)``.

It is plain PyTorch, as the JAX module is plain ``jnp`` (no Pallas kernel),
and differentiable through autograd. ``config.use_fused_pyramid`` selects it
(``None`` = auto = off until an H100 A/B).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import get_config, matmul_numerics, round_to_storage
from ..core.frame import frame_signal, num_frames


def pyramid_enabled() -> bool:
    """Whether the pyramid classes take the fused contraction (auto: off)."""
    return bool(get_config().use_fused_pyramid)


def materialize_frames(x: torch.Tensor, width: int, hop: int,
                       t: int | None = None) -> torch.Tensor:
    """(B, L) -> (B, T, width) overlapping frames. ``t`` overrides the frame
    count (a caller framing at a padded width passes the frame count of the
    true width); the signal is zero-extended where frames run past its end."""
    length = x.shape[-1]
    if t is None:
        t = num_frames(length, width, hop)
    need = (t - 1) * hop + width
    if need > length:
        x = F.pad(x, (0, need - length))
    return frame_signal(x[:, :need], width, hop)


def pyramid_basis_pair(levels, banks_real, banks_imag, hops):
    """Per-level signals (already center-padded) against per-level (F, W_i)
    bank pairs -> ``(real, imag_raw)``, each ``(B, n_levels * F, T)``, bins
    concatenated in list order (callers pass the deepest octave first, as
    the per-octave loop assembles its bins).

    Returns ``None`` when the per-level frame counts or filter counts
    disagree; callers then keep the per-octave loop."""
    n_levels = len(levels)
    f = banks_real[0].shape[0]
    widths = [br.shape[1] for br in banks_real]
    ts = [num_frames(lv.shape[-1], w, h)
          for lv, w, h in zip(levels, widths, hops)]
    if len(set(ts)) != 1 or any(br.shape[0] != f for br in banks_real):
        return None
    t = ts[0]
    b = levels[0].shape[0]
    w_max = max(widths)

    frames = torch.stack([materialize_frames(lv, w_max, h, t=t)
                          for lv, h in zip(levels, hops)])  # (L, B, T, W)
    banks = torch.stack([
        F.pad(torch.cat((br, bi), dim=0), (0, w_max - w))
        for br, bi, w in zip(banks_real, banks_imag, widths)
    ])  # (L, 2F, W)
    with matmul_numerics():
        out = torch.matmul(round_to_storage(frames.reshape(n_levels, b * t, w_max)),
                           round_to_storage(banks).transpose(1, 2))  # (L, B*T, 2F)
    out = out.reshape(n_levels, b, t, 2, f).permute(3, 1, 0, 4, 2)  # (2, B, L, F, T)
    real = out[0].reshape(b, n_levels * f, t)
    imag = out[1].reshape(b, n_levels * f, t)
    return real, imag
