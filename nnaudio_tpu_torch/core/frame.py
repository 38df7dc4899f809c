"""Signal shaping: broadcast, pad, frame, overlap-add.

A frame is a strided view of the signal (``Tensor.unfold``), so framing
copies nothing; overlap-add is its adjoint, an ``index_add`` scatter.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def broadcast_dim(x: torch.Tensor) -> torch.Tensor:
    """Accept ``(L,)``, ``(B, L)`` or ``(B, 1, L)``; return ``(B, L)``."""
    if x.ndim == 1:
        return x[None, :]
    if x.ndim == 2:
        return x
    if x.ndim == 3:
        if x.shape[1] != 1:
            raise ValueError(
                f"3-D input must have a singleton channel axis, got {tuple(x.shape)}"
            )
        return x[:, 0, :]
    raise ValueError(
        "Only inputs of shape (len), (batch, len) or (batch, 1, len) are "
        f"supported; got {tuple(x.shape)}"
    )


def pad_signal(x: torch.Tensor, pad_amount: int, pad_mode: str = "reflect") -> torch.Tensor:
    """Center padding on the last axis of a ``(B, L)`` signal. ``reflect``
    matches ReflectionPad1d; ``constant`` zero-pads."""
    if pad_amount == 0:
        return x
    if pad_mode == "constant":
        return F.pad(x, (pad_amount, pad_amount), mode="constant")
    if pad_mode == "reflect":
        if x.shape[-1] < pad_amount + 1:
            raise ValueError(
                "Signal length shorter than reflect padding length (n_fft // 2)."
            )
        # reflect padding wants a channel axis
        return F.pad(x[:, None, :], (pad_amount, pad_amount), mode="reflect")[:, 0, :]
    raise ValueError(f"pad_mode must be 'reflect' or 'constant', got {pad_mode!r}")


def num_frames(length: int, frame_length: int, hop: int) -> int:
    """Frames produced by a stride-``hop`` window of ``frame_length`` over
    ``length`` samples (conv1d 'valid' arithmetic)."""
    return (length - frame_length) // hop + 1


def frame_signal(x: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """(..., L) -> (..., T, frame_length) overlapping frames, as a view."""
    return x.unfold(-1, frame_length, hop)


def frames_to_signal(frames: torch.Tensor, hop: int, length: int) -> torch.Tensor:
    """Overlap-add: (..., T, N) -> (..., length), the exact adjoint of
    :func:`frame_signal`. Samples past ``length`` are dropped; a shortfall
    stays zero."""
    t, n = frames.shape[-2], frames.shape[-1]
    lead = frames.shape[:-2]
    span = max(length, n + hop * (t - 1))
    idx = (torch.arange(t, device=frames.device)[:, None] * hop
           + torch.arange(n, device=frames.device)[None, :]).reshape(-1)
    out = frames.new_zeros(*lead, span)
    out = out.index_add(-1, idx, frames.reshape(*lead, t * n))
    return out[..., :length]
