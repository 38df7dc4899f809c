"""Bucketed lengths and padding masks for variable-length audio.

Ragged utterances padded to a small set of lengths share one shape per
bucket (for the port: one plan per shape, and batches that stack), and the
frames that touch padding are masked:

    x_pad, valid = pad_to_bucket(batch_of_utterances, device="cuda")
    spec = stft(x_pad)
    mask = frame_mask(spec.shape[-1], valid, n_fft=2048, hop=512)
    pooled = (spec * mask[:, None, :]).sum(-1) / mask.sum(-1, keepdim=True)
"""
from __future__ import annotations

import warnings
from typing import Sequence

import numpy as np
import torch

from ..config import resolve_device


def default_buckets(max_seconds: float = 60.0, sr: float = 22050,
                    granularity: float = 1.5) -> list[int]:
    """Geometric bucket boundaries (samples), each ~``granularity`` x the
    previous, from one second up to ``max_seconds``."""
    out, n = [], int(sr)  # 1 second minimum bucket
    while n < max_seconds * sr:
        out.append(n)
        n = int(n * granularity)
    out.append(int(max_seconds * sr))
    return out


def bucket_length(length: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= length (the largest bucket if none fits)."""
    for b in buckets:
        if b >= length:
            return b
    return buckets[-1]


def pad_to_bucket(signals: Sequence, buckets: Sequence[int] | None = None,
                  sr: float = 22050, device=None):
    """Ragged utterances -> (batch tensor padded to one bucket, valid
    lengths), both on ``device`` (CUDA unless ``device="cpu"``).

    All utterances share the bucket of the longest one. Zero padding on the
    right: mask the affected frames (reflect-centred transforms also perturb
    the first and last ``n_fft//2 // hop`` frames of any padded signal).
    """
    if buckets is None:
        buckets = default_buckets(sr=sr)
    device = resolve_device(device)
    lengths = np.array([np.shape(s)[-1] for s in signals])
    target = bucket_length(int(lengths.max()), buckets)
    if lengths.max() > target:
        warnings.warn(
            f"signal(s) of length up to {int(lengths.max())} exceed the largest "
            f"bucket ({target}) and will be truncated", stacklevel=2)
        lengths = np.minimum(lengths, target)
    batch = torch.zeros((len(signals), target), device=device)
    for i, s in enumerate(signals):
        s = torch.as_tensor(s)[..., : lengths[i]]
        batch[i, : lengths[i]] = s.to(device=device, dtype=torch.float32)
    return batch, torch.as_tensor(lengths, device=device)


def valid_frame_count(valid_len, n_fft: int, hop: int, center: bool = True):
    """Frames whose analysis window touches only valid samples.

    center=True: frame t spans samples [t*hop - n_fft//2, t*hop + n_fft//2),
    fully valid when t*hop + n_fft//2 <= valid_len; center=False: when
    t*hop + n_fft <= valid_len."""
    valid_len = torch.as_tensor(valid_len)
    reach = n_fft // 2 if center else n_fft
    return torch.clamp_min(torch.div(valid_len - reach, hop, rounding_mode="floor") + 1, 0)


def frame_mask(n_frames: int, valid_len, n_fft: int, hop: int,
               center: bool = True) -> torch.Tensor:
    """(B, n_frames) float mask: 1 for frames fully inside the valid
    samples, on ``valid_len``'s device."""
    counts = valid_frame_count(valid_len, n_fft, hop, center)
    t = torch.arange(n_frames, device=counts.device)[None, :]
    return (t < counts[:, None]).float()
