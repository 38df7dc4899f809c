"""Plain reference of the ``cqt84_22k`` configuration: ``CQT1992v2``'s
Magnitude output with librosa's normalisation, in float32 with TF32 off (or
the control's TF32), on a wavelet bank built by ``builders.cqt_bank``."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import builders
from .numerics import fp32, matmul

#: rows (clips) computed at once
BLOCK = 4


def bank(s: dict, device):
    """float32 ``(real, imag)`` (n_bins, width) and ``sqrt(lengths)``."""
    kernels, lengths = builders.cqt_bank(s["sr"], s["fmin"], s["n_bins"],
                                         s["bins_per_octave"], s["filter_scale"],
                                         s["norm"], s["window"])
    as32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)
    return as32(kernels.real), as32(kernels.imag), as32(np.sqrt(lengths))


@torch.no_grad()
def offline(s: dict, x: torch.Tensor, control: bool = False) -> torch.Tensor:
    """(B, L) -> (B, n_bins, T) magnitudes."""
    real, imag, scale = bank(s, x.device)
    width = real.shape[1]
    if s["center"]:
        x = F.pad(x[:, None, :], (width // 2, width // 2), mode=s["pad_mode"])[:, 0, :]
    out = []
    with fp32():
        for i in range(0, x.shape[0], BLOCK):
            frames = x[i:i + BLOCK].unfold(-1, width, s["hop_length"])
            re = matmul(frames, real.T, control)
            im = matmul(frames, imag.T, control)
            out.append((torch.sqrt(re * re + im * im) * scale).transpose(1, 2))
    return torch.cat(out)
