"""Plain reference of the ``whisper128_16k`` configuration: Whisper's
``log_mel_spectrogram`` (openai's ``whisper/audio.py``), with the floor taken
per clip.

float32 PyTorch with TF32 off (``numerics.fp32``), or the control's TF32
(``control=True``): the STFT as the dense products with the windowed Fourier
basis (``torch.stft``'s ``center=True``, reflect padding, periodic Hann), so
that the control's rounding reaches them; the bases from ``builders``. Then,
as openai writes it: the last frame dropped, ``|X|^2``, the mel filters,
``log10`` of the power clamped at ``amin``, the maximum with the clip's max
less ``log_floor``, and ``(x + 4) / 4``. openai takes the max over what it
is handed, one file: here each clip's own, as Hugging Face's batched
``WhisperFeatureExtractor`` does.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import builders
from .numerics import fp32, matmul

#: rows (clips) computed at once
BLOCK = 8


def bases(s: dict, device) -> dict:
    """float32 ``wcos``, ``wsin`` (F, n_fft) and ``filters`` (n_mels, F)."""
    wcos, wsin = builders.fourier_basis(s["n_fft"], s["window"])
    mel = builders.mel_filterbank(s["sr"], s["n_fft"], s["n_mels"], s["fmin"], s["fmax"],
                                  htk=s["htk"], norm=s["norm"])
    return {k: torch.from_numpy(v.astype(np.float32)).to(device)
            for k, v in (("wcos", wcos), ("wsin", wsin), ("filters", mel))}


def _log_mel(s, b, audio, control):
    """(B, L) -> (B, n_mels, T - 1)."""
    half = s["n_fft"] // 2
    padded = F.pad(audio[:, None, :], (half, half), mode=s["pad_mode"])[:, 0, :]
    frames = padded.unfold(-1, s["n_fft"], s["hop_length"])[:, :-1]
    re = matmul(frames, b["wcos"].T, control)
    im = matmul(frames, b["wsin"].T, control)
    magnitudes = re * re + im * im
    mel_spec = matmul(magnitudes, b["filters"].T, control).transpose(1, 2)
    log_spec = torch.clamp(mel_spec, min=s["amin"]).log10()
    peak = log_spec.amax(dim=(1, 2), keepdim=True)
    log_spec = torch.maximum(log_spec, peak - s["log_floor"])
    return (log_spec + 4.0) / 4.0


@torch.no_grad()
def offline(s: dict, x: torch.Tensor, control: bool = False) -> torch.Tensor:
    """The configuration's ``WhisperLogMel`` of ``x`` (B, L)."""
    b = bases(s, x.device)
    with fp32():
        return torch.cat([_log_mel(s, b, x[i:i + BLOCK], control)
                          for i in range(0, x.shape[0], BLOCK)])
