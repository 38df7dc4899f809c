"""Plain reference of the ``istft1024_24k`` configuration: the STFT that makes
a stream's requests, and Vocos's ``ISTFT(padding="same")`` of a whole stream.

Everything here is float32 PyTorch with TF32 off (``numerics.fp32``), or the
control (``control=True``). The window comes from ``builders``.

- Requests: the ``center=False`` STFT of the clips: frames of ``n_fft``
  samples at ``hop_length`` by ``unfold``, times the periodic Hann window,
  ``torch.fft.rfft``; ``(B, F, T, 2)``, the real and imaginary parts last,
  as the port's streams take them.
- Synthesis, as ``vocos/spectral_ops.py``'s ``ISTFT.forward`` with
  ``padding="same"``: ``torch.fft.irfft(spec, n_fft, dim=1,
  norm="backward")``, times the window; ``F.fold`` overlap-add over
  ``(T - 1) hop + win_length`` samples, cut to ``pad:-pad`` with ``pad =
  (win_length - hop_length) // 2``; the same fold of the squared window,
  cut the same way; the one divided by the other.

Departures from Vocos's code: the spectrum arrives as real and imaginary
parts and is made complex here; the window is scipy's periodic Hann in
float64, stored in float32, where Vocos computes ``torch.hann_window`` in
float32; Vocos asserts that the cut envelope exceeds 1e-11, which holds at
the configuration's settings, and this divides without the assertion; the
streams are computed in blocks of :data:`BLOCK`.

The control is the same synthesis one precision lower, in TF32. An FFT has
no matrix product whose operands could be rounded, so the control rounds
what enters and leaves the inverse FFT (``numerics.to_tf32``): the spectrum
before ``irfft``, and both operands of the window's product after it.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import builders
from .numerics import fp32, to_tf32

#: streams computed at once
BLOCK = 8


def window(s: dict, device) -> torch.Tensor:
    """The periodic window of ``win_length`` centred in ``n_fft``, float32."""
    w = builders.pad_center(builders.window(s["window"], s["win_length"]), s["n_fft"])
    return torch.from_numpy(w.astype(np.float32)).to(device)


def pad(s: dict) -> int:
    """Samples Vocos's ``"same"`` padding cuts from each end."""
    return (s["win_length"] - s["hop_length"]) // 2


@torch.no_grad()
def requests(s: dict, x: torch.Tensor) -> torch.Tensor:
    """The ``center=False`` STFT of the clips ``x`` (B, L): (B, F, T, 2)."""
    w = window(s, x.device)
    out = []
    with fp32():
        for i in range(0, x.shape[0], BLOCK):
            frames = x[i:i + BLOCK].unfold(-1, s["n_fft"], s["hop_length"]) * w
            spec = torch.fft.rfft(frames, dim=-1).transpose(1, 2)
            out.append(torch.view_as_real(spec))
    return torch.cat(out)


def _istft_same(s, w, spec, control):
    """(B, F, T) complex -> (B, T hop) when ``win_length - hop`` is even."""
    n, hop = s["n_fft"], s["hop_length"]
    if control:
        spec = torch.complex(to_tf32(spec.real), to_tf32(spec.imag))
    ifft = torch.fft.irfft(spec, n, dim=1, norm="backward")
    ifft = to_tf32(ifft) * to_tf32(w)[None, :, None] if control else ifft * w[None, :, None]
    t = spec.shape[-1]
    size = (t - 1) * hop + n
    cut = pad(s)
    y = F.fold(ifft, output_size=(1, size), kernel_size=(1, n),
               stride=(1, hop))[:, 0, 0, cut:-cut]
    window_sq = w.square().expand(1, t, -1).transpose(1, 2)
    envelope = F.fold(window_sq, output_size=(1, size), kernel_size=(1, n),
                      stride=(1, hop)).squeeze()[cut:-cut]
    return y / envelope


@torch.no_grad()
def synthesis(s: dict, spec: torch.Tensor, control: bool = False) -> torch.Tensor:
    """Vocos's ``ISTFT(padding="same")`` of whole streams: (B, F, T, 2) ->
    (B, T hop)."""
    w = window(s, spec.device)
    with fp32():
        return torch.cat([_istft_same(s, w, torch.view_as_complex(spec[i:i + BLOCK].contiguous()),
                                      control)
                          for i in range(0, spec.shape[0], BLOCK)])
