"""Plain reference of the ``mel80_22k`` configuration: the Mel spectrogram of
power 1 that makes the requests, and its inversion to audio by NNLS and
Griffin-Lim.

Everything here is float32 PyTorch with TF32 off (``numerics.fp32``), or
the control's TF32 (``control=True``): every matrix product goes through
``numerics.matmul``. The bases come from ``builders``; the mel basis's
pseudo-inverse and the NNLS step from float64 NumPy. The inversion follows
nnAudio's ``InverseMelSpectrogram`` and ``Griffin_Lim``:

- NNLS: ``s = relu(pinv(M) mel)``, then ``n_iter_nnls`` projected-gradient
  steps ``s = relu(s - (M^T (M s - mel)) / sigma_max(M)^2)``; the
  magnitude is ``s ** (1 / power)``.
- Fast Griffin-Lim with momentum ``a``: ``c = S e^{2 pi i phase}``,
  ``p = 0``; each iteration synthesises ``c``, analyses the signal again
  (``r``), then ``n = r - a / (1 + a) p``, ``c = S n / (|n| + 1e-16)``,
  ``p = r``; after the last, one more synthesis.
- Analysis: the centre's reflect padding of ``n_fft // 2``, frames by
  ``unfold``, the product with the Hann-windowed Fourier basis;
  ``X = (frames . wcos, -frames . wsin)``.
- Synthesis, as ``torch.istft`` defines it: each frame's inverse real DFT
  (bins weighted 1 at DC and Nyquist, 2 between), windowed, over
  ``n_fft``; overlap-add; division by the overlap-added squared window
  where it exceeds 1e-10; the centre trim of ``n_fft // 2`` at each end.

Departures: the inverse DFT and the analysis are products with explicit
bases, not FFTs, so that the control can round their operands; the squared
window's overlap-add is summed in float64 and stored in float32.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import builders
from .numerics import fp32, matmul

#: rows (clips) computed at once
BLOCK = 8
#: added to ``|n|`` before the division, as nnAudio's ``Griffin_Lim`` does
EPS = 1e-16


def bases(s: dict, device) -> dict:
    """float32 ``wcos``, ``wsin`` (F, n_fft), the inverse bases ``icos``,
    ``isin`` (F, n_fft), ``mel_basis`` (M, F) and ``mel_pinv`` (F, M), and
    the NNLS step (a float)."""
    n = s["n_fft"]
    wcos, wsin = builders.fourier_basis(n, s["window"])
    weights = np.full((n // 2 + 1, 1), 2.0)
    weights[0] = 1.0
    if n % 2 == 0:
        weights[-1] = 1.0
    mel = builders.mel_filterbank(s["sr"], n, s["n_mels"], s["fmin"], s["fmax"],
                                  htk=s["htk"], norm=s["norm"])
    as32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)
    out = {k: as32(v) for k, v in (("wcos", wcos), ("wsin", wsin),
                                   ("icos", weights * wcos / n), ("isin", weights * wsin / n),
                                   ("mel_basis", mel), ("mel_pinv", np.linalg.pinv(mel)))}
    out["step"] = float(1.0 / np.linalg.svd(mel, compute_uv=False)[0] ** 2)
    return out


def envelope(s: dict, frames: int, device) -> torch.Tensor:
    """The squared window overlap-added over ``frames`` frames, float32."""
    n, hop = s["n_fft"], s["hop_length"]
    w2 = builders.pad_center(builders.window(s["window"], n), n) ** 2
    env = np.zeros(n + hop * (frames - 1))
    for t in range(frames):
        env[t * hop:t * hop + n] += w2
    return torch.from_numpy(env.astype(np.float32)).to(device)


def _padded(s: dict, x: torch.Tensor) -> torch.Tensor:
    if not s["center"]:
        return x
    half = s["n_fft"] // 2
    return F.pad(x[:, None, :], (half, half), mode=s["pad_mode"])[:, 0, :]


def _analysis(s, b, x, control):
    """(B, L) -> the spectrum's ``(re, im)``, each (B, T, F)."""
    frames = _padded(s, x).unfold(-1, s["n_fft"], s["hop_length"])
    return matmul(frames, b["wcos"].T, control), -matmul(frames, b["wsin"].T, control)


def _synthesis(s, b, env, re, im, control):
    """(B, T, F) spectra -> (B, L): inverse DFT, overlap-add, envelope, trim."""
    frames = matmul(re, b["icos"], control) - matmul(im, b["isin"], control)
    batch, t, n = frames.shape
    length = n + s["hop_length"] * (t - 1)
    signal = F.fold(frames.transpose(1, 2), (1, length), (1, n),
                    stride=(1, s["hop_length"])).reshape(batch, length)
    ok = env > 1e-10
    signal = torch.where(ok, signal / torch.where(ok, env, torch.ones_like(env)), signal)
    if s["center"]:
        half = n // 2
        signal = signal[:, half:length - half]
    return signal


def _mel(s, b, x, control):
    """(B, L) -> (B, M, T): the mel of ``|X| ** power``."""
    re, im = _analysis(s, b, x, control)
    mag = (re * re + im * im) ** (s["power"] / 2)
    return matmul(mag, b["mel_basis"].T, control).transpose(1, 2)


@torch.no_grad()
def offline(s: dict, x: torch.Tensor, control: bool = False) -> torch.Tensor:
    """The configuration's mel spectrogram of the clips ``x`` (B, L)."""
    b = bases(s, x.device)
    with fp32():
        return torch.cat([_mel(s, b, x[i:i + BLOCK], control)
                          for i in range(0, x.shape[0], BLOCK)])


def _nnls(b, mel, n_iter_nnls, control):
    """(B, M, T) mel -> (B, T, F): the nonnegative least-squares spectrum."""
    target = mel.transpose(1, 2)
    spec = torch.relu(matmul(target, b["mel_pinv"].T, control))
    for _ in range(n_iter_nnls):
        resid = matmul(spec, b["mel_basis"].T, control) - target
        spec = torch.relu(spec - b["step"] * matmul(resid, b["mel_basis"], control))
    return spec


def _griffin_lim(s, b, env, mag, phase, n_iter, control):
    """(B, T, F) magnitudes and phases (in cycles) -> (B, L) audio."""
    mom = s["momentum"] / (1 + s["momentum"])
    angle = 2 * np.pi * phase
    c_re, c_im = mag * torch.cos(angle), mag * torch.sin(angle)
    p_re, p_im = torch.zeros_like(c_re), torch.zeros_like(c_im)
    for _ in range(n_iter):
        r_re, r_im = _analysis(s, b, _synthesis(s, b, env, c_re, c_im, control), control)
        n_re, n_im = r_re - mom * p_re, r_im - mom * p_im
        scale = mag / (torch.sqrt(n_re * n_re + n_im * n_im) + EPS)
        c_re, c_im, p_re, p_im = n_re * scale, n_im * scale, r_re, r_im
    return _synthesis(s, b, env, c_re, c_im, control)


@torch.no_grad()
def invert(s: dict, mel: torch.Tensor, phase: torch.Tensor, n_iter: int, n_iter_nnls: int,
           control: bool = False) -> torch.Tensor:
    """Audio (B, (T - 1) hop) from mels (B, M, T) and the initial phases
    (B, F, T), in cycles: NNLS, then Griffin-Lim."""
    b = bases(s, mel.device)
    env = envelope(s, mel.shape[-1], mel.device)
    out = []
    with fp32():
        for i in range(0, mel.shape[0], BLOCK):
            mag = _nnls(b, mel[i:i + BLOCK], n_iter_nnls, control)
            if s["power"] != 1.0:
                mag = mag ** (1.0 / s["power"])
            out.append(_griffin_lim(s, b, env, mag, phase[i:i + BLOCK].transpose(1, 2),
                                    n_iter, control))
    return torch.cat(out)
