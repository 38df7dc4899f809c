"""Plain reference of the ``mel128_22k`` configuration: the Mel spectrogram,
its streamed (``center=False``) form and the trainable front end's SGD step.

Everything here is float32 PyTorch with TF32 off (``numerics.fp32``), or the
control's TF32 (``control=True``). The bases come from ``builders``; the
initial parameters of the train step are made here from the seed.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import builders
from .numerics import fp32, matmul

#: rows (clips) computed at once
BLOCK = 8


def bases(s: dict, device) -> dict:
    """float32 ``wcos``, ``wsin`` (F, n_fft) and ``mel_basis`` (M, F)."""
    wcos, wsin = builders.fourier_basis(s["n_fft"], s["window"])
    mel = builders.mel_filterbank(s["sr"], s["n_fft"], s["n_mels"], s["fmin"],
                                  s["fmax"], htk=s["htk"], norm=s["norm"])
    return {k: torch.from_numpy(v.astype(np.float32)).to(device)
            for k, v in (("wcos", wcos), ("wsin", wsin), ("mel_basis", mel))}


def _padded(s: dict, x: torch.Tensor, center: bool) -> torch.Tensor:
    if not center:
        return x
    half = s["n_fft"] // 2
    return F.pad(x[:, None, :], (half, half), mode=s["pad_mode"])[:, 0, :]


def _mel(s, b, x, control, center, eps=0.0):
    """(B, L) -> (B, M, T): frames, both DFT products, power, projection."""
    frames = _padded(s, x, center).unfold(-1, s["n_fft"], s["hop_length"])
    re = matmul(frames, b["wcos"].T, control)
    im = matmul(frames, b["wsin"].T, control)
    power = re * re + im * im
    if eps:
        power = power + eps
    if s["power"] != 2.0:
        power = power ** (s["power"] / 2)
    return matmul(power, b["mel_basis"].T, control).transpose(1, 2)


@torch.no_grad()
def offline(s: dict, x: torch.Tensor, control: bool = False) -> torch.Tensor:
    """The configuration's ``MelSpectrogram`` of ``x`` (B, L)."""
    b = bases(s, x.device)
    with fp32():
        return torch.cat([_mel(s, b, x[i:i + BLOCK], control, s["center"])
                          for i in range(0, x.shape[0], BLOCK)])


@torch.no_grad()
def stream(s: dict, x: torch.Tensor, control: bool = False) -> torch.Tensor:
    """What a stream of ``x`` (B, L) should emit: the ``center=False`` Mel."""
    b = bases(s, x.device)
    with fp32():
        return torch.cat([_mel(s, b, x[i:i + BLOCK], control, False)
                          for i in range(0, x.shape[0], BLOCK)])


def init_params(s: dict, t: dict, gen: torch.Generator, device) -> dict:
    """The train step's initial parameters under the program's state keys:
    the Fourier and mel bases, a head drawn from ``gen`` (normal, scaled by
    1/sqrt(n_mels)) and a zero bias."""
    p = bases(s, device)
    m, c = s["n_mels"], t["n_classes"]
    p["head_w"] = torch.randn(m, c, generator=gen, device=device) / math.sqrt(m)
    p["head_b"] = torch.zeros(c, device=device)
    return p


def loss(s: dict, p: dict, x: torch.Tensor, labels: torch.Tensor,
         control: bool = False) -> torch.Tensor:
    """The classifier's loss: the trainable Mel (1e-8 under the power), log
    of the clamped projection, mean over time, linear head, cross entropy."""
    mel = _mel(s, p, x, control, s["center"], eps=1e-8)
    feats = torch.log(torch.clamp(mel, min=0.0) + 1e-6).mean(dim=-1)
    return F.cross_entropy(matmul(feats, p["head_w"], control) + p["head_b"], labels)


def train(s: dict, t: dict, p: dict, batches, control: bool = False):
    """SGD steps from ``p`` over ``batches`` of ``(x, labels)``: the list of
    losses and the list of parameter dicts after each step."""
    losses, states = [], []
    with fp32():
        for x, labels in batches:
            leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
            value = loss(s, leaves, x, labels, control)
            grads = torch.autograd.grad(value, list(leaves.values()))
            p = {k: (v - t["lr"] * g).detach() for (k, v), g in zip(leaves.items(), grads)}
            losses.append(float(value.detach()))
            states.append(p)
    return losses, states
