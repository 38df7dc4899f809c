"""The one generator of the benchmark's inputs: seeded clips of harmonic
partials over noise, made on the device in a few large calls.

A traffic mix's ``signal`` block sets the clips' make-up (the lowest and
highest fundamental, the number of partials, the noise level); the mix sets
how many clips of what length, and the configuration the sample rate. The
same seed gives the same clips on the same device.
"""
from __future__ import annotations

import math

import torch

#: the make-up of a clip where a mix gives no ``signal`` block
DEFAULT_SIGNAL = {"f0_hz": [55.0, 880.0], "partials": 8, "noise": 0.05}


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from any whole number."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    return gen


def clips(gen: torch.Generator, count: int, length: int, sr: float,
          signal: dict | None = None) -> torch.Tensor:
    """``(count, length)`` float32 clips on ``gen``'s device. Each clip has a
    fundamental drawn log-uniformly from ``f0_hz``, ``partials`` harmonics
    below 0.45 ``sr`` with amplitudes ``u / k`` (``u`` uniform in [0.5, 1])
    and uniform phases, scaled to a peak of about 0.5, plus white noise of
    standard deviation ``noise``."""
    sig = {**DEFAULT_SIGNAL, **(signal or {})}
    device = gen.device
    lo, hi = (math.log(f) for f in sig["f0_hz"])
    f0 = torch.exp(lo + (hi - lo) * torch.rand(count, 1, generator=gen, device=device,
                                               dtype=torch.float64))
    k = torch.arange(1, sig["partials"] + 1, device=device, dtype=torch.float64)
    amp = (0.5 + 0.5 * torch.rand(count, k.numel(), generator=gen, device=device,
                                  dtype=torch.float64)) / k
    amp = torch.where(k * f0 < 0.45 * sr, amp, torch.zeros_like(amp))
    amp = 0.5 * amp / amp.sum(dim=1, keepdim=True)
    phase = torch.rand(count, k.numel(), generator=gen, device=device, dtype=torch.float64)
    t = torch.arange(length, device=device, dtype=torch.float64) / sr
    x = sig["noise"] * torch.randn(count, length, generator=gen, device=device)
    for j in range(k.numel()):
        # the phase in cycles, reduced before the sine so float32 keeps it
        cycles = torch.frac(k[j] * f0 * t + phase[:, j:j + 1])
        x += (amp[:, j:j + 1] * torch.sin(2 * math.pi * cycles)).float()
    return x


def labels(gen: torch.Generator, count: int, n_classes: int) -> torch.Tensor:
    return torch.randint(0, n_classes, (count,), generator=gen, device=gen.device)
