"""What the loops share: the port's entry points by name, the device's
synchronisation, the seeded sample of answers and the comparison."""
from __future__ import annotations

import contextlib
import gc
import importlib
import random

import torch

PORT = "nnaudio_tpu_torch"


def entry(path: str):
    """``'features.MelSpectrogram'`` -> that attribute of the port."""
    module, _, name = path.rpartition(".")
    return getattr(importlib.import_module(f"{PORT}.{module}"), name)


def use_precision(mode: str) -> None:
    importlib.import_module(PORT).set_matmul_precision(mode)


def entry_args(entry_cfg: dict, settings: dict, device) -> dict:
    """An entry's keyword arguments: the named settings, its fixed ones and
    the device."""
    args = {k: settings[k] for k in entry_cfg.get("args", [])}
    return {**args, **entry_cfg.get("fixed", {}), "device": device}


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def release(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


class Reservoir:
    """A uniform sample of at most ``size`` answers of a window, drawn from
    the seed: answer ``i`` replaces a kept one with probability
    ``size / (i + 1)``. Keeps ``(index, answer)`` pairs."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = random.Random(seed)
        self.kept: list = []
        self.seen = 0

    def offer(self, index: int, answer) -> None:
        if len(self.kept) < self.size:
            self.kept.append((index, answer))
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.size:
                self.kept[j] = (index, answer)
        self.seen += 1


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    """The worst row's ``||got - want|| / ||want||``, rows along dim 0, in
    float64."""
    got, want = got.double().flatten(1), want.double().flatten(1)
    if got.shape != want.shape:
        return float("inf")
    err = torch.linalg.vector_norm(got - want, dim=1)
    ref = torch.linalg.vector_norm(want, dim=1)
    return float(torch.max(err / ref))


def worst(values) -> float:
    """The largest of ``values``; NaN if any is NaN."""
    values = [float(v) for v in values]
    if any(v != v for v in values):
        return float("nan")
    return max(values, default=0.0)


def span(name: str | None):
    """A profiler span of the benchmark's own around one call, or nothing."""
    if name is None:
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)
