"""Faults planted in the port, to show that the check catches them.

Each fault wraps the port's entry that a loop calls, for the length of a
``with`` block, and is a fault that a cell of that loop can have:

- ``altered`` (every loop): one value of an answer changed by 1% of the
  answer's largest magnitude where it is produced; in training, one entry of
  the first new parameter moved by 1e-3;
- ``unchanged`` (stream, train): the step returns the state it was given;
- ``half_batch`` (train): the step sees half of the batch, its loss the
  mean over that half.

No card path of one chip exchanges anything between chips, so the fault of
an exchange left out has no cell here.

Those are the faults of the three loops above. Any other loop brings its
own: its module ``loops/<loop>.py`` defines ``FAULTS``, a tuple of names,
and ``plant(fault, entry_cfg)``, a context manager; :func:`names` and
:func:`planted` ask it.
"""
from __future__ import annotations

import contextlib
import importlib

import torch

FAULTS = {"offline": ("altered",), "stream": ("altered", "unchanged"),
          "train": ("altered", "unchanged", "half_batch")}


def _loop_module(loop: str):
    return importlib.import_module(f"{__package__}.loops.{loop}")


def names(loop: str) -> tuple:
    """The faults that a cell of ``loop`` can have."""
    if loop in FAULTS:
        return FAULTS[loop]
    return tuple(getattr(_loop_module(loop), "FAULTS", ()))


def _alter(y: torch.Tensor) -> torch.Tensor:
    y = y.clone()
    flat = y.view(-1)
    flat[flat.numel() // 2] += 0.01 * float(y.abs().max())
    return y


@contextlib.contextmanager
def patched(owner, name: str, make):
    own = name in vars(owner)
    original = getattr(owner, name)
    setattr(owner, name, make(original))
    try:
        yield
    finally:
        if own:
            setattr(owner, name, original)
        else:
            delattr(owner, name)


def planted(fault: str, loop: str, entry_cfg: dict):
    """A context in which the entry of ``entry_cfg`` carries ``fault``."""
    if fault not in names(loop):
        raise ValueError(f"a {loop} cell has no fault {fault!r}")
    if loop not in FAULTS:
        return _loop_module(loop).plant(fault, entry_cfg)
    port = importlib.import_module("nnaudio_tpu_torch")
    if loop == "offline":
        module, _, name = entry_cfg["call"].rpartition(".")
        cls = getattr(importlib.import_module(f"{port.__name__}.{module}"), name)
        return patched(cls, "forward", lambda f: lambda self, x, **kw: _alter(f(self, x, **kw)))
    if loop == "stream":
        module, _, name = entry_cfg["call"].rpartition(".")
        cls = getattr(importlib.import_module(f"{port.__name__}.{module}"), name)

        def make(f):
            def step(self, state, chunk):
                new_state, y = f(self, state, chunk)
                if fault == "unchanged":
                    return state, y
                return new_state, (_alter(y) if y.numel() else y)
            return step
        return patched(cls, "step", make)

    module, _, name = entry_cfg["step"].rpartition(".")
    owner = importlib.import_module(f"{port.__name__}.{module}")

    def make(f):
        def step(model, params, x, labels, lr=1e-3):
            if fault == "unchanged":
                loss, _ = f(model, params, x, labels, lr)
                return loss, params
            if fault == "half_batch":
                half = x.shape[0] // 2
                return f(model, params, x[:half], labels[:half], lr)
            loss, new = f(model, params, x, labels, lr)
            new = dict(new)
            first = next(iter(new))
            new[first] = new[first].clone()
            new[first].view(-1)[0] += 1e-3
            return loss, new
        return step
    return patched(owner, name, make)
