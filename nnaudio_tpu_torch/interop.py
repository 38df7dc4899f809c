"""Carry the JAX package's weights into the port.

The caller turns the JAX side into numpy (``{k: np.asarray(v) ...}``, or a
transform's ``state_dict()``); this module never imports JAX. Every array
becomes float32, as the JAX package's arrays are (``torch.as_tensor`` alone
would keep a float64 numpy array float64).
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from .config import resolve_device
from .features.base import to_float32


def params_from_jax(state: Mapping[str, np.ndarray], device) -> dict[str, torch.Tensor]:
    """Flat ``{name: array}`` from the JAX package -> float32 tensors on
    ``device`` (``None`` means CUDA)."""
    dev = resolve_device(device)
    return {k: to_float32(v, dev) for k, v in state.items()}


def load_jax_state(module: nn.Module, state: Mapping[str, np.ndarray],
                   strict: bool = True):
    """Load a JAX ``state_dict()`` (or params dict) into ``module``, each
    tensor onto the device of the tensor it replaces. ``strict=True`` raises
    on missing or unexpected keys; keys that name derived arrays (a pyramid
    snapshot's legacy ``lowpass_cascade_k``) are accepted and ignored by the
    transform's ``load_state_dict``."""
    own = module.state_dict()
    tensors = {k: to_float32(v, own[k].device if k in own else "cpu")
               for k, v in state.items()}
    return module.load_state_dict(tensors, strict=strict)
