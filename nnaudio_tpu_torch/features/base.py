"""Transform base class: an ``nn.Module`` with flat, JAX-compatible state.

Trainable kernels are ``nn.Parameter``s, frozen ones buffers, registered
under the same flat names as the JAX package's ``state_dict()`` keys, so a
snapshot of one loads into the other: ``nn.Module.state_dict`` and
``load_state_dict(strict)``, and
:func:`nnaudio_tpu_torch.interop.load_jax_state` for numpy snapshots. After
either, and after ``update_params``, the ``_refresh_derived`` hook lets a
transform drop what it derived from the old values.
Every forward reads its tensors from an explicit ``params`` dict, which makes
``apply(params, x)`` a functional call with any subset of the tensors
overridden.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from .._spans import span
from ..config import resolve_device
from ..ops.framed_kernels import mark_own


def to_float32(value, device) -> torch.Tensor:
    """A float32 tensor on ``device``: numpy arrays of any float type, like the
    JAX package's float32 arrays, become float32 (``torch.as_tensor`` alone
    would keep float64)."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.array(value, dtype=np.float32)).to(device)


def adopt_state(dst: nn.Module, src: nn.Module, names=None) -> None:
    """Register ``src``'s own parameters and buffers (or the ``names`` among
    them) on ``dst`` under the same names: the very same tensors, so the two
    modules share one state and ``dst.state_dict()`` keeps flat keys."""
    for name, p in src.named_parameters(recurse=False):
        if names is None or name in names:
            dst.register_parameter(name, p)
    for name, buf in src.named_buffers(recurse=False):
        if names is None or name in names:
            dst.register_buffer(name, buf)


class SpectralTransform(nn.Module):
    """Base for the feature transforms.

    Subclasses register tensors in ``__init__`` with :meth:`_register` and
    implement ``_forward(params, x, **kwargs)``. While a profiler runs,
    :meth:`apply` is the span ``nnaudio.transform.<Class>``.
    """

    _span_name = "nnaudio.transform.SpectralTransform"

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        cls._span_name = "nnaudio.transform." + cls.__name__

    def __init__(self, device=None) -> None:
        super().__init__()
        self._init_device = resolve_device(device)

    # ------------------------------------------------------------- params --
    def _register(self, name: str, value, trainable: bool = False) -> torch.Tensor:
        t = to_float32(value, self._init_device)
        if trainable:
            self.register_parameter(name, nn.Parameter(t))
        else:
            self.register_buffer(name, t)
        t = getattr(self, name)
        mark_own(t)
        return t

    def _apply(self, fn, recurse=True):
        """``nn.Module._apply`` (``.to()``, ``.cuda()``, ``.float()``): the
        tensors put in place of this transform's own are its own, so a moved
        transform keeps its FFT routes (``framed_kernels.mark_own``)."""
        result = super()._apply(fn, recurse)
        mark_own(*self.params.values())
        return result

    def __setstate__(self, state):  # a copy (``copy.deepcopy``, unpickling)
        super().__setstate__(state)
        mark_own(*self.params.values())

    def _hold(self, name: str, module: nn.Module) -> None:
        """Keep a helper transform without registering it as a submodule, so
        its tensors do not appear a second time in the state under a dotted
        name; this transform reads only its own flat tensors."""
        object.__setattr__(self, name, module)

    @property
    def device(self) -> torch.device:
        for t in self.params.values():
            return t.device
        return self._init_device

    @property
    def params(self) -> dict[str, torch.Tensor]:
        """All tensors (frozen buffers and trainable kernels alike)."""
        return {**dict(self.named_buffers(recurse=False)),
                **dict(self.named_parameters(recurse=False))}

    def trainable_params(self) -> dict[str, torch.Tensor]:
        """The trainable subset of :attr:`params`: its ``nn.Parameter``s."""
        return dict(self.named_parameters(recurse=False))

    def update_params(self, new_params: Mapping[str, Any]) -> None:
        """Write updated (e.g. optimizer-stepped) values back in place."""
        own = self.params
        for k, v in new_params.items():
            if k not in own:
                raise KeyError(f"unknown parameter {k!r}")
            with torch.no_grad():
                own[k].copy_(to_float32(v, own[k].device))
        self._refresh_derived(set(new_params))

    # ------------------------------------------------------------ derived --
    def _refresh_derived(self, changed: set) -> None:
        """Hook: recompute or drop what is derived from the tensors named in
        ``changed``, after they were persistently updated (``update_params``
        / ``load_state_dict``). Default: nothing is derived."""

    def _derived_state_key(self, key: str) -> bool:
        """Hook: whether ``key`` of a snapshot names an array that is a pure
        function of the state (older JAX snapshots stored some). Such keys
        are accepted by ``load_state_dict`` and ignored."""
        return False

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        state = {k: v for k, v in state_dict.items()
                 if not self._derived_state_key(k)}
        result = super().load_state_dict(state, strict=strict, assign=assign)
        mark_own(*self.params.values())  # assign=True puts the snapshot's tensors in place
        self._refresh_derived(set(state) & set(self.params))
        return result

    # ------------------------------------------------------------ forward --
    def _forward(self, params: Mapping[str, torch.Tensor], x: torch.Tensor, **kw):
        raise NotImplementedError

    def _input(self, x) -> torch.Tensor:
        return to_float32(x, self.device)

    def apply(self, params: Mapping[str, torch.Tensor] | None, x, **kwargs):
        """Functional forward: ``params`` (possibly a partial override, e.g.
        just the trainable subset) applied over the stored tensors."""
        with span(self._span_name):
            merged = self.params
            if params:
                merged.update(params)
            return self._forward(merged, self._input(x), **kwargs)

    def forward(self, x, **kwargs):
        return self.apply(None, x, **kwargs)

    def _verbose_print(self, verbose: bool, message: str) -> None:
        if verbose:
            print(message)
