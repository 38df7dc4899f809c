"""Checkpoint / resume for transform parameter dicts.

``.npz`` for the simple local case, in the JAX package's layout, so a file
written by either package loads into the other; any other suffix goes
through ``torch.save`` / ``torch.load(weights_only=True)`` (the JAX package
writes an orbax directory there, which has no torch reader). Parameters laid
out over a device mesh (``parallel.shard_kernel_bank``'s DTensors) are saved
with ``torch.distributed.checkpoint``, whose layout on disk does not depend
on the mesh.
"""
from __future__ import annotations

import os
from typing import Mapping

import numpy as np
import torch


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_params(path: str, params: Mapping) -> None:
    """Save a flat params dict (tensors or arrays): ``.npz`` through numpy,
    any other suffix through ``torch.save``."""
    if path.endswith(".npz"):
        np.savez(path, **{k: _host(v) for k, v in params.items()})
        return
    torch.save({k: torch.as_tensor(_host(v)) for k, v in params.items()}, path)


def load_params(path: str) -> dict:
    """The dict :func:`save_params` wrote: numpy arrays from ``.npz``, CPU
    tensors otherwise."""
    if path.endswith(".npz"):
        with np.load(path) as data:
            return {k: data[k] for k in data.files}
    return torch.load(path, weights_only=True)


def restore_transform(transform, path: str, strict: bool = True) -> None:
    """Load parameters into an existing transform in place. ``strict``
    (default) raises on missing or unexpected keys, as ``nn.Module`` does;
    ``strict=False`` loads the intersection, e.g. a checkpoint of another
    package version with another parameter set."""
    state = {k: torch.as_tensor(v) for k, v in load_params(path).items()}
    transform.load_state_dict(state, strict=strict)


def save_sharded(path: str, params: Mapping) -> None:
    """Save a params dict whose values may be DTensors laid out over a device
    mesh (``parallel.shard_kernel_bank``); plain tensors are saved whole.

    A collective: call it on every rank of the process group with the same
    ``path``. Each rank writes its own shards, and the layout on disk does not
    depend on the mesh, so :func:`load_sharded` may restore onto a mesh of
    another shape, or a world of another size."""
    import torch.distributed.checkpoint as dcp

    dcp.save(dict(params), checkpoint_id=os.path.abspath(path))


def load_sharded(path: str, like: Mapping, shardings: Mapping | None = None) -> dict:
    """Restore a checkpoint of :func:`save_sharded` directly onto target
    layouts.

    ``like`` supplies shapes and dtypes (e.g. ``transform.params``);
    ``shardings`` maps parameter names to ``(mesh, placements)`` on a mesh
    of this world, which may have another shape than the one the checkpoint
    was saved from: each rank reads only what its shards need. Names absent
    from ``shardings`` restore whole, as plain tensors on this rank's device
    (``parallel.mesh.rank_device()``). A collective, like the save."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.tensor import distribute_tensor

    from ..parallel.mesh import rank_device

    shardings = shardings or {}
    device = rank_device()
    state = {}
    for k, v in like.items():
        target = torch.empty(v.shape, dtype=v.dtype, device=device)
        if k in shardings:
            mesh, placements = shardings[k]
            target = distribute_tensor(target, mesh, placements, src_data_rank=None)
        state[k] = target
    dcp.load(state, checkpoint_id=os.path.abspath(path))
    return state
