"""Process-group initialization and the per-rank input pipeline.

With one process per device, each rank loads its own shard of the global
batch: its local batch *is* its part of the data axis, and no array spans
processes. The helpers check the local batch against the mesh and move it to
the rank's device.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..features.base import to_float32
from .mesh import rank_device


def distributed_initialize(**kwargs) -> None:
    """Initialize the process group (no-op when there is nothing to join).

    Explicit ``kwargs`` go to ``torch.distributed.init_process_group`` as
    they are (``backend``, ``init_method``, ``world_size``, ``rank``, ...),
    and its errors propagate: an explicitly configured cluster must not fail
    silently. With no kwargs, an environment that names a cluster
    (``MASTER_ADDR``, ``WORLD_SIZE`` and ``RANK``, as ``torchrun`` sets them)
    initializes from it; without one the call is a no-op. An already
    initialized group is left as it is. Under NCCL each rank then takes the
    CUDA device of its ``LOCAL_RANK`` (or of its rank modulo the devices)."""
    if dist.is_initialized():
        return
    if not kwargs:
        if not all(k in os.environ for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK")):
            return  # single process: nothing to join
        kwargs = {"init_method": "env://"}
    dist.init_process_group(**kwargs)
    if dist.get_backend() == "nccl":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank() % torch.cuda.device_count()))
        torch.cuda.set_device(local)


def global_batch_from_host_local(local_batch, mesh: DeviceMesh, axis: str = "data"):
    """This rank's part of a global batch, from its local ``(B_local, ...)``
    batch: checked against the mesh (``axis`` one of its axes, a leading
    batch axis) and moved to the rank's device. The global batch is the
    concatenation of the ranks' local batches along ``axis``; it is never
    assembled in one process."""
    if axis not in mesh.mesh_dim_names:
        raise ValueError(f"mesh has no axis {axis!r}: {mesh.mesh_dim_names}")
    if not getattr(local_batch, "ndim", 0):
        raise ValueError("a local batch needs a leading batch axis")
    if isinstance(local_batch, torch.Tensor):
        return local_batch.to(rank_device())
    return to_float32(local_batch, rank_device())


def iter_host_batches(dataset, mesh: DeviceMesh, axis: str = "data"):
    """Wrap an iterator of this rank's local batches into batches on its
    device (:func:`global_batch_from_host_local`)."""
    for local in dataset:
        yield global_batch_from_host_local(local, mesh, axis)
