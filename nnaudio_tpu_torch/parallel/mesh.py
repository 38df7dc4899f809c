"""Device mesh construction and placement helpers.

Axis convention: ``("data", "model")``, the batch over ``data`` and the
kernel bank over ``model``. One process per device: the mesh spans the
ranks of the initialized process group (``distributed_initialize`` or
``torch.distributed.init_process_group``), and each rank works on its own
device (:func:`rank_device`).
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard


def _require_group() -> None:
    if not dist.is_initialized():
        raise RuntimeError(
            "nnaudio_tpu_torch.parallel needs an initialized process group: "
            "call parallel.distributed_initialize(...) or "
            "torch.distributed.init_process_group(...) first")


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def rank_device() -> torch.device:
    """This rank's device: its current CUDA device under NCCL, else the CPU."""
    _require_group()
    if _device_type() == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_mesh(data: int | None = None, model: int = 1, devices=None) -> DeviceMesh:
    """A ``(data, model)`` mesh over the process group's ranks (``devices``:
    the ranks, all of them by default); ``data=None`` takes every rank left
    after ``model``. With one process per device every rank needs a place,
    so a mesh smaller than the world is refused (the JAX package would leave
    the spare devices idle)."""
    _require_group()
    world = dist.get_world_size()
    ranks = list(range(world)) if devices is None else sorted(devices)
    n = len(ranks)
    if n % model:
        raise ValueError(f"{n} devices not divisible by model={model}")
    if data is None:
        data = n // model
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} exceeds {n} devices")
    if data * model < world or ranks != list(range(world)):
        raise ValueError(f"mesh {data}x{model} leaves ranks of the {world}-process "
                         "group out: with one process per device every rank needs a place")
    return init_device_mesh(_device_type(), (data, model), mesh_dim_names=("data", "model"))


def local_batch_sharding(mesh: DeviceMesh) -> tuple:
    """Placements of a batch: dim 0 split over ``data``, replicated over
    ``model``."""
    return (Shard(0), Replicate())


def replicate(mesh: DeviceMesh) -> tuple:
    """Placements of a tensor every rank holds whole."""
    return (Replicate(), Replicate())
