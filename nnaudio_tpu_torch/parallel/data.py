"""Data parallelism: the batch over the ``data`` mesh axis.

Each rank runs the transform on its rows; a per-example transform needs no
communication, so each rank's output equals the single-device output's rows
(bit for bit on one kind of device). For training, a trainable tensor's
gradient is all-reduced (summed) over ``data`` in the backward, so every
rank holds the gradient of the sum of all ranks' losses, the single-device
gradient of a loss summed over the batch.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..features.base import to_float32
from .mesh import rank_device


def shard_batch(x, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's rows of the global ``(B, ...)`` batch ``x`` over the
    ``data`` axis, on this rank's device. B must divide by the axis size."""
    n = mesh.size(mesh.mesh_dim_names.index("data"))
    b = x.shape[0]
    if b % n:
        raise ValueError(f"batch {b} not divisible by data-axis size {n}")
    r, rows = mesh.get_local_rank("data"), b // n
    part = x[r * rows:(r + 1) * rows]
    if isinstance(part, torch.Tensor):
        return part.to(rank_device())
    return to_float32(part, rank_device())


class _SumGradOver(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over ``group``."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def data_parallel(transform, mesh: DeviceMesh, **static_kwargs):
    """Wrap a transform into ``run(x, params=None)``: ``x`` is this rank's
    rows of the batch (e.g. :func:`shard_batch`'s), the result this rank's
    output. Parameters are replicated; those that require a gradient have it
    all-reduced over ``data`` in the backward."""
    group = mesh.get_group("data")
    sum_grads = mesh.size(mesh.mesh_dim_names.index("data")) > 1

    def run(x, params=None):
        merged = transform.params
        if params:
            merged.update(params)
        if sum_grads and torch.is_grad_enabled():
            merged = {k: _SumGradOver.apply(v, group) if v.requires_grad else v
                      for k, v in merged.items()}
        return transform.apply(merged, x, **static_kwargs)

    return run
