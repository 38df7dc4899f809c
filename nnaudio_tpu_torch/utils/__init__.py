"""Auxiliary subsystems: bucketed lengths, checkpoints and profiling.

A transform's state is an ``nn.Module`` state dict with the JAX package's
flat keys: :func:`save_params` writes it as ``.npz`` (readable by both
packages) or with ``torch.save``, and :func:`save_sharded` writes parameters
laid out over a device mesh with ``torch.distributed.checkpoint``.
:func:`trace` wraps ``torch.profiler``.
"""
from .buckets import (
    bucket_length,
    default_buckets,
    frame_mask,
    pad_to_bucket,
    valid_frame_count,
)
from .checkpoint import (
    load_params,
    load_sharded,
    restore_transform,
    save_params,
    save_sharded,
)
from .profiling import trace

__all__ = [
    "save_params",
    "load_params",
    "save_sharded",
    "load_sharded",
    "restore_transform",
    "trace",
    "pad_to_bucket",
    "bucket_length",
    "default_buckets",
    "frame_mask",
    "valid_frame_count",
]
