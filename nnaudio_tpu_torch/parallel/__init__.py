"""Multi-device scale-out on ``torch.distributed``, one process per device.

The counterpart of ``nnaudio_tpu.parallel``, where one process drives every
device of a ``jax.sharding`` mesh. Here each rank of an initialized process
group (NCCL on CUDA, gloo on the CPU) drives one device, the mesh is a
``DeviceMesh`` with axes ``("data", "model")``, and a function takes and
returns this rank's part:

- :func:`make_mesh` / :func:`data_parallel` / :func:`shard_batch`: batch
  (data) parallelism; a trainable bank's gradients are all-reduced over
  ``data``.
- :func:`shard_kernel_bank` / :func:`bank_sharded_apply`: the bank's rows
  over ``model``, the output frequency-sharded; :func:`bank_sharded_inverse`
  and :func:`contraction_sharded_cqt1992` reduce partial products with one
  ``all_reduce`` per call.
- :func:`time_sharded_stft` / :func:`time_sharded_istft`: a long signal's
  time axis over the ranks, with an ``(n_fft - hop)``-sample halo exchanged
  in a ring.
"""
from .mesh import local_batch_sharding, make_mesh, rank_device, replicate
from .data import data_parallel, shard_batch
from . import bank
from .bank import (
    bank_sharded_apply,
    bank_sharded_inverse,
    contraction_sharded_cqt1992,
    shard_kernel_bank,
)
from .timeshard import time_sharded_istft, time_sharded_stft
from .input import (
    distributed_initialize,
    global_batch_from_host_local,
    iter_host_batches,
)

__all__ = [
    "make_mesh",
    "local_batch_sharding",
    "replicate",
    "data_parallel",
    "shard_batch",
    "shard_kernel_bank",
    "bank_sharded_apply",
    "contraction_sharded_cqt1992",
    "time_sharded_stft",
    "time_sharded_istft",
    "distributed_initialize",
    "global_batch_from_host_local",
    "iter_host_batches",
]
