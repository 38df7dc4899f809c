"""Sequence-parallel long-audio STFT / iSTFT: the time axis over the ranks.

A single long utterance is split along time, one contiguous piece per rank
of the mesh axis. Each rank frames its piece after receiving the first
``n_fft - hop`` samples of its right neighbour (a ring exchange through
``torch.distributed.batch_isend_irecv``); the last rank's halo is zeros. The
inverse sends its overlap-add tail to the right neighbour, which adds it:
the exact adjoint, so ``istft(stft(x))`` round-trips across ranks.

Conventions: ``center=False``; the local length must be a multiple of
``hop`` and at least ``n_fft - hop``. The ranks' frames together equal an
unsharded ``center=False`` STFT of the whole signal zero-padded by
``n_fft - hop`` at the end.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from ..core.overlap import normalize_by_window_envelope, window_sumsquare
from ..features.base import to_float32
from ..ops.dispatch import framed_basis_pair, synthesis_ola
from .mesh import rank_device


def _ring(mesh: DeviceMesh, axis: str):
    """(group, ranks of the group in axis order, size, this rank's index)."""
    group = mesh.get_group(axis)
    ranks = dist.get_process_group_ranks(group)
    return group, ranks, len(ranks), mesh.get_local_rank(axis)


def _shift(t: torch.Tensor, mesh: DeviceMesh, axis: str, step: int) -> torch.Tensor:
    """Send ``t`` to the rank ``step`` places along the ring and return what
    arrives from the rank ``step`` places the other way."""
    group, ranks, n, idx = _ring(mesh, axis)
    t = t.contiguous()
    recv = torch.empty_like(t)
    ops = [dist.P2POp(dist.isend, t, ranks[(idx + step) % n], group),
           dist.P2POp(dist.irecv, recv, ranks[(idx - step) % n], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


def _as_tensor(x, device) -> torch.Tensor:
    return x.to(device) if isinstance(x, torch.Tensor) else to_float32(x, device)


def time_sharded_stft(x, wcos, wsin, hop: int, mesh: DeviceMesh, axis: str = "data"):
    """This rank's piece ``(B, L_local)`` of a signal split in time over
    ``axis`` -> this rank's frames of the cos and un-negated sin projections,
    two ``(B, F, L_local // hop)`` maps (the pair, K5, for CUDA tensors)."""
    device = rank_device()
    x, wcos, wsin = (_as_tensor(t, device) for t in (x, wcos, wsin))
    _, _, n, idx = _ring(mesh, axis)
    n_fft, local = wcos.shape[-1], x.shape[-1]
    halo = n_fft - hop
    if local % hop:
        raise ValueError(f"local length {local} must be divisible by hop = {hop}")
    if local < halo:
        raise ValueError("local chunk shorter than the halo (n_fft - hop)")
    if halo > 0 and n > 1:
        # the first `halo` samples of the right neighbour; the last rank's
        # neighbour is the signal's end: zeros
        recv = _shift(x[:, :halo], mesh, axis, -1)
        if idx == n - 1:
            recv = torch.zeros_like(recv)
        x = torch.cat((x, recv), dim=-1)
    elif halo > 0:
        x = F.pad(x, (0, halo))
    return framed_basis_pair(x, wcos, wsin, hop)


def time_sharded_istft(spec_real, spec_imag, kernel_cos, kernel_sin, window, hop: int,
                       mesh: DeviceMesh, axis: str = "data"):
    """Inverse of :func:`time_sharded_stft` for full-bin (n_fft-row) kernels:
    this rank's ``(B, n_fft, T_local)`` spectra -> its ``(B, T_local*hop)``
    piece of the waveform, normalized by the window sum-square envelope. The
    synthesis is one overlap-add kernel launch (K3) for CUDA tensors; the
    overlap-add tail and the envelope's tail go to the right neighbour in one
    ring exchange."""
    device = rank_device()
    spec_real, spec_imag, kernel_cos, kernel_sin, window = (
        _as_tensor(t, device) for t in (spec_real, spec_imag, kernel_cos, kernel_sin, window))
    _, _, n, idx = _ring(mesh, axis)
    n_fft = kernel_cos.shape[0]
    t_local = spec_real.shape[-1]
    l_local, halo = t_local * hop, n_fft - hop
    # frames[b, t, j] = (sum_f kc[j, f] re[b, f, t] - ks[j, f] im[b, f, t]) w[j] / n_fft
    kc = kernel_cos.t() * window[None, :] / n_fft
    ks = kernel_sin.t() * window[None, :] / n_fft
    full = synthesis_ola(spec_real, spec_imag, kc, ks, hop)     # (B, l_local + halo)
    env = window_sumsquare(window, t_local, hop, n_fft)[None]   # (1, l_local + halo)
    both = torch.cat((full, env), dim=0)
    body = both[:, :l_local]
    if halo > 0 and n > 1:
        # my tail overlaps the right neighbour's head: ship it right and add
        recv = _shift(both[:, l_local:], mesh, axis, 1)
        if idx > 0:
            body = torch.cat((body[:, :halo] + recv, body[:, halo:]), dim=1)
    sig, env = body[:-1], body[-1]
    return normalize_by_window_envelope(sig, env)
