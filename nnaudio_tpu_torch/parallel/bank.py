"""Kernel-bank (tensor-parallel) sharding: basis rows over the ``model`` axis.

A CQT or Fourier basis is a ``(n_bins, n)`` matrix whose rows are
independent output bands, so each rank of the ``model`` axis computes the
bands of its rows and the output comes out frequency-sharded, with no
reduction. Splitting the contraction axis instead (the Fourier bins of
CQT1992, or the bins of an inverse's synthesis bank) leaves a partial sum on
every rank, reduced with one ``all_reduce`` per call.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from .mesh import rank_device

# parameter names whose leading axis is an output frequency band
_BANK_PARAM_PREFIXES = (
    "wsin",
    "wcos",
    "cqt_kernels_real",
    "cqt_kernels_imag",
    # the composed time-domain bases frozen CQT1992 / CQT2010 contract
    "combined_real",
    "combined_imag",
    "mel_basis",
    "gammatone_basis",
    "chroma_basis",
)


def _is_bank(name: str) -> bool:
    return any(name == p or name.startswith(p + "_") for p in _BANK_PARAM_PREFIXES)


def _axis(mesh: DeviceMesh, axis: str) -> tuple[int, int]:
    """(size, this rank's index) of a mesh axis."""
    return mesh.size(mesh.mesh_dim_names.index(axis)), mesh.get_local_rank(axis)


def _block(v: torch.Tensor, n: int, r: int, dim: int = 0) -> torch.Tensor:
    k = v.shape[dim] // n
    return v.narrow(dim, r * k, k)


def _local(v) -> torch.Tensor:
    return v.to_local() if isinstance(v, DTensor) else v


def shard_kernel_bank(params: dict, mesh: DeviceMesh) -> dict:
    """Every bank-shaped parameter (the prefixes above) row-sharded over
    ``model``, everything else replicated, as DTensors on this rank's device
    (``.to_local()`` is this rank's part). A bank whose rows do not divide
    by the axis size is replicated rather than refused."""
    n, _ = _axis(mesh, "model")
    out = {}
    for k, v in params.items():
        rows = _is_bank(k) and v.shape[0] % n == 0
        # every rank holds the whole tensor: each keeps its part, no transfer
        out[k] = distribute_tensor(v.detach().to(rank_device()), mesh,
                                   (Replicate(), Shard(0) if rows else Replicate()),
                                   src_data_rank=None)
    return out


def _output_bank(transform) -> list[str]:
    """The parameters whose rows are the transform's output bins. Empty where
    the output couples its bins (MFCC's DCT, Chroma's per-frame norm) or
    there is no bank: the transform then runs replicated."""
    from ..features import Gammatonegram, MelSpectrogram, STFT

    names = list(transform.params)
    cqt = [k for k in names if k.startswith(("cqt_kernels_", "combined_"))]
    if cqt:
        return cqt
    if isinstance(transform, MelSpectrogram):
        return ["mel_basis"]
    if isinstance(transform, Gammatonegram):
        return ["gammatone_basis"]
    if isinstance(transform, STFT):
        return ["wsin", "wcos"]
    return []


def _output_rows(transform, bank_rows: int, n: int, r: int) -> torch.Tensor:
    """The global output bins that this rank's rows of the bank produce, in
    the order the transform's forward emits them (-1: a row the forward's
    cut to the top ``n_bins`` drops). The pyramid classes run one bank per
    octave and stack the octaves deepest first."""
    k = bank_rows // n
    local = torch.arange(r * k, (r + 1) * k)
    n_oct = getattr(transform, "n_octaves", None)
    if n_oct is None:
        return local
    cut = n_oct * bank_rows - transform.n_bins
    rows = torch.cat([(n_oct - 1 - i) * bank_rows + local for i in reversed(range(n_oct))])
    rows = rows - cut
    # the forward keeps the top n_bins of the rows it stacks
    rows = rows[-min(len(rows), transform.n_bins):]
    return torch.where(rows >= 0, rows, torch.full_like(rows, -1))


def bank_sharded_apply(transform, mesh: DeviceMesh, **static_kwargs):
    """``run(x, params=None)``: the transform on ``x`` (this rank's rows of
    the batch) with its output bank row-sharded over ``model``; returns this
    rank's output bins, ``run.rows`` their global indices. ``params`` may
    override stored tensors, whole or as :func:`shard_kernel_bank`'s
    DTensors. A bank whose rows do not divide by the axis size, or a
    transform whose output couples its bins, runs replicated: every rank
    returns every bin, and ``run.rows`` is None."""
    n, r = _axis(mesh, "model")
    stored = transform.params
    bank = _output_bank(transform)
    rows_of = {stored[k].shape[0] for k in bank}
    if len(rows_of) != 1 or next(iter(rows_of)) % n:
        bank, n, r = [], 1, 0
    out_rows = (_output_rows(transform, rows_of.pop(), n, r) if bank else None)

    def run(x, params=None):
        merged = dict(stored)
        if params:
            merged.update({k: _local(v) for k, v in params.items()})
        if bank:
            for k in bank:
                v = merged[k]
                merged[k] = v if v.shape[0] != stored[k].shape[0] else _block(v, n, r)
            if "lenghts" in merged:
                merged["lenghts"] = merged["lenghts"][out_rows.clamp(min=0).to(
                    merged["lenghts"].device)]
        out = transform.apply(merged, x, **static_kwargs)
        if bank:
            out = out[:, (out_rows >= 0).to(out.device)]
        return out

    run.rows = out_rows[out_rows >= 0] if bank else None
    return run


def contraction_sharded_cqt1992(transform, mesh: DeviceMesh, axis: str = "model",
                                output_format: str | None = None,
                                normalization_type: str = "librosa"):
    """CQT1992 with the contraction axis sharded: each rank of ``axis`` holds
    a block of the Fourier bins (rows of ``wcos`` / ``wsin``) and the
    matching kernel columns, computes its partial complex product (the pair,
    K5, for CUDA tensors, then CQT1992's complex product of the kernel
    columns), and one ``all_reduce(SUM)`` per call adds the partials. The
    contraction is zero-padded to a divisible size (zero bins add nothing).

    Needs the two-stage (trainable-style) CQT1992 parameters; covers the
    full output surface: ``output_format`` Magnitude / Complex / Phase and
    every ``normalization_type``, the Phase-on-raw-pair quirk included.
    ``run(x)`` takes the signal whole (replicated over ``axis``)."""
    from ..core.apply import complex_bank_mul, phase_unit_stack
    from ..features.base import to_float32
    from ..features.cqt import _center_pad, _check_norm_type, _cqt_output
    from ..ops.dispatch import framed_basis_pair

    _check_norm_type(normalization_type)
    n, r = _axis(mesh, axis)
    group = mesh.get_group(axis)
    device = rank_device()
    p = {k: v.detach().to(device) for k, v in transform.params.items()}
    if "cqt_kernels_real" not in p or "wcos" not in p:
        raise ValueError("contraction_sharded_cqt1992 needs CQT1992's two-stage "
                         "parameters (trainable_STFT or trainable_CQT)")
    f_pad = -p["wcos"].shape[0] % n
    wcos, wsin = (F.pad(p[k], (0, 0, 0, f_pad)) for k in ("wcos", "wsin"))
    kr, ki = (F.pad(p[k], (0, f_pad)) for k in ("cqt_kernels_real", "cqt_kernels_imag"))
    wcos, wsin = _block(wcos, n, r), _block(wsin, n, r)
    kr, ki = _block(kr, n, r, dim=1), _block(ki, n, r, dim=1)
    hop, width = transform.hop_length, transform.kernel_width
    output_format = output_format or transform.output_format
    lengths = p["lenghts"]

    def run(x):
        x = to_float32(x, device) if not isinstance(x, torch.Tensor) else x.to(device)
        if x.ndim == 1:
            x = x[None]
        if transform.center:
            x = _center_pad(x, width // 2, transform.pad_mode)
        fr, fi = framed_basis_pair(x, wcos, wsin, hop)
        # CQT1992's own product, on this rank's block of the Fourier bins
        part = torch.cat(complex_bank_mul(kr, ki, fr, fi), dim=1)
        dist.all_reduce(part, op=dist.ReduceOp.SUM, group=group)
        cqt_real, cqt_imag = part.chunk(2, dim=1)
        # CQT1992._forward's output head
        real_n, imag_n = cqt_real, -cqt_imag
        if normalization_type == "librosa":
            scale = torch.sqrt(lengths)[None, :, None] / width
            real_n, imag_n = real_n * scale, imag_n * scale
        elif normalization_type == "wrap":
            real_n, imag_n = real_n * (2 / width), imag_n * (2 / width)
        if output_format == "Phase":
            return phase_unit_stack(cqt_real, cqt_imag)
        return _cqt_output(real_n, imag_n, output_format, trainable=False)

    return run


def bank_sharded_inverse(transform, mesh: DeviceMesh, axis: str = "model",
                         data_axis: str = "data", normalization_type: str = "librosa",
                         band_eta: float = 1e-3, length: int | None = None):
    """Inverse CQT with the canonical-dual synthesis bank's rows (bins)
    sharded over ``axis``: each rank synthesizes its bins' part of the
    waveform (the synthesis kernel, K3, for CUDA tensors) and one
    ``all_reduce(SUM)`` of the ``(B_local, L)`` signal per call adds them.
    ``run(X)`` takes this rank's rows of the batch over ``data_axis``, the
    Complex CQT ``(B_local, n_bins, T, 2)``. Works for CQT1992v2 (the flat
    dual bank) and the pyramid families (the collapsed dual bank)."""
    from ..features.cqt import _check_norm_type
    from ..ops.dispatch import synthesis_ola

    _check_norm_type(normalization_type)
    if data_axis not in mesh.mesh_dim_names:
        raise ValueError(f"mesh has no axis {data_axis!r}")
    n, r = _axis(mesh, axis)
    group = mesh.get_group(axis)
    device = rank_device()
    if hasattr(transform, "_dual_kernels"):  # CQT1992v2 / CQT
        kc, ks = transform._dual_kernels(normalization_type, band_eta)
        hop = transform.hop_length
        start = transform.kernel_width // 2 if transform.center else 0

        def natural(t):
            return transform.kernel_width + hop * (t - 1) - 2 * start
    else:  # the pyramid families
        kc, ks, start, hop = transform._pyramid_dual_kernels(normalization_type, band_eta)

        def natural(t):
            return hop * (t - 1)
    f_pad = -kc.shape[0] % n
    kc, ks = (_block(F.pad(k.to(device), (0, 0, 0, f_pad)), n, r) for k in (kc, ks))

    def run(X):
        X = X.to(device) if isinstance(X, torch.Tensor) else torch.as_tensor(X, device=device)
        X = _block(F.pad(X, (0, 0, 0, 0, 0, f_pad)), n, r, dim=1)
        sig = synthesis_ola(X[..., 0], X[..., 1], kc, ks, hop).contiguous()
        dist.all_reduce(sig, op=dist.ReduceOp.SUM, group=group)
        want = natural(X.shape[2]) if length is None else length
        out = sig[:, start:start + want]
        if out.shape[-1] < want:
            out = F.pad(out, (0, want - out.shape[-1]))
        return out

    return run
