"""Framed ops and the CUDA kernels behind them."""
from .dispatch import (
    KCHUNK_MIN_N,
    framed_basis_pair,
    framed_complex,
    framed_filterbank,
    framed_magnitude,
    framed_power,
    force_fuse,
    gl_step,
    kchunk_envelope,
    synthesis_ola,
)
from .framed_kernels import LAUNCHES, reset_launches
from .pyramid import materialize_frames, pyramid_basis_pair, pyramid_enabled

__all__ = [
    "framed_basis_pair",
    "framed_complex",
    "framed_filterbank",
    "framed_magnitude",
    "framed_power",
    "force_fuse",
    "gl_step",
    "synthesis_ola",
    "KCHUNK_MIN_N",
    "kchunk_envelope",
    "LAUNCHES",
    "reset_launches",
    "materialize_frames",
    "pyramid_basis_pair",
    "pyramid_enabled",
]
