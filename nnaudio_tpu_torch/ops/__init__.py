"""Framed ops and the CUDA kernels behind them."""
from .dispatch import (
    framed_basis_pair,
    framed_complex,
    framed_filterbank,
    framed_magnitude,
    framed_power,
    gl_step,
    synthesis_ola,
)
from .framed_kernels import LAUNCHES, reset_launches

__all__ = [
    "framed_basis_pair",
    "framed_complex",
    "framed_filterbank",
    "framed_magnitude",
    "framed_power",
    "gl_step",
    "synthesis_ola",
    "LAUNCHES",
    "reset_launches",
]
