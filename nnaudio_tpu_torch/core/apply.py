"""Basis application and spectrogram output heads.

Output formats keep the reference's conventions: ``Complex`` stacks
``(real, -imag)``, STFT ``Phase`` is a scalar ``atan2`` and the CQT family's
``Phase`` a ``(cos, sin)`` stack.
"""
from __future__ import annotations

import torch

from ..config import matmul_numerics, round_to_storage


def apply_basis(frames: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """(B, T, N) frames x (F, N) basis -> (B, F, T) in one matmul."""
    with matmul_numerics():
        return torch.matmul(round_to_storage(basis),
                            round_to_storage(frames).transpose(-1, -2))


def project(basis: torch.Tensor, spec: torch.Tensor) -> torch.Tensor:
    """(F_out, F_in) x (B, F_in, T) -> (B, F_out, T) filterbank projection."""
    with matmul_numerics():
        return torch.matmul(round_to_storage(basis), spec)


def magnitude(real: torch.Tensor, imag: torch.Tensor, trainable: bool = False) -> torch.Tensor:
    """sqrt(re^2 + im^2); +1e-8 under the root when trainable to keep the
    gradient finite at 0."""
    power = real * real + imag * imag
    if trainable:
        return torch.sqrt(power + 1e-8)
    return torch.sqrt(power)


def complex_stack(real: torch.Tensor, imag: torch.Tensor) -> torch.Tensor:
    """Stack (real, imag) on a new last axis: the reference complex layout."""
    return torch.stack((real, imag), dim=-1)


def phase_atan(real: torch.Tensor, imag: torch.Tensor) -> torch.Tensor:
    """Scalar phase via atan2; ``+0.0`` scrubs -0.0 exactly like the
    reference."""
    return torch.atan2(imag + 0.0, real)


def phase_unit_stack(real: torch.Tensor, imag: torch.Tensor) -> torch.Tensor:
    """(cos theta, sin theta) stack used by the CQT family."""
    theta = torch.atan2(imag, real)
    return torch.stack((torch.cos(theta), torch.sin(theta)), dim=-1)


def complex_bank_mul(
    kernel_real: torch.Tensor,
    kernel_imag: torch.Tensor,
    spec_real: torch.Tensor,
    spec_imag: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Complex matmul (a+bi)(c+di) of a (F_out, F_in) kernel bank with
    (B, F_in, T) spectra, as one stacked real product
    ``[[kr, -ki], [ki, kr]] @ [fr; fi]`` that reads the spectra once."""
    bank = torch.cat(
        (
            torch.cat((kernel_real, -kernel_imag), dim=1),
            torch.cat((kernel_imag, kernel_real), dim=1),
        ),
        dim=0,
    )
    spec = torch.cat((spec_real, spec_imag), dim=1)
    out = project(bank, spec)
    f_out = kernel_real.shape[0]
    return out[:, :f_out], out[:, f_out:]
