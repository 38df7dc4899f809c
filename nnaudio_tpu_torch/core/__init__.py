"""Functional runtime: framing, basis matmuls, overlap-add, FIR decimation."""
from .frame import (
    broadcast_dim,
    frame_signal,
    frames_to_signal,
    num_frames,
    pad_signal,
)
from .apply import (
    apply_basis,
    complex_bank_mul,
    complex_stack,
    magnitude,
    phase_atan,
    phase_unit_stack,
    project,
)
from .overlap import (
    extend_fbins,
    normalize_by_window_envelope,
    window_sumsquare,
)
from .resample import (compose_cascade, downsample_by_2, downsample_by_n,
                       resample_poly)

__all__ = [
    "broadcast_dim",
    "frame_signal",
    "frames_to_signal",
    "num_frames",
    "pad_signal",
    "apply_basis",
    "complex_bank_mul",
    "complex_stack",
    "magnitude",
    "phase_atan",
    "phase_unit_stack",
    "project",
    "compose_cascade",
    "resample_poly",
    "downsample_by_2",
    "downsample_by_n",
    "extend_fbins",
    "normalize_by_window_envelope",
    "window_sumsquare",
]
