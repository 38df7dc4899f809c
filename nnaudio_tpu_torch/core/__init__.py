"""Functional runtime: framing, basis matmuls, overlap-add."""
from .frame import (
    broadcast_dim,
    frame_signal,
    frames_to_signal,
    num_frames,
    pad_signal,
)
from .apply import (
    apply_basis,
    complex_stack,
    magnitude,
    phase_atan,
    project,
)
from .overlap import (
    extend_fbins,
    normalize_by_window_envelope,
    window_sumsquare,
)

__all__ = [
    "broadcast_dim",
    "frame_signal",
    "frames_to_signal",
    "num_frames",
    "pad_signal",
    "apply_basis",
    "complex_stack",
    "magnitude",
    "phase_atan",
    "project",
    "extend_fbins",
    "normalize_by_window_envelope",
    "window_sumsquare",
]
