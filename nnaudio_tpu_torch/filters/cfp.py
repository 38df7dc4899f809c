"""CFP (combined frequency & periodicity) projection matrices — host side.

Behavioral parity with nnAudio's ``create_logfreq_matrix``
(``features/cfp.py:195-246``): triangular
interpolation of linear-frequency bins and quefrency bins onto a log-frequency
axis with ``NumPerOct`` bins per octave.
"""
from __future__ import annotations

import numpy as np


def log_central_freqs(fc: float, tc: float, num_per_oct: int) -> np.ndarray:
    """Log-spaced center frequencies from ``fc`` up to (exclusive) ``1/tc``."""
    stop_freq = 1 / tc
    n_est = int(np.ceil(np.log2(stop_freq / fc)) * num_per_oct)
    cen = fc * 2.0 ** (np.arange(n_est, dtype=np.float64) / num_per_oct)
    return cen[cen < stop_freq]


def _triangle_weight(fj: float, lo: float, mid: float, hi: float) -> float:
    if lo < fj < mid:
        return (fj - lo) / (mid - lo)
    if mid < fj < hi:
        return (hi - fj) / (hi - mid)
    return 0.0


def cfp_logfreq_matrices(
    f: np.ndarray,
    q: np.ndarray,
    fr: float,
    fc: float,
    tc: float,
    num_per_oct: int,
    fs: float,
) -> tuple[np.ndarray, np.ndarray]:
    """(freq->logfreq, quef->logfreq) triangular projection matrices.

    Shapes ``(n_log_bins - 1, len(f))`` and ``(n_log_bins - 1, len(q))``.
    Row 0 and the last row stay zero, matching the reference loop bounds.
    """
    central = log_central_freqs(fc, tc, num_per_oct)
    n_est = len(central)

    freq_mat = np.zeros((n_est - 1, len(f)), dtype=np.float64)
    for i in range(1, n_est - 1):
        lo, mid, hi = central[i - 1], central[i], central[i + 1]
        l = int(round(lo / fr))
        r = int(round(hi / fr) + 1)
        if l >= r - 1:
            freq_mat[i, l] = 1.0
        else:
            for j in range(l, r):
                freq_mat[i, j] = _triangle_weight(f[j], lo, mid, hi)

    # quefrency bins are mapped through their reciprocal frequency 1/q
    with np.errstate(divide="ignore"):
        f_of_q = 1.0 / q
    quef_mat = np.zeros((n_est - 1, len(q)), dtype=np.float64)
    for i in range(1, n_est - 1):
        lo, mid, hi = central[i - 1], central[i], central[i + 1]
        j_lo = int(round(fs / hi))
        j_hi = int(round(fs / lo) + 1)
        for j in range(j_lo, j_hi):
            quef_mat[i, j] = _triangle_weight(f_of_q[j], lo, mid, hi)

    return freq_mat, quef_mat
