"""Window construction helpers (host-side, NumPy/SciPy).

Behavioral parity with the reference dispatch at
nnAudio's ``utils.py:476-495`` (``get_window_dispatch``):
strings go straight to ``scipy.signal.get_window``; ``("gaussian", att_db)`` tuples
derive sigma from the attenuation at the window border; floats select a Kaiser
window with that beta.
"""
from __future__ import annotations

import numpy as np
from scipy.signal import get_window


def window_dispatch(window, n: int, fftbins: bool = True) -> np.ndarray:
    """Resolve a window spec (str | ("gaussian", att_db) | kaiser-beta float) to samples."""
    if isinstance(window, str):
        return get_window(window, n, fftbins=fftbins)
    if isinstance(window, tuple):
        if window[0] == "gaussian":
            att_db = window[1]
            if att_db < 0:
                raise ValueError("gaussian window attenuation must be >= 0 dB")
            sigma = np.floor(-n / 2 / np.sqrt(-2 * np.log(10 ** (-att_db / 20))))
            return get_window(("gaussian", sigma), n, fftbins=fftbins)
        return get_window(window, n, fftbins=fftbins)
    if isinstance(window, float):
        return get_window(window, n, fftbins=fftbins)
    raise TypeError(
        "window must be a string, a tuple, or a float (kaiser beta); "
        f"got {type(window)!r}"
    )


def pad_center(data: np.ndarray, size: int, axis: int = -1) -> np.ndarray:
    """Zero-pad ``data`` to ``size`` along ``axis``, centering the original samples.

    Matches the centering arithmetic of librosa's ``pad_center`` as vendored at
    ``librosa_functions.py:493-564`` (lpad = (size - n) // 2).
    """
    n = data.shape[axis]
    lpad = (size - n) // 2
    if lpad < 0:
        raise ValueError(f"target size {size} smaller than input size {n}")
    widths = [(0, 0)] * data.ndim
    widths[axis] = (lpad, size - n - lpad)
    return np.pad(data, widths, mode="constant")
