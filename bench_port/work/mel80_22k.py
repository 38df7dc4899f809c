"""Least work of the ``mel80_22k`` cell's calls and kernels.

``least(part, loop, shape, s)`` gives ``(operations, bytes)`` for one
inversion call of ``shape = (B, T, n_iter, n_iter_nnls)`` (``B`` mels of
``T`` frames), or None where the part does no work in that loop. ``s`` is
the configuration's ``settings``. Each input is read once and each output
written once; a frozen Fourier basis counts a real FFT of each frame
(2.5 N log2 N) and the frozen mel filterbank its nonzero entries (2 each).

- ``call``: the mel, the initial phases in and the audio out; a real FFT
  (the analysis) and an inverse real FFT (the synthesis) of every frame in
  each iteration, and one more inverse after the last; 12 operations a bin
  and iteration for the update (``n = r - a p``, ``|n|``, ``S n / |n|``);
  the NNLS's products (:func:`nnls_gemm`).
- ``K3``, each of the call's ``n_iter + 1`` launches: the spectrum pair in
  and the overlap-added signal (``N + hop (T - 1)`` samples) out; an
  inverse real FFT and ``N`` adds (the overlap-add) a frame.
- ``K5``, each of the call's ``n_iter`` launches: the padded signal in and
  the two spectra out; a real FFT a frame.
- ``nnls_gemm``, the call's ``1 + 2 n_iter_nnls`` products: the dense
  pseudo-inverse seed ``pinv(M) mel``, then ``M s`` and ``M^T r`` each NNLS
  step at 2 operations a nonzero of ``M``; each product's operands in and
  its result out.
"""
from __future__ import annotations

import functools

from ..reference import builders
from .counts import FLOAT32, nonzeros, rfft_flops

#: operations of the Griffin-Lim update, a bin and an iteration
UPDATE_FLOPS = 12


@functools.lru_cache(maxsize=None)
def _mel_nonzeros(sr, n_fft, n_mels, fmin, fmax, htk, norm) -> int:
    return nonzeros(builders.mel_filterbank(sr, n_fft, n_mels, fmin, fmax, htk, norm))


def nnls_gemm(shape: tuple, s: dict):
    """``(operations, bytes)`` of a call's NNLS products."""
    b, t, _, steps = shape
    f, m = s["n_fft"] // 2 + 1, s["n_mels"]
    nz = _mel_nonzeros(s["sr"], s["n_fft"], m, s["fmin"], s["fmax"], s["htk"], s["norm"])
    cols = b * t
    seed = 2.0 * f * m * cols, FLOAT32 * (f * m + m * cols + f * cols)
    # M s: M and s in, (M, cols) out; M^T r: M and r in, (F, cols) out
    step = 2 * 2.0 * nz * cols, 2 * FLOAT32 * (m * f + f * cols + m * cols)
    return seed[0] + steps * step[0], seed[1] + steps * step[1]


def least(part: str, loop: str, shape: tuple, s: dict):
    if loop != "invert":
        return None
    b, t, n_iter, _ = shape
    n, hop = s["n_fft"], s["hop_length"]
    f, m = n // 2 + 1, s["n_mels"]
    spectra = FLOAT32 * 2 * b * f * t
    if part == "K3":
        signal = FLOAT32 * b * (n + hop * (t - 1))
        return (n_iter + 1) * b * t * (rfft_flops(n) + n), (n_iter + 1) * (spectra + signal)
    if part == "K5":
        padded = FLOAT32 * b * (hop * (t - 1) + n)
        return n_iter * b * t * rfft_flops(n), n_iter * (padded + spectra)
    if part == "nnls_gemm":
        return nnls_gemm(shape, s)
    if part == "call":
        gemm_flops, _ = nnls_gemm(shape, s)
        ffts = (2 * n_iter + 1) * b * t * rfft_flops(n)
        update = UPDATE_FLOPS * n_iter * b * f * t
        nbytes = FLOAT32 * (b * m * t + b * f * t + b * hop * (t - 1))
        return ffts + update + gemm_flops, nbytes
    return None
