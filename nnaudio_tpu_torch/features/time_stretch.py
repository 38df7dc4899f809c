"""Phase vocoder, time stretching, resampling and pitch shifting.

The accumulated phase of the classic vocoder is ``initial + cumsum(per-step
increments)``: every output frame's magnitude interpolation, phase
increment and wrap are computed for all steps at once, and one
``torch.cumsum`` along time replaces librosa's loop. The phase-locked
vocoder couples each step to the previous output phases, so it is a loop
over output steps of a few elementwise (B, F) operations, as the JAX
package's ``lax.scan`` is.

:class:`TimeStretch` is the STFT's Complex output (the pair, K5, for CUDA
tensors), the vocoder, then the iSTFT (the synthesis, K3). ``resample`` is
``core.resample.resample_poly``; :class:`PitchShift` a time stretch followed
by it.
"""
from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch
import torch.nn.functional as F

from ..config import resolve_device
from ..core.resample import resample_poly
from .base import to_float32
from .stft import STFT, iSTFT


def _as_tensor(x, device) -> torch.Tensor:
    """A tensor stays on its device unless ``device`` is given; an array goes
    to ``device``, which ``None`` makes CUDA (and raises without it)."""
    if isinstance(x, torch.Tensor) and device is None:
        return x
    return to_float32(x, resolve_device(device))


def _nearest_peak_index(mag):
    """For every (batch, bin, step), the index of the nearest local maximum
    of the magnitude along the bins (ties to the lower bin), and the peak
    mask. Peaks by padded comparisons, the nearest by a forward
    ``cummax`` and a backward ``cummin`` of the peak positions. The global
    maximum always qualifies, so every frame has a peak."""
    f = mag.shape[1]
    ninf = torch.full_like(mag[:, :1], -np.inf)
    lo = torch.cat((ninf, mag[:, :-1]), dim=1)
    hi = torch.cat((mag[:, 1:], ninf), dim=1)
    is_peak = (mag >= lo) & (mag >= hi)
    bins = torch.arange(f, device=mag.device)[None, :, None].expand_as(mag)
    fwd = torch.cummax(torch.where(is_peak, bins, -1), dim=1).values
    bwd = torch.cummin(torch.where(is_peak, bins, 2 * f).flip(1), dim=1).values.flip(1)
    # the closer side; fwd == -1 and bwd == 2f mark "none"
    d_f = torch.where(fwd >= 0, bins - fwd, 2 * f)
    d_b = torch.where(bwd < f, bwd - bins, 2 * f)
    return torch.where(d_f <= d_b, fwd.clamp(min=0), bwd.clamp(max=f - 1)), is_peak


def phase_vocoder(X, rate: float, hop_length: int, phase_lock: bool = True,
                  device=None):
    """Stretch a complex STFT in time by ``rate`` without changing pitch.

    ``X`` is a ``(B, F, T, 2)`` onesided complex stack (the rfft convention,
    as ``STFT(output_format="Complex")`` gives it); ``rate > 1`` speeds up,
    ``rate < 1`` slows down, and the output has ``ceil(T / rate)`` frames.
    ``hop_length`` sets the expected phase advance per frame,
    ``2 pi f hop / n_fft``. With ``phase_lock`` (the default) only the local
    magnitude peaks accumulate phase and every other bin takes its nearest
    peak's phase plus the source frame's offset between the two
    (Laroche-Dolson identity phase locking); without it, the classic
    vocoder (librosa's ``phase_vocoder``). A tensor ``X`` is worked on
    where it lies; an array goes to ``device`` (``None`` means CUDA; pass
    ``device="cpu"`` for the CPU). Returns the stretched
    ``(B, F, ceil(T/rate), 2)`` stack: magnitudes interpolated linearly
    between the two bracketing input frames (past the last one towards
    zero, as librosa pads), phases advanced by the instantaneous
    frequency."""
    X = _as_tensor(X, device)
    b, f, t = X.shape[0], X.shape[1], X.shape[2]
    n_fft = 2 * (f - 1)
    dev = X.device

    steps = np.arange(0, t, float(rate))
    idx0 = torch.as_tensor(np.floor(steps).astype(np.int64), device=dev)
    idx1 = idx0 + 1  # <= t, which hits the zero pad
    alpha = torch.as_tensor((steps - np.floor(steps)).astype(np.float32),
                            device=dev)

    Xp = F.pad(X, (0, 0, 0, 1))
    r0, i0 = Xp[..., 0][:, :, idx0], Xp[..., 1][:, :, idx0]
    r1, i1 = Xp[..., 0][:, :, idx1], Xp[..., 1][:, :, idx1]
    mag = ((1.0 - alpha) * torch.sqrt(r0 * r0 + i0 * i0)
           + alpha * torch.sqrt(r1 * r1 + i1 * i1))

    omega = ((2.0 * np.pi * hop_length / n_fft)
             * torch.arange(f, dtype=torch.float32, device=dev))[None, :, None]
    phase0 = torch.atan2(i0, r0)
    phase1 = torch.atan2(i1, r1)
    # instantaneous frequency: the expected advance plus the principal
    # value of the deviation (torch.round rounds half to even, as jnp does)
    dev_ph = phase1 - phase0 - omega
    dev_ph = dev_ph - 2.0 * np.pi * torch.round(dev_ph / (2.0 * np.pi))
    inc = omega + dev_ph

    if not phase_lock:
        # the first frame keeps the input's phase, each later frame adds the
        # previous step's increment: an exclusive cumsum
        acc = torch.cumsum(inc, dim=2)
        phase = phase0[:, :, :1] + torch.cat(
            (torch.zeros_like(acc[:, :, :1]), acc[:, :, :-1]), dim=2)
        return torch.stack((mag * torch.cos(phase), mag * torch.sin(phase)), dim=-1)

    peak_idx, is_peak = _nearest_peak_index(mag)
    phases = [phase0[:, :, 0]]  # step 0 emits the source phases
    for s in range(1, len(steps)):
        acc = phases[-1] + inc[:, :, s - 1]  # valid at the peaks
        pidx = peak_idx[:, :, s]
        src = phase0[:, :, s]
        locked = (torch.gather(acc, 1, pidx)
                  + (src - torch.gather(src, 1, pidx)))
        phases.append(torch.where(is_peak[:, :, s], acc, locked))
    phase = torch.stack(phases, dim=2)
    return torch.stack((mag * torch.cos(phase), mag * torch.sin(phase)), dim=-1)


class TimeStretch:
    """Time-stretch audio without changing pitch: the STFT's Complex output,
    the phase vocoder (:func:`phase_vocoder`), then the iSTFT.

    Parameters: ``n_fft=2048``, ``hop_length=None`` (``n_fft // 4``),
    ``window='hann'``, ``verbose=False``, as in
    ``nnaudio_tpu.features.TimeStretch``; plus ``device`` (``None`` means
    CUDA; pass ``device="cpu"`` for the CPU), which the STFT and iSTFT take.

    Call as ``ts(x, rate)`` (``rate > 1`` faster, ``< 1`` slower) with
    ``x`` of shape ``(L,)`` or ``(B, L)``; the output has
    ``round(L / rate)`` samples.
    """

    def __init__(self, n_fft: int = 2048, hop_length: int | None = None,
                 window: str = "hann", verbose: bool = False, device=None):
        self.n_fft = n_fft
        self.hop = n_fft // 4 if hop_length is None else hop_length
        self.device = resolve_device(device)
        self._stft = STFT(n_fft=n_fft, hop_length=self.hop, window=window,
                          output_format="Complex", center=True,
                          verbose=verbose, device=self.device)
        self._istft = iSTFT(n_fft=n_fft, hop_length=self.hop, window=window,
                            center=True, verbose=verbose, device=self.device)

    def __call__(self, x, rate: float, phase_lock: bool = True):
        if rate <= 0:
            raise ValueError("rate must be positive")
        x = to_float32(x, self.device)
        squeeze = x.ndim == 1
        if squeeze:
            x = x[None]
        length = int(round(x.shape[-1] / rate))
        X = self._stft(x, output_format="Complex")
        Y = phase_vocoder(X, rate, self.hop, phase_lock=phase_lock)
        out = self._istft(Y, onesided=True, length=length)
        return out[0] if squeeze else out


def resample(x, orig_sr: float, target_sr: float, max_denominator: int = 512,
             device=None):
    """Rational-rate resampling, librosa's ``resample`` with
    ``res_type='polyphase'``: one banded framed matmul
    (``core.resample.resample_poly``, equal to ``scipy.signal.resample_poly``
    up to fp32 rounding). The ratio is approximated by a fraction with a
    denominator of at most ``max_denominator`` (exact for rates such as
    22050 -> 44100 or 44100 -> 48000). A tensor ``x`` is worked on where it
    lies; an array goes to ``device`` (``None`` means CUDA; pass
    ``device="cpu"`` for the CPU)."""
    x = _as_tensor(x, device)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None]
    frac = Fraction(target_sr / orig_sr).limit_denominator(max_denominator)
    out = resample_poly(x, frac.numerator, frac.denominator)
    return out[0] if squeeze else out


class PitchShift:
    """Shift pitch by ``n_steps`` (fractions allowed) without changing
    duration: a phase-locked time stretch by ``2^(-n/bins_per_octave)``
    followed by a polyphase speed change back to the original length.

    Parameters: ``sr=22050``, ``n_fft=2048``, ``hop_length=None``,
    ``window='hann'``, ``bins_per_octave=12``, ``max_denominator=150``,
    ``verbose=False``, as in ``nnaudio_tpu.features.PitchShift``; plus
    ``device`` (``None`` means CUDA; pass ``device="cpu"`` for the CPU).
    Call as ``ps(x, n_steps)``.
    """

    def __init__(self, sr: float = 22050, n_fft: int = 2048,
                 hop_length: int | None = None, window: str = "hann",
                 bins_per_octave: int = 12, max_denominator: int = 150,
                 verbose: bool = False, device=None):
        self.sr = sr
        self.bins_per_octave = bins_per_octave
        self.max_denominator = max_denominator
        self._ts = TimeStretch(n_fft=n_fft, hop_length=hop_length,
                               window=window, verbose=verbose, device=device)

    def __call__(self, x, n_steps: float, phase_lock: bool = True):
        x = to_float32(x, self._ts.device)
        squeeze = x.ndim == 1
        if squeeze:
            x = x[None]
        if n_steps == 0:
            return x[0] if squeeze else x
        s = 2.0 ** (float(n_steps) / self.bins_per_octave)
        stretched = self._ts(x, rate=1.0 / s, phase_lock=phase_lock)
        # the speed change by s: L*s samples -> L, raising the pitch by s
        frac = Fraction(1.0 / s).limit_denominator(self.max_denominator)
        out = resample_poly(stretched, frac.numerator, frac.denominator)
        length = x.shape[-1]
        out = out[:, :length]
        if out.shape[-1] < length:
            out = F.pad(out, (0, length - out.shape[-1]))
        return out[0] if squeeze else out
