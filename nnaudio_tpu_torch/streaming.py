"""Streaming (chunked) feature extraction for online / serving pipelines.

A serving system that receives audio in chunks would otherwise re-run the
transform over a growing buffer or hand-roll the overlap bookkeeping. These
classes do the bookkeeping once, exactly:

    stream = StreamingSTFT(n_fft=2048, hop_length=512)
    state = stream.init_state(batch)
    for chunk in chunks:                       # each len % hop == 0
        state, frames = stream.step(state, chunk)

``concat(frames)`` equals the offline ``center=False`` transform of
``concat(chunks)``: the state carries exactly the samples that every frame
boundary straddles, and each step runs the same framed op (the same CUDA
kernel) as the offline transform on the frames it completes. The sums of a
kernel may be split differently at another frame count (K6 plans its K splits
from the shapes), so agreement is to the last ulp, not bitwise.

Each step launches its kernel once (``ops.dispatch``), eagerly: there is no
compile cache, so a stream may change its chunk length between calls at no
cost beyond the launch. ``fuse=`` overrides the kernel switches for a
stream's steps (``ops.dispatch.force_fuse``): ``True`` launches the kernels
for CUDA tensors even where ``config.set_use_kernels*(False)`` turned them
off, ``False`` takes the plain PyTorch versions, ``None`` leaves ``config`` in
charge.

Design notes / contract (those of the JAX package's ``streaming``):
- ``center=False`` (the only convention with a causal streaming equivalent).
- chunk lengths must be multiples of ``hop_length`` (``ValueError``
  otherwise); they may vary between calls.
- the first ``width - hop`` samples only prime the state: frame 0 spans
  ``x[0:width]`` exactly like offline, and until ``width`` samples have
  arrived ``step`` emits 0 frames.
- buffers live on the transform's device (``device=``: CUDA unless the
  caller passes ``device="cpu"``); a numpy chunk is moved there, a tensor
  chunk on another device raises.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ._spans import span
from .core.apply import project
from .core.overlap import normalize_by_window_envelope, window_sumsquare
from .features.base import to_float32
from .features.stft import STFT, iSTFT
from .ops.dispatch import (force_fuse, framed_basis_pair, framed_filterbank,
                           framed_magnitude, synthesis_ola)
from .ops.framed_kernels import mark_own, synthesis_kernels

__all__ = [
    "StreamState",
    "StreamingSTFT",
    "StreamingCQT",
    "StreamingMel",
    "StreamingMFCC",
    "StreamingGammatone",
    "StreamingChroma",
    "StreamingiSTFT",
    "StreamingInverseCQT",
]


class StreamState(NamedTuple):
    """Carry between chunks: the not-yet-consumed tail of the stream
    (right-aligned, zeros until primed) and how many of its samples are real
    (a Python int).

    Capacity is ``ceil((width - hop)/hop) * hop``: with hop-multiple chunks
    the un-consumed leftover is always ``= 0 (mod hop)`` in
    ``[width - hop, width)``, which exceeds ``width - hop`` itself whenever
    ``width % hop != 0`` (e.g. 512/160 carries 480)."""

    buffer: torch.Tensor  # (B, buf_cap)
    primed: int           # count of valid samples in buffer, 0..buf_cap


def _make_carry_step(width: int, hop: int, buf_cap: int, c: int, primed: int,
                     apply_sig, empty_out):
    """Streaming step for any frame-local transform (output column ``t``
    depends only on ``sig[t*hop : t*hop + width]``). Returns ``(fn,
    new_primed)`` where ``fn`` maps (params, buffer, chunk) -> (new_buffer,
    frames).

    ``apply_sig(params, sig)`` computes the transform over an exact-length
    signal (``(n_frames-1)*hop + width`` samples); ``empty_out(params, b)``
    builds the zero-frame output while priming."""
    valid = primed + c          # samples available this step
    n_frames = max(0, (valid - width) // hop + 1)
    # samples consumed by emitted frames; the remainder carries over. With
    # hop-multiple chunks the leftover is in [width-hop, width) after any
    # emission, and == valid (< width) while priming: both within buf_cap
    new_primed = valid - n_frames * hop
    if not 0 <= new_primed <= buf_cap:
        raise RuntimeError(f"stream carry {new_primed} outside [0, {buf_cap}]")

    def step(params, buffer, chunk):
        with span("nnaudio.stream.carry"):
            ext = (torch.cat((buffer[:, buffer.shape[1] - primed:], chunk), dim=-1)
                   if primed else chunk)
            tail = ext[:, ext.shape[1] - new_primed:] if new_primed else ext[:, :0]
            pad = buf_cap - new_primed
            new_buffer = F.pad(tail, (pad, 0)) if pad else tail
        if n_frames == 0:
            return new_buffer, empty_out(params, chunk.shape[0])
        sig = ext[:, : (n_frames - 1) * hop + width]
        return new_buffer, apply_sig(params, sig)

    return step, new_primed


def _on_device(x, device: torch.device, what: str) -> torch.Tensor:
    """A float32 tensor on the stream's device: an array is moved there, a
    tensor on another device raises."""
    if isinstance(x, torch.Tensor) and x.device != device:
        raise ValueError(f"{what} is on {x.device}; this stream runs on {device}")
    return to_float32(x, device)


class _StreamingFramed:
    """Shared chunked-analysis machinery for frame-local transforms.
    Subclasses call :meth:`_init_stream` and implement
    ``_apply_sig(params, sig)`` / ``_empty_out(params, batch)``. While a
    profiler runs, :meth:`step` is the span ``nnaudio.stream.step.<Class>``."""

    _span_name = "nnaudio.stream.step._StreamingFramed"

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        cls._span_name = "nnaudio.stream.step." + cls.__name__

    def _init_stream(self, width: int, hop: int, params: dict, device,
                     fuse: bool | None = None) -> None:
        if hop > width:
            raise ValueError("hop_length > frame width has gaps; cannot stream")
        self.width = width
        self.hop = hop
        self.fuse = fuse
        self.device = device
        self._params = dict(params)

    @property
    def overlap(self) -> int:
        return self.width - self.hop

    @property
    def buf_cap(self) -> int:
        """Carry capacity (see :class:`StreamState`)."""
        return -(-self.overlap // self.hop) * self.hop

    def init_state(self, batch: int) -> StreamState:
        return StreamState(
            buffer=torch.zeros((batch, self.buf_cap), device=self.device), primed=0)

    # ------------------------------------------------------------- one step
    def step(self, state: StreamState, chunk) -> tuple[StreamState, torch.Tensor]:
        """Consume one ``(B, C)`` chunk (``C % hop == 0``); return
        ``(new_state, frames)`` with the time axis sized ``C//hop`` once
        primed (first frames appear when ``width`` samples have arrived)."""
        with span(self._span_name):
            chunk = _on_device(chunk, self.device, "chunk")
            if chunk.ndim == 1:
                chunk = chunk[None]
            c = chunk.shape[1]
            if c % self.hop:
                raise ValueError(f"chunk length {c} must be a multiple of hop={self.hop}")
            fn, new_primed = _make_carry_step(
                self.width, self.hop, self.buf_cap, c, state.primed,
                self._apply_sig, self._empty_out)
            with force_fuse(self.fuse):
                new_buffer, frames = fn(self._params, state.buffer, chunk)
            return StreamState(new_buffer, new_primed), frames

    # ------------------------------------------------- whole-signal helper
    def stream(self, x, chunk_len: int):
        """Generator over a pre-recorded ``(B, L)`` signal in
        ``chunk_len``-sized chunks. A trailing remainder is processed too,
        floored to a hop multiple: only the final sub-hop residue (which
        completes no frame) is dropped."""
        x = _on_device(x, self.device, "signal")
        if x.ndim == 1:
            x = x[None]
        state = self.init_state(x.shape[0])
        total = x.shape[-1]
        pos = 0
        while pos < total:
            c = min(chunk_len, total - pos)
            c = (c // self.hop) * self.hop
            if c == 0:
                break
            state, frames = self.step(state, x[:, pos: pos + c])
            pos += c
            if frames.shape[2]:  # time axis (shape[-1] is ri for Complex)
                yield frames


def _empty_frames(b: int, f: int, complex_: bool, device) -> torch.Tensor:
    return torch.zeros((b, f, 0, 2) if complex_ else (b, f, 0), device=device)


class StreamingSTFT(_StreamingFramed):
    """Chunked STFT equal to the offline ``STFT(center=False)``.

    Parameters mirror :class:`~nnaudio_tpu_torch.features.STFT`;
    ``output_format`` in {'Magnitude', 'Complex'} (the magnitude kernel K1,
    or the pair K5, once per step for CUDA tensors); ``device`` as the
    features take it.
    """

    def __init__(
        self,
        n_fft: int = 2048,
        hop_length: int | None = None,
        win_length: int | None = None,
        freq_bins: int | None = None,
        window: str = "hann",
        freq_scale: str = "no",
        sr: float = 22050,
        fmin: float = 50,
        fmax: float = 6000,
        output_format: str = "Magnitude",
        verbose: bool = False,
        fuse: bool | None = None,
        device=None,
    ):
        if output_format not in ("Magnitude", "Complex"):
            raise ValueError("streaming supports output_format 'Magnitude' or 'Complex'")
        self.n_fft = n_fft
        hop = n_fft // 4 if hop_length is None else hop_length
        self.output_format = output_format
        self._stft = STFT(
            n_fft=n_fft, hop_length=hop, win_length=win_length,
            freq_bins=freq_bins, window=window, freq_scale=freq_scale,
            sr=sr, fmin=fmin, fmax=fmax, center=False,
            output_format=output_format, verbose=verbose, device=device,
        )
        self._init_stream(n_fft, hop, self._stft.params, self._stft.device, fuse=fuse)

    def _apply_sig(self, params, sig):
        if self.output_format == "Magnitude":
            return framed_magnitude(sig, params["wcos"], params["wsin"], self.hop, eps=0.0)
        re, im_raw = framed_basis_pair(sig, params["wcos"], params["wsin"], self.hop)
        return torch.stack((re, -im_raw), dim=-1)

    def _empty_out(self, params, b):
        return _empty_frames(b, params["wcos"].shape[0],
                             self.output_format == "Complex", self.device)


class StreamingCQT(_StreamingFramed):
    """Chunked CQT1992v2 (``center=False``): the wavelet bank's width takes
    the role of ``n_fft``, so frame ``t`` spans ``x[t*hop : t*hop + width]``
    and the same carry applies (the default 84-bin bank is 16384 samples
    wide). Any :class:`~nnaudio_tpu_torch.features.CQT1992v2` argument is
    accepted (``center`` is forced False); ``output_format`` in {'Magnitude',
    'Complex'}: the banded magnitude kernel K6 (or K1 outside its envelope),
    or the pair K5, once per step for CUDA tensors."""

    def __init__(self, output_format: str = "Magnitude",
                 normalization_type: str = "librosa",
                 fuse: bool | None = None, **kwargs):
        from .features.cqt import CQT1992v2

        if output_format not in ("Magnitude", "Complex"):
            raise ValueError("streaming supports output_format 'Magnitude' or 'Complex'")
        kwargs.pop("center", None)
        self._cqt = CQT1992v2(center=False, output_format=output_format, **kwargs)
        self.output_format = output_format
        self.normalization_type = normalization_type
        self._init_stream(self._cqt.kernel_width, self._cqt.hop_length,
                          self._cqt.params, self._cqt.device, fuse=fuse)

    def _apply_sig(self, params, sig):
        return self._cqt._forward(params, sig, output_format=self.output_format,
                                  normalization_type=self.normalization_type)

    def _empty_out(self, params, b):
        return _empty_frames(b, params["cqt_kernels_real"].shape[0],
                             self.output_format == "Complex", self.device)


class _StreamingFilterbank(_StreamingFramed):
    """Shared chunked machinery for filterbank spectrograms: Mel, Gammatone,
    Chroma and MFCC are frame-local projections of ``|STFT|^power`` (plus an
    optional per-frame epilogue, :meth:`_post`). At ``power=2`` each step
    runs the same framed filterbank op as the offline transforms (K2 for
    CUDA tensors); other powers take ``|STFT|^p`` (K1) then project."""

    def _init_filterbank(self, sr, n_fft, hop_length, window, power, basis,
                         verbose, fuse, device):
        self.power = power
        self._stft = STFT(n_fft=n_fft, hop_length=hop_length, window=window,
                          sr=sr, center=False, output_format="Magnitude",
                          verbose=verbose, device=device)
        params = self._stft.params
        params["basis"] = to_float32(basis, self._stft.device)
        mark_own(params["basis"])  # its own, as the STFT's bases are
        self._init_stream(n_fft, hop_length, params, self._stft.device, fuse=fuse)

    def _project(self, params, sig):
        if self.power == 2.0:
            return framed_filterbank(sig, params["wcos"], params["wsin"],
                                     params["basis"], self.hop, eps=0.0)
        mag = framed_magnitude(sig, params["wcos"], params["wsin"], self.hop, eps=0.0)
        return project(params["basis"], mag ** self.power)

    def _apply_sig(self, params, sig):
        return self._post(params, self._project(params, sig))

    def _post(self, params, out):  # per-frame epilogue; identity by default
        return out

    def _out_bins(self, params) -> int:
        return params["basis"].shape[0]

    def _empty_out(self, params, b):
        return _empty_frames(b, self._out_bins(params), False, self.device)


class StreamingMel(_StreamingFilterbank):
    """Chunked MelSpectrogram (see :class:`_StreamingFilterbank`)."""

    def __init__(self, sr: float = 22050, n_fft: int = 2048,
                 hop_length: int = 512, n_mels: int = 128,
                 fmin: float = 0.0, fmax: float | None = None,
                 htk: bool = False, norm=1, window: str = "hann",
                 power: float = 2.0, verbose: bool = False,
                 fuse: bool | None = None, device=None):
        from .filters.mel import mel_filterbank

        basis = mel_filterbank(sr, n_fft, n_mels, fmin, fmax, htk=htk, norm=norm)
        self._init_filterbank(sr, n_fft, hop_length, window, power, basis,
                              verbose, fuse, device)


class StreamingMFCC(_StreamingFilterbank):
    """Chunked MFCC: log-power Mel + DCT-II crop, per frame, so chunk seams
    are exact, except that the offline ``top_db`` clamp thresholds against
    the whole-signal max, which no causal stream can know. Streaming
    therefore requires ``top_db=None`` (raises otherwise); the offline
    equivalent is ``MFCC(..., top_db=None, center=False)``."""

    def __init__(self, sr: float = 22050, n_mfcc: int = 20,
                 norm: str = "ortho", ref: float = 1.0, amin: float = 1e-10,
                 top_db: float | None = None, n_fft: int = 2048,
                 hop_length: int = 512, n_mels: int = 128,
                 fmin: float = 0.0, fmax: float | None = None,
                 htk: bool = False, mel_norm=1, window: str = "hann",
                 power: float = 2.0, verbose: bool = False,
                 fuse: bool | None = None, device=None):
        from .filters.mel import dct_matrix, mel_filterbank

        if top_db is not None:
            raise ValueError(
                "StreamingMFCC requires top_db=None: the offline top_db "
                "clamp thresholds against the whole-signal max, which a "
                "causal stream cannot know")
        if amin <= 0:
            raise ValueError("amin must be strictly positive")
        self.n_mfcc = n_mfcc
        self.amin = float(amin)
        self.ref = abs(float(ref))
        basis = mel_filterbank(sr, n_fft, n_mels, fmin, fmax, htk=htk, norm=mel_norm)
        self._init_filterbank(sr, n_fft, hop_length, window, power, basis,
                              verbose, fuse, device)
        self._params["dct_basis"] = to_float32(dct_matrix(n_mels, n_mels, norm=norm),
                                               self.device)

    def _post(self, params, mel):
        from .features.mel import mfcc_from_db, power_to_db

        db = power_to_db(mel, self.amin, self.ref, None)
        return mfcc_from_db(params["dct_basis"], db, self.n_mfcc)

    def _out_bins(self, params) -> int:
        return self.n_mfcc


class StreamingGammatone(_StreamingFilterbank):
    """Chunked Gammatonegram (see :class:`_StreamingFilterbank`). Defaults
    mirror :class:`~nnaudio_tpu_torch.features.Gammatonegram`."""

    def __init__(self, sr: float = 22050, n_fft: int = 2048,
                 hop_length: int = 512, n_bins: int = 64,
                 fmin: float = 0.0, fmax: float | None = None,
                 window: str = "hann", power: float = 2.0,
                 verbose: bool = False, fuse: bool | None = None, device=None):
        from .filters.gammatone import gammatone_filterbank

        basis = gammatone_filterbank(sr, n_fft, n_bins, fmin=fmin, fmax=fmax)
        self._init_filterbank(sr, n_fft, hop_length, window, power, basis,
                              verbose, fuse, device)


class StreamingChroma(_StreamingFilterbank):
    """Chunked ChromaSTFT. The per-frame norm (``inf`` = the frame's max) is
    frame-local, so it streams exactly (unlike MFCC's ``top_db``)."""

    def __init__(self, sr: float = 22050, n_fft: int = 2048,
                 hop_length: int = 512, n_chroma: int = 12,
                 tuning: float = 0.0, norm=math.inf, window: str = "hann",
                 power: float = 2.0, verbose: bool = False,
                 fuse: bool | None = None, device=None):
        from .filters.chroma import chroma_filterbank

        self.norm = norm
        basis = chroma_filterbank(sr, n_fft, n_chroma=n_chroma, tuning=tuning)
        self._init_filterbank(sr, n_fft, hop_length, window, power, basis,
                              verbose, fuse, device)

    def _post(self, params, chroma):
        from .features.chroma import normalize_frames

        return normalize_frames(chroma, self.norm)


class StreamingiSTFT:
    """Chunked overlap-add synthesis, the dual of :class:`StreamingSTFT`
    (``center=False``): consume ``(B, F, T, 2)`` onesided spectral chunks and
    emit samples the moment every frame overlapping them has arrived.

    Each chunk of ``T`` frames finalizes exactly ``T*hop`` samples; the
    un-finalized ``n_fft - hop``-sample overlap-add tail and its
    window-envelope tail carry to the next step. Overlap-add and the envelope
    are linear, so ``concat(steps..., flush())`` equals the offline
    ``iSTFT(center=False)(X, onesided=True)``. Each step is one synthesis
    kernel launch (K3, on its FFT route) for CUDA tensors.

    ``padding`` names the alignment as Vocos's ``ISTFT`` does: ``"none"``
    (the default) emits the ``center=False`` overlap-add from its first
    sample; ``"same"`` drops ``(n_fft - hop) // 2`` samples (Vocos's
    ``(win_length - hop_length) // 2``, its frames being ``win_length =
    n_fft`` wide) from the head of the stream, across as many steps as that
    takes, and as many from the end in :meth:`flush`, so that ``concat(steps...,
    flush())`` equals Vocos's ``ISTFT(padding="same")``: ``T*hop`` samples for
    ``T`` frames where ``n_fft - hop`` is even. The samples still to drop
    ride in the state, so chunk lengths may vary between calls.

    While a profiler runs, :meth:`step` is the span
    ``nnaudio.stream.step.StreamingiSTFT`` (inside it ``nnaudio.stream.envelope``
    around the step's window envelope and ``nnaudio.stream.carry`` around the
    tails' additions, the slices and the trim) and :meth:`flush` the span
    ``nnaudio.stream.flush.StreamingiSTFT``.
    """

    def __init__(self, n_fft: int = 2048, hop_length: int | None = None,
                 win_length: int | None = None, window: str = "hann",
                 verbose: bool = False, fuse: bool | None = None, device=None,
                 padding: str = "none"):
        if padding not in ("none", "same"):
            raise ValueError(f"padding must be 'none' or 'same', got {padding!r}")
        self.fuse = fuse
        self._ist = iSTFT(n_fft=n_fft, hop_length=hop_length,
                          win_length=win_length, window=window,
                          center=False, verbose=verbose, device=device)
        self.device = self._ist.device
        self.n_fft = n_fft
        self.hop = self._ist.stride
        if self.hop > n_fft:
            raise ValueError("hop_length > n_fft has gaps; cannot stream")
        self.padding = padding
        self.trim = (n_fft - self.hop) // 2 if padding == "same" else 0
        with torch.no_grad():
            # onesided Hermitian-folded, fully weighted synthesis kernels
            self._kc, self._ks = synthesis_kernels(
                self._ist.kernel_cos, self._ist.kernel_sin, self._ist.window_mask)
            self._window = self._ist.window_mask.clone()

    @property
    def overlap(self) -> int:
        return self.n_fft - self.hop

    def init_state(self, batch: int):
        """(overlap-add tail, envelope tail), both un-normalized running sums;
        with ``padding="same"`` also the count of head samples still to drop."""
        state = (torch.zeros((batch, self.overlap), device=self.device),
                 torch.zeros((self.overlap,), device=self.device))
        return state + (self.trim,) if self.padding == "same" else state

    def step(self, state, X):
        """``X``: (B, n_fft//2+1, T, 2) onesided frames (T >= 1); returns
        ``(new_state, samples)`` with ``samples`` shaped (B, T*hop), less
        what the ``"same"`` trim still drops."""
        with span("nnaudio.stream.step.StreamingiSTFT"):
            X = _on_device(X, self.device, "spectrum")
            f, t = X.shape[1], X.shape[2]
            if f != self.n_fft // 2 + 1:
                raise ValueError(f"expected {self.n_fft // 2 + 1} onesided bins, got {f}")
            tail, env_tail, *trim = state
            hop, overlap, emit = self.hop, self.overlap, t * self.hop
            with force_fuse(self.fuse):
                sig = synthesis_ola(X[..., 0], X[..., 1], self._kc, self._ks, hop)
            with span("nnaudio.stream.envelope"):
                env = window_sumsquare(self._window, t, hop, self.n_fft)
            with span("nnaudio.stream.carry"):
                if overlap:
                    sig = torch.cat((sig[:, :overlap] + tail, sig[:, overlap:]), dim=1)
                    env = torch.cat((env[:overlap] + env_tail, env[overlap:]))
                new_state = (sig[:, emit:], env[emit:])
                sig, env = sig[:, :emit], env[:emit]
                if trim:
                    drop = min(trim[0], emit)
                    sig, env = sig[:, drop:], env[drop:]
                    new_state += (trim[0] - drop,)
            return new_state, normalize_by_window_envelope(sig, env)

    def flush(self, state):
        """Emit the final ``n_fft - hop`` tail samples after the last chunk,
        less the ``"same"`` trim at the end (and at the head, where the
        stream was too short to pass it)."""
        with span("nnaudio.stream.flush.StreamingiSTFT"):
            tail, env_tail, *trim = state
            if trim:
                keep = slice(trim[0], self.overlap - self.trim)
                tail, env_tail = tail[:, keep], env_tail[keep]
            return normalize_by_window_envelope(tail, env_tail)


class StreamingInverseCQT:
    """Chunked CQT-domain resynthesis, the dual of :class:`StreamingCQT`
    (``center=False``): consume ``(B, n_bins, T, 2)`` Complex CQT chunks and
    emit samples through canonical-dual synthesis
    (``CQT1992v2._dual_kernels``) the moment every frame overlapping them has
    arrived. There is no envelope carry: the dual atoms absorb the frame
    operator's inverse, so a step is one synthesis kernel launch (K3) plus
    the carried tail, and ``concat(steps..., flush())`` equals the offline
    ``CQT1992v2(center=False).inverse(X)``.

    Same quality contract as the offline inverse: keep ``hop_length`` at or
    below half the shortest atom or the top octave aliases (warned).

    While a profiler runs, :meth:`step` is the span
    ``nnaudio.stream.step.StreamingInverseCQT`` (inside it
    ``nnaudio.stream.carry`` around the tail's addition and the slices) and
    :meth:`flush` the span ``nnaudio.stream.flush.StreamingInverseCQT``.
    """

    def __init__(self, sr: float = 22050, hop_length: int = 512,
                 fmin: float = 32.70, fmax: float | None = None,
                 n_bins: int = 84, bins_per_octave: int = 12,
                 filter_scale: float = 1, norm: float = 1,
                 window="hann", normalization_type: str = "librosa",
                 band_eta: float = 1e-3, verbose: bool = False,
                 fuse: bool | None = None, device=None):
        from .features.cqt import (CQT1992v2, _check_norm_type, _np64,
                                   _warn_undersampled_hop)

        _check_norm_type(normalization_type)
        self.fuse = fuse
        cqt = CQT1992v2(sr=sr, hop_length=hop_length, fmin=fmin, fmax=fmax,
                        n_bins=n_bins, bins_per_octave=bins_per_octave,
                        filter_scale=filter_scale, norm=norm, window=window,
                        center=False, output_format="Complex",
                        verbose=verbose, device=device)
        self.device = cqt.device
        self.n_bins = cqt.cqt_kernels_real.shape[0]
        self.kernel_width = cqt.kernel_width
        self.hop = hop_length
        if self.hop > self.kernel_width:
            raise ValueError("hop_length > kernel_width has gaps; cannot stream")
        _warn_undersampled_hop(hop_length, _np64(cqt.lenghts), "StreamingInverseCQT")
        self._kc, self._ks = cqt._dual_kernels(normalization_type, band_eta)

    @property
    def overlap(self) -> int:
        return self.kernel_width - self.hop

    def init_state(self, batch: int):
        """The un-finalized overlap-add tail (an un-normalized running sum)."""
        return torch.zeros((batch, self.overlap), device=self.device)

    def step(self, state, X):
        """``X``: (B, n_bins, T, 2) Complex CQT frames (T >= 1); returns
        ``(new_state, samples)`` with ``samples`` shaped (B, T*hop)."""
        with span("nnaudio.stream.step.StreamingInverseCQT"):
            X = _on_device(X, self.device, "spectrum")
            if X.ndim != 4 or X.shape[-1] != 2:
                raise ValueError(
                    "step expects Complex format (batch, n_bins, time, 2); for "
                    "magnitude CQTs use features.GriffinLimCQT (offline)")
            f, t = X.shape[1], X.shape[2]
            if f != self.n_bins:
                raise ValueError(f"expected {self.n_bins} bins, got {f}")
            with force_fuse(self.fuse):
                sig = synthesis_ola(X[..., 0], X[..., 1], self._kc, self._ks, self.hop)
            overlap, emit = self.overlap, t * self.hop
            with span("nnaudio.stream.carry"):
                if overlap:
                    sig = torch.cat((sig[:, :overlap] + state, sig[:, overlap:]), dim=1)
                return sig[:, emit:], sig[:, :emit]

    def flush(self, state):
        """Emit the final ``kernel_width - hop`` tail samples."""
        with span("nnaudio.stream.flush.StreamingInverseCQT"):
            return state
