"""Wrappers of the hand-written CUDA kernels, each beside its plain version.

===========================  ==============================  =====================
wrapper                      CUDA kernel (``csrc/``)         TPU kernel replaced
===========================  ==============================  =====================
``framed_magnitude``         ``framed_tc.cu`` K1             ``_magnitude_kernel``
``framed_filterbank``        ``framed_tc.cu`` K2             ``_filterbank_kernel``
``synthesis_ola``            ``synthesis_ola.cu`` K3         ``_synthesis_ola_kernel``
                             (``framed_fft.cu``, FFT route)
``gl_step``                  ``framed_tc.cu`` K4             ``_gl_step_kernel``
                             (``framed_fft.cu``, FFT route)
``framed_pair``              ``framed_tc.cu`` K5             ``_pair_kernel``
``framed_magnitude_kchunk``  ``framed_kchunk.cu`` K6         ``_magnitude_kchunk_kernel``
``nnls``                     ``nnls_banded.cu``              none (``einsum``)
===========================  ==============================  =====================

K1 and K6 compute one function, ``framed_magnitude_plain``: K6 is its
split-K form for a bank of at most 128 bins and a long contraction, with
each group of :data:`KCHUNK_GROUP` bins multiplied only over the columns
where its rows are nonzero (:func:`kchunk_ranges`), found on the device at
every call.

K2, K3 and K4 have a second route each, chosen here from the operands (no
caller hands one over): where the operands are a transform's own tensors
(:func:`mark_own`), frozen, in fp32 storage, and make a Fourier basis, the
route's plan (recognised once per set of tensors, :func:`fft_plan`,
:func:`synthesis_fft_plan`, :func:`gl_step_fft_plan`) sends the call to
``framed_fft.cu``. K2's is a real FFT of each frame on the CUDA cores, its
power and the filterbank's bands of nonzero columns
(:func:`framed_filterbank_fft_plain` repeats its arithmetic), for the
windowed DFT of ``wcos[0]``; K3's, for synthesis products that
:func:`synthesis_kernels` made of the Hermitian-weighted Fourier basis, an
inverse real FFT of each frame of the fp32 spectra, read where they lie, and
its overlap-add (:func:`synthesis_ola_fft_plain`); K4's, for that basis and
fp32 carries, the real FFT of each frame and the Griffin-Lim update
(:func:`gl_step_fft_plain`). Every other call (a tensor passed in, a
trainable basis, the inverse CQT's dual atoms, K5's backward) takes the
tensor-core K2 or K3; a Griffin-Lim step with bf16 carries takes the
tensor-core K4, and with fp32 carries the pair (K5) and :func:`gl_update`.

The inverse Mel's NNLS (:func:`nnls`) is one launch of
``nnls_banded.cu`` where :func:`nnls_plan` has a plan for the transform's own
basis and pseudo-inverse outside autograd in fp32 storage: every
projected-gradient step of a column runs on chip over the basis's bands
(:func:`nnls_banded_plain` repeats its arithmetic); every other call takes
the dense products of :func:`nnls_plain`.

K1, K2, K4 and K5 are one tensor-core kernel (``wgmma``) with four
epilogues. In fp32 storage it takes three TF32 products of operands split as
``a = hi + lo`` and accumulates in fp32; :func:`tf32_split`,
:func:`framed_pair_3xtf32_plain`, :func:`framed_filterbank_3xtf32_plain` and
:func:`gl_step_3xtf32_plain` repeat that arithmetic in plain PyTorch. In bf16
storage it takes one bf16 product (K2 also rounds the power to bf16 for its
projection). K3 and K6 run on the tensor cores too, with the same split
(:func:`synthesis_ola_3xtf32_plain`, :func:`framed_magnitude_banded_3xtf32_plain`).

A wrapper given a CPU tensor computes its plain version; given a CUDA tensor
it launches its kernel or raises. It checks device, dtype and shape, makes
the operands contiguous in the storage type of the precision mode (bf16 in
``default`` mode, fp32 otherwise), allocates the output with ``torch.empty``,
launches on the current stream, raises on a nonzero ``cudaError_t``, and
adds one to its entry of :data:`LAUNCHES`. While a profiler runs, each
launcher is the span ``nnaudio.wrap.K<n>`` and each ``ctypes`` call the span
``nnaudio.launch.K<n>``; the launch and each new tensor made from an operand
count against the wrapper's span (:mod:`nnaudio_tpu_torch.utils.profiling`).

A differentiated call (grad enabled and an operand that requires grad)
takes the JAX package's route for a differentiated forward
(``dispatch.py``: ``_pow_fwd``, ``_fb_fwd``, ``_mag_fwd``): the magnitude,
power and filterbank wrappers skip K1, K2 and K6 and take the pair from K5,
then compute their epilogue in PyTorch, so autograd keeps the pair as the
residual. ``framed_pair`` has the JAX package's backward (``_bwd``): dW as a
matmul over chunks of frames, dx through K3. ``synthesis_ola`` has
``_ola_bwd``'s: the spectra's gradient is the pair of the cotangent signal
(K5), the kernels' a matmul over chunks of its frames. The magnitude's
backward divides by ``where(mag > 0, mag, 1)`` as ``_mag_bwd`` does, on every
route. Only the Griffin-Lim step's backward raises: the JAX loop carries no
gradient. On the CPU the plain versions differentiate through autograd.
"""
from __future__ import annotations

import ctypes
import weakref
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from .._spans import copied, note_launch, note_route, span
from ..config import get_config, matmul_numerics, round_to_storage, storage_dtype
from ..core.apply import apply_basis, project
from ..core.frame import frame_signal, frames_to_signal, num_frames

#: kernel launches per wrapper, counted where the kernel is launched
LAUNCHES: dict[str, int] = {"framed_magnitude": 0, "framed_filterbank": 0,
                            "synthesis_ola": 0, "gl_step": 0,
                            "framed_pair": 0, "framed_magnitude_kchunk": 0,
                            "framed_filterbank_fft": 0, "synthesis_ola_fft": 0,
                            "gl_step_fft": 0, "nnls_banded": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ----------------------------------------------------------- plain versions --
def framed_pair_plain(x, wcos, wsin, hop):
    """(B, L) x (F, N) bases -> (re, im_raw), each (B, F, T): unfold + matmul."""
    frames = frame_signal(x, wcos.shape[-1], hop)  # (B, T, N) view
    return apply_basis(frames, wcos), apply_basis(frames, wsin)


def tf32_split(t):
    """``(hi, lo)`` with ``hi = tf32(t)`` and ``lo = tf32(t - hi)``, both
    float32 holding TF32 values (10 mantissa bits). The rounding is to
    nearest with ties away from zero, as ``cvt.rna.tf32.f32`` rounds, done
    on the bit patterns with integer arithmetic: add half a TF32 unit to the
    magnitude and clear the 13 low bits."""
    def rna(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)

    t = t.float()
    hi = rna(t)
    return hi, rna(t - hi)


def framed_pair_3xtf32_plain(x, wcos, wsin, hop):
    """The pair as the tensor-core kernel computes it in fp32 storage: each
    operand split by :func:`tf32_split`, then ``lo*hi + hi*lo`` and last
    ``hi*hi`` in fp32 (``lo*lo`` is dropped)."""
    n = wcos.shape[-1]
    x_hi, x_lo = (frame_signal(p, n, hop) for p in tf32_split(x))

    def product(w):
        w_hi, w_lo = tf32_split(w)
        small = (torch.einsum("fn,btn->bft", w_lo, x_hi)
                 + torch.einsum("fn,btn->bft", w_hi, x_lo))
        return small + torch.einsum("fn,btn->bft", w_hi, x_hi)

    return product(wcos), product(wsin)


class _SafeMagnitude(torch.autograd.Function):
    """``sqrt(re^2 + im^2 + eps)`` with the JAX package's backward
    (``_mag_bwd``): ``g / where(mag > 0, mag, 1)`` times ``re`` and ``im``,
    so a silent frame gets a zero gradient where ``torch.sqrt``'s own
    backward gives ``inf * 0``."""

    @staticmethod
    def forward(ctx, re, im, eps):
        power = re * re + im * im
        if eps:
            power = power + eps
        mag = torch.sqrt(power)
        ctx.save_for_backward(re, im, mag)
        return mag

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        re, im, mag = ctx.saved_tensors
        scale = g / torch.where(mag > 0, mag, torch.ones_like(mag))
        return scale * re, scale * im, None


def pair_magnitude(re, im, eps=0.0, square=False):
    """The magnitude epilogue on a pair: ``sqrt(re^2 + im^2 + eps)``, or the
    power ``re^2 + im^2 + eps`` when ``square``."""
    if not square:
        return _SafeMagnitude.apply(re, im, eps)
    power = re * re + im * im
    return power + eps if eps else power


def framed_magnitude_plain(x, wcos, wsin, hop, eps=0.0, square=False):
    """sqrt(re^2 + im^2 + eps), or the power itself when ``square``."""
    return pair_magnitude(*framed_pair_plain(x, wcos, wsin, hop), eps, square)


def framed_filterbank_plain(x, wcos, wsin, fb, hop, eps=0.0):
    """fb (M, F) @ (re^2 + im^2 + eps) -> (B, M, T)."""
    power = framed_magnitude_plain(x, wcos, wsin, hop, eps=eps, square=True)
    return project(fb, power)


#: bins of one block of the tensor-core kernel: K2 sums its projection over
#: tiles of this many bins, in a workspace, in index order
TC_BLOCK_F = 128
#: K2's workspace pads T to a multiple of this many frames
TC_FRAME_ALIGN = 8


def framed_filterbank_3xtf32_plain(x, wcos, wsin, fb, hop, eps=0.0):
    """K2 as the tensor-core kernel computes it in fp32 storage: the pair by
    :func:`framed_pair_3xtf32_plain`, the power, then the projection of
    split operands per 32-bin chunk (``lo*hi + hi*lo``, then ``hi*hi``),
    the chunks of each :data:`TC_BLOCK_F`-bin tile summed in order, and the
    tiles summed in order."""
    re, im = framed_pair_3xtf32_plain(x, wcos, wsin, hop)
    power = re * re + im * im + eps
    b, f, t = power.shape
    pad = -f % TC_BLOCK_F
    tiles = (f + pad) // TC_BLOCK_F
    p_hi, p_lo = (a.reshape(b, tiles, 4, 32, t)
                  for a in tf32_split(F.pad(power, (0, 0, 0, pad))))
    w_hi, w_lo = (a.reshape(-1, tiles, 4, 32)
                  for a in tf32_split(F.pad(fb.float(), (0, pad))))
    small = (torch.einsum("mjcf,bjcft->bjcmt", w_lo, p_hi)
             + torch.einsum("mjcf,bjcft->bjcmt", w_hi, p_lo))
    parts = small + torch.einsum("mjcf,bjcft->bjcmt", w_hi, p_hi)
    per_tile = parts[:, :, 0]
    for c in range(1, 4):
        per_tile = per_tile + parts[:, :, c]
    out = per_tile[:, 0]
    for j in range(1, tiles):
        out = out + per_tile[:, j]
    return out


#: n_fft of the FFT routes: a power of two in this range (K2's also 2^a 5^b
#: with a >= 2, :func:`mixed_radix`)
FFT_MIN_N, FFT_MAX_N = 64, 8192
#: points of the widest pass of the route's complex FFT, each held by one
#: thread in registers (``RADIX`` in ``csrc/framed_fft.cu``)
FFT_RADIX = 32
#: cos(2 pi / 5), cos(4 pi / 5), sin(2 pi / 5), sin(4 pi / 5), each rounded
#: once to fp32 (``C5_1`` ... ``S5_2`` in ``csrc/framed_fft.cu``)
FFT_C5 = tuple(float(np.float32(v)) for v in (np.cos(0.4 * np.pi), np.cos(0.8 * np.pi),
                                              np.sin(0.4 * np.pi), np.sin(0.8 * np.pi)))
#: the recognition of a Fourier basis: each entry within FOURIER_ULPS fp32
#: units of its value (2^-23 of it each) plus FOURIER_FLOOR times the
#: window's largest value, of ``w[k] cos(2 pi f k / N)`` (or sin) evaluated
#: in float64
FOURIER_ULPS = 4
FOURIER_FLOOR = 2.0 ** -32


def _bitrev(q: int, bits: int) -> int:
    return int(format(q, f"0{bits}b")[::-1], 2) if bits else 0


def mixed_radix(n: int) -> bool:
    """Whether ``n`` is an n_fft of K2's mixed-radix kernel: 2^a 5^b in
    [FFT_MIN_N, FFT_MAX_N] with a >= 2 and b >= 1."""
    rest = n >> 2 if FFT_MIN_N <= n <= FFT_MAX_N and n % 4 == 0 else 0
    while rest and rest % 2 == 0:
        rest //= 2
    fives = 0
    while rest and rest % 5 == 0:
        rest, fives = rest // 5, fives + 1
    return rest == 1 and fives > 0


def fft_radices(h: int) -> list[int]:
    """The passes of the route's ``h``-point complex FFT. For ``h`` a power
    of two :data:`FFT_RADIX` points each, the last one fewer where ``log2 h``
    asks for it; for ``h = 2^a 5^b`` (:func:`mixed_radix`) radix 16, 8, 4 or
    2 for the 2^a part, in as few passes as radix 16 allows, the larger
    first, then radix 5 b times (``mixed_passes`` in ``csrc/framed_fft.cu``)."""
    out = []
    if h & (h - 1) == 0:
        while h > 1:
            out.append(min(FFT_RADIX, h))
            h //= out[-1]
        return out
    twos = (h & -h).bit_length() - 1
    parts = -(-twos // 4)
    out = [1 << (twos // parts + (i < twos % parts)) for i in range(parts)]
    h >>= twos
    while h > 1:
        out.append(5)
        h //= 5
    return out


def fft_pass_offsets(h: int) -> list[int]:
    """Where each pass's twiddles start in :func:`fft_twiddles` for an
    ``h``-point FFT (the first pass has none), and last the table's length."""
    offsets, at, ns = [], h + 1, 1
    for r in fft_radices(h):
        offsets.append(at)
        if ns > 1:
            at += ns * (r - 1)
        ns *= r
    return offsets + [at]


def fft_twiddles(n: int, device=None) -> torch.Tensor:
    """The FFT route's twiddles, (count, 2) float32, each ``exp(-2 pi i m /
    n)`` for an m of [0, n), evaluated in float64 and rounded once (the
    cosines and sines that are 0 at a quarter turn are exactly 0): first
    ``W_n^f`` for f in [0, n/2] (the unpacking of the real FFT; its entry
    ``t n/32`` is ``W_32^t``, the kernel's constants), then for each pass
    after the first, with Ns the points already combined and R its radix,
    ``W_(Ns R)^(r k)`` at ``(r - 1) Ns + k`` for k < Ns and 0 < r < R: a
    warp's lanes, whose k run on, read neighbours
    (:func:`fft_pass_offsets`)."""
    h = n // 2
    a = 2.0 * np.pi * np.arange(n) / n
    full = np.stack((np.cos(a), -np.sin(a)), 1)
    full[np.abs(full) < 1e-12] = 0.0
    parts, ns = [full[:h + 1]], 1
    for r in fft_radices(h):
        if ns > 1:
            q, k = np.arange(1, r)[:, None], np.arange(ns)[None, :]
            parts.append(full[(2 * q * k * (h // (ns * r))).reshape(-1)])
        ns *= r
    return torch.from_numpy(np.concatenate(parts).astype(np.float32)).to(device)


def synthesis_edge(n: int, device=None) -> torch.Tensor:
    """K3's FFT route's turns of its threads' edge sums (:func:`_edge_samples`),
    (n/64, 2) float64: ``cos(2 pi p / n)`` and ``sin(2 pi p / n)`` for the
    team's threads p."""
    a = 2.0 * np.pi * np.arange(n // 64) / n
    return torch.from_numpy(np.stack((np.cos(a), np.sin(a)), 1)).to(device)


def _cos_sin_pi32():
    """cos and sin of r pi / 32 for r in [0, 32), float64, from the 17 values
    of cos(t pi / 32), t in [0, 16], that the kernel holds as constants."""
    k = np.cos(np.arange(17) * np.pi / 32)
    k[16] = 0.0
    r = np.arange(32)
    cos = np.where(r <= 16, k[np.minimum(r, 16)], -k[np.clip(32 - r, 0, 16)])
    sin = np.where(r <= 16, k[np.clip(16 - r, 0, 16)], k[np.clip(r - 16, 0, 16)])
    return torch.from_numpy(cos), torch.from_numpy(sin)


def _cmul(ar, ai, wr, wi):
    return ar * wr - ai * wi, ar * wi + ai * wr


def _dft5(vr, vi):
    """The radix-5 step of the mixed-radix kernel (``dft5``) on 5 points, in
    its order of operations. Returns the 5 outputs in natural order."""
    c1, c2, s1, s2 = FFT_C5
    t1r, t1i, t2r, t2i = vr[1] + vr[4], vi[1] + vi[4], vr[2] + vr[3], vi[2] + vi[3]
    t3r, t3i, t4r, t4i = vr[1] - vr[4], vi[1] - vi[4], vr[2] - vr[3], vi[2] - vi[3]
    a1r, a1i = vr[0] + c1 * t1r + c2 * t2r, vi[0] + c1 * t1i + c2 * t2i
    a2r, a2i = vr[0] + c2 * t1r + c1 * t2r, vi[0] + c2 * t1i + c1 * t2i
    b1r, b1i = s1 * t3r + s2 * t4r, s1 * t3i + s2 * t4i
    b2r, b2i = s2 * t3r - s1 * t4r, s2 * t3i - s1 * t4i
    return ([vr[0] + t1r + t2r, a1r + b1i, a2r + b2i, a2r - b2i, a1r - b1i],
            [vi[0] + t1i + t2i, a1i - b1r, a2i - b2r, a2i + b2r, a1i + b1r])


def _dft_in_registers(vr, vi, w32r, w32i):
    """The radix-R step of one thread on R points: decimation in frequency,
    radix 2, from the widest half to the narrowest; ``d * W_2half^i`` is
    ``d * W_32^(16i/half)``, a swap for ``-i``. Returns the R outputs in
    natural order."""
    r = len(vr)
    half = r // 2
    while half:
        for b in range(0, r, 2 * half):
            for i in range(half):
                ar, ai, cr, ci = vr[b + i], vi[b + i], vr[b + i + half], vi[b + i + half]
                vr[b + i], vi[b + i] = ar + cr, ai + ci
                dr, di = ar - cr, ai - ci
                t = i * (16 // half)
                if t == 8:
                    dr, di = di, -dr
                elif t:
                    dr, di = _cmul(dr, di, w32r[t], w32i[t])
                vr[b + i + half], vi[b + i + half] = dr, di
        half //= 2
    bits = r.bit_length() - 1
    return ([vr[_bitrev(q, bits)] for q in range(r)],
            [vi[_bitrev(q, bits)] for q in range(r)])


def _fft_stockham(zr, zi, table):
    """The route's complex FFT of ``(zr, zi)`` (..., H) in fp32: Stockham
    passes of :func:`fft_radices`, each reading ``z[j + r H/R]``, turning
    point r by ``W_(Ns R)^(r k)`` (k = j mod Ns; none in the first pass,
    where k is 0), the step of :func:`_dft_in_registers`, and writing point
    q to ``(j // Ns) Ns R + k + q Ns``: natural order at the end. ``table``
    is :func:`fft_twiddles`. A radix-5 pass takes :func:`_dft5`'s step."""
    h = zr.shape[-1]
    tr, ti = table[:, 0], table[:, 1]
    w32r, w32i = fft_twiddles(32, zr.device)[:16].unbind(1)
    ns = 1
    for r, at in zip(fft_radices(h), fft_pass_offsets(h)):
        m = h // r
        j = torch.arange(m, device=zr.device)
        k = j % ns
        vr = [zr[..., q * m:(q + 1) * m] for q in range(r)]
        vi = [zi[..., q * m:(q + 1) * m] for q in range(r)]
        if ns > 1:
            for q in range(1, r):
                w = at + (q - 1) * ns + k
                vr[q], vi[q] = _cmul(vr[q], vi[q], tr[w], ti[w])
        vr, vi = _dft5(vr, vi) if r == 5 else _dft_in_registers(vr, vi, w32r, w32i)
        base = (j // ns) * ns * r + k
        zr, zi = torch.empty_like(zr), torch.empty_like(zi)
        for q in range(r):
            zr[..., base + q * ns] = vr[q]
            zi[..., base + q * ns] = vi[q]
        ns *= r
    return zr, zi


def _rfft_pairs(frames, window):
    """The real FFT of windowed (..., N) fp32 frames as the FFT routes of K2
    and K4 unpack it: the windowed frame packed as N/2 complex points
    ``(x[2j], x[2j+1])``, their FFT by :func:`_fft_stockham`, then for each
    f of [0, N/4], with ``A = Z[f]``, ``B = Z[N/2 - f]`` (indices mod N/2),
    ``E = A + conj B``, ``O = A - conj B``: ``E - i W_N^f O``, twice bin f,
    and ``E + i W_N^f O``, twice the conjugate of bin N/2 - f. -> those two,
    each a (re, im) pair of (..., N/4 + 1)."""
    n = frames.shape[-1]
    h = n // 2
    table = fft_twiddles(n, frames.device)
    z = frames.float() * window.float()
    zr, zi = _fft_stockham(z[..., 0::2], z[..., 1::2], table)
    f = torch.arange(h // 2 + 1, device=frames.device)
    ar, ai = zr[..., f], zi[..., f]
    br, bi = zr[..., (h - f) % h], zi[..., (h - f) % h]
    er, ei = ar + br, ai - bi
    qr, qi = _cmul(ar - br, ai + bi, table[f, 0], table[f, 1])
    return (er + qi, ei - qr), (er - qi, ei + qr)


def fft_power_plain(frames, window, eps=0.0):
    """``|rfft(window * frame)|^2 + eps`` of (..., N) fp32 frames as K2's FFT
    route computes it: each pair of :func:`_rfft_pairs` squared as ``|X|^2 /
    4 + eps`` (bin N/4 taken from the first). -> (..., N/2 + 1)."""
    lower, upper = [(xr * xr + xi * xi) * 0.25 + eps for xr, xi in _rfft_pairs(frames, window)]
    return torch.cat((lower, upper[..., :-1].flip(-1)), -1)


def rfft_plain(frames, window):
    """``rfft(window * frame)`` of (..., N) fp32 frames as K4's FFT route
    computes it: the pairs of :func:`_rfft_pairs` halved, bin f from the
    first and bin N/2 - f the conjugate of the second (bin N/4 taken from
    the first). -> (re, im), each (..., N/2 + 1)."""
    (lr, li), (ur, ui) = _rfft_pairs(frames, window)
    return (torch.cat((lr * 0.5, ur[..., :-1].flip(-1) * 0.5), -1),
            torch.cat((li * 0.5, ui[..., :-1].flip(-1) * -0.5), -1))


def _edge_samples(re, im):
    """Samples 1 and N - 1 of :func:`irfft_plain`'s frames as the kernel sums
    them, in float64, each rounded once to fp32: ``A - B`` and ``A + B``, with
    ``A = sum_f c_f Re_f cos(2 pi f / N)`` and ``B = sum_f c_f Im_f sin(2 pi f
    / N)``. Thread p's bins f = p + r N/64 lie at the turns 2 pi p / N + r pi
    / 32: each thread sums Re and Im times cos and sin of r pi / 32
    (:func:`_cos_sin_pi32`), turns the sums by 2 pi p / N
    (:func:`synthesis_edge`) and weights them 2; DC is taken off once and
    Nyquist (cos pi = -1) added. A tapering window is smallest beside a
    frame's ends, and the envelope of a ``center=False`` signal divides its
    first and last samples by that window's square (w[1]^2 ~ 1.4e-9 for a
    Hann of 512): the FFT's rounding, a fraction of an fp32 unit of the
    frame's largest sample, would come out of that division hundreds of
    units of the signal's. (..., N/2 + 1) planes, their imaginary parts of
    DC and Nyquist zero -> two (...,) fp32."""
    h = re.shape[-1] - 1
    turn = synthesis_edge(2 * h, re.device)
    cos, sin = (t.to(re.device) for t in _cos_sin_pi32())
    # (..., r, p): bin f = p + r N/64
    rr, ii = (x[..., :h].double().reshape(*x.shape[:-1], 32, h // 32) for x in (re, im))
    rc, rs = (rr * cos[:, None]).sum(-2), (rr * sin[:, None]).sum(-2)
    ic, is_ = (ii * cos[:, None]).sum(-2), (ii * sin[:, None]).sum(-2)
    dc, nyquist = re[..., 0].double(), re[..., h].double()
    a = (2.0 * (turn[:, 0] * rc - turn[:, 1] * rs)).sum(-1) - (dc + nyquist)
    b = (2.0 * (turn[:, 1] * ic + turn[:, 0] * is_)).sum(-1)
    return (a - b).float(), (a + b).float()


def irfft_plain(spec_re, spec_im):
    """The unnormalised inverse real FFT of (..., N/2 + 1) onesided spectra as
    K3's FFT route computes it, ``y[k] = sum_f c_f (Re_f cos(2 pi f k / N) -
    Im_f sin(2 pi f k / N))`` with ``c_f`` 1 at DC and Nyquist (whose
    imaginary parts are not read) and 2 between: for each f of [0, N/2), with
    ``a = X[f]``, ``c = X[N/2 - f]``, the point ``V[f] = E - i W_N^f D``
    (``E = conj a + c``, ``D = conj a - c``), then the FFT of V by
    :func:`_fft_stockham`, whose point j is ``y[2j] - i y[2j+1]``; samples 1
    and N - 1 are then :func:`_edge_samples`'. -> (..., N)."""
    h = spec_re.shape[-1] - 1
    n = 2 * h
    table = fft_twiddles(n, spec_re.device)
    f = torch.arange(h, device=spec_re.device)
    re, im = spec_re.float(), spec_im.float().clone()
    im[..., 0] = im[..., h] = 0.0
    ar, ai, cr, ci = re[..., f], im[..., f], re[..., h - f], im[..., h - f]
    wr, wi = _cmul(ar - cr, -ai - ci, table[f, 0], table[f, 1])
    yr, yi = _fft_stockham(ar + cr + wi, ci - ai - wr, table)
    y = torch.stack((yr, -yi), -1).reshape(*yr.shape[:-1], n)
    y[..., 1], y[..., n - 1] = _edge_samples(re, im)
    return y


def synthesis_ola_fft_plain(spec_re, spec_im, scale, hop):
    """K3's FFT route in plain PyTorch, with the kernel's arithmetic: each
    frame's :func:`irfft_plain` times ``scale`` (the window over N), then
    overlap-added from zero in order of t. (B, N/2 + 1, T) spectra -> (B, N +
    hop*(T-1)). It computes :func:`synthesis_ola_plain` where the kernels are
    the Hermitian-weighted Fourier basis times ``scale``
    (:func:`build_synthesis_fft_plan`)."""
    b, f, t = spec_re.shape
    n = 2 * (f - 1)
    frames = irfft_plain(spec_re.transpose(1, 2), spec_im.transpose(1, 2)) * scale.float()
    n_chunks = _ceil_div(n, hop)
    chunks = F.pad(frames, (0, n_chunks * hop - n)).reshape(b, t, n_chunks, hop)
    rows = frames.new_zeros((b, t + n_chunks - 1, hop))
    for c in reversed(range(n_chunks)):  # row r adds its frames r - c in order of t
        rows[:, c:c + t] += chunks[:, :, c]
    return rows.reshape(b, -1)[:, :n + hop * (t - 1)]


def filterbank_bands(fb):
    """``(lo, off, vals)`` of a filterbank (M, F): per row the first of the
    contiguous range of columns that holds its nonzero entries (0 for a row
    of zeros), the offsets of the rows' ranges in ``vals`` (M + 1 of them),
    and the ranges' entries, row after row (zeros inside a range kept; a NaN
    counts as nonzero)."""
    lo, length = _band_ranges(fb)
    off = F.pad(torch.cumsum(length, 0), (1, 0))
    return lo, off, _band_values(fb, lo, off, length, int(off[-1]))


def _band_ranges(fb):
    m, f = fb.shape
    nonzero = fb != 0
    k = torch.arange(f, device=fb.device)
    lo = torch.where(nonzero, k, f).amin(1)
    hi = torch.where(nonzero, k + 1, 0).amax(1)
    empty = lo >= hi
    return lo.masked_fill(empty, 0), (hi - lo).masked_fill(empty, 0)


def _band_values(fb, lo, off, length, nnz: int):
    rows = torch.repeat_interleave(torch.arange(fb.shape[0], device=fb.device), length,
                                   output_size=nnz)
    cols = lo[rows] + torch.arange(nnz, device=fb.device) - off[rows]
    return fb.detach().float()[rows, cols].contiguous()


def banded_project_plain(power, lo, off, vals):
    """``out[..., m] = sum_j vals[off_m + j] * power[..., lo_m + j]`` as K2's
    FFT route adds it: the terms j of a row in four partial sums by j mod 4,
    each from zero in order, then ``(s0 + s1) + (s2 + s3)``. (..., F) ->
    (..., M)."""
    length = off[1:] - off[:-1]
    parts = [power.new_zeros(power.shape[:-1] + (lo.shape[0],)) for _ in range(4)]
    for j in range(int(length.max())):
        inside = j < length
        v = vals[torch.where(inside, off[:-1] + j, 0)]
        acc = parts[j % 4]
        parts[j % 4] = torch.where(inside, acc + v * power[..., torch.where(inside, lo + j, 0)],
                                   acc)
    return (parts[0] + parts[1]) + (parts[2] + parts[3])


def framed_filterbank_fft_plain(x, wcos, wsin, fb, hop, eps=0.0):
    """K2's FFT route in plain PyTorch, with the kernel's arithmetic:
    :func:`fft_power_plain` of each frame with the window ``wcos[0]``, then
    :func:`banded_project_plain` over :func:`filterbank_bands`. -> (B, M, T).
    It computes :func:`framed_filterbank_plain` where ``(wcos, wsin)`` is the
    Fourier basis of that window (:func:`build_fft_plan`); ``wsin`` is not read."""
    n = wcos.shape[-1]
    power = fft_power_plain(frame_signal(x.float(), n, hop), wcos[0], eps)
    return banded_project_plain(power, *filterbank_bands(fb)).transpose(1, 2)


def synthesis_ola_plain(spec_re, spec_im, kc, ks, hop):
    """OLA(kc^T Re - ks^T Im): (B, F, T) spectra (fp32, or bf16 carries) x
    (F, N) kernels -> (B, N + hop*(T-1)), without window normalisation."""
    with matmul_numerics():
        frames = torch.einsum("fj,bft->btj", round_to_storage(kc),
                              round_to_storage(spec_re.float()))
        frames = frames - torch.einsum("fj,bft->btj", round_to_storage(ks),
                                       round_to_storage(spec_im.float()))
    length = kc.shape[1] + hop * (spec_re.shape[-1] - 1)
    return frames_to_signal(frames, hop, length)


#: bins of one K chunk of K3's tensor-core loop in fp32 storage (128 bytes)
#: and in bf16; the wrapper pads the transposed kernels' rows to a multiple
SYNTH_BK = {torch.float32: 32, torch.bfloat16: 64}

#: steps of one output row's fp32 running sum in K3 (``2 * ceil(N/hop) *
#: Fp/32``) past which the kernel adds each step by a compensated sum
#: (``KAHAN_MIN_STEPS`` in ``csrc/synthesis_ola.cu``)
SYNTH_KAHAN_MIN_STEPS = 512


def synthesis_compensated(f: int, n: int, hop: int) -> bool:
    """Whether K3 in fp32 storage sums each output row by a compensated sum:
    its running sum is longer than :data:`SYNTH_KAHAN_MIN_STEPS` steps."""
    steps = 2 * _ceil_div(n, hop) * _ceil_div(f, SYNTH_BK[torch.float32])
    return steps > SYNTH_KAHAN_MIN_STEPS


def synthesis_ola_3xtf32_plain(spec_re, spec_im, kc, ks, hop):
    """K3 as the tensor-core kernel computes it in fp32 storage. In the row
    view of the signal, ``y[r*hop + p] = sum_c sum_f kc[f, c*hop + p] *
    Re[f, r - c] - ks[f, c*hop + p] * Im[f, r - c]``; the K loop runs over
    the chunks c, then the :data:`SYNTH_BK`-bin chunks of F, then Re and
    -Im. Each step splits both operands by :func:`tf32_split` and sums
    ``lo*hi + hi*lo``, then ``hi*hi``, in fp32 (``lo*lo`` is dropped). Where
    :func:`synthesis_compensated` says so, that sum starts from the step's
    partial (which enters holding minus the previous add's rounding error)
    and is added to the running sum by a compensated (Kahan) sum, the result
    being the sum plus its last compensation; else it starts from zero and
    is added plainly."""
    b, f, t = spec_re.shape
    n = kc.shape[1]
    bk = SYNTH_BK[torch.float32]
    n_chunks = _ceil_div(n, hop)
    pad_f = -f % bk

    def kernel(k):  # (Fp, n_chunks, hop), zeros past F and past N
        return F.pad(k.float(), (0, n_chunks * hop - n, 0, pad_f)).reshape(
            f + pad_f, n_chunks, hop)
    steps = [(*tf32_split(kernel(k)), *tf32_split(F.pad(s.float(), (0, 0, 0, pad_f))))
             for k, s in ((kc, spec_re), (ks, -spec_im))]
    rows = torch.zeros((b, t + n_chunks - 1, hop), dtype=torch.float32,
                       device=spec_re.device)
    kahan = synthesis_compensated(f, n, hop)
    part = torch.zeros_like(rows)
    for c in range(n_chunks):
        at = slice(c, c + t)
        for f0 in range(0, f + pad_f, bk):
            fs = slice(f0, f0 + bk)
            for w_hi, w_lo, s_hi, s_lo in steps:
                small = (torch.einsum("fp,bft->btp", w_lo[fs, c], s_hi[:, fs])
                         + torch.einsum("fp,bft->btp", w_hi[fs, c], s_lo[:, fs]))
                y = (part[:, at] + small if kahan else small) + torch.einsum(
                    "fp,bft->btp", w_hi[fs, c], s_hi[:, fs])
                if not kahan:
                    rows[:, at] += y
                    continue
                total = rows[:, at] + y
                part[:, at] = y - (total - rows[:, at])
                rows[:, at] = total
    return (rows + part).reshape(b, -1)[:, :n + hop * (t - 1)]


def gl_update(re, im_raw, S, p_re, p_im, mom):
    """The Griffin-Lim carry update after the analysis pair: ``r = (re,
    -im_raw)``, ``n = r - mom * p``, ``c = S * n * rsqrt(|n|^2 + 1e-32)``.
    Returns ``(c_re, c_im, r_re, r_im)`` in the carry type, ``p``'s dtype."""
    carry = p_re.dtype
    r_re, r_im = re, -im_raw
    n_re = r_re - mom * p_re.float()
    n_im = r_im - mom * p_im.float()
    scale = S * torch.rsqrt(n_re * n_re + n_im * n_im + 1e-32)
    return ((n_re * scale).to(carry), (n_im * scale).to(carry),
            r_re.to(carry), r_im.to(carry))


def gl_step_plain(x, wcos, wsin, S, p_re, p_im, hop, mom):
    """One Griffin-Lim analysis step: the plain pair, then :func:`gl_update`."""
    re, im = framed_pair_plain(x, wcos, wsin, hop)
    return gl_update(re, im, S, p_re, p_im, mom)


def gl_step_fft_plain(x, wcos, wsin, S, p_re, p_im, hop, mom):
    """K4's FFT route in plain PyTorch, with the kernel's arithmetic:
    :func:`rfft_plain` of each frame with the window ``wcos[0]``, then
    :func:`gl_update`. It computes :func:`gl_step_plain` where ``(wcos,
    wsin)`` is the Fourier basis of that window
    (:func:`build_gl_step_fft_plan`); ``wsin`` is not read."""
    re, im = rfft_plain(frame_signal(x.float(), wcos.shape[-1], hop), wcos[0])
    return gl_update(re.transpose(1, 2), -im.transpose(1, 2), S, p_re, p_im, mom)


def gl_step_3xtf32_plain(x, wcos, wsin, S, p_re, p_im, hop, mom):
    """K4 as the tensor-core kernel computes it in fp32 storage: the pair by
    :func:`framed_pair_3xtf32_plain`, then :func:`gl_update`."""
    re, im = framed_pair_3xtf32_plain(x, wcos, wsin, hop)
    return gl_update(re, im, S, p_re, p_im, mom)


def nnls_plain(mel_basis, mel_pinv, mel, step, n_iter):
    """The inverse Mel's NNLS as dense products: ``s = relu(pinv(M) mel)``,
    then ``n_iter`` steps of ``s = relu(s - step M^T (M s - mel))``, each
    product a :func:`project` (the precision mode's matmul). (M, F) basis, (F,
    M) pseudo-inverse, (B, M, T) mels -> (B, F, T). Differentiable."""
    s = torch.relu(project(mel_pinv, mel))
    for _ in range(n_iter):
        resid = project(mel_basis, s) - mel
        s = torch.relu(s - step * project(mel_basis.t(), resid))
    return s


def nnls_banded_plain(mel_basis, mel_pinv, mel, step, n_iter):
    """The NNLS kernel in plain PyTorch, with its arithmetic, per (batch,
    time) column: the seed ``relu(pinv(M) mel)`` summed over the mel rows in
    order from zero, then ``n_iter`` steps of ``r = M s - mel`` over the
    basis's row bands and ``s = relu(s - step M^T r)`` over its column bands,
    each band as :func:`banded_project_plain` adds it (:func:`filterbank_bands`
    of M and of M^T), ``s - step g`` rounded twice. It computes
    :func:`nnls_plain` in fp32. (B, M, T) mels -> (B, F, T)."""
    cols = mel.detach().float().transpose(1, 2)  # (B, T, M)
    pinv_t = mel_pinv.detach().float().t()
    s = cols.new_zeros(cols.shape[:-1] + (pinv_t.shape[1],))
    for m in range(pinv_t.shape[0]):
        s = s + cols[..., m:m + 1] * pinv_t[m]
    s = torch.relu(s)
    basis = mel_basis.detach().float()
    rows, bins = filterbank_bands(basis), filterbank_bands(basis.t())
    for _ in range(n_iter):
        r = banded_project_plain(s, *rows) - cols
        s = torch.relu(s - step * banded_project_plain(r, *bins))
    return s.transpose(1, 2)


#: elements of one (B, frames, N) chunk of frames in the pair's dW
DW_CHUNK_ELEMS = 1 << 26


def _frames_dw(x, g_re, g_im, n, hop):
    """``(sum_bt g_re[b,f,t] x[b, t*hop + k], sum_bt g_im[...] x[...])``, each
    (F, n): the framed signal's product with two (B, F, T) cotangents, over
    chunks of frames, so at most :data:`DW_CHUNK_ELEMS` frame samples exist
    at once."""
    b, f, t = g_re.shape
    step = max(1, DW_CHUNK_ELEMS // (b * n))
    d_re = g_re.new_zeros((f, n), dtype=torch.float32)
    d_im = g_im.new_zeros((f, n), dtype=torch.float32)
    with matmul_numerics():
        for t0 in range(0, t, step):
            t1 = min(t, t0 + step)
            frames = round_to_storage(
                frame_signal(x[:, t0 * hop:(t1 - 1) * hop + n], n, hop))
            d_re += torch.einsum("bft,btn->fn",
                                 round_to_storage(g_re[..., t0:t1].float()), frames)
            d_im += torch.einsum("bft,btn->fn",
                                 round_to_storage(g_im[..., t0:t1].float()), frames)
    return d_re, d_im


def framed_pair_backward(x, wcos, wsin, g_re, g_im, hop,
                         needs=(True, True, True)):
    """Gradients of :func:`framed_pair` w.r.t. ``(x, wcos, wsin)`` (each None
    where ``needs`` says so), as the JAX package's ``_bwd``: dx is the
    synthesis of the cotangent spectra on the same bases (the K3 kernel for
    CUDA tensors), dW a matmul over chunks of frames (:func:`_frames_dw`).
    No dx, no K3: a train step whose waveform needs no gradient launches
    none."""
    d_x = d_wc = d_ws = None
    if needs[0]:
        d_x = synthesis_ola(g_re, -g_im, wcos, wsin, hop)
        # the last frame ends at or before the end of the signal
        d_x = F.pad(d_x, (0, x.shape[-1] - d_x.shape[-1]))
    if needs[1] or needs[2]:
        d_wc, d_ws = _frames_dw(x, g_re, g_im, wcos.shape[-1], hop)
    return d_x, d_wc, d_ws


def synthesis_ola_backward(spec_re, spec_im, kc, ks, g, hop,
                           needs=(True, True, True, True)):
    """Gradients of :func:`synthesis_ola` w.r.t. ``(spec_re, spec_im, kc,
    ks)`` for the cotangent signal ``g`` (each None where ``needs`` says so),
    as the JAX package's ``_ola_bwd``: the adjoint of synthesis + overlap-add
    is analysis, so the spectra's gradient is the pair of ``g`` on the same
    kernels (the K5 kernel for CUDA tensors; ``g`` has ``N + hop*(T-1)``
    samples, exactly T frames), the kernels' a matmul over chunks of its
    frames (:func:`_frames_dw`)."""
    d_re = d_im = d_kc = d_ks = None
    if needs[0] or needs[1]:
        d_re, d_im_raw = framed_pair(g, kc, ks, hop)
        d_im = -d_im_raw
    if needs[2] or needs[3]:
        d_kc, d_ks = _frames_dw(g, spec_re, spec_im, kc.shape[-1], hop)
        d_ks = -d_ks
    return d_re, d_im, d_kc, d_ks


# ------------------------------------------------------------------ launch --
_VOID = ctypes.c_void_p
_INT = ctypes.c_int
_SIGNATURES = {
    "nnaudio_framed_magnitude": (
        "framed_tc",
        [_VOID, _VOID, _VOID, _VOID, _INT, _INT, _INT, _INT, _INT, _INT,
         ctypes.c_float, _INT, _INT, _VOID]),
    "nnaudio_framed_filterbank": (
        "framed_tc",
        [_VOID] * 6 + [_INT] * 7 + [ctypes.c_float, _INT, _VOID]),
    "nnaudio_synthesis_ola": (
        "synthesis_ola",
        [_VOID] * 5 + [_INT] * 8 + [_VOID]),
    "nnaudio_framed_pair": (
        "framed_tc",
        [_VOID, _VOID, _VOID, _VOID, _VOID, _INT, _INT, _INT, _INT, _INT, _INT,
         _INT, _VOID]),
    "nnaudio_gl_step": (
        "framed_tc",
        [_VOID] * 10 + [_INT] * 6 + [ctypes.c_float, _INT, _INT, _VOID]),
    "nnaudio_framed_magnitude_kchunk": (
        "framed_kchunk",
        [_VOID] * 5 + [ctypes.c_longlong] + [_INT] * 7 + [ctypes.c_float, _INT, _INT,
                                                          _VOID]),
    "nnaudio_kchunk_ranges": (
        "framed_kchunk",
        [_VOID] * 3 + [ctypes.c_longlong] + [_INT] * 4 + [_VOID]),
    "nnaudio_framed_filterbank_fft": (
        "framed_fft",
        [_VOID] * 6 + [_INT] * 7 + [ctypes.c_float, _VOID]),
    "nnaudio_framed_filterbank_fft_twiddles": ("framed_fft", [_INT] * 2),
    "nnaudio_synthesis_fft": (
        "framed_fft",
        [_VOID, _VOID] + [ctypes.c_longlong] * 3 + [_VOID] * 4 + [_INT] * 4 + [_VOID]),
    "nnaudio_synthesis_fft_twiddles": ("framed_fft", [_INT]),
    "nnaudio_gl_step_fft": (
        "framed_fft",
        [_VOID] * 10 + [_INT] * 5 + [ctypes.c_float, _VOID]),
    "nnaudio_gl_step_fft_twiddles": ("framed_fft", [_INT]),
    "nnaudio_nnls_banded": (
        "nnls_banded",
        [_VOID] * 5 + [_INT] * 8 + [ctypes.c_float, _INT, _VOID]),
    "nnaudio_nnls_banded_smem": ("nnls_banded", [_INT] * 3),
}
#: the span of each C entry's launch
_LAUNCH_SPANS = {"nnaudio_framed_magnitude": "nnaudio.launch.K1",
                 "nnaudio_framed_filterbank": "nnaudio.launch.K2",
                 "nnaudio_synthesis_ola": "nnaudio.launch.K3",
                 "nnaudio_gl_step": "nnaudio.launch.K4",
                 "nnaudio_framed_pair": "nnaudio.launch.K5",
                 "nnaudio_framed_magnitude_kchunk": "nnaudio.launch.K6",
                 "nnaudio_kchunk_ranges": "nnaudio.launch.K6",
                 "nnaudio_framed_filterbank_fft": "nnaudio.launch.K2",
                 "nnaudio_synthesis_fft": "nnaudio.launch.K3",
                 "nnaudio_gl_step_fft": "nnaudio.launch.K4",
                 "nnaudio_nnls_banded": "nnaudio.launch.NNLS"}
_fns: dict[str, object] = {}


def _fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        from .build import library

        lib_name, argtypes = _SIGNATURES[name]
        fn = getattr(library(lib_name), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _operand(t: torch.Tensor, name: str, ndim: int, device) -> torch.Tensor:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} must be float32 (or bfloat16), got {t.dtype}")
    return copied(t.to(storage_dtype()).contiguous(), t)


def _carry(t: torch.Tensor, name: str, shape, dtype, device) -> torch.Tensor:
    """A (B, F, T) loop state operand of the Griffin-Lim step, contiguous in
    ``dtype``."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    return copied(t.to(dtype).contiguous(), t)


def _check_cuda(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(
            f"the CUDA kernels take CUDA tensors; got a tensor on {x.device}")


def _run(name: str, *args) -> None:
    with span(_LAUNCH_SPANS[name]):
        err = _fn(name)(*args)
    note_launch()
    if err != 0:
        raise RuntimeError(f"{name} failed to launch: cudaError_t {err}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _analysis_operands(x, wcos, wsin, hop):
    """Checked storage-type operands of an analysis kernel, and the dims
    ``(B, L, N, hop, F, T)`` in the order the launchers take them."""
    _check_cuda(x)
    dev = x.device
    xs = _operand(x, "x", 2, dev)
    wc = _operand(wcos, "wcos", 2, dev)
    ws = _operand(wsin, "wsin", 2, dev)
    if wc.shape != ws.shape:
        raise ValueError(f"wcos {tuple(wc.shape)} and wsin {tuple(ws.shape)} differ")
    if hop < 1:
        raise ValueError(f"hop must be >= 1, got {hop}")
    b, length = xs.shape
    f, n = wc.shape
    t = num_frames(length, n, hop)
    if t < 1:
        raise ValueError(f"signal of {length} samples is shorter than n_fft={n}")
    return xs, wc, ws, (b, length, n, hop, f, t)


def _launch_magnitude(x, wcos, wsin, hop, eps, square):
    with span("nnaudio.wrap.K1"):
        xs, wc, ws, dims = _analysis_operands(x, wcos, wsin, hop)
        b, _, _, _, f, t = dims
        out = torch.empty((b, f, t), dtype=torch.float32, device=xs.device)
        with torch.cuda.device(xs.device):
            _run("nnaudio_framed_magnitude", xs.data_ptr(), wc.data_ptr(),
                 ws.data_ptr(), out.data_ptr(), *dims, float(eps), int(square),
                 int(xs.dtype == torch.bfloat16), _stream())
        LAUNCHES["framed_magnitude"] += 1
        return out


#: K6 takes banks of at most this many bins (one block holds them all)
KCHUNK_MAX_F = 128
#: bins of one group of ``csrc/framed_kchunk.cu``: the N side of a product
#: is the group's cos and sin rows, and its K range is the hull of its rows'
KCHUNK_GROUP = 32
#: frames per block of K6 (two multiplying warpgroups of 64)
KCHUNK_BT = 128
#: samples of one K chunk (a 128-byte row) by storage type: the unit of the
#: groups' ranges and of the splits
KCHUNK_BK = {torch.float32: 32, torch.bfloat16: 64}
#: K6 cuts K until the grid fills one wave of this many blocks (one per SM
#: of an H100: a block takes ~190 KB of shared memory) ...
KCHUNK_TARGET_BLOCKS = 132
#: ... but leaves every split at least this many samples of K on average
KCHUNK_MIN_SPLIT_K = 512
#: K6's workspace: a header of int32 ranges (the rows', then from byte
#: KCHUNK_GROUP_RANGES the groups'), the packed bank, the split partials
KCHUNK_HEADER_BYTES = 2048
KCHUNK_GROUP_RANGES = 1024


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def kchunk_plan(b: int, t: int, n: int, splits: int | None = None) -> int:
    """K6's split count for a batch of ``b`` signals, ``t`` frames and a
    contraction of ``n`` samples: a function of the shapes alone. The kernel
    gives each split an equal share of the bank's work, found on the device;
    a split may come out empty. ``splits`` asks for a count instead of the
    planned one."""
    if splits is None:
        base = b * _ceil_div(t, KCHUNK_BT)
        splits = min(KCHUNK_TARGET_BLOCKS // base, n // KCHUNK_MIN_SPLIT_K)
    return max(1, min(splits, _ceil_div(n, KCHUNK_BK[torch.float32])))


def kchunk_workspace_bytes(b: int, f: int, n: int, t: int, splits: int,
                           dtype: torch.dtype) -> int:
    """Bytes of K6's workspace, as ``layout()`` in ``csrc/framed_kchunk.cu``
    counts them: the header, the packed bank (per plane, ``2 * cap`` rows of
    ``npad`` samples; fp32 has a TF32 hi and a lo plane), and with more than
    one split the partial re and im, each (splits, B, F, T) fp32."""
    cap = _ceil_div(f, 32) * 32
    bk = KCHUNK_BK[dtype]
    npad = _ceil_div(n, bk) * bk
    planes, esz = (2, 4) if dtype == torch.float32 else (1, 2)
    packed = _ceil_div(planes * 2 * cap * npad * esz, 256) * 256
    partial = 2 * splits * b * f * t * 4 if splits > 1 else 0
    return KCHUNK_HEADER_BYTES + packed + partial


def kchunk_ranges_plain(wcos, wsin, group: int = KCHUNK_GROUP):
    """(ceil(F / group), 2) int64: per group of ``group`` bins the range
    ``[k_lo, k_hi)`` of the columns where any of its rows has a nonzero cos
    or sin entry (a NaN counts), ``(0, 0)`` for a group that is all zero."""
    f, n = wcos.shape
    nonzero = (wcos != 0) | (wsin != 0)
    groups = _ceil_div(f, group)
    pad = nonzero.new_zeros((groups * group - f, n))
    nonzero = torch.cat((nonzero, pad)).reshape(groups, group, n).any(1)
    k = torch.arange(n, device=wcos.device)
    lo = torch.where(nonzero, k, n).amin(1)
    hi = torch.where(nonzero, k + 1, 0).amax(1)
    empty = lo >= hi
    return torch.stack((lo.masked_fill(empty, 0), hi.masked_fill(empty, 0)), 1)


def kchunk_ranges(wcos, wsin):
    """The group ranges of :func:`kchunk_ranges_plain` as K6's pre-pass finds
    them on the card, from the bank in the storage type of the precision
    mode (an inspection: :data:`LAUNCHES` is not touched)."""
    if not _on_card(wcos):
        return kchunk_ranges_plain(wcos, wsin)
    with span("nnaudio.wrap.K6"):
        _check_cuda(wcos)
        dev = wcos.device
        wc = _operand(wcos, "wcos", 2, dev)
        ws = _operand(wsin, "wsin", 2, dev)
        f, n = wc.shape
        if ws.shape != wc.shape or f > KCHUNK_MAX_F:
            raise ValueError(f"banks {tuple(wc.shape)}, {tuple(ws.shape)}: equal shapes of "
                             f"at most {KCHUNK_MAX_F} bins")
        nbytes = kchunk_workspace_bytes(1, f, n, 1, 1, wc.dtype)
        work = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        with torch.cuda.device(dev):
            _run("nnaudio_kchunk_ranges", wc.data_ptr(), ws.data_ptr(), work.data_ptr(),
                 nbytes, f, n, int(wc.dtype == torch.bfloat16), KCHUNK_GROUP, _stream())
        groups = _ceil_div(f, KCHUNK_GROUP)
        at = KCHUNK_GROUP_RANGES
        return work[at:at + 8 * groups].view(torch.int32).reshape(groups, 2).long()


def framed_magnitude_banded_3xtf32_plain(x, wcos, wsin, hop, eps=0.0, square=False,
                                         group: int = KCHUNK_GROUP):
    """K6 as the kernel computes it in fp32 storage: both operands split by
    :func:`tf32_split`; per bin and K chunk of ``KCHUNK_BK[float32]``
    samples ``lo*hi + hi*lo``, then ``hi*hi``, summed from zero, only for
    the chunks that meet the range of the bin's group
    (:func:`kchunk_ranges_plain`, rounded out to whole chunks: a chunk
    outside it is never multiplied, so a non-finite sample there does not
    reach the output); the chunk sums added, then the epilogue."""
    bk = KCHUNK_BK[torch.float32]
    f, n = wcos.shape
    chunks = _ceil_div(n, bk)
    pad = chunks * bk - n
    frames = F.pad(frame_signal(x.float(), n, hop), (0, pad))
    b, t = frames.shape[:2]
    x_hi, x_lo = (a.reshape(b, t, chunks, bk) for a in tf32_split(frames))
    ranges = kchunk_ranges_plain(wcos, wsin, group)
    c = torch.arange(chunks, device=x.device)
    lo = torch.div(ranges[:, 0], bk, rounding_mode="floor")
    hi = torch.div(ranges[:, 1] + bk - 1, bk, rounding_mode="floor")
    inside = ((c >= lo[:, None]) & (c < hi[:, None])).repeat_interleave(group, 0)[:f]

    def product(w):
        w_hi, w_lo = (a.reshape(f, chunks, bk) for a in tf32_split(F.pad(w.float(), (0, pad))))
        small = (torch.einsum("fck,btck->bftc", w_lo, x_hi)
                 + torch.einsum("fck,btck->bftc", w_hi, x_lo))
        parts = small + torch.einsum("fck,btck->bftc", w_hi, x_hi)
        return torch.where(inside[:, None, :], parts, parts.new_zeros(())).sum(-1)

    return pair_magnitude(product(wcos), product(wsin), eps, square)


def _launch_magnitude_kchunk(x, wcos, wsin, hop, eps, square, splits=None):
    with span("nnaudio.wrap.K6"):
        xs, wc, ws, dims = _analysis_operands(x, wcos, wsin, hop)
        b, _, n, _, f, t = dims
        if f > KCHUNK_MAX_F:
            raise ValueError(
                f"the split-K magnitude kernel takes at most {KCHUNK_MAX_F} bins, "
                f"got {f}")
        splits = kchunk_plan(b, t, n, splits)
        # the bank's ranges and packed copy, made anew by the kernel's pre-pass,
        # and the partial (re, im) of every split
        nbytes = kchunk_workspace_bytes(b, f, n, t, splits, xs.dtype)
        work = torch.empty(nbytes, dtype=torch.uint8, device=xs.device)
        out = torch.empty((b, f, t), dtype=torch.float32, device=xs.device)
        with torch.cuda.device(xs.device):
            _run("nnaudio_framed_magnitude_kchunk", xs.data_ptr(), wc.data_ptr(),
                 ws.data_ptr(), out.data_ptr(), work.data_ptr(), nbytes, *dims, splits,
                 float(eps), int(square), int(xs.dtype == torch.bfloat16), _stream())
        LAUNCHES["framed_magnitude_kchunk"] += 1
        return out


def _launch_filterbank(x, wcos, wsin, fb, hop, eps):
    """Dense K2, inside the wrapper's span (:func:`framed_filterbank`)."""
    xs, wc, ws, dims = _analysis_operands(x, wcos, wsin, hop)
    b, _, _, _, f, t = dims
    fb_t = _operand(fb.t(), "fb", 2, xs.device)  # (F, M)
    if fb_t.shape[0] != f:
        raise ValueError(f"fb {tuple(fb.shape)} does not match {f} bins")
    m = fb_t.shape[1]
    out = torch.empty((b, m, t), dtype=torch.float32, device=xs.device)
    # each block tile of bins writes its partial projection here; a second
    # kernel sums the tiles in order
    work = torch.empty((_ceil_div(f, TC_BLOCK_F), b, m,
                        _ceil_div(t, TC_FRAME_ALIGN) * TC_FRAME_ALIGN),
                       dtype=torch.float32, device=xs.device)
    with torch.cuda.device(xs.device):
        _run("nnaudio_framed_filterbank", xs.data_ptr(), wc.data_ptr(),
             ws.data_ptr(), fb_t.data_ptr(), out.data_ptr(), work.data_ptr(),
             *dims, m, float(eps), int(xs.dtype == torch.bfloat16), _stream())
    LAUNCHES["framed_filterbank"] += 1
    return out


class FFTPlan(NamedTuple):
    """What K2's FFT route reads besides the signal, made once per basis and
    filterbank: the window ``wcos[0]`` (N,), the twiddle table
    (:func:`fft_twiddles`), the filterbank's M bands as int32 ``lo`` (M)
    then ``off`` (M + 1), and their entries (:func:`filterbank_bands`)."""
    window: torch.Tensor
    twiddle: torch.Tensor
    band: torch.Tensor
    vals: torch.Tensor
    m: int


def _fourier_mismatch(wcos, wsin, window=None, weights=None):
    """A 0-d bool on the bases' device, unread (no synchronisation): whether
    an entry of ``(wcos, wsin)`` (F, N) lies off ``weights[f] w[k] cos(2 pi f
    k / N)`` (or sin), with ``w = wcos[0]`` (or ``window``) and ``weights``
    ones where not given, by more than :data:`FOURIER_ULPS` units of its own
    value plus ``FOURIER_FLOOR * max |w|`` (the float64 reference's own error
    near the zeros of cos and sin, at the largest phases); a NaN is off. Rows
    go by chunks of at most 4M entries."""
    f, n = wcos.shape
    dev = wcos.device
    w = (wcos[0] if window is None else window).detach().double()
    floor = FOURIER_FLOOR * w.abs().max()
    k = torch.arange(n, device=dev)
    off = torch.zeros((), dtype=torch.bool, device=dev)
    step = max(1, (1 << 22) // n)
    for f0 in range(0, f, step):
        rows = torch.arange(f0, min(f, f0 + step), device=dev)
        turn = (rows[:, None] * k % n).double() * (2.0 * np.pi / n)
        for basis, ref in ((wcos, torch.cos(turn)), (wsin, torch.sin(turn))):
            ref = ref * w if weights is None else ref * w * weights[rows, None]
            err = (basis[f0:f0 + rows.numel()].detach().double() - ref).abs()
            off |= ~(err <= FOURIER_ULPS * 2.0 ** -23 * ref.abs() + floor).all()
    return off


def _fft_kernel_takes(entry: str, n: int, *args) -> bool:
    """Whether a kernel of ``csrc/framed_fft.cu`` runs frames of ``n``
    samples: the kernel owns its block's shape and shared memory, and says
    so with the length of the twiddle table it reads for ``n`` (0 where it
    cannot run; ``entry`` is its query), which has to be
    :func:`fft_twiddles`'s."""
    length = _fn(entry)(n, *args)
    if length and length != fft_pass_offsets(n // 2)[-1]:
        raise RuntimeError(f"framed_fft.cu's {entry} reads {length} twiddles at n_fft {n}, "
                           f"fft_twiddles makes {fft_pass_offsets(n // 2)[-1]}")
    return length > 0


def _kernel_takes(n: int, m: int) -> bool:
    """Whether K2's FFT route projects frames of ``n`` samples onto ``m``
    rows (:func:`_fft_kernel_takes`)."""
    return _fft_kernel_takes("nnaudio_framed_filterbank_fft_twiddles", n, m)


def _fourier_shape(wcos, wsin, mixed: bool = False) -> bool:
    """Whether ``(wcos, wsin)`` have the shape and type of an FFT route's
    Fourier basis: fp32 (F, N), N a power of two in [64, 8192] (or, where
    ``mixed``, 2^a 5^b there: :func:`mixed_radix`), F = N/2 + 1."""
    f, n = wcos.shape
    return ((FFT_MIN_N <= n <= FFT_MAX_N and n & (n - 1) == 0 or mixed and mixed_radix(n))
            and f == n // 2 + 1 and wcos.dtype == wsin.dtype == torch.float32
            and wsin.shape == wcos.shape)


def build_fft_plan(wcos, wsin, fb) -> FFTPlan | None:
    """The FFT route's plan for ``(wcos, wsin, fb)``, or None where they are
    not its operands: fp32 bases (F, N) with N a power of two in [64, 8192]
    or 2^a 5^b there (:func:`mixed_radix`) and F = N/2 + 1 that are the
    Fourier basis of the window ``wcos[0]`` (:func:`_fourier_mismatch`), and
    an fp32 or bf16 filterbank (M, F); on the card, one that the kernel takes
    (:func:`_kernel_takes`). One synchronisation."""
    f, n = wcos.shape
    if not (_fourier_shape(wcos, wsin, mixed=True) and fb.dtype in (torch.float32, torch.bfloat16)
            and fb.ndim == 2 and fb.shape[1] == f):
        return None
    if wcos.is_cuda and not _kernel_takes(n, fb.shape[0]):
        return None
    off_basis = _fourier_mismatch(wcos, wsin)
    lo, length = _band_ranges(fb.detach())
    off = F.pad(torch.cumsum(length, 0), (1, 0))
    off_basis, nnz = torch.stack((off_basis.long(), off[-1])).tolist()
    if off_basis:
        return None
    return FFTPlan(window=wcos[0].detach().clone(), twiddle=fft_twiddles(n, wcos.device),
                   band=torch.cat((lo, off)).int(),
                   vals=_band_values(fb, lo, off, length, nnz), m=fb.shape[0])


class SynthesisFFTPlan(NamedTuple):
    """What K3's FFT route reads besides the spectra, made once per basis:
    the window over N (N,), the twiddle table (:func:`fft_twiddles`) and the
    edge samples' weights (:func:`synthesis_edge`)."""
    scale: torch.Tensor
    twiddle: torch.Tensor
    edge: torch.Tensor


def _synthesis_kernel_takes(n: int) -> bool:
    """Whether K3's FFT route runs frames of ``n`` samples
    (:func:`_fft_kernel_takes`)."""
    return _fft_kernel_takes("nnaudio_synthesis_fft_twiddles", n)


def build_synthesis_fft_plan(kernel_cos, kernel_sin, window, weighted) -> SynthesisFFTPlan | None:
    """K3's FFT route's plan for a transform's synthesis factors, or None
    where they are not its operands: fp32 kernels of at least N/2 + 1 rows
    of N, N a power of two in [64, 8192], whose first N/2 + 1 rows are the
    Fourier basis ``cos(2 pi f k / N)`` (and sin), times the Hermitian fold
    weights (1 at DC and Nyquist, 2 between) where ``weighted``
    (:func:`_fourier_mismatch`, with a unit window), and an fp32 window (N,);
    on the card, an N that the kernel takes (:func:`_synthesis_kernel_takes`).
    One synchronisation."""
    n = kernel_cos.shape[-1]
    f = n // 2 + 1
    if not (kernel_cos.ndim == 2 and FFT_MIN_N <= n <= FFT_MAX_N and n & (n - 1) == 0
            and kernel_sin.shape == kernel_cos.shape and kernel_cos.shape[0] >= f
            and kernel_cos.dtype == kernel_sin.dtype == window.dtype == torch.float32
            and tuple(window.shape) == (n,)):
        return None
    if kernel_cos.is_cuda and not _synthesis_kernel_takes(n):
        return None
    dev = kernel_cos.device
    weights = None
    if weighted:
        weights = torch.full((f,), 2.0, dtype=torch.float64, device=dev)
        weights[0] = weights[-1] = 1.0
    unit = torch.ones(n, dtype=torch.float64, device=dev)
    if _fourier_mismatch(kernel_cos[:f], kernel_sin[:f], unit, weights).item():
        return None
    return SynthesisFFTPlan(scale=window.detach() / n, twiddle=fft_twiddles(n, dev),
                            edge=synthesis_edge(n, dev))


class GLStepFFTPlan(NamedTuple):
    """What K4's FFT route reads besides the signal and the carries, made
    once per basis: the window ``wcos[0]`` (N,) and the twiddle table
    (:func:`fft_twiddles`)."""
    window: torch.Tensor
    twiddle: torch.Tensor


def build_gl_step_fft_plan(wcos, wsin) -> GLStepFFTPlan | None:
    """K4's FFT route's plan for ``(wcos, wsin)``, or None where they are
    not its operands: fp32 bases (F, N), N a power of two in [64, 8192], F =
    N/2 + 1, that are the Fourier basis of the window ``wcos[0]``
    (:func:`_fourier_mismatch`); on the card, an N that the kernel takes
    (:func:`_fft_kernel_takes`). One synchronisation."""
    if not _fourier_shape(wcos, wsin):
        return None
    n = wcos.shape[1]
    if wcos.is_cuda and not _fft_kernel_takes("nnaudio_gl_step_fft_twiddles", n):
        return None
    if _fourier_mismatch(wcos, wsin).item():
        return None
    return GLStepFFTPlan(window=wcos[0].detach().clone(), twiddle=fft_twiddles(n, wcos.device))


class NNLSPlan(NamedTuple):
    """What the NNLS kernel reads besides the mels, made once per basis: the
    pseudo-inverse transposed (M, F); the bands, int32 (M + nf, 4), per row of
    M ``(lo - fa, length, offset, 0)`` (its nonzero columns, from the active
    bins' first), then per bin of the active range ``[fa, fa + nf)`` (the bins
    whose column of M is not all zero) ``(first row, length, offset, 0)``, or
    for a bin of at most two rows ``(first row, length, v0, v1)`` with its
    entries' fp32 bits in place (0 past its length); their entries, the rows'
    ``nnz_rows`` then the bins' (:func:`filterbank_bands` of M and of M^T)."""
    pinv_t: torch.Tensor
    band: torch.Tensor
    vals: torch.Tensor
    fa: int
    nf: int
    nnz_rows: int


#: columns of a block of the NNLS kernel's steps (one to a lane), and the mel
#: rows it takes at most (a warp keeps its rows' mel in registers)
NNLS_COLUMNS = 32
NNLS_MAX_M = 128
#: shared memory a block of the H100 can have, in bytes
SMEM_LIMIT = 232448


def nnls_block_bytes(nf: int, m: int, nnz: int) -> int:
    """Shared memory of a block of the NNLS kernel's steps
    (``step_smem_bytes`` in ``csrc/nnls_banded.cu``): s of ``nf`` active bins
    and the residual of ``m`` rows, :data:`NNLS_COLUMNS` columns each, a
    16-byte header a row and a bin, the ``nnz`` entries of both bands."""
    return 4 * NNLS_COLUMNS * (nf + m) + 16 * (m + nf) + 4 * nnz


def _nnls_kernel_takes(nf: int, m: int, nnz: int) -> bool:
    """Whether the NNLS kernel runs a block of these bands: its query says so
    with the block's shared memory (0 where it cannot), which has to be
    :func:`nnls_block_bytes`'s."""
    nbytes = _fn("nnaudio_nnls_banded_smem")(nf, m, nnz)
    if nbytes and nbytes != nnls_block_bytes(nf, m, nnz):
        raise RuntimeError(f"nnls_banded.cu's block takes {nbytes} bytes for nf={nf}, m={m}, "
                           f"nnz={nnz}; nnls_block_bytes counts {nnls_block_bytes(nf, m, nnz)}")
    return nbytes > 0


def build_nnls_plan(mel_basis, mel_pinv) -> NNLSPlan | None:
    """The NNLS kernel's plan for a basis (M, F) and its pseudo-inverse (F,
    M), or None where they are not its operands: fp32, at most
    :data:`NNLS_MAX_M` rows, and a block of the steps that fits the H100's
    shared memory (:func:`nnls_block_bytes`; on the card, the kernel's own
    query)."""
    if not (mel_basis.ndim == 2 and mel_basis.dtype == mel_pinv.dtype == torch.float32
            and tuple(mel_pinv.shape) == tuple(mel_basis.shape)[::-1]
            and 1 <= mel_basis.shape[0] <= NNLS_MAX_M):
        return None
    basis = mel_basis.detach()
    m = basis.shape[0]
    active = torch.nonzero((basis != 0).any(0)).flatten().tolist()
    fa, nf = (active[0], active[-1] + 1 - active[0]) if active else (0, 0)
    lo, off, row_vals = filterbank_bands(basis)
    clo, coff, bin_vals = filterbank_bands(basis.t()[fa:fa + nf])
    nnz = row_vals.numel() + bin_vals.numel()
    if nnls_block_bytes(nf, m, nnz) > SMEM_LIMIT:
        return None
    if basis.is_cuda and not _nnls_kernel_takes(nf, m, nnz):
        return None
    length, clen = off[1:] - off[:-1], coff[1:] - coff[:-1]
    # a bin of at most two rows holds its entries in its header
    padded = F.pad(bin_vals, (0, 2))
    v0 = torch.where(clen > 0, padded[coff[:-1]], 0.0).view(torch.int32).long()
    v1 = torch.where(clen > 1, padded[coff[:-1] + 1], 0.0).view(torch.int32).long()
    short = clen <= 2
    rows = torch.stack((lo - fa, length, off[:-1], torch.zeros_like(lo)), 1)
    bins = torch.stack((clo, clen, torch.where(short, v0, coff[:-1]), torch.where(short, v1, 0)), 1)
    return NNLSPlan(pinv_t=mel_pinv.detach().t().contiguous(),
                    band=torch.cat((rows, bins)).int().contiguous(),
                    vals=torch.cat((row_vals, bin_vals)), fa=fa, nf=nf, nnz_rows=row_vals.numel())


# ------------------------------------------------------------ the routes --
class _Own:
    """The mark of a transform's own tensor (:func:`mark_own`): the FFT plans
    kept on it, by the function that makes them, each with the stamp of the
    operands it was made for; and the weak reference that drops the mark
    with its tensor."""
    __slots__ = ("plans", "ref")


#: the marks of the tensors :func:`mark_own` marked, by ``id``. A mark goes
#: when its tensor does, so an ``id`` never names another tensor; the tensor
#: itself carries nothing (it pickles, and loads with ``weights_only``, as
#: any tensor does).
_OWN: dict[int, _Own] = {}


def mark_own(*tensors) -> None:
    """Mark tensors as a transform's own: ``SpectralTransform`` marks each
    tensor it registers, and again those that ``.to()``, a load with
    ``assign=True`` or a copy of the transform puts in their place; a stream
    marks the filterbank it keeps. Only such operands are looked at for an
    FFT route, so a tensor passed in (a ``params`` override, a train step's
    new parameters, a clone) takes the dense kernel unchecked. A marked
    tensor keeps its mark and its plans."""
    for t in tensors:
        key = id(t)
        if key not in _OWN:
            own = _OWN[key] = _Own()
            own.plans = {}
            own.ref = weakref.ref(t, lambda _, key=key, marks=_OWN: marks.pop(key, None))


def _kept(build, operands, *args):
    """``build(*operands, *args)`` for marked operands as they are now, kept
    on the first one's mark: made at the first call (one comparison in
    float64, one synchronisation) and again only after an operand was
    replaced or changed in place (its version, which ``update_params``,
    ``load_state_dict`` and in-place ops bump; a write through ``.data``
    bumps none: make it in place under ``torch.no_grad()``). The plan holds
    none of the operands. None where an operand is not marked."""
    own, stamp = None, args
    for t in operands:
        mark = _OWN.get(id(t))
        if mark is None:
            return None
        own = own or mark
        stamp += (mark, t._version, t.data_ptr())
    kept = own.plans.get(build)
    if kept is None or kept[0] != stamp:
        kept = own.plans[build] = (stamp, build(*operands, *args))
    return kept[1]


def fft_plan(wcos, wsin, fb) -> FFTPlan | None:
    """K2's FFT route for these operands: their plan (:func:`build_fft_plan`,
    kept as :func:`_kept` keeps it), or None, which leaves them to dense K2.
    Operands not all marked (:func:`mark_own`), a basis that requires grad,
    and bf16 storage take dense K2 unchecked."""
    if storage_dtype() != torch.float32 or wcos.requires_grad or wsin.requires_grad:
        return None
    return _kept(build_fft_plan, (wcos, wsin, fb))


def hermitian_weights(n_fft: int, n_bins: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Per-bin fold weights for onesided synthesis: DC (and Nyquist when
    ``n_fft`` is even) count once, interior bins twice, which replaces the
    explicit ``extend_fbins`` mirror and halves the IDFT matmul."""
    wt = torch.full((n_bins,), 2.0, dtype=dtype, device=device)
    wt[0] = 1.0
    if n_fft % 2 == 0:
        wt[-1] = 1.0
    return wt


def synthesis_kernels(kernel_cos, kernel_sin, window, weighted=False):
    """K3's onesided synthesis products ``(kc, ks)``, F = N/2 + 1 rows of N:
    the kernels' first F rows times the Hermitian fold weights
    (:func:`hermitian_weights`), times the window, over N. ``weighted``: the
    kernels are onesided and carry the weights already (``Griffin_Lim``'s
    ``kernel_*_inv``), and the window is divided by N first. Both products
    record their factors, so that :func:`synthesis_ola` finds the factors'
    FFT route (:func:`synthesis_fft_plan`) by itself."""
    n = kernel_cos.shape[-1]
    if weighted:
        w = window[None, :] / n
        kc, ks = kernel_cos * w, kernel_sin * w
    else:
        f = n // 2 + 1
        wt = hermitian_weights(n, f, kernel_cos.dtype, kernel_cos.device)[:, None]
        kc = kernel_cos[:f] * wt * window[None, :] / n
        ks = kernel_sin[:f] * wt * window[None, :] / n
    kc._nnaudio_factors = ks._nnaudio_factors = (kernel_cos, kernel_sin, window, weighted)
    return kc, ks


def synthesis_fft_plan(kc, ks) -> SynthesisFFTPlan | None:
    """K3's FFT route for the products ``kc`` and ``ks``: the plan of the
    factors that :func:`synthesis_kernels` recorded on both
    (:func:`build_synthesis_fft_plan`, kept on the factors as :func:`_kept`
    keeps it, never on the products), or None, which leaves the synthesis to
    dense K3. Products made otherwise, factors not all marked
    (:func:`mark_own`), factors that require grad, and bf16 storage take
    dense K3 unchecked."""
    factors = getattr(kc, "_nnaudio_factors", None)
    if (factors is None or getattr(ks, "_nnaudio_factors", None) is not factors
            or storage_dtype() != torch.float32):
        return None
    kernel_cos, kernel_sin, window, weighted = factors
    if kernel_cos.requires_grad or kernel_sin.requires_grad or window.requires_grad:
        return None
    return _kept(build_synthesis_fft_plan, (kernel_cos, kernel_sin, window), weighted)


def gl_step_fft_plan(wcos, wsin, p_re, p_im) -> GLStepFFTPlan | None:
    """K4's FFT route for these operands: the plan of the basis
    (:func:`build_gl_step_fft_plan`, kept as :func:`_kept` keeps it), or
    None, which leaves the step to the tensor-core K4 or the pair
    (:func:`gl_step`). A basis not marked (:func:`mark_own`) or that requires
    grad, bf16 storage and bf16 carries take another route unchecked."""
    if (storage_dtype() != torch.float32 or p_re.dtype != torch.float32
            or p_im.dtype != torch.float32 or wcos.requires_grad or wsin.requires_grad):
        return None
    return _kept(build_gl_step_fft_plan, (wcos, wsin))


def nnls_plan(mel_basis, mel_pinv, mel) -> NNLSPlan | None:
    """The NNLS kernel for these operands: the plan of the basis and its
    pseudo-inverse (:func:`build_nnls_plan`, kept as :func:`_kept` keeps it),
    or None, which leaves the NNLS to the dense products (:func:`nnls_plain`).
    Mels not in fp32, bf16 storage, a differentiated call, and a basis or
    pseudo-inverse not marked (:func:`mark_own`) take the products
    unchecked."""
    if (storage_dtype() != torch.float32 or mel.dtype != torch.float32
            or _differentiated(mel, mel_basis, mel_pinv)):
        return None
    return _kept(build_nnls_plan, (mel_basis, mel_pinv))


def _launch_filterbank_fft(x, wcos, wsin, fb, hop, eps, plan):
    """K2's FFT route, inside the wrapper's span: the bases and the
    filterbank are read from ``plan``."""
    _check_cuda(x)
    xs = _operand(x, "x", 2, plan.window.device)
    if hop < 1:
        raise ValueError(f"hop must be >= 1, got {hop}")
    b, length = xs.shape
    n, m = plan.window.shape[0], plan.m
    t = num_frames(length, n, hop)
    if t < 1:
        raise ValueError(f"signal of {length} samples is shorter than n_fft={n}")
    out = torch.empty((b, m, t), dtype=torch.float32, device=xs.device)
    with torch.cuda.device(xs.device):
        _run("nnaudio_framed_filterbank_fft", xs.data_ptr(), plan.window.data_ptr(),
             plan.twiddle.data_ptr(), plan.band.data_ptr(), plan.vals.data_ptr(),
             out.data_ptr(), b, length, n, hop, t, m, plan.vals.numel(), float(eps),
             _stream())
    LAUNCHES["framed_filterbank_fft"] += 1
    return out


def _launch_pair(x, wcos, wsin, hop):
    with span("nnaudio.wrap.K5"):
        xs, wc, ws, dims = _analysis_operands(x, wcos, wsin, hop)
        b, _, _, _, f, t = dims
        re = torch.empty((b, f, t), dtype=torch.float32, device=xs.device)
        im = torch.empty_like(re)
        with torch.cuda.device(xs.device):
            _run("nnaudio_framed_pair", xs.data_ptr(), wc.data_ptr(),
                 ws.data_ptr(), re.data_ptr(), im.data_ptr(), *dims,
                 int(xs.dtype == torch.bfloat16), _stream())
        LAUNCHES["framed_pair"] += 1
        return re, im


def _launch_gl_step(x, wcos, wsin, S, p_re, p_im, hop, mom):
    """Dense K4, inside the wrapper's span (:func:`gl_step`), in either carry
    type."""
    xs, wc, ws, dims = _analysis_operands(x, wcos, wsin, hop)
    b, _, _, _, f, t = dims
    dev, shape, carry = xs.device, (b, f, t), p_re.dtype
    mag = _carry(S, "S", shape, torch.float32, dev)
    pr = _carry(p_re, "p_re", shape, carry, dev)
    pi = _carry(p_im, "p_im", shape, carry, dev)
    outs = [torch.empty(shape, dtype=carry, device=dev) for _ in range(4)]
    with torch.cuda.device(dev):
        _run("nnaudio_gl_step", xs.data_ptr(), wc.data_ptr(), ws.data_ptr(),
             mag.data_ptr(), pr.data_ptr(), pi.data_ptr(),
             *(o.data_ptr() for o in outs), *dims, float(mom),
             int(xs.dtype == torch.bfloat16), int(carry == torch.bfloat16),
             _stream())
    LAUNCHES["gl_step"] += 1
    return tuple(outs)


def _launch_gl_step_fft(x, wcos, wsin, S, p_re, p_im, hop, mom, plan):
    """K4's FFT route, inside the wrapper's span: the basis read from
    ``plan``, fp32 carries."""
    _check_cuda(x)
    dev = plan.window.device
    xs = _operand(x, "x", 2, dev)
    if hop < 1:
        raise ValueError(f"hop must be >= 1, got {hop}")
    b, length = xs.shape
    n = plan.window.shape[0]
    t = num_frames(length, n, hop)
    if t < 1:
        raise ValueError(f"signal of {length} samples is shorter than n_fft={n}")
    shape = (b, n // 2 + 1, t)
    mag = _carry(S, "S", shape, torch.float32, dev)
    pr = _carry(p_re, "p_re", shape, torch.float32, dev)
    pi = _carry(p_im, "p_im", shape, torch.float32, dev)
    outs = [torch.empty(shape, dtype=torch.float32, device=dev) for _ in range(4)]
    with torch.cuda.device(dev):
        _run("nnaudio_gl_step_fft", xs.data_ptr(), plan.window.data_ptr(),
             plan.twiddle.data_ptr(), mag.data_ptr(), pr.data_ptr(), pi.data_ptr(),
             *(o.data_ptr() for o in outs), b, length, n, hop, t, float(mom), _stream())
    LAUNCHES["gl_step_fft"] += 1
    return tuple(outs)


def _launch_nnls(mel_basis, mel_pinv, mel, step, n_iter, plan):
    """The NNLS kernel, inside the wrapper's span: the basis's bands and its
    pseudo-inverse read from ``plan``, ``n_iter`` steps of ``step``."""
    _check_cuda(mel)
    dev = plan.pinv_t.device
    ms = _operand(mel, "mel", 3, dev)
    b, m, t = ms.shape
    if m != plan.pinv_t.shape[0]:
        raise ValueError(f"mel {tuple(ms.shape)} does not match {plan.pinv_t.shape[0]} mel rows")
    f = plan.pinv_t.shape[1]
    out = torch.empty((b, f, t), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        _run("nnaudio_nnls_banded", ms.data_ptr(), plan.pinv_t.data_ptr(), plan.band.data_ptr(),
             plan.vals.data_ptr(), out.data_ptr(), b, m, f, t, plan.fa, plan.nf,
             plan.nnz_rows, plan.vals.numel(), float(step), max(0, int(n_iter)), _stream())
    LAUNCHES["nnls_banded"] += 1
    return out


def _launch_synthesis(spec_re, spec_im, kc, ks, hop):
    """Dense K3, inside the wrapper's span (:class:`_SynthesisOLA`)."""
    _check_cuda(spec_re)
    dev = spec_re.device
    sre = _operand(spec_re, "spec_re", 3, dev)
    sim = _operand(spec_im, "spec_im", 3, dev)
    kcs = _operand(kc, "kc", 2, dev)
    kss = _operand(ks, "ks", 2, dev)
    if sre.shape != sim.shape or kcs.shape != kss.shape \
            or kcs.shape[0] != sre.shape[1]:
        raise ValueError(
            f"shapes differ: spec_re {tuple(sre.shape)}, spec_im "
            f"{tuple(sim.shape)}, kc {tuple(kcs.shape)}, ks {tuple(kss.shape)}")
    if hop < 1:
        raise ValueError(f"hop must be >= 1, got {hop}")
    b, f, t = sre.shape
    n = kcs.shape[1]
    bf16 = sre.dtype == torch.bfloat16
    # the kernels transposed to (N, Fp), Fp = F rounded up to a K chunk, zeros
    # past F: the K-major A operand that TF32 products need, with rows that
    # TMA can read (16-byte aligned)
    fp = _ceil_div(f, SYNTH_BK[sre.dtype]) * SYNTH_BK[sre.dtype]
    kct = torch.zeros((n, fp), dtype=sre.dtype, device=dev)
    kst = torch.zeros_like(kct)
    kct[:, :f] = kcs.t()
    kst[:, :f] = kss.t()
    copied(kct)
    copied(kst)
    # the kernel copies the spectra in 16-byte pieces from 16-byte aligned
    # rows: pad each row with zeros to a multiple of a piece
    per16 = 16 // sre.element_size()
    tp = _ceil_div(t, per16) * per16
    if tp != t:
        sre, sim = (copied(F.pad(a, (0, tp - t))) for a in (sre, sim))
    elif sre.data_ptr() % 16 or sim.data_ptr() % 16:
        sre, sim = copied(sre.clone()), copied(sim.clone())
    out = torch.empty((b, n + hop * (t - 1)), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _run("nnaudio_synthesis_ola", sre.data_ptr(), sim.data_ptr(),
             kct.data_ptr(), kst.data_ptr(), out.data_ptr(), b, f, t, tp, n,
             hop, fp, int(bf16), _stream())
    LAUNCHES["synthesis_ola"] += 1
    return out


def _launch_synthesis_fft(spec_re, spec_im, hop, plan):
    """K3's FFT route, inside the wrapper's span, for a hop of at most N: the
    fp32 spectra read where they lie, by their strides (two planes of
    different strides made contiguous), the window and twiddles from
    ``plan``."""
    _check_cuda(spec_re)
    dev = plan.scale.device
    n = plan.scale.shape[0]
    for t, name in ((spec_re, "spec_re"), (spec_im, "spec_im")):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.ndim != 3 or t.shape[1] != n // 2 + 1:
            raise ValueError(f"{name} must be (B, {n // 2 + 1}, T), got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    sre, sim = spec_re, spec_im
    if sre.shape != sim.shape:
        raise ValueError(f"shapes differ: spec_re {tuple(sre.shape)}, spec_im {tuple(sim.shape)}")
    if sre.stride() != sim.stride():
        sre, sim = (copied(p.contiguous(), p) for p in (sre, sim))
    b, _, t = sre.shape
    out = torch.empty((b, n + hop * (t - 1)), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _run("nnaudio_synthesis_fft", sre.data_ptr(), sim.data_ptr(), *sre.stride(),
             plan.scale.data_ptr(), plan.twiddle.data_ptr(), plan.edge.data_ptr(),
             out.data_ptr(), b, t, n, hop, _stream())
    LAUNCHES["synthesis_ola_fft"] += 1
    return out


class _SynthesisOLA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, spec_re, spec_im, kc, ks, hop):
        ctx.save_for_backward(spec_re, spec_im, kc, ks)
        ctx.hop = hop
        with span("nnaudio.wrap.K3"):
            plan = synthesis_fft_plan(kc, ks)
            if plan is not None and hop <= plan.scale.shape[0]:
                note_route("K3.fft")
                return _launch_synthesis_fft(spec_re, spec_im, hop, plan)
            note_route("K3.dense")
            return _launch_synthesis(spec_re, spec_im, kc, ks, hop)

    @staticmethod
    def backward(ctx, g):
        return (*synthesis_ola_backward(*ctx.saved_tensors, g, ctx.hop,
                                        ctx.needs_input_grad[:4]), None)


class _Pair(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wcos, wsin, hop):
        ctx.save_for_backward(x, wcos, wsin)
        ctx.hop = hop
        return _launch_pair(x, wcos, wsin, hop)

    @staticmethod
    def backward(ctx, g_re, g_im):
        with span("nnaudio.K5.backward"):
            x, wcos, wsin = ctx.saved_tensors
            return (*framed_pair_backward(x, wcos, wsin, g_re, g_im, ctx.hop,
                                          ctx.needs_input_grad[:3]), None)


class _GLStep(torch.autograd.Function):
    """Dense K4, or its FFT route where a plan is given."""

    @staticmethod
    def forward(ctx, x, wcos, wsin, S, p_re, p_im, hop, mom, plan):
        if plan is None:
            return _launch_gl_step(x, wcos, wsin, S, p_re, p_im, hop, mom)
        return _launch_gl_step_fft(x, wcos, wsin, S, p_re, p_im, hop, mom, plan)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "the Griffin-Lim step has no gradient: the JAX package's loop "
            "carries none")


# ---------------------------------------------------------------- wrappers --
def _on_card(t: torch.Tensor) -> bool:
    """Whether a wrapper launches its kernel for ``t``: for any tensor off
    the CPU (the kernel's checks reject one that is not on CUDA)."""
    return t.device.type != "cpu"


def _differentiated(*operands) -> bool:
    """Whether autograd records this call: grad is enabled and an operand
    requires grad (the JAX package's differentiated forward)."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in operands)


def framed_magnitude(x, wcos, wsin, hop, eps=0.0, square=False):
    """K1: |STFT| (or |STFT|^2 when ``square``) -> (B, F, T) float32. A
    differentiated call takes the pair (K5) and the epilogue in PyTorch."""
    if not _on_card(x):
        return framed_magnitude_plain(x, wcos, wsin, hop, eps=eps, square=square)
    if _differentiated(x, wcos, wsin):
        return pair_magnitude(*framed_pair(x, wcos, wsin, hop), eps, square)
    return _launch_magnitude(x, wcos, wsin, hop, eps, square)


def framed_magnitude_kchunk(x, wcos, wsin, hop, eps=0.0, square=False,
                            splits=None):
    """K6: the function of K1 for a bank of at most 128 bins and a long
    contraction, each bin group multiplied over its own range of columns and
    split over K -> (B, F, T) float32. ``splits`` overrides the planned
    split count (:func:`kchunk_plan`); the result does not depend on it
    beyond fp32 summation order. A differentiated call takes the pair (K5),
    as :func:`framed_magnitude` does."""
    if not _on_card(x):
        return framed_magnitude_plain(x, wcos, wsin, hop, eps=eps, square=square)
    if _differentiated(x, wcos, wsin):
        return pair_magnitude(*framed_pair(x, wcos, wsin, hop), eps, square)
    return _launch_magnitude_kchunk(x, wcos, wsin, hop, eps, square, splits)


def framed_filterbank(x, wcos, wsin, fb, hop, eps=0.0):
    """K2: fb @ (|STFT|^2 + eps) -> (B, M, T) float32. A differentiated call
    takes the pair (K5), then the power and the projection in PyTorch, whose
    autograd gives the JAX package's ``_fb_bwd`` (``d_fb`` included). Else
    the FFT route (``csrc/framed_fft.cu``) where :func:`fft_plan` has a plan
    for the operands, and the dense tensor-core K2 for every other basis."""
    if not _on_card(x):
        return framed_filterbank_plain(x, wcos, wsin, fb, hop, eps=eps)
    if _differentiated(x, wcos, wsin, fb):
        return project(fb, pair_magnitude(*framed_pair(x, wcos, wsin, hop),
                                          eps, square=True))
    with span("nnaudio.wrap.K2"):
        plan = fft_plan(wcos, wsin, fb)
        if plan is not None:
            note_route("K2.fft")
            return _launch_filterbank_fft(x, wcos, wsin, fb, hop, eps, plan)
        note_route("K2.dense")
        return _launch_filterbank(x, wcos, wsin, fb, hop, eps)


def synthesis_ola(spec_re, spec_im, kc, ks, hop):
    """K3: OLA(kc^T Re - ks^T Im) -> (B, N + hop*(T-1)) float32. The FFT
    route (``csrc/framed_fft.cu``) where :func:`synthesis_fft_plan` has a
    plan for the factors that ``kc`` and ``ks`` were made of (and ``hop <=
    N``); the dense tensor-core K3 for every other synthesis. The backward
    is dense K3's on either route."""
    if not _on_card(spec_re):
        return synthesis_ola_plain(spec_re, spec_im, kc, ks, hop)
    return _SynthesisOLA.apply(spec_re, spec_im, kc, ks, hop)


def framed_pair(x, wcos, wsin, hop):
    """K5: the STFT pair ``(re, im_raw)``, each (B, F, T) float32."""
    if not _on_card(x):
        return framed_pair_plain(x, wcos, wsin, hop)
    return _Pair.apply(x, wcos, wsin, hop)


def gl_step(x, wcos, wsin, S, p_re, p_im, hop, mom):
    """K4: one Griffin-Lim analysis step -> ``(c_re, c_im, r_re, r_im)``,
    each (B, F, T) in the carry type of ``p_re`` (float32 or bfloat16). The
    FFT route (``csrc/framed_fft.cu``) where :func:`gl_step_fft_plan` has a
    plan for the basis (fp32 carries) and the call is not differentiated;
    the tensor-core K4 for bf16 carries outside ``tensorfloat32``, the steps
    that the JAX package's loop fuses; else the pair (K5), then
    :func:`gl_update`, whose autograd carries gradients back to ``S``, the
    carries and the signal, as the JAX package's fp32 loop does. Neither
    kernel has a backward. The tensor-core K4's fp32-carry variant is
    reached by no route here: fp32 carries take the FFT route or the pair."""
    if not _on_card(x):
        return gl_step_plain(x, wcos, wsin, S, p_re, p_im, hop, mom)
    with span("nnaudio.wrap.K4"):
        plan = (None if _differentiated(x, S, p_re, p_im)
                else gl_step_fft_plan(wcos, wsin, p_re, p_im))
        if plan is not None:
            note_route("K4.fft")
            return _GLStep.apply(x, wcos, wsin, S, p_re, p_im, hop, mom, plan)
        if p_re.dtype == torch.bfloat16 and get_config().matmul_precision != "tensorfloat32":
            note_route("K4.dense")
            return _GLStep.apply(x, wcos, wsin, S, p_re, p_im, hop, mom, None)
        note_route("K4.pair")
    return gl_update(*framed_pair(x, wcos, wsin, hop), S, p_re, p_im, mom)


def nnls(mel_basis, mel_pinv, mel, step, n_iter):
    """The inverse Mel's NNLS -> (B, F, T) float32: ``s = relu(pinv(M)
    mel)``, then ``n_iter`` steps of ``s = relu(s - step M^T (M s - mel))``
    for every (batch, time) column of the (B, M, T) mels. The kernel
    (``csrc/nnls_banded.cu``) where :func:`nnls_plan` has a plan for the
    operands; the dense products of :func:`nnls_plain` for every other call:
    under autograd (the inverse stays differentiable), in bf16 storage, on the
    CPU, for a basis passed in or one whose block does not fit. The kernel
    has no backward."""
    if not _on_card(mel):
        return nnls_plain(mel_basis, mel_pinv, mel, step, n_iter)
    with span("nnaudio.wrap.NNLS"):
        plan = nnls_plan(mel_basis, mel_pinv, mel)
        if plan is not None:
            note_route("NNLS.fused")
            return _launch_nnls(mel_basis, mel_pinv, mel, step, n_iter, plan)
        note_route("NNLS.plain")
    return nnls_plain(mel_basis, mel_pinv, mel, step, n_iter)
