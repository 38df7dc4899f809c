"""Wrappers of the hand-written CUDA kernels, each beside its plain version.

===========================  ==============================  =====================
wrapper                      CUDA kernel (``csrc/``)         TPU kernel replaced
===========================  ==============================  =====================
``framed_magnitude``         ``framed_analysis.cu`` K1       ``_magnitude_kernel``
``framed_filterbank``        ``framed_analysis.cu`` K2       ``_filterbank_kernel``
``synthesis_ola``            ``synthesis_ola.cu`` K3         ``_synthesis_ola_kernel``
===========================  ==============================  =====================

A wrapper given a CPU tensor computes its plain version; given a CUDA tensor
it launches its kernel or raises. It checks device, dtype and shape, makes
the operands contiguous in the storage type of the precision mode (bf16 in
``default`` mode, fp32 otherwise), allocates the output with ``torch.empty``,
launches on the current stream, raises on a nonzero ``cudaError_t``, and
adds one to its entry of :data:`LAUNCHES`.

The kernel wrappers are ``torch.autograd.Function``s whose backward raises:
the kernels' gradients come with the training slice. On the CPU the plain
versions differentiate through autograd.
"""
from __future__ import annotations

import ctypes

import torch

from ..config import matmul_numerics, round_to_storage, storage_dtype
from ..core.apply import apply_basis, project
from ..core.frame import frame_signal, frames_to_signal, num_frames

#: kernel launches per wrapper, counted where the kernel is launched
LAUNCHES: dict[str, int] = {"framed_magnitude": 0, "framed_filterbank": 0,
                            "synthesis_ola": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ----------------------------------------------------------- plain versions --
def framed_pair_plain(x, wcos, wsin, hop):
    """(B, L) x (F, N) bases -> (re, im_raw), each (B, F, T): unfold + matmul."""
    frames = frame_signal(x, wcos.shape[-1], hop)  # (B, T, N) view
    return apply_basis(frames, wcos), apply_basis(frames, wsin)


def framed_magnitude_plain(x, wcos, wsin, hop, eps=0.0, square=False):
    """sqrt(re^2 + im^2 + eps), or the power itself when ``square``."""
    re, im = framed_pair_plain(x, wcos, wsin, hop)
    power = re * re + im * im
    if eps:
        power = power + eps
    return power if square else torch.sqrt(power)


def framed_filterbank_plain(x, wcos, wsin, fb, hop, eps=0.0):
    """fb (M, F) @ (re^2 + im^2 + eps) -> (B, M, T)."""
    power = framed_magnitude_plain(x, wcos, wsin, hop, eps=eps, square=True)
    return project(fb, power)


def synthesis_ola_plain(spec_re, spec_im, kc, ks, hop):
    """OLA(kc^T Re - ks^T Im): (B, F, T) spectra x (F, N) kernels ->
    (B, N + hop*(T-1)), without window normalisation."""
    with matmul_numerics():
        frames = torch.einsum("fj,bft->btj", round_to_storage(kc),
                              round_to_storage(spec_re))
        frames = frames - torch.einsum("fj,bft->btj", round_to_storage(ks),
                                       round_to_storage(spec_im))
    length = kc.shape[1] + hop * (spec_re.shape[-1] - 1)
    return frames_to_signal(frames, hop, length)


# ------------------------------------------------------------------ launch --
_VOID = ctypes.c_void_p
_INT = ctypes.c_int
_SIGNATURES = {
    "nnaudio_framed_magnitude": (
        "framed_analysis",
        [_VOID, _VOID, _VOID, _VOID, _INT, _INT, _INT, _INT, _INT, _INT,
         ctypes.c_float, _INT, _INT, _VOID]),
    "nnaudio_framed_filterbank": (
        "framed_analysis",
        [_VOID, _VOID, _VOID, _VOID, _VOID, _INT, _INT, _INT, _INT, _INT, _INT,
         _INT, ctypes.c_float, _INT, _VOID]),
    "nnaudio_synthesis_ola": (
        "synthesis_ola",
        [_VOID, _VOID, _VOID, _VOID, _VOID, _INT, _INT, _INT, _INT, _INT, _INT,
         _VOID]),
}
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
    return t.to(storage_dtype()).contiguous()


def _check_cuda(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(
            f"the CUDA kernels take CUDA tensors; got a tensor on {x.device}")


def _run(name: str, *args) -> None:
    err = _fn(name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} failed to launch: cudaError_t {err}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _no_grad_yet(name):
    raise NotImplementedError(
        f"the gradient of the {name} CUDA kernel comes with the training "
        "slice of the port; run on the CPU or with the kernels off "
        "(config.set_use_kernels(False)) to differentiate")


def _launch_magnitude(x, wcos, wsin, hop, eps, square):
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
    out = torch.empty((b, f, t), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _run("nnaudio_framed_magnitude", xs.data_ptr(), wc.data_ptr(),
             ws.data_ptr(), out.data_ptr(), b, length, n, hop, f, t,
             float(eps), int(square), int(xs.dtype == torch.bfloat16),
             _stream())
    LAUNCHES["framed_magnitude"] += 1
    return out


def _launch_filterbank(x, wcos, wsin, fb, hop, eps):
    _check_cuda(x)
    dev = x.device
    xs = _operand(x, "x", 2, dev)
    wc = _operand(wcos, "wcos", 2, dev)
    ws = _operand(wsin, "wsin", 2, dev)
    fb_t = _operand(fb.t(), "fb", 2, dev)  # (F, M)
    if wc.shape != ws.shape or fb_t.shape[0] != wc.shape[0]:
        raise ValueError(
            f"shapes differ: wcos {tuple(wc.shape)}, wsin {tuple(ws.shape)}, "
            f"fb {tuple(fb.shape)}")
    if hop < 1:
        raise ValueError(f"hop must be >= 1, got {hop}")
    b, length = xs.shape
    f, n = wc.shape
    m = fb_t.shape[1]
    t = num_frames(length, n, hop)
    if t < 1:
        raise ValueError(f"signal of {length} samples is shorter than n_fft={n}")
    out = torch.empty((b, m, t), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _run("nnaudio_framed_filterbank", xs.data_ptr(), wc.data_ptr(),
             ws.data_ptr(), fb_t.data_ptr(), out.data_ptr(), b, length, n, hop,
             f, t, m, float(eps), int(xs.dtype == torch.bfloat16), _stream())
    LAUNCHES["framed_filterbank"] += 1
    return out


def _launch_synthesis(spec_re, spec_im, kc, ks, hop):
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
    out = torch.empty((b, n + hop * (t - 1)), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _run("nnaudio_synthesis_ola", sre.data_ptr(), sim.data_ptr(),
             kcs.data_ptr(), kss.data_ptr(), out.data_ptr(), b, f, t, n, hop,
             int(sre.dtype == torch.bfloat16), _stream())
    LAUNCHES["synthesis_ola"] += 1
    return out


class _Magnitude(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wcos, wsin, hop, eps, square):
        return _launch_magnitude(x, wcos, wsin, hop, eps, square)

    @staticmethod
    def backward(ctx, g):
        _no_grad_yet("framed_magnitude")


class _Filterbank(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wcos, wsin, fb, hop, eps):
        return _launch_filterbank(x, wcos, wsin, fb, hop, eps)

    @staticmethod
    def backward(ctx, g):
        _no_grad_yet("framed_filterbank")


class _SynthesisOLA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, spec_re, spec_im, kc, ks, hop):
        return _launch_synthesis(spec_re, spec_im, kc, ks, hop)

    @staticmethod
    def backward(ctx, g):
        _no_grad_yet("synthesis_ola")


# ---------------------------------------------------------------- wrappers --
def framed_magnitude(x, wcos, wsin, hop, eps=0.0, square=False):
    """K1: |STFT| (or |STFT|^2 when ``square``) -> (B, F, T) float32."""
    if x.device.type == "cpu":
        return framed_magnitude_plain(x, wcos, wsin, hop, eps=eps, square=square)
    return _Magnitude.apply(x, wcos, wsin, hop, eps, square)


def framed_filterbank(x, wcos, wsin, fb, hop, eps=0.0):
    """K2: fb @ (|STFT|^2 + eps) -> (B, M, T) float32."""
    if x.device.type == "cpu":
        return framed_filterbank_plain(x, wcos, wsin, fb, hop, eps=eps)
    return _Filterbank.apply(x, wcos, wsin, fb, hop, eps)


def synthesis_ola(spec_re, spec_im, kc, ks, hop):
    """K3: OLA(kc^T Re - ks^T Im) -> (B, N + hop*(T-1)) float32."""
    if spec_re.device.type == "cpu":
        return synthesis_ola_plain(spec_re, spec_im, kc, ks, hop)
    return _SynthesisOLA.apply(spec_re, spec_im, kc, ks, hop)
