"""Global numerics / execution configuration of the PyTorch port.

Mirrors ``nnaudio_tpu.config``: the same precision modes and kernel
switches, with the Pallas switches renamed to the port's hand-written
kernels, and the fused-pyramid, MXU-FFT and parallel-chain switches that
``ops/pyramid``, the CQT/VQT pyramid's decimation chain and CFP read. Those
three are ``None`` (auto) by default, and auto means off until an H100 A/B
says otherwise; ``True`` and ``False`` force them.

- ``highest``: fp32 operands, fp32 accumulation (TF32 off for plain matmuls).
- ``default`` (``fast_mode()``): bf16 operand storage, fp32 accumulation.
- ``tensorfloat32``: TF32 for plain matmuls; the kernels store fp32.

In the kernels: the magnitude (K1), the filterbank (K2), the synthesis (K3),
the Griffin-Lim step (K4), the pair (K5) and the split-K magnitude (K6) run
on the tensor cores. With fp32 storage (``highest`` and ``tensorfloat32``)
they take three TF32 products of operands split into a high and a low TF32
part and accumulate in fp32, which keeps fp32 accuracy; with bf16 storage
(``default``) one bf16 tensor-core product with fp32 accumulation (K2 also
rounds the power to bf16 for its projection).

There is no jit cache to salt and no backend probe: PyTorch runs eagerly and
dispatch keys on the device of the tensor it is given.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch

PRECISIONS = ("highest", "default", "tensorfloat32")


@dataclass
class _Config:
    # "highest" (fp32 parity, default), "default" (bf16 fast mode) or
    # "tensorfloat32"
    matmul_precision: str = "highest"
    # Master switch for the hand-written CUDA kernels (ops/framed_kernels.py).
    use_kernels: bool = True
    # Analysis kernels (magnitude / power / filterbank epilogues). None =
    # auto = the kernel for CUDA tensors. False selects the plain version.
    use_kernels_analysis: bool | None = None
    # Synthesis + overlap-add kernel (iSTFT). None = auto = the kernel for
    # CUDA tensors. False selects the plain version.
    use_kernels_synthesis: bool | None = None
    # CQT2010 / CQT2010v2 / VQT: every octave's projections in one batched
    # matmul (ops/pyramid.py) instead of the per-octave loop. None = auto =
    # off until an H100 A/B (chip_smoke.py path (p)); True forces it on.
    use_fused_pyramid: bool | None = None
    # CFP's interior real FFTs as matmul stages (ops/mxu_fft.py) instead of
    # torch.fft.rfft. None = auto = off until an H100 A/B; True forces it on.
    use_mxu_fft: bool | None = None
    # The pyramid's decimation chain with every level computed from the
    # top-rate signal through a composed cascade filter
    # (core/resample.compose_cascade) instead of the serial lowpass +
    # decimate per octave. None = auto = off until an H100 A/B (chip_smoke.py
    # path (p)); True forces it on.
    use_parallel_chain: bool | None = None


_config = _Config()


def get_config() -> _Config:
    return _config


def set_matmul_precision(mode: str) -> None:
    if mode not in PRECISIONS:
        raise ValueError(f"unknown matmul precision {mode!r}")
    _config.matmul_precision = mode


def set_use_kernels(flag: bool) -> None:
    _config.use_kernels = bool(flag)


def set_use_kernels_analysis(flag: bool | None) -> None:
    _config.use_kernels_analysis = flag if flag is None else bool(flag)


def set_use_kernels_synthesis(flag: bool | None) -> None:
    _config.use_kernels_synthesis = flag if flag is None else bool(flag)


def set_use_fused_pyramid(flag: bool | None) -> None:
    _config.use_fused_pyramid = flag if flag is None else bool(flag)


def set_use_mxu_fft(flag: bool | None) -> None:
    _config.use_mxu_fft = flag if flag is None else bool(flag)


def set_use_parallel_chain(flag: bool | None) -> None:
    _config.use_parallel_chain = flag if flag is None else bool(flag)


def parallel_chain_enabled() -> bool:
    """Whether the pyramid takes the parallel decimation chain (auto: off)."""
    return bool(_config.use_parallel_chain)


# the JAX package's names for the kernel switches
set_use_pallas = set_use_kernels
set_use_pallas_analysis = set_use_kernels_analysis
set_use_pallas_synthesis = set_use_kernels_synthesis


@contextlib.contextmanager
def fast_mode():
    """Context: bf16 operand storage with fp32 accumulation."""
    prev = _config.matmul_precision
    _config.matmul_precision = "default"
    try:
        yield
    finally:
        _config.matmul_precision = prev


def analysis_kernel_enabled() -> bool:
    """Whether the analysis ops launch their kernel for a CUDA tensor."""
    flag = _config.use_kernels_analysis
    return _config.use_kernels and (flag is None or flag)


def synthesis_kernel_enabled() -> bool:
    """Whether ``synthesis_ola`` launches its kernel for a CUDA tensor."""
    flag = _config.use_kernels_synthesis
    return _config.use_kernels and (flag is None or flag)


def storage_dtype() -> torch.dtype:
    """Operand storage type of the kernels in the current precision mode."""
    return torch.bfloat16 if _config.matmul_precision == "default" else torch.float32


@contextlib.contextmanager
def matmul_numerics():
    """Plain-path matmul and convolution numerics for the current precision
    mode: fp32 (TF32 off, for cuBLAS and for cuDNN, whose fp32 convolutions
    run in TF32 by default) in ``highest``, TF32 in ``tensorfloat32``, and,
    in ``default``, fp32 products on operands the caller rounded to bf16."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    tf32 = _config.matmul_precision == "tensorfloat32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def resolve_device(device) -> torch.device:
    """Entry points run on CUDA unless the caller passes ``device="cpu"``;
    without CUDA and without an explicit device they raise instead of
    quietly running on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "nnaudio_tpu_torch runs on CUDA by default and no CUDA device "
                "is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def round_to_storage(t: torch.Tensor) -> torch.Tensor:
    """Round a float32 operand to the kernels' storage type and back, so a
    plain matmul in fp32 sees exactly what a kernel reads (bf16 in
    ``default`` mode; unchanged otherwise)."""
    if _config.matmul_precision == "default":
        return t.to(torch.bfloat16).float()
    return t
