"""nnaudio_tpu_torch: the PyTorch / CUDA port of nnaudio_tpu for NVIDIA Hopper.

Same public names, constructor arguments, output shapes and state keys as
the JAX package; the Pallas TPU kernels become hand-written CUDA kernels
(``csrc/``), built with ``nvcc`` at first use. Entry points run on CUDA
unless the caller passes ``device="cpu"``. This package never imports JAX or
``nnaudio_tpu``. ``streaming``, ``parallel``, ``utils``, ``Spectrogram``,
``filters``, ``core`` and ``ops`` load on first use, so importing the package
stays light (``torch.distributed`` loads with ``parallel``).
"""

__version__ = "0.1.0"

from . import config
from .config import (fast_mode, set_matmul_precision, set_use_fused_pyramid,
                     set_use_kernels, set_use_kernels_analysis,
                     set_use_kernels_synthesis, set_use_mxu_fft,
                     set_use_pallas, set_use_pallas_analysis,
                     set_use_pallas_synthesis, set_use_parallel_chain)
from . import features, interop, models

__all__ = ["config", "features", "interop", "models", "fast_mode",
           "set_matmul_precision", "set_use_kernels",
           "set_use_kernels_analysis", "set_use_kernels_synthesis",
           "set_use_pallas", "set_use_pallas_analysis",
           "set_use_pallas_synthesis", "set_use_fused_pyramid",
           "set_use_mxu_fft", "set_use_parallel_chain", "streaming"]


def __getattr__(name):
    if name in ("filters", "core", "ops", "parallel", "utils", "streaming", "Spectrogram"):
        import importlib

        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
