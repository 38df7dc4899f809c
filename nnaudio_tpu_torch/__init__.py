"""nnaudio_tpu_torch: the PyTorch / CUDA port of nnaudio_tpu for NVIDIA Hopper.

Same public names, constructor arguments, output shapes and state keys as
the JAX package; the Pallas TPU kernels become hand-written CUDA kernels
(``csrc/``), built with ``nvcc`` at first use. Entry points run on CUDA
unless the caller passes ``device="cpu"``. This package never imports JAX or
``nnaudio_tpu``.
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
           "set_use_mxu_fft", "set_use_parallel_chain"]
