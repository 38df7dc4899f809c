"""Deprecated alias of :mod:`nnaudio_tpu_torch.features` (nnAudio keeps its
pre-0.3 import path alive with a warning; so does the JAX package)."""
import warnings

from .features import *  # noqa: F401,F403
from .features import __all__  # noqa: F401

warnings.warn(
    "Spectrogram namespace will be deprecated, please use the features "
    "namespace instead: `from nnaudio_tpu import features`",
    DeprecationWarning,
)
