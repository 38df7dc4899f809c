"""End-to-end models built on the feature transforms."""
from .classifier import SpectrogramClassifier, train_step

__all__ = ["SpectrogramClassifier", "train_step"]
