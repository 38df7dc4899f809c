"""End-to-end models built on the feature transforms."""
from .classifier import SpectrogramClassifier

__all__ = ["SpectrogramClassifier"]
