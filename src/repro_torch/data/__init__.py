"""Training data: the seekable synthetic token pipeline."""

from .pipeline import DataConfig, SyntheticTokenPipeline

__all__ = ["DataConfig", "SyntheticTokenPipeline"]
