"""Deterministic synthetic token streams (`pipeline`)."""
from .pipeline import DataConfig, Prefetcher, TokenPipeline

__all__ = ["DataConfig", "TokenPipeline", "Prefetcher"]
