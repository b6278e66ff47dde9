"""The token pipeline (the port's copy of ``repro/data``)."""
from .pipeline import DataConfig, TokenPipeline

__all__ = ["DataConfig", "TokenPipeline"]
