"""The training data pipeline."""
from .pipeline import DataConfig, Pipeline, make_pipeline  # noqa: F401
