"""Deterministic synthetic data pipeline."""
from repro_torch.data.pipeline import TokenPipeline  # noqa: F401
