"""Data pipelines (deterministic, resumable, host-sharded)."""

from repro_torch.data.pipeline import TokenPipeline  # noqa: F401
