"""Fault-tolerant checkpointing (atomic, async, device-agnostic restore)."""

from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: F401
