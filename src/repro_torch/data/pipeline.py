"""Deterministic, resumable, sharded synthetic token pipeline.

Each host materialises only its shard of the global batch (host-sharded
data parallelism); the stream is a counter-based PRNG so that (a) any step's
batch can be regenerated exactly from ``step`` alone — restart-safe without
buffering — and (b) no two hosts ever duplicate data. ``state()`` /
``restore()`` round-trip through the checkpoint manifest.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig

__all__ = ["TokenPipeline"]


@dataclasses.dataclass
class TokenPipeline:
    cfg: ModelConfig
    shape: ShapeConfig
    host_id: int = 0
    n_hosts: int = 1
    seed: int = 0
    step: int = 0
    prefetch: int = 2

    def __post_init__(self):
        if self.shape.global_batch % self.n_hosts:
            raise ValueError("global_batch must divide across hosts")
        self.host_batch = self.shape.global_batch // self.n_hosts

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id])
        )

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = self._rng(step)
        b, s = self.host_batch, self.shape.seq_len
        cfg = self.cfg
        if cfg.family == "audio":
            return {
                "frame_embeds": rng.normal(0, 1, (b, s, cfg.d_model)).astype(np.float32),
                "labels": rng.integers(0, cfg.vocab_size, (b, s, cfg.num_codebooks)).astype(np.int32),
            }
        if cfg.family == "vlm":
            st = s - cfg.num_patches
            return {
                "patch_embeds": rng.normal(0, 1, (b, cfg.num_patches, cfg.d_model)).astype(np.float32),
                "tokens": rng.integers(0, cfg.vocab_size, (b, st)).astype(np.int32),
                "labels": rng.integers(0, cfg.vocab_size, (b, st)).astype(np.int32),
            }
        toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.batch_at(self.step)
            self.step += 1

    # checkpointable iterator state
    def state(self) -> Dict[str, Any]:
        return {"step": self.step, "seed": self.seed, "host_id": self.host_id}

    def restore(self, state: Dict[str, Any]) -> None:
        self.step = int(state["step"])
        self.seed = int(state["seed"])
