"""Model / shape configuration system.

Every assigned architecture gets a ``ModelConfig`` (exact published numbers)
in ``repro/configs/<id>.py`` and registers itself here. Shapes are the four
assigned input-shape cells; ``train_*`` lowers ``train_step`` and
``prefill_*`` / ``decode_*`` / ``long_*`` lower ``serve_step``.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple

__all__ = [
    "ModelConfig",
    "ShapeConfig",
    "SHAPES",
    "ARCH_IDS",
    "get_config",
    "reduced_config",
    "supports_long_context",
]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # --- attention pattern ---
    window: Optional[int] = None        # uniform sliding window (Mistral/Mixtral)
    local_window: Optional[int] = None  # local:global pattern (gemma3)
    global_every: int = 0               # every k-th layer is global (gemma3: 6)
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    # --- SSM (Mamba2) / RWKV ---
    ssm_state: int = 0
    ssm_head_dim: int = 0
    ssm_expand: int = 2
    attn_every: int = 0                 # zamba2: shared attn block cadence
    rwkv: bool = False
    # --- modality frontend stubs ---
    frontend: Optional[str] = None      # siglip | encodec
    num_patches: int = 0
    num_codebooks: int = 0
    # --- misc ---
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5

    # ------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 so the embedding/logits dims
        shard over any mesh axis (granite's 49155 is not divisible by 16)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def ssm_heads(self) -> int:
        if not (self.ssm_state or self.rwkv):
            return 0
        d_inner = self.ssm_expand * self.d_model if not self.rwkv else self.d_model
        return d_inner // self.ssm_head_dim

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer kind: 'attn' | 'mamba' | 'rwkv'. For zamba2, 'mamba'
        everywhere with the shared 'attn' block applied at ``attn_every``
        cadence (handled by the model; kinds list marks those slots)."""
        if self.rwkv:
            return ("rwkv",) * self.num_layers
        if self.family == "hybrid":
            return tuple(
                "mamba+attn" if (i + 1) % self.attn_every == 0 else "mamba"
                for i in range(self.num_layers)
            )
        return ("attn",) * self.num_layers

    def layer_windows(self, seq_len: int) -> Tuple[int, ...]:
        """Effective attention window per layer (seq_len == full/global)."""
        out = []
        for i in range(self.num_layers):
            if self.window is not None:
                out.append(min(self.window, seq_len))
            elif self.local_window is not None and self.global_every:
                is_global = (i + 1) % self.global_every == 0
                out.append(seq_len if is_global else min(self.local_window, seq_len))
            else:
                out.append(seq_len)
        return tuple(out)

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Total parameters (embedding + stacked layers + head)."""
        d, v = self.d_model, self.padded_vocab
        total = v * d  # embedding
        total += v * d  # lm head (untied)
        total += d  # final norm
        per_layer = 0
        kinds = self.layer_kinds()
        n_attn = sum(1 for k in kinds if "attn" in k and self.family != "hybrid")
        n_mamba = sum(1 for k in kinds if "mamba" in k)
        n_rwkv = sum(1 for k in kinds if k == "rwkv")
        attn_params = d * self.num_heads * self.head_dim + 2 * d * self.num_kv_heads * self.head_dim + self.num_heads * self.head_dim * d
        if self.num_experts:
            ffn = self.num_experts * 3 * d * self.d_ff + d * self.num_experts
        else:
            ffn = 3 * d * self.d_ff
        if self.family in ("dense", "moe", "vlm", "audio"):
            per_layer = attn_params + ffn + 2 * d
            total += self.num_layers * per_layer
        elif self.family == "hybrid":
            d_in = self.ssm_expand * d
            mamba = d * (2 * d_in + 2 * self.ssm_state * 1 + self.ssm_heads) + d_in * d + d_in  # in/out proj + dt + conv-ish
            total += n_mamba * (mamba + 2 * d)
            # one SHARED attention block (weights reused at every application)
            total += attn_params + 3 * d * self.d_ff + 2 * d
        elif self.family == "ssm":
            per = d * d * 4 + 3 * d * self.d_ff + 2 * d  # r/k/v/g + channel mix
            total += n_rwkv * per
        if self.frontend == "encodec":
            total += (self.num_codebooks - 1) * v * d  # extra codebook heads
        return int(total)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k experts only)."""
        if not self.num_experts:
            return self.param_count()
        d = self.d_model
        dense_ffn = self.num_experts * 3 * d * self.d_ff
        active_ffn = self.experts_per_token * 3 * d * self.d_ff
        return int(self.param_count() - self.num_layers * (dense_ffn - active_ffn))


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

ARCH_IDS = [
    "mixtral_8x7b",
    "granite_moe_1b_a400m",
    "gemma3_1b",
    "phi3_medium_14b",
    "granite_3_8b",
    "yi_6b",
    "zamba2_2p7b",
    "paligemma_3b",
    "rwkv6_1p6b",
    "musicgen_medium",
]


def get_config(arch: str) -> ModelConfig:
    arch = arch.replace("-", "_").replace(".", "p")
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.CONFIG


def supports_long_context(cfg: ModelConfig) -> bool:
    """long_500k is run only for sub-quadratic archs (SWA / local:global /
    SSM / hybrid); pure full-attention archs skip it (DESIGN.md §6)."""
    return (
        cfg.window is not None
        or cfg.local_window is not None
        or cfg.family in ("ssm", "hybrid")
    )


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """A smoke-test-sized config of the same family: small widths/depths,
    few experts, tiny vocab — runs a real step on one CPU device."""
    return dataclasses.replace(
        cfg,
        num_layers=min(cfg.num_layers, 4 if cfg.family != "hybrid" else 6),
        d_model=128,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads < cfg.num_heads else 4,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        num_experts=min(cfg.num_experts, 4),
        experts_per_token=min(cfg.experts_per_token, 2),
        window=min(cfg.window, 32) if cfg.window else None,
        local_window=min(cfg.local_window, 16) if cfg.local_window else None,
        global_every=cfg.global_every,
        attn_every=3 if cfg.attn_every else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_head_dim=32 if (cfg.ssm_state or cfg.rwkv) else 0,
        num_patches=16 if cfg.num_patches else 0,
    )
