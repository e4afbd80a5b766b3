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
    "Zamba2Config",
    "GraniteHybridConfig",
    "ShapeConfig",
    "SHAPES",
    "ARCH_IDS",
    "PORT_ARCH_IDS",
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
class Zamba2Config(ModelConfig):
    """Zyphra's Zamba2 layout (family ``zamba2``, ``models/zamba2.py``): a
    stack of Mamba2 layers with ``ssm_ngroups`` groups of B and C and a
    depthwise conv with bias over x, B and C; before the Mamba2 of each
    layer in ``hybrid_layer_ids`` one of ``num_mem_blocks`` shared
    attention+MLP blocks, taken in turn, runs over the concatenation of the
    hidden stream and the embedding (width ``2 * d_model``; ``num_heads``
    of ``head_dim``, logits scaled by ``(head_dim / 2) ** -0.5``), with a
    gelu MLP of width ``d_ff``, a rank-``adapter_rank`` adapter on the MLP's
    gate/up projection for each use and a ``d_model`` linear a use. The
    embedding is tied to the LM head."""

    hybrid_layer_ids: Tuple[int, ...] = ()
    num_mem_blocks: int = 2
    adapter_rank: int = 0
    ssm_ngroups: int = 1

    @property
    def attn_width(self) -> int:
        """The shared block's input: the hidden stream and the embedding."""
        return 2 * self.d_model

    @property
    def attn_scale(self) -> float:
        return (self.head_dim / 2) ** -0.5

    @property
    def ssm_conv_dim(self) -> int:
        """Channels of the depthwise conv: x, then B and C of every group."""
        return self.ssm_expand * self.d_model + 2 * self.ssm_ngroups * self.ssm_state

    def layer_kinds(self) -> Tuple[str, ...]:
        ids = set(self.hybrid_layer_ids)
        return tuple("mamba+attn" if i in ids else "mamba" for i in range(self.num_layers))

    def param_count(self) -> int:
        d, d_in, h, f = self.d_model, self.ssm_expand * self.d_model, self.ssm_heads, self.d_ff
        conv, attn = self.ssm_conv_dim, self.num_heads * self.head_dim
        mamba = (d * (d_in + conv + h) + 4 * conv + conv + 3 * h + d_in + d_in * d + d)
        block = (2 * d + self.attn_width * 3 * attn + attn * d + d + d * 2 * f + f * d)
        use = self.adapter_rank * (d + 2 * f) + d * d
        return int(self.padded_vocab * d + d + self.num_layers * mamba
                   + self.num_mem_blocks * block + len(self.hybrid_layer_ids) * use)


@dataclasses.dataclass(frozen=True)
class GraniteHybridConfig(ModelConfig):
    """IBM's Granite 4.0-H layout (family ``granite_hybrid``,
    ``models/granite_hybrid.py``): each layer of ``layer_types`` mixes by
    Mamba2 (``ssm_ngroups`` groups of B and C, a depthwise conv with bias,
    a gated RMSNorm over each group) or by grouped-query attention with no
    positional encoding (logits scaled by ``attention_multiplier``), then
    runs a mixture of ``num_experts`` SwiGLU experts of width ``d_ff``, the
    top ``experts_per_token`` of each token weighted by the softmax of their
    router logits, beside a shared SwiGLU expert of width ``shared_d_ff``.
    Each branch enters the hidden stream times ``residual_multiplier``; the
    embedding is scaled by ``embedding_multiplier`` and tied to the LM head,
    whose logits are divided by ``logits_scaling``."""

    layer_types: Tuple[str, ...] = ()  # "mamba" | "attention", one a layer
    shared_d_ff: int = 0
    ssm_ngroups: int = 1
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0
    attention_multiplier: float = 1.0

    @property
    def ssm_conv_dim(self) -> int:
        """Channels of the depthwise conv: x, then B and C of every group."""
        return self.ssm_expand * self.d_model + 2 * self.ssm_ngroups * self.ssm_state

    def layer_kinds(self) -> Tuple[str, ...]:
        return tuple("attn" if t == "attention" else "mamba" for t in self.layer_types)

    def param_count(self) -> int:
        """Every leaf: the tied embedding, the final norm, each layer's two
        norms, its mixer (Mamba2: projections, conv taps and bias, dt bias,
        A, D, the gated norm; attention: q, k, v, o) and its MoE (router,
        experts, shared expert)."""
        d, d_in = self.d_model, self.ssm_expand * self.d_model
        h, conv = self.ssm_heads, self.ssm_conv_dim
        mamba = d * (d_in + conv + h) + 4 * conv + conv + 3 * h + d_in + d_in * d
        attn = 2 * d * self.num_heads * self.head_dim + 2 * d * self.num_kv_heads * self.head_dim
        moe = d * self.num_experts + self.num_experts * 3 * d * self.d_ff + 3 * d * self.shared_d_ff
        kinds = self.layer_kinds()
        return int(self.padded_vocab * d + d + self.num_layers * (2 * d + moe)
                   + kinds.count("mamba") * mamba + kinds.count("attn") * attn)


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


# architectures of the port alone: the JAX package has no counterpart, and
# ARCH_IDS stays equal to its list
PORT_ARCH_IDS = [
    "zamba2_7b",
    "granite_4_0_h_small",
]


def get_config(arch: str) -> ModelConfig:
    arch = arch.replace("-", "_").replace(".", "p")
    if arch not in ARCH_IDS + PORT_ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS + PORT_ARCH_IDS}")
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
    few experts, tiny vocab — runs a real step on one CPU device. A Zamba2
    keeps two shared blocks alternating over three uses, its adapters, two
    SSM groups and the concatenated embedding; a Granite 4.0-H one period of
    its layer pattern (ten layers, one of them attention), 8 experts, top 3
    and its shared expert."""
    if isinstance(cfg, GraniteHybridConfig):
        return dataclasses.replace(
            cfg, num_layers=10, layer_types=cfg.layer_types[:10], d_model=64, num_heads=4,
            num_kv_heads=2, head_dim=16, d_ff=32, shared_d_ff=64, vocab_size=256, ssm_state=16,
            ssm_head_dim=16, num_experts=8, experts_per_token=3)
    if isinstance(cfg, Zamba2Config):
        return dataclasses.replace(
            cfg, num_layers=8, d_model=64, num_heads=4, num_kv_heads=4, head_dim=32, d_ff=128,
            vocab_size=256, ssm_state=16, ssm_head_dim=16, hybrid_layer_ids=(1, 4, 6),
            adapter_rank=8, ssm_ngroups=2)
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
