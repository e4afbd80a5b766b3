"""AdamW with global-norm clipping, functional: the JAX package's
``repro.optim.adamw`` over nested dicts of tensors.

Optimizer states mirror the parameter tree (fp32 moments ``m`` and ``v``,
an int32 step ``count``). Leaves are walked in the JAX package's order
(:mod:`repro_torch.tree`), the arithmetic is fp32 throughout (the bias
corrections ``b ** count`` and the schedule's cosine as well, as JAX
computes them on float32 arrays), and :func:`adamw_update` returns new
trees: nothing is updated in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch import tree as tree_mod

__all__ = ["OptConfig", "adamw_init", "adamw_update", "global_norm", "schedule"]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup → cosine decay to min_lr_ratio; fp32, on ``step``'s
    device."""
    step = step.to(torch.float32)
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    frac = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0
    )
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def adamw_init(params: Any) -> Dict[str, Any]:
    """Zero moments in fp32 beside each parameter, and a zero int32 count on
    the parameters' device."""
    zeros = lambda t: tree_mod.tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32), t)
    device = tree_mod.leaves(params)[0].device
    return {"m": zeros(params), "v": zeros(params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree_mod.leaves(tree)))


@torch.no_grad()
def adamw_update(
    grads: Any, state: Dict[str, Any], params: Any, cfg: OptConfig
) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One step: returns (new params, new state, {"grad_norm", "lr"})."""
    count = state["count"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9), 1.0)
    lr = schedule(cfg, count)
    b1c = 1.0 - cfg.b1 ** count.to(torch.float32)
    b2c = 1.0 - cfg.b2 ** count.to(torch.float32)

    def upd(g, m, v, p):
        g = g.float() * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        mh = m / b1c
        vh = v / b2c
        step = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p
        return p - lr * step, m, v

    new = [upd(*leaf) for leaf in zip(*(tree_mod.leaves(t) for t in
                                          (grads, state["m"], state["v"], params)))]
    unflat = lambda i: tree_mod.unflatten(grads, [n[i] for n in new])
    metrics = {"grad_norm": gnorm, "lr": lr}
    return unflat(0), {"m": unflat(1), "v": unflat(2), "count": count}, metrics
