"""Optimizers + schedules (AdamW over fp32 master weights)."""

from repro_torch.optim.adamw import (  # noqa: F401
    OptConfig,
    adamw_init,
    adamw_update,
    global_norm,
    schedule,
)
