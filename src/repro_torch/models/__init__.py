"""Model zoo: layer library + models built from a config (RWKV-6 and Zamba2 so far)."""

from repro_torch.models.model import (  # noqa: F401
    decode_step,
    init_cache,
    init_params,
    params_from_jax,
    prefill,
)
