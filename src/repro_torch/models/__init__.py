"""Model zoo: layer library + models built from a config: every family of the JAX package."""

from repro_torch.models.model import (  # noqa: F401
    decode_attention_calls,
    decode_moe_calls,
    decode_step,
    decoder,
    forward_train,
    init_cache,
    init_params,
    params_from_jax,
    prefill,
)
