"""Architecture configs (one module per assigned architecture) + shapes."""

from repro_torch.configs.base import (  # noqa: F401
    ARCH_IDS,
    SHAPES,
    ModelConfig,
    ShapeConfig,
    get_config,
    reduced_config,
    supports_long_context,
)
