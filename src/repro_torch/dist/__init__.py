"""Distributed execution on ``torch.distributed``: the mesh-aware sharding
layer that every model forward, launcher and the elastic runtime share, as
the JAX package's ``repro.dist``."""

from repro_torch.dist.sharding import (  # noqa: F401
    AbstractMesh,
    NamedSharding,
    P,
    ParallelCtx,
    cache_shardings,
    constrain_hidden,
    constrain_qkv,
    input_shardings,
    make_ctx,
    param_shardings,
    placements,
    shard_map_compat,
)
