"""Gradient compression for data parallelism: the wire format of the JAX
package's ``repro.optim.grad_compression`` (bf16, or int8 with one scale
for the tensor), simulated on one device.

Only :func:`compress_decompress` is ported. The reference's
``compressed_psum`` and ``make_dp_grad_reducer`` all-reduce inside a
``shard_map`` over a device mesh; the port runs on one device and has no
mesh yet (``dist/sharding.py`` is not ported), so they come with it.
"""

from __future__ import annotations

import torch

__all__ = ["compress_decompress"]


def compress_decompress(g: torch.Tensor, scheme: str = "bf16") -> torch.Tensor:
    """``g`` through the wire format and back, in ``g``'s dtype. int8
    rounds half to even (``torch.round``, as ``jnp.round``)."""
    if scheme == "bf16":
        return g.to(torch.bfloat16).to(g.dtype)
    if scheme == "int8":
        scale = torch.max(torch.abs(g)) / 127.0 + 1e-12
        q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
        return q.to(g.dtype) * scale
    raise ValueError(scheme)
