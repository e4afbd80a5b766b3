"""The port's compressed gradient reduction (``compressed_psum``,
``make_dp_grad_reducer``) over 8 gloo ranks on the CPU, each rank with its
own seeded gradient, against the JAX package's ``compressed_psum`` inside a
``shard_map`` over 8 host devices (a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=8``, as the JAX tests
run theirs). int8 is held equal exactly; bf16 within one bf16 rounding of
the sum. JAX is imported in the subprocess only: the spawned ranks import
this module.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import torch

from torch_dist_ranks import run_ranks

ROOT = pathlib.Path(__file__).resolve().parents[1]
N, WORLD = 1000, 8


def _grad(rank: int) -> np.ndarray:
    return np.random.default_rng(100 + rank).normal(0, 1e-2, (N,)).astype(np.float32)


JAX_SCRIPT = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.dist.sharding import shard_map_compat
from repro.launch.mesh import make_mesh_from_devices
from repro.optim.grad_compression import compressed_psum

n, world = int(sys.argv[1]), int(sys.argv[2])
g = np.stack([np.random.default_rng(100 + r).normal(0, 1e-2, (n,)).astype(np.float32)
              for r in range(world)])
mesh = make_mesh_from_devices((world,), ("data",))
x = jax.device_put(jnp.asarray(g), NamedSharding(mesh, P("data", None)))
out = {}
for scheme in ("bf16", "int8"):
    f = shard_map_compat(lambda t: compressed_psum(t[0], "data", scheme)[None], mesh=mesh,
                         in_specs=P("data", None), out_specs=P("data", None))
    res = np.asarray(jax.jit(f)(x))
    assert all(np.array_equal(res[0], r) for r in res), "every device holds the sum"
    out[scheme] = res[0].tolist()
print(json.dumps(out))
"""


def _jax_sums():
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", JAX_SCRIPT, str(N), str(WORLD)],
                          capture_output=True, text=True, timeout=120, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def _reduce_on_ranks(rank, world):
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.dist.sharding import P, shard_map_compat
    from repro_torch.launch.mesh import make_mesh_from_devices
    from repro_torch.optim.grad_compression import (compress_decompress, compressed_psum,
                                                    make_dp_grad_reducer)

    g = torch.from_numpy(_grad(rank))
    mesh = make_mesh_from_devices((world,), ("data",))
    out = {}
    for scheme in ("bf16", "int8"):
        # compressed_psum on each rank's own local tensor, inside local_map
        summed = shard_map_compat(lambda t: compressed_psum(t, (mesh, "data"), scheme), mesh=mesh,
                                  in_specs=P(None), out_specs=P(None))(g)
        out[scheme] = summed.to_local().numpy()
        # the reducer: a plain leaf is this rank's gradient -> the mean over data
        mean = make_dp_grad_reducer(mesh, ("data",), scheme)({"w": g})["w"]
        out[scheme + "_mean"] = mean.numpy()
        # a replicated DTensor leaf: every rank holds the same gradient, whose
        # mean is that gradient through the wire format
        same = distribute_tensor(torch.from_numpy(_grad(0)), mesh, [Replicate()])
        red = make_dp_grad_reducer(mesh, ("data",), scheme)({"w": same})["w"]
        out[scheme + "_same"] = bool(torch.equal(red.to_local(),
                                                 compress_decompress(same.to_local(), scheme)))
        out[scheme + "_same_placements"] = [repr(p) for p in red.placements]
    return out


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at ``x`` (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


def test_compressed_psum_over_8_ranks_matches_jax():
    want = _jax_sums()
    ranks = run_ranks(_reduce_on_ranks, WORLD, timeout=120)
    r0 = ranks[0]
    for r in ranks:
        for scheme in ("bf16", "int8"):
            np.testing.assert_array_equal(r[scheme], r0[scheme])  # every rank holds the sum
    # int8: one shared scale, an exact int32 sum: equal
    np.testing.assert_array_equal(r0["int8"], want["int8"])
    # bf16: the bf16 sum's order is the backend's; within one bf16 rounding
    exact = sum(torch.from_numpy(_grad(r)).to(torch.bfloat16).double() for r in range(WORLD))
    exact = exact.numpy()
    assert np.all(np.abs(r0["bf16"] - want["bf16"]) <= _bf16_ulp(exact))
    assert np.all(np.abs(r0["bf16"] - exact) <= _bf16_ulp(exact))
    # the reducer's mean is the sum over the 8 data ranks, divided by 8
    np.testing.assert_array_equal(r0["int8_mean"], want["int8"] / WORLD)
    np.testing.assert_array_equal(r0["bf16_mean"], r0["bf16"] / WORLD)
    for scheme in ("bf16", "int8"):
        assert r0[scheme + "_same"], scheme
        assert r0[scheme + "_same_placements"] == ["Replicate()"]
