"""Run a function on every rank of a ``torch.distributed`` gloo world on
the CPU: the port's multi-rank tests use it as the JAX package's tests use
host devices.

``run_ranks(fn, world, *args)`` spawns ``world`` processes on 127.0.0.1
(a free port), calls ``fn(rank, world, *args)`` in each after starting the
process group, and returns the ranks' results in rank order. A rank that
raises, or a world that outlives ``timeout`` seconds, fails the call, and
every process is stopped before it returns. ``fn`` must be importable by
name (a module-level function): spawned ranks import its module afresh,
so a test module that holds one imports JAX inside its tests only.
"""

import multiprocessing
import os
import queue
import socket
import time
import traceback


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world, port, out, args):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)  # the ranks share the machine's cores
    try:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=world)
        out.put((rank, True, fn(rank, world, *args)))
    except BaseException:  # reported to the parent, which fails the test
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world: int, *args, timeout: float = 120.0):
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    env = {"OMP_NUM_THREADS": "1"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        procs = [ctx.Process(target=_rank_main, args=(fn, r, world, port, out, args), daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    results = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world:
            try:
                rank, ok, value = out.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} exited {procs[dead[0]].exitcode} "
                                       "without a result") from None
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks did not finish within {timeout} s") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            results[rank] = value
    finally:
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 5.0))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return [results[r] for r in range(world)]
