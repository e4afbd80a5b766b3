"""The reference's tests/test_rpc_fastpath.py re-targeted at ``repro_torch`` (the
import root renamed; the study generator is ``test_torch_study_gen``).

The process backend's fast-path mechanisms (DESIGN.md §14).

The four flag-gated optimizations — batched control-plane frames, warm
plan caches, shared-memory result handoff, async store commits — are
transport optimizations, never approximations. This suite pins the claims
the conformance suite (`tests/test_worker_backend.py`, which runs with all
flags at their shipping defaults) does not isolate:

* the ``"process[...]"`` flag-spec grammar (`process_flag_kwargs`);
* the shm codec round-trips arbitrary array trees **bit-identically**
  (dtype, shape, bytes) and refuses — returns None, never corrupts —
  anything only pickle can carry;
* batched frames change framing, not settlement: exactly-once callbacks
  across batch boundaries, with batching provably exercised;
* a SIGKILLed worker holding a mid-batch backlog loses nothing — its
  inflight leases re-enqueue to survivors and the store is never torn;
* ``barrier()`` is the async-commit durability point: after ``drain()``,
  a FRESH store mount on the directory resolves every committed key.

Helpers are module-level so they pickle across the spawn boundary.
"""

import os
import pathlib
import random
import signal
import threading
import time

import numpy as np
import pytest

from repro_torch.engine import execute_study, plan_study
from repro_torch.runtime import Manager, ProcessRpcBackend, WorkItem
from repro_torch.runtime.storage import SharedStore
from repro_torch.runtime.transport import process_flag_kwargs, shm_decode, shm_encode

from test_torch_study_gen import (
    mix_study_build,
    random_layout,
    random_param_sets,
    workflow_from_layout,
)

pytestmark = pytest.mark.filterwarnings("ignore::ResourceWarning")


# ---------------------------------------------------------------------------
# Spawn-picklable task functions
# ---------------------------------------------------------------------------


def _quick(tag):
    return f"q-{tag}"


def _array_of(seed):
    # deterministic array payload: exercises shm/inline staging end to end
    return {"x": np.random.default_rng(seed).standard_normal((8, 8)), "seed": seed}


def _hang_until_killed(marker_dir):
    marker = pathlib.Path(marker_dir) / "pid"
    if not marker.exists():
        marker.write_text(str(os.getpid()))
        time.sleep(60.0)
        return "hung"
    return "fast"


def _mk(tmp_path, n_workers=2, *, backend_kwargs=None, **mgr_kwargs):
    mgr = Manager(
        backend=ProcessRpcBackend(
            store_dir=str(tmp_path / "store"),
            heartbeat_interval=0.05,
            **(backend_kwargs or {}),
        ),
        **mgr_kwargs,
    )
    mgr.start(n_workers)
    return mgr


# ---------------------------------------------------------------------------
# Flag-spec grammar
# ---------------------------------------------------------------------------


def test_flag_spec_defaults_all_on():
    # bare "process" adds nothing: the constructor defaults (all ON) rule
    assert process_flag_kwargs("process") == {}
    assert process_flag_kwargs("process[]") == {}
    assert process_flag_kwargs("process[all]") == {
        "batch_frames": True,
        "warm_plans": True,
        "shm_results": True,
        "async_commit": True,
    }


def test_flag_spec_none_and_single_enables():
    none = process_flag_kwargs("process[none]")
    assert none == {
        "batch_frames": False,
        "warm_plans": False,
        "shm_results": False,
        "async_commit": False,
    }
    only_batch = process_flag_kwargs("process[none,batch]")
    assert only_batch["batch_frames"] is True
    assert not (
        only_batch["warm_plans"]
        or only_batch["shm_results"]
        or only_batch["async_commit"]
    )


def test_flag_spec_minus_disables_and_tunables_parse():
    kw = process_flag_kwargs("process[-async,max_batch=4,max_delay_ms=0.5]")
    assert kw["async_commit"] is False
    # untouched flags stay on the constructor defaults (absent = ON)
    assert "batch_frames" not in kw and "warm_plans" not in kw
    assert kw["max_batch"] == 4 and type(kw["max_batch"]) is int
    assert kw["max_delay_ms"] == 0.5
    assert process_flag_kwargs("process[shm_max_bytes=1024]")["shm_max_bytes"] == 1024


def test_flag_spec_rejects_unknown_tokens():
    for bad in ("process[turbo]", "process[-nope]", "process[max_batch=x]",
                "process[unknown=1]", "thread"):
        with pytest.raises(ValueError):
            process_flag_kwargs(bad)


# ---------------------------------------------------------------------------
# shm codec: bit-identical round trips, safe refusals
# ---------------------------------------------------------------------------

_DTYPES = ["f4", "f8", "i4", "i8", "u1", "b1", "c8"]


def _random_tree(rng, depth=0):
    roll = rng.random()
    if depth >= 2 or roll < 0.45:
        dt = np.dtype(rng.choice(_DTYPES))
        shape = tuple(rng.randint(0, 4) for _ in range(rng.randint(0, 3)))
        a = np.asarray(np.random.default_rng(rng.randint(0, 10**9)).random(shape))
        # 0-d stays a true ndarray: the codec (like the npz store path)
        # canonicalises numpy scalars to 0-d arrays, so feed it arrays
        return np.asarray((a * 100).astype(dt))
    if roll < 0.6:
        return rng.choice([None, True, 7, -1.5, "s", b"b", 2 + 3j, np.float64(0.1)])
    if roll < 0.75:
        return [_random_tree(rng, depth + 1) for _ in range(rng.randint(0, 3))]
    if roll < 0.9:
        return tuple(_random_tree(rng, depth + 1) for _ in range(rng.randint(0, 3)))
    return {
        rng.choice(["k", 3, (1, "t"), b"kb"]): _random_tree(rng, depth + 1)
        for _ in range(rng.randint(0, 3))
    }


def _trees_identical(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (
            isinstance(a, np.ndarray)
            and isinstance(b, np.ndarray)
            and a.dtype == b.dtype
            and a.shape == b.shape
            and a.tobytes() == b.tobytes()  # bit-level, nan-proof
        )
    if isinstance(a, dict):
        return (
            isinstance(b, dict)
            and a.keys() == b.keys()
            and all(_trees_identical(a[k], b[k]) for k in a)
        )
    if isinstance(a, (list, tuple)):
        return (
            type(a) is type(b)
            and len(a) == len(b)
            and all(_trees_identical(x, y) for x, y in zip(a, b))
        )
    return type(a) is type(b) and a == b


def test_shm_roundtrip_property_bit_identical():
    rng = random.Random(1406)
    done = 0
    for i in range(40):
        tree = {"root": _random_tree(rng), "pin": np.arange(6, dtype=np.int32)}
        desc = shm_encode(tree, f"rtf_test_rt_{os.getpid()}_{i}", max_bytes=1 << 20)
        assert desc is not None  # "pin" guarantees an array leaf
        out = shm_decode(desc)
        assert _trees_identical(out, tree)
        done += 1
    assert done == 40


def test_shm_roundtrip_nan_inf_and_dtype_extremes():
    tree = {
        "nan": np.array([np.nan, -np.inf, np.inf, 0.0]),
        "big": np.array([2**62], dtype=np.int64),
        "empty": np.empty((0, 3), dtype=np.float32),
        "scalar0d": np.array(3.5, dtype=np.float16),
    }
    desc = shm_encode(tree, f"rtf_test_edge_{os.getpid()}", max_bytes=1 << 20)
    out = shm_decode(desc)
    assert _trees_identical(out, tree)


def test_shm_decode_unlinks_the_segment():
    from multiprocessing import shared_memory

    name = f"rtf_test_unlink_{os.getpid()}"
    desc = shm_encode({"a": np.ones(4)}, name, max_bytes=1 << 20)
    assert desc is not None
    shm_decode(desc)
    with pytest.raises(FileNotFoundError):
        shared_memory.SharedMemory(name=name)


def test_shm_refuses_what_only_pickle_can_carry():
    name = f"rtf_test_refuse_{os.getpid()}"
    # object dtype, custom objects, structured dtypes: fall back (None)
    assert shm_encode({"o": np.array([{"x": 1}], dtype=object)}, name,
                      max_bytes=1 << 20) is None
    assert shm_encode({"f": lambda: 0}, name, max_bytes=1 << 20) is None
    assert shm_encode(
        {"s": np.zeros(2, dtype=np.dtype([("x", "i4")]))}, name, max_bytes=1 << 20
    ) is None
    # no arrays at all: the frame itself is cheaper
    assert shm_encode({"n": 1, "s": "x"}, name, max_bytes=1 << 20) is None
    # over budget: fall back rather than fill /dev/shm
    assert shm_encode({"a": np.zeros(1024)}, name, max_bytes=64) is None
    # and none of the refusals may leak a segment
    from multiprocessing import shared_memory

    with pytest.raises(FileNotFoundError):
        shared_memory.SharedMemory(name=name)


# ---------------------------------------------------------------------------
# Batched frames: framing changes, settlement does not
# ---------------------------------------------------------------------------


def test_batch_boundary_exactly_once_callbacks(tmp_path):
    """30 tasks through 2 workers with max_batch=4: leases and completions
    cross in multi-entry frames, yet every callback fires exactly once with
    the right value — batching is invisible to the lease table."""
    calls = {}
    lock = threading.Lock()

    def cb(key, value):
        with lock:
            calls.setdefault(key, []).append(value)

    mgr = _mk(
        tmp_path, 2,
        backend_kwargs={"max_batch": 4, "max_delay_ms": 1.0},
        enable_backup_tasks=False,
    )
    try:
        for i in range(30):
            mgr.submit(
                WorkItem(key=f"k{i}", spec=("call", _quick, (i,), {}), callback=cb)
            )
        mgr.drain()
        out = mgr.results()
        for i in range(30):
            assert out[f"k{i}"] == f"q-{i}"
            assert calls[f"k{i}"] == [f"q-{i}"], "callback not exactly-once"
        stats = mgr.backend.stats()
        assert stats["leader"]["lease_batches"] >= 1, "batching never engaged"
        assert stats["leader"]["comp_batches"] >= 1
        assert mgr.backend.slots_per_worker == 4
    finally:
        mgr.close()


def test_sigkill_mid_batch_survivor_completes_and_store_is_never_torn(tmp_path):
    """The victim worker holds a batched backlog (the hang + queued pads)
    when it is SIGKILLed. Dead-worker expiry must re-enqueue every inflight
    lease of the batch to the survivor, results must all arrive, and after
    drain()'s barrier every committed store entry must resolve from a
    FRESH mount — an interrupted async commit may lose a staged entry (the
    retry recomputes it) but can never corrupt the store."""
    marker_dir = tmp_path / "marker"
    marker_dir.mkdir()
    mgr = _mk(
        tmp_path, 2,
        backend_kwargs={"max_batch": 8},
        enable_backup_tasks=False, max_attempts=3,
    )
    try:
        mgr.submit(
            WorkItem(key="victim", spec=("call", _hang_until_killed,
                                         (str(marker_dir),), {}))
        )
        for i in range(12):
            mgr.submit(
                WorkItem(key=f"pad{i}", spec=("call", _array_of, (i,), {}))
            )
        pid_file = marker_dir / "pid"
        deadline = time.monotonic() + 30
        while not pid_file.exists():
            assert time.monotonic() < deadline, "hang task never started"
            time.sleep(0.02)
        os.kill(int(pid_file.read_text()), signal.SIGKILL)
        mgr.drain()
        out = mgr.results()
        assert out["victim"] == "fast"
        for i in range(12):
            assert out[f"pad{i}"]["seed"] == i
            assert np.array_equal(
                out[f"pad{i}"]["x"],
                np.random.default_rng(i).standard_normal((8, 8)),
            )
        assert mgr.heartbeat_expiries >= 1
        # nothing the dead worker left behind may be torn: every committed
        # key resolves, from the live mount and from a fresh one
        live = mgr.backend.store
        fresh = SharedStore(64 << 20, disk_dir=mgr.backend.store_dir,
                            writer_id="probe")
        for key in sorted(k for k in live.committed_keys()
                          if k.startswith("rpc:")):
            assert fresh.get(key) is not None, f"torn/missing entry {key}"
    finally:
        mgr.close()


# ---------------------------------------------------------------------------
# Async commit: barrier() is the durability point
# ---------------------------------------------------------------------------


def test_drain_barrier_makes_every_staged_result_durable(tmp_path):
    mgr = _mk(tmp_path, 2, enable_backup_tasks=False)
    try:
        for i in range(10):
            mgr.submit(WorkItem(key=f"a{i}", spec=("call", _array_of, (i,), {})))
        mgr.drain()  # calls backend.barrier(): flusher must be empty after
        live = mgr.backend.store
        committed = [k for k in live.committed_keys() if k.startswith("rpc:")]
        assert len(committed) >= 10
        fresh = SharedStore(64 << 20, disk_dir=mgr.backend.store_dir,
                            writer_id="probe")
        for key in committed:
            got, want = fresh.get(key), live.get(key)
            assert got is not None
            if isinstance(want, dict) and "x" in want:
                assert np.array_equal(got["x"], want["x"])
        stats = mgr.backend.stats()
        assert stats["flusher"]["pending"] == 0
        assert stats["flusher"]["errors"] == 0
        assert stats["flusher"]["committed"] == stats["flusher"]["staged"]
    finally:
        mgr.close()


def test_barrier_is_truthful_noop_with_async_off(tmp_path):
    mgr = _mk(tmp_path, 1, backend_kwargs={"async_commit": False},
              enable_backup_tasks=False)
    try:
        mgr.submit(WorkItem(key="k", spec=("call", _array_of, (5,), {})))
        mgr.drain()
        assert mgr.backend.barrier(timeout=1.0) is True
        # sync mode: committed before the ack, no staging tier at all
        committed = [k for k in mgr.backend.store.committed_keys()
                     if k.startswith("rpc:")]
        assert committed
        assert "flusher" not in mgr.backend.stats()
    finally:
        mgr.close()


# ---------------------------------------------------------------------------
# Warm plan caches: identical recipes re-install as a dictionary hit
# ---------------------------------------------------------------------------


def _poll_worker_stat(backend, key, minimum, deadline_s=10.0):
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        if backend.stats().get("worker", {}).get(key, 0) >= minimum:
            return True
        time.sleep(0.05)
    return False


def test_warm_plan_cache_hits_on_identical_recipe(tmp_path):
    rng = random.Random(777)
    layout, names, cards = random_layout(rng, max_stages=2)
    wf = workflow_from_layout(layout)
    sets = random_param_sets(rng, names, cards, 6)
    inputs = [3, 8]
    plan = plan_study(wf, sets, policy="hybrid", max_bucket_size=3)
    backend = ProcessRpcBackend(
        build=mix_study_build,
        build_kwargs={"layout": layout, "inputs": inputs},
        store_dir=str(tmp_path / "store"),
        heartbeat_interval=0.05,
    )
    mgr = Manager(backend=backend, enable_backup_tasks=False)
    mgr.start(1)
    try:
        s1 = execute_study(plan, inputs, manager=mgr, key_prefix="a:")
        s2 = execute_study(plan, inputs, manager=mgr, key_prefix="b:")
        # identical results either way — the warm hit is pure reuse
        assert s1.outputs == s2.outputs
        # the second install of the SAME recipe must be a cache hit, and
        # must not have rebuilt the plan (worker stats ride heartbeats)
        assert _poll_worker_stat(backend, "plan_hits", 1), backend.stats()
        w = backend.stats()["worker"]
        assert w.get("plan_builds", 0) == 1
    finally:
        mgr.close()


# ---------------------------------------------------------------------------
# Deferred-forget resubmission: a stale memo must not swallow a new lifecycle
# ---------------------------------------------------------------------------


def test_resubmit_after_deferred_forget_starts_a_new_lifecycle():
    """A key forgotten while a losing attempt still holds a lease keeps its
    memo for first-completion-wins dedup (the deferred-forget set).
    Resubmitting that key must start a NEW lifecycle — historically it was
    a silent no-op against the stale memo, so a shared session reusing
    work keys across rounds returned the PREVIOUS round's value and the
    new round's stage never closed (the flaky rpc-benchmark KeyError).

    The stranded lease's late completion must not settle the new lifecycle
    either: its lease id is orphaned and dropped on arrival.
    """
    release = threading.Event()
    calls = {"n": 0}
    guard = threading.Lock()

    def flaky_straggler():
        with guard:
            calls["n"] += 1
            first = calls["n"] == 1
        if first:  # the original attempt stalls; the backup clone wins
            release.wait(30.0)
            return "old-straggler"
        return "old-backup"

    got = []
    mgr = Manager(straggler_factor=1.0, heartbeat_timeout=60.0)
    mgr.start(2)
    try:
        # two quick pads give the straggler detector the >=2 duration
        # samples it needs before it will clone anything
        for i in range(2):
            mgr.submit(WorkItem(key=f"pad{i}", fn=lambda i=i: _quick(i)))
        mgr.submit(WorkItem(key="K", fn=flaky_straggler))
        mgr.drain()
        assert mgr.results()["K"] == "old-backup"
        assert mgr.backups_launched >= 1
        # forget K while the losing original still holds its lease: the
        # memo is retained (deferred forget), not released
        mgr.forget(["K"])
        # resubmit the same key — a new lifecycle with a new value
        mgr.submit(WorkItem(key="K", fn=lambda: "new",
                            callback=lambda k, v: got.append(v)))
        mgr.drain()
        assert mgr.results()["K"] == "new"
        assert got == ["new"]
        # release the stranded original: its completion must be dropped,
        # never resurrecting the old lifecycle's value
        release.set()
        deadline = time.monotonic() + 10.0
        while mgr._orphaned and time.monotonic() < deadline:
            time.sleep(0.02)
        assert not mgr._orphaned
        assert mgr.results()["K"] == "new"
        assert got == ["new"]
    finally:
        release.set()
        mgr.close()
