"""The reference's tests/test_worker_backend.py re-targeted at ``repro_torch`` (the
import root renamed; the study generator is ``test_torch_study_gen``).

WorkerBackend conformance suite (DESIGN.md §13).

The dispatch boundary's contract, asserted against BOTH shipped backends:

* **differential** — the same plans over the whole policy matrix produce
  bit-identical outputs through in-process Worker threads and through RPC
  worker processes (results crossing the boundary only as SharedStore
  keys; the integer workloads are collision-sensitive, so any wire/store
  rounding shows up as a wrong int, not a tolerance miss);
* **SA indices** — an adaptive StudyDriver study run on the process
  backend reproduces the thread-backend study's indices, CIs and decisions
  exactly, for every caching policy;
* **fault tolerance** — a SIGKILLed worker process's leases are
  re-enqueued (immediate dead-worker expiry) and completed by surviving
  workers; transient remote failures retry; permanent failures surface
  with the remote traceback;
* **straggler/backup races** and **exactly-once completion callbacks**
  behave identically on both backends (first completion wins);
* ``Manager.close()`` is idempotent and safe to race with ``drain()``.

Helpers are module-level and data-only where they must cross the spawn
boundary (worker processes re-import this module in a fresh interpreter).
"""

import os
import pathlib
import random
import signal
import threading
import time

import pytest

from repro_torch.engine import ClusterSpec, execute_study, plan_study
from repro_torch.engine.types import CACHING_POLICIES, POLICIES
from repro_torch.runtime import (
    Manager,
    ProcessRpcBackend,
    RemoteTaskError,
    SocketBackend,
    WorkItem,
)
from repro_torch.study import StudyDriver

from test_torch_study_gen import (
    mix_study_build,
    naive_outputs,
    random_layout,
    random_param_sets,
    workflow_from_layout,
)

pytestmark = pytest.mark.filterwarnings("ignore::ResourceWarning")


# ---------------------------------------------------------------------------
# Spawn-picklable task functions for the Manager-level ("call" spec) tests
# ---------------------------------------------------------------------------


def _quick(tag):
    time.sleep(0.01)
    return f"q-{tag}"


def _hang_until_killed(marker_dir):
    """First execution anywhere in the fleet: record our pid and hang (the
    test SIGKILLs us). Every later execution returns immediately — the
    surviving worker's retry path."""
    marker = pathlib.Path(marker_dir) / "pid"
    if not marker.exists():
        marker.write_text(str(os.getpid()))
        time.sleep(60.0)
        return "hung"
    return "fast"


def _wedge_worker_process(marker_dir):
    """Worst-case teardown adversary: the TASK completes normally, but it
    leaves the worker process unable to exit — a non-daemon thread parked
    far past any test budget — and shrugs off SIGTERM. The stop frame ends
    the serve loop, then interpreter exit blocks joining the thread: only
    shutdown's terminate→KILL escalation can retire this process."""
    signal.signal(signal.SIGTERM, signal.SIG_IGN)
    threading.Thread(target=time.sleep, args=(300.0,), daemon=False).start()
    (pathlib.Path(marker_dir) / "stuck_pid").write_text(str(os.getpid()))
    return "wedged"


def _slow_once(marker_dir):
    """First execution straggles (but completes); the backup clone returns
    fast. Either may win — first completion wins."""
    marker = pathlib.Path(marker_dir) / "slow"
    try:
        # exclusive create = atomic "am I first" across processes
        fd = os.open(marker, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        os.close(fd)
    except FileExistsError:
        return "fast"
    time.sleep(1.2)
    return "slow"


_FLAKY_CALLS = {"n": 0}  # per-process (workers re-import this module)


def _flaky_twice(x):
    if _FLAKY_CALLS["n"] < 2:
        _FLAKY_CALLS["n"] += 1
        raise RuntimeError("injected transient fault")
    return x * 2


def _boom():
    raise ValueError("boom: unconditional remote failure")


def _scalar_dict():
    # str-keyed dict of Python scalars: must round-trip the store with its
    # types intact (npz coercion would hand back 0-d arrays)
    return {"n": 2, "s": "x", "f": 0.5}


def _returns_none():
    return None  # a legal result; must not read as "missing from store"


def _mk_process_manager(tmp_path, n_workers=2, *, build=None, build_kwargs=None,
                        **mgr_kwargs):
    mgr = Manager(
        backend=ProcessRpcBackend(
            build=build,
            build_kwargs=build_kwargs,
            store_dir=str(tmp_path / "store"),
            heartbeat_interval=0.05,
        ),
        **mgr_kwargs,
    )
    mgr.start(n_workers)
    return mgr


# ---------------------------------------------------------------------------
# Differential: policy matrix × both backends, bit-identical to the oracle
# ---------------------------------------------------------------------------


def test_policy_matrix_bit_identical_across_backends(tmp_path):
    """One persistent process-backend session executes every policy's plan;
    outputs must equal the naive oracle AND the thread-backend run exactly
    (exact ints — any serialisation loss at the store/wire would wrap)."""
    rng = random.Random(1105)
    layout, names, cards = random_layout(rng, max_stages=3)
    wf = workflow_from_layout(layout)
    sets = random_param_sets(rng, names, cards, 12)
    inputs = [3, 8, 21]
    oracles = [naive_outputs(wf, sets, x) for x in inputs]

    mgr = _mk_process_manager(
        tmp_path, 2,
        build=mix_study_build,
        build_kwargs={"layout": layout, "inputs": inputs},
        enable_backup_tasks=False,
    )
    # third row of the matrix: a loopback TCP fleet over the object-store
    # tier — no shared working directory beyond the store root (§16)
    sock_mgr = Manager(
        backend=SocketBackend(
            build=mix_study_build,
            build_kwargs={"layout": layout, "inputs": inputs},
            store="obj:" + str(tmp_path / "objroot"),
            heartbeat_interval=0.05,
        ),
        enable_backup_tasks=False,
    )
    sock_mgr.start(2)
    try:
        for policy in POLICIES:
            plan = plan_study(wf, sets, policy=policy, max_bucket_size=3)
            thread_stream = execute_study(
                plan, inputs,
                cluster=ClusterSpec(n_workers=2, enable_backup_tasks=False),
            )
            proc_stream = execute_study(
                plan, inputs, manager=mgr, key_prefix=f"{policy}:"
            )
            sock_stream = execute_study(
                plan, inputs, manager=sock_mgr, key_prefix=f"{policy}:"
            )
            assert proc_stream.backend == "process"
            assert thread_stream.backend == "thread"
            assert sock_stream.backend == "socket"
            assert sum(proc_stream.dispatch_counts.values()) > 0
            assert sum(sock_stream.dispatch_counts.values()) > 0
            for i in range(len(inputs)):
                assert thread_stream.outputs[i] == oracles[i], (policy, i)
                assert proc_stream.outputs[i] == oracles[i], (policy, i)
                assert sock_stream.outputs[i] == oracles[i], (policy, i)
    finally:
        mgr.close()
        sock_mgr.close()


def test_results_cross_the_boundary_only_as_store_keys(tmp_path):
    """White-box: every process-backend result is committed to the shared
    store under its session-scoped work key — the completion message
    carries the key, and the hydrated value equals what the store serves
    (bit-exactly: a str survives as a str, not an array)."""
    mgr = _mk_process_manager(tmp_path, 1)
    try:
        mgr.submit(WorkItem(key="k0", spec=("call", _quick, ("x",), {})))
        mgr.drain()
        assert mgr.results()["k0"] == "q-x"
        store = mgr.backend.store
        committed = [k for k in store.committed_keys() if k.endswith(":k0")]
        assert len(committed) == 1
        assert committed[0].startswith("rpc:")  # session-scoped namespace
        assert store.get(committed[0]) == "q-x"
        # type-exact hydration: identical to what ThreadBackend would return
        mgr.submit(WorkItem(key="d0", spec=("call", _scalar_dict, (), {})))
        mgr.drain()
        d = mgr.results()["d0"]
        assert d == {"n": 2, "s": "x", "f": 0.5}
        assert type(d["n"]) is int and type(d["s"]) is str and type(d["f"]) is float
        # a None result succeeds (rides the completion as a marker), same
        # as ThreadBackend — not a retry-to-death "missing result"
        mgr.submit(WorkItem(key="n0", spec=("call", _returns_none, (), {})))
        mgr.drain()
        assert mgr.results()["n0"] is None
        assert mgr.retries == 0
    finally:
        mgr.close()


def test_restarted_backend_never_serves_a_stale_store_entry(tmp_path):
    """The same work key re-submitted through a RESTARTED backend over one
    store directory must recompute, not replay the previous session's
    committed value (store keys are session-scoped)."""
    backend = ProcessRpcBackend(store_dir=str(tmp_path / "store"),
                                heartbeat_interval=0.05)
    marker = tmp_path / "m"
    marker.mkdir()

    mgr1 = Manager(backend=backend)
    mgr1.start(1)
    mgr1.submit(WorkItem(key="k", spec=("call", _slow_once, (str(marker),), {})))
    mgr1.drain()
    assert mgr1.results()["k"] == "slow"  # first execution anywhere
    mgr1.close()

    mgr2 = Manager(backend=backend)
    mgr2.start(1)
    mgr2.submit(WorkItem(key="k", spec=("call", _slow_once, (str(marker),), {})))
    mgr2.drain()
    out = mgr2.results()["k"]
    mgr2.close()
    assert out == "fast", "second session served the first session's entry"


# ---------------------------------------------------------------------------
# SA indices: adaptive studies identical across backends, per caching policy
# ---------------------------------------------------------------------------


def _objective(leaf, _i):
    return float(leaf % 9973) / 9973.0


@pytest.mark.parametrize("policy", CACHING_POLICIES)
def test_sa_indices_bit_identical_thread_vs_process(tmp_path, policy):
    rng = random.Random(7000 + hash(policy) % 100)
    layout = [
        [("s0t0", (), 1.0, 64)],
        [
            ("s1t0", ("p0",), 1.0, 64),
            ("s1t1", ("p1",), 1.0, 64),
            ("s1t2", ("p2",), 1.0, 64),
        ],
    ]
    from repro_torch.core import ParamSpace

    space = ParamSpace.from_dict({f"p{i}": [0, 1, 2] for i in range(3)})
    inputs = [rng.randrange(1000)]

    def run(backend):
        driver = StudyDriver(
            workflow_from_layout(layout),
            space,
            inputs,
            objective=_objective,
            seed=5,
            engine_policy=policy,
            cluster=ClusterSpec(n_workers=2),
            n_boot=8,
            backend=backend,
        )
        try:
            return driver.run(max_rounds=2)
        finally:
            driver.close()

    thread_state = run(None)
    proc_state = run(
        ProcessRpcBackend(
            build=mix_study_build,
            build_kwargs={"layout": layout, "inputs": inputs},
            store_dir=str(tmp_path / f"store-{policy}"),
        )
    )
    assert proc_state.evaluated == thread_state.evaluated
    assert len(proc_state.rounds) == len(thread_state.rounds) == 2
    for pr, tr in zip(proc_state.rounds, thread_state.rounds):
        assert pr.outputs == tr.outputs
        assert pr.analysis == tr.analysis  # indices + CIs, exact floats
        assert pr.decision == tr.decision
    assert proc_state.active == thread_state.active
    # the workers flushed their task caches at shutdown: the store dir
    # holds durable task-level entries (what a resumed study rehydrates),
    # while the transient rpc: transport payloads were purged
    store_dir = tmp_path / f"store-{policy}"
    assert any(store_dir.glob("*.npz")), "worker caches never flushed"


def test_sa_indices_bit_identical_thread_vs_socket(tmp_path):
    """The full adaptive loop over a TCP fleet + object store: indices,
    CIs, decisions and the active set must equal the thread run exactly —
    the multi-host acceptance row (here on loopback)."""
    rng = random.Random(7042)
    layout = [
        [("s0t0", (), 1.0, 64)],
        [
            ("s1t0", ("p0",), 1.0, 64),
            ("s1t1", ("p1",), 1.0, 64),
            ("s1t2", ("p2",), 1.0, 64),
        ],
    ]
    from repro_torch.core import ParamSpace

    space = ParamSpace.from_dict({f"p{i}": [0, 1, 2] for i in range(3)})
    inputs = [rng.randrange(1000)]

    def run(backend):
        driver = StudyDriver(
            workflow_from_layout(layout),
            space,
            inputs,
            objective=_objective,
            seed=5,
            engine_policy="hybrid",
            cluster=ClusterSpec(n_workers=2),
            n_boot=8,
            backend=backend,
        )
        try:
            return driver.run(max_rounds=2)
        finally:
            driver.close()

    thread_state = run(None)
    sock_state = run(
        SocketBackend(
            build=mix_study_build,
            build_kwargs={"layout": layout, "inputs": inputs},
            store="obj:" + str(tmp_path / "objroot"),
            heartbeat_interval=0.05,
        )
    )
    assert sock_state.evaluated == thread_state.evaluated
    assert len(sock_state.rounds) == len(thread_state.rounds) == 2
    for sr, tr in zip(sock_state.rounds, thread_state.rounds):
        assert sr.outputs == tr.outputs
        assert sr.analysis == tr.analysis  # indices + CIs, exact floats
        assert sr.decision == tr.decision
    assert sock_state.active == thread_state.active
    # the fleet's durable artifacts live under the object root as
    # footer-verified entries/ objects — no .npz scatter, no flocks
    entries = tmp_path / "objroot" / "entries"
    assert entries.is_dir() and any(entries.iterdir())


# ---------------------------------------------------------------------------
# Fault tolerance across the process boundary
# ---------------------------------------------------------------------------


def test_killed_worker_lease_reenqueued_and_completed_by_survivor(tmp_path):
    marker_dir = tmp_path / "marker"
    marker_dir.mkdir()
    mgr = _mk_process_manager(
        tmp_path, 2, enable_backup_tasks=False, max_attempts=3
    )
    try:
        mgr.submit(
            WorkItem(key="victim", spec=("call", _hang_until_killed,
                                         (str(marker_dir),), {}))
        )
        for i in range(3):
            mgr.submit(WorkItem(key=f"pad{i}", spec=("call", _quick, (i,), {})))
        pid_file = marker_dir / "pid"
        deadline = time.monotonic() + 30
        while not pid_file.exists():
            assert time.monotonic() < deadline, "hang task never started"
            time.sleep(0.02)
        victim_pid = int(pid_file.read_text())
        os.kill(victim_pid, signal.SIGKILL)
        mgr.drain()
        out = mgr.results()
        assert out["victim"] == "fast"  # re-run by a SURVIVING worker
        for i in range(3):
            assert out[f"pad{i}"] == f"q-{i}"
        assert mgr.heartbeat_expiries >= 1
        assert mgr.retries >= 1
        # the backend reports the victim dead; a survivor remains
        view = mgr.backend.heartbeat_view()
        assert sum(1 for st in view.values() if not st.alive) == 1
        assert sum(1 for st in view.values() if st.alive) == 1
        assert victim_pid in mgr.backend.worker_pids()
    finally:
        mgr.close()


def test_shutdown_bounded_even_with_stuck_worker(tmp_path):
    """``Manager.close()`` can never hang a fleet teardown: a worker whose
    process cannot exit after the stop frame (wedged by a non-daemon
    thread, SIGTERM ignored) is joined with a deadline, terminated, then
    KILLED at the escalation deadline — close returns in bounded
    wall-clock time and no worker process survives it. (Before the bound,
    shutdown's unconditional ``proc.join()`` waited on this forever.)"""
    marker_dir = tmp_path / "marker"
    marker_dir.mkdir()
    mgr = Manager(
        backend=ProcessRpcBackend(
            store_dir=str(tmp_path / "store"),
            heartbeat_interval=0.05,
            shutdown_grace=0.5,
        ),
        enable_backup_tasks=False,
    )
    mgr.start(2)
    closed = False
    try:
        mgr.submit(
            WorkItem(key="wedge", spec=("call", _wedge_worker_process,
                                        (str(marker_dir),), {}))
        )
        mgr.drain()  # the task itself completes fine
        assert mgr.results()["wedge"] == "wedged"
        pids = list(mgr.backend.worker_pids())
        t0 = time.monotonic()
        mgr.close()
        closed = True
        elapsed = time.monotonic() - t0
        # grace 0.5s + terminate(2s) + kill(1s) escalation windows, with
        # slack for process-table churn — far below the hung-join forever
        assert elapsed < 15.0, f"teardown took {elapsed:.1f}s"
        for pid in pids:
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline:
                try:
                    os.kill(pid, 0)
                except ProcessLookupError:
                    break  # reaped
                time.sleep(0.05)
            else:
                pytest.fail(f"worker {pid} survived shutdown")
    finally:
        if not closed:
            mgr.close()


def test_transient_remote_failures_retry_to_success(tmp_path):
    mgr = _mk_process_manager(
        tmp_path, 1, enable_backup_tasks=False, max_attempts=5
    )
    try:
        mgr.submit(WorkItem(key="flaky", spec=("call", _flaky_twice, (21,), {})))
        mgr.drain()
        assert mgr.results()["flaky"] == 42
        assert mgr.retries == 2
    finally:
        mgr.close()


def test_permanent_remote_failure_carries_traceback(tmp_path):
    mgr = _mk_process_manager(
        tmp_path, 1, enable_backup_tasks=False, max_attempts=2
    )
    try:
        mgr.submit(WorkItem(key="bad", spec=("call", _boom, (), {})))
        mgr.drain()
        err = mgr.results()["bad"]
        assert isinstance(err, RemoteTaskError)
        assert isinstance(err, RuntimeError)  # streaming abort path re-raises
        assert "boom: unconditional remote failure" in str(err)
        assert "ValueError" in str(err)  # the remote traceback text
    finally:
        mgr.close()


@pytest.mark.parametrize("backend", ["thread", "process"])
def test_straggler_backup_and_exactly_once_callbacks(tmp_path, backend):
    """Identical straggler semantics on both backends: the slow attempt is
    cloned, first completion wins, and the per-key callback fires exactly
    once no matter how the race lands. Both backends execute the SAME
    spec-only WorkItems (ThreadBackend runs the portable call spec)."""
    marker_dir = tmp_path / f"m-{backend}"
    marker_dir.mkdir()
    counts = {}
    lock = threading.Lock()

    def cb(key, value):
        with lock:
            counts[key] = counts.get(key, 0) + 1

    if backend == "process":
        mgr = _mk_process_manager(
            tmp_path, 3, straggler_factor=0.5, max_attempts=4
        )
    else:
        mgr = Manager(straggler_factor=0.5, max_attempts=4)
        mgr.start(3)
    try:
        for i in range(6):
            mgr.submit(
                WorkItem(key=f"q{i}", spec=("call", _quick, (i,), {}),
                         callback=cb)
            )
        mgr.submit(
            WorkItem(key="strag", spec=("call", _slow_once,
                                        (str(marker_dir),), {}), callback=cb)
        )
        deadline = time.monotonic() + 60
        while "strag" not in mgr.results():
            assert time.monotonic() < deadline
            time.sleep(0.02)
        mgr.drain()
        out = mgr.results()
        assert out["strag"] in ("fast", "slow")
        assert all(c == 1 for c in counts.values()), counts
        assert set(counts) == {f"q{i}" for i in range(6)} | {"strag"}
    finally:
        mgr.close()


# ---------------------------------------------------------------------------
# ResultCache.flush() returns the persisted-entry count
# ---------------------------------------------------------------------------


def test_result_cache_flush_returns_persist_count(tmp_path):
    from repro_torch.engine import ResultCache
    from repro_torch.runtime import HierarchicalStore

    store = HierarchicalStore(1 << 20, disk_dir=str(tmp_path / "s"))
    cache = ResultCache(1 << 20, spill_store=store)
    for i in range(3):
        cache.put(("k", i), float(i), 8)
    flushed = cache.flush()
    assert flushed == 3
    # a reopened store resolves everything the flush persisted
    reopened = HierarchicalStore(1 << 20, disk_dir=str(tmp_path / "s"))
    for i in range(3):
        assert reopened.get(repr(("k", i))) == float(i)
    # and without a spill store the flush is an explicit no-op zero
    assert ResultCache(1 << 20).flush() == 0


# ---------------------------------------------------------------------------
# Manager.close(): guarded state transition
# ---------------------------------------------------------------------------


class TestCloseIdempotency:
    def test_double_close_and_close_without_start(self):
        mgr = Manager()
        mgr.start(2)
        mgr.submit(WorkItem(key="a", fn=lambda: 1))
        mgr.close()
        mgr.close()  # second close: no join of a retired pool, no error
        assert mgr.results()["a"] == 1
        assert not mgr.is_running

        never_started = Manager()
        never_started.close()
        never_started.close()

    def test_concurrent_close_from_many_threads(self):
        mgr = Manager()
        mgr.start(2)
        for i in range(8):
            mgr.submit(WorkItem(key=f"k{i}", fn=lambda i=i: i))
        errors = []

        def closer():
            try:
                mgr.close()
            except BaseException as e:  # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=closer) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive(), "close() deadlocked"
        assert not errors
        assert len(mgr.results()) == 8

    def test_close_racing_drain(self):
        """drain() on one thread, close() on another, while slow work is in
        flight: both must return, all results must exist, nothing hangs."""
        mgr = Manager(enable_backup_tasks=False)
        mgr.start(2)
        for i in range(6):
            mgr.submit(
                WorkItem(key=f"s{i}", fn=lambda i=i: time.sleep(0.05) or i)
            )
        done = []

        def drainer():
            mgr.drain()
            done.append("drain")

        def closer():
            time.sleep(0.02)  # land mid-drain
            mgr.close()
            done.append("close")

        t1 = threading.Thread(target=drainer)
        t2 = threading.Thread(target=closer)
        t1.start()
        t2.start()
        t1.join(timeout=30)
        t2.join(timeout=30)
        assert not t1.is_alive() and not t2.is_alive(), "drain/close deadlock"
        assert sorted(done) == ["close", "drain"]
        assert len(mgr.results()) == 6
        with pytest.raises(RuntimeError):
            mgr.submit(WorkItem(key="late", fn=lambda: 1))

    def test_restart_after_close_is_a_fresh_session(self):
        mgr = Manager()
        mgr.submit(WorkItem(key="one", fn=lambda: 1))
        out = mgr.run(1, expected=1)
        assert out == {"one": 1}
        assert not mgr.is_running
        mgr.start(1)  # a closed Manager may host a fresh session
        mgr.submit(WorkItem(key="two", fn=lambda: 2))
        mgr.drain()
        mgr.close()
        assert mgr.results()["two"] == 2
