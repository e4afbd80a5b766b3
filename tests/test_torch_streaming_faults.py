"""The reference's tests/test_streaming_faults.py re-targeted at ``repro_torch`` (the
import root renamed; the study generator is ``test_torch_study_gen``).

Fault injection for the persistent Manager + streaming executor.

The streaming claims under fire: transient task failures, Workers dying
mid-lease (heartbeat expiry), and injected stragglers (backup tasks racing
originals) during a multi-input `execute_study` must leave every output
bit-identical to the fault-free oracle, with `retries` /
`backups_launched` / cache-hit accounting consistent — in particular no
double-count when a backup and its original both complete (first completion
wins; only the winner's counters and callback fire).
"""

import os
import pathlib
import random
import signal
import threading
import time

import pytest

from repro_torch.core import StageSpec, TaskSpec, Workflow
from repro_torch.engine import ClusterSpec, execute_study, plan_study
from repro_torch.runtime import ProcessRpcBackend
from repro_torch.runtime.manager import Manager, WorkItem

from test_torch_study_gen import naive_outputs, random_param_sets, random_workflow

try:
    from hypothesis import given, settings, strategies as st

    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False


class Injector:
    """Thread-safe fault switchboard consulted by instrumented task fns.
    Inactive while the oracle runs, armed only for the streaming run."""

    def __init__(self):
        self.lock = threading.Lock()
        self.active = False
        self.failures_left = 0
        self.sleep_once_seconds = 0.0
        self.injected_failures = 0

    def maybe_fault(self):
        with self.lock:
            if not self.active:
                return
            if self.failures_left > 0:
                self.failures_left -= 1
                self.injected_failures += 1
                raise RuntimeError("injected transient fault")
            if self.sleep_once_seconds > 0.0:
                s, self.sleep_once_seconds = self.sleep_once_seconds, 0.0
            else:
                return
        time.sleep(s)  # straggle outside the lock


def instrumented_workflow(rng, injector):
    wf, names, cards = random_workflow(rng, max_stages=2)

    def wrap(fn):
        def wrapped(x, **kw):
            injector.maybe_fault()
            return fn(x, **kw)

        return wrapped

    stages = tuple(
        StageSpec(
            name=s.name,
            tasks=tuple(
                TaskSpec(
                    name=t.name,
                    param_names=t.param_names,
                    fn=wrap(t.fn),
                    cost=t.cost,
                    output_bytes=t.output_bytes,
                )
                for t in s.tasks
            ),
        )
        for s in wf.stages
    )
    return Workflow(stages=stages), wf, names, cards


@pytest.mark.parametrize("policy", ["stage", "hybrid"])
def test_transient_failures_leave_outputs_unchanged(policy):
    inj = Injector()
    rng = random.Random(501)
    wf, clean_wf, names, cards = instrumented_workflow(rng, inj)
    sets = random_param_sets(rng, names, cards, 12)
    inputs = [3, 8, 21]
    oracles = [naive_outputs(clean_wf, sets, x) for x in inputs]

    plan = plan_study(wf, sets, policy=policy, max_bucket_size=3)
    inj.failures_left = 3
    inj.active = True
    try:
        stream = execute_study(
            plan,
            inputs,
            cluster=ClusterSpec(
                n_workers=2, max_attempts=6, enable_backup_tasks=False
            ),
        )
    finally:
        inj.active = False
    assert inj.injected_failures == 3
    for i in range(len(inputs)):
        assert stream.outputs[i] == oracles[i], i
    # each injected task fault fails exactly one bucket attempt → one retry
    assert stream.retries == 3
    assert stream.backups_launched == 0
    # winner-only accounting: retried replays never double-count
    assert (
        stream.tasks_executed + stream.cache_hits
        == plan.tasks_executed * len(inputs)
    )


def test_permanent_failure_aborts_study_with_original_error():
    inj = Injector()
    rng = random.Random(502)
    wf, _, names, cards = instrumented_workflow(rng, inj)
    sets = random_param_sets(rng, names, cards, 6)
    plan = plan_study(wf, sets, policy="stage")
    inj.failures_left = 10**9
    inj.active = True
    try:
        with pytest.raises(RuntimeError, match="injected transient fault"):
            execute_study(
                plan,
                [1, 2],
                cluster=ClusterSpec(
                    n_workers=2, max_attempts=2, enable_backup_tasks=False
                ),
            )
    finally:
        inj.active = False


def test_injected_straggler_backup_no_double_count():
    """One bucket attempt straggles (sleeps); idle Workers clone it. First
    completion wins: outputs stay bit-identical and per-task accounting is
    counted exactly once even when original and backup both finish."""
    inj = Injector()
    rng = random.Random(503)
    wf, clean_wf, names, cards = instrumented_workflow(rng, inj)
    sets = random_param_sets(rng, names, cards, 16)
    inputs = [5, 9]
    oracles = [naive_outputs(clean_wf, sets, x) for x in inputs]

    plan = plan_study(wf, sets, policy="stage", max_bucket_size=2)
    inj.sleep_once_seconds = 0.6
    inj.active = True
    try:
        stream = execute_study(
            plan,
            inputs,
            cluster=ClusterSpec(
                n_workers=3, straggler_factor=1.5, max_attempts=4
            ),
        )
    finally:
        inj.active = False
    for i in range(len(inputs)):
        assert stream.outputs[i] == oracles[i], i
    # every run routed exactly once per input, regardless of raced backups
    for i in range(len(inputs)):
        assert sorted(stream.outputs[i]) == list(range(len(sets)))
    assert (
        stream.tasks_executed + stream.cache_hits
        == plan.tasks_executed * len(inputs)
    )


class TestPersistentManagerSessions:
    def test_submit_while_running_chained_callbacks_drain(self):
        """drain() must not return while a completion callback is still
        submitting downstream work — the per-input stage-edge pattern."""
        mgr = Manager(enable_backup_tasks=False)
        seen = []

        def cb(key, value):
            seen.append((key, value))
            if value < 5:
                mgr.submit(
                    WorkItem(
                        key=f"chain{value + 1}",
                        fn=lambda v=value: v + 1,
                        callback=cb,
                    )
                )

        mgr.start(2)
        try:
            mgr.submit(WorkItem(key="chain0", fn=lambda: 0, callback=cb))
            mgr.drain()
            assert sorted(mgr.results().values()) == [0, 1, 2, 3, 4, 5]
            assert len(seen) == 6
            # session persists: a second wave reuses the same Workers
            before = Manager.sessions_started
            mgr.submit(WorkItem(key="late", fn=lambda: "ok"))
            mgr.drain()
            assert mgr.results()["late"] == "ok"
            assert Manager.sessions_started == before  # no new session
        finally:
            mgr.close()
        with pytest.raises(RuntimeError):
            mgr.submit(WorkItem(key="after-close", fn=lambda: 1))

    def test_callback_fires_exactly_once_per_key(self):
        counts = {}
        lock = threading.Lock()

        def cb(key, value):
            with lock:
                counts[key] = counts.get(key, 0) + 1

        mgr = Manager(straggler_factor=0.5, max_attempts=4)
        release = threading.Event()

        def slow():
            if not release.is_set():
                release.set()
                time.sleep(0.5)
                return "slow"
            return "fast"

        for i in range(6):
            mgr.submit(
                WorkItem(key=f"q{i}", fn=lambda: time.sleep(0.01) or "q", callback=cb)
            )
        mgr.submit(WorkItem(key="strag", fn=slow, callback=cb))
        out = mgr.run(3, expected=7)
        assert out["strag"] in ("fast", "slow")
        assert all(c == 1 for c in counts.values()), counts
        assert set(counts) == {f"q{i}" for i in range(6)} | {"strag"}

    def test_heartbeat_expiry_recovers_dead_worker_lease(self):
        """A lease whose Worker misses the heartbeat deadline is re-enqueued
        and completed by a live Worker; the zombie's late completion is
        deduped by first-completion-wins."""
        mgr = Manager(
            heartbeat_timeout=0.05, enable_backup_tasks=False, max_attempts=3
        )
        first = threading.Event()

        def dead_then_alive():
            if not first.is_set():
                first.set()
                time.sleep(0.5)  # "dead" well past the 50ms deadline
                return "zombie"
            return "alive"

        mgr.submit(WorkItem(key="k", fn=dead_then_alive))
        for i in range(3):
            mgr.submit(WorkItem(key=f"pad{i}", fn=lambda: "p"))
        out = mgr.run(2, expected=4)
        assert out["k"] in ("alive", "zombie")
        assert mgr.heartbeat_expiries >= 1
        assert mgr.retries >= 1


# ---------------------------------------------------------------------------
# Work stealing under fire: steal storms + expired leases +
# killed workers must preserve exactly-once settlement and callbacks
# ---------------------------------------------------------------------------

# ``block=1, steal_min=1`` delegates one item at a time and lets every idle
# pump raid every peer — the maximum-contention "steal storm" topology. Any
# double-lease, lost item, or double-settlement shows up as a wrong count.
STORM = "fanout={f},block=1,steal_min=1"


def _hier_hang_until_killed(marker_dir):
    """Spawn-picklable: first execution in the fleet records its pid and
    hangs for the test to SIGKILL; retries return fast."""
    marker = pathlib.Path(marker_dir) / "pid"
    if not marker.exists():
        marker.write_text(str(os.getpid()))
        time.sleep(60.0)
        return "hung"
    return "fast"


def _hier_quick(tag):
    time.sleep(0.01)
    return f"q-{tag}"


def test_steal_storm_with_expired_leases_exactly_once():
    """Manager-level storm: 40 keys over 4 sub-pumps with one-item blocks,
    aggressive backups (straggler_factor 0.5), one worker that goes dead
    past the heartbeat deadline mid-lease, and transient failures. Every
    key must settle exactly once — one callback, one result — and the
    storm must actually steal (the topology guarantees imbalance)."""
    counts = {}
    lock = threading.Lock()

    def cb(key, value):
        with lock:
            counts[key] = counts.get(key, 0) + 1

    first = threading.Event()

    def dead_then_alive():
        if not first.is_set():
            first.set()
            time.sleep(0.4)  # well past the 50ms heartbeat deadline
            return "zombie"
        return "alive"

    flaky_left = [2]

    def flaky():
        with lock:
            if flaky_left[0] > 0:
                flaky_left[0] -= 1
                raise RuntimeError("injected transient fault")
        return "ok"

    mgr = Manager(
        heartbeat_timeout=0.05,
        straggler_factor=0.5,
        max_attempts=6,
        hierarchy=STORM.format(f=4),
    )
    mgr.submit(WorkItem(key="dead", fn=dead_then_alive, callback=cb))
    mgr.submit(WorkItem(key="flaky", fn=flaky, callback=cb))
    for i in range(38):
        mgr.submit(
            WorkItem(
                key=f"k{i}",
                fn=lambda i=i: time.sleep(0.005) or i * 3,
                callback=cb,
            )
        )
    out = mgr.run(4, expected=40)
    stats = mgr.scheduler_stats()
    assert len(out) == 40
    assert out["dead"] in ("alive", "zombie")
    assert out["flaky"] == "ok"
    assert all(out[f"k{i}"] == i * 3 for i in range(38))
    assert all(c == 1 for c in counts.values()), {
        k: c for k, c in counts.items() if c != 1
    }
    assert set(counts) == set(out)
    assert stats["mode"] == "hierarchical" and stats["fanout"] == 4
    assert mgr.heartbeat_expiries >= 1
    assert mgr.retries >= 3  # 2 injected faults + the expired lease


def _check_streaming_storm(seed, fanout, failures, straggle):
    """The storm property: streaming under a steal storm + transient
    failures + an optional injected straggler (backup clones racing
    originals) leaves outputs bit-identical to the fault-free oracle with
    the exactly-once accounting identity intact."""
    inj = Injector()
    rng = random.Random(seed)
    wf, clean_wf, names, cards = instrumented_workflow(rng, inj)
    sets = random_param_sets(rng, names, cards, rng.randint(2, 12))
    inputs = [rng.randrange(1 << 40) for _ in range(2)]
    oracles = [naive_outputs(clean_wf, sets, x) for x in inputs]
    plan = plan_study(wf, sets, policy="hybrid", max_bucket_size=2)

    inj.failures_left = failures
    if straggle:
        inj.sleep_once_seconds = 0.3
    inj.active = True
    try:
        stream = execute_study(
            plan,
            inputs,
            cluster=ClusterSpec(
                n_workers=4, max_attempts=8, straggler_factor=1.5
            ),
            hierarchy=STORM.format(f=fanout),
        )
    finally:
        inj.active = False
    for i in range(len(inputs)):
        assert stream.outputs[i] == oracles[i], i
    assert (
        stream.tasks_executed + stream.cache_hits
        == plan.tasks_executed * len(inputs)
    )
    assert stream.scheduler["fanout"] == fanout


@pytest.mark.parametrize("seed,fanout,failures,straggle", [
    (601, 2, 0, False),
    (602, 3, 2, False),
    (603, 4, 3, True),
    (604, 4, 1, True),
])
def test_streaming_storm_bit_identical(seed, fanout, failures, straggle):
    """Seeded instances of the storm property (always run; the hypothesis
    layer below explores the same contract when hypothesis is installed)."""
    _check_streaming_storm(seed, fanout, failures, straggle)


if HAVE_HYPOTHESIS:

    class TestHypothesisStealStorm:
        @given(
            seed=st.integers(min_value=0, max_value=2**20),
            fanout=st.sampled_from([2, 3, 4]),
            failures=st.integers(min_value=0, max_value=3),
            straggle=st.booleans(),
        )
        @settings(max_examples=10, deadline=None)
        def test_streaming_storm_bit_identical(
            self, seed, fanout, failures, straggle
        ):
            _check_streaming_storm(seed, fanout, failures, straggle)


def test_sigkilled_worker_under_hierarchy_settles_exactly_once(tmp_path):
    """fanout=2 over RPC worker processes, one worker SIGKILLed mid-lease:
    the leader's heartbeat expiry re-enqueues the lease, a sub-pump whose
    shard lost its only worker goes idle, and the surviving shard (via
    redistribution/stealing) completes everything — every key exactly once."""
    marker_dir = tmp_path / "marker"
    marker_dir.mkdir()
    counts = {}
    lock = threading.Lock()

    def cb(key, value):
        with lock:
            counts[key] = counts.get(key, 0) + 1

    mgr = Manager(
        backend=ProcessRpcBackend(
            store_dir=str(tmp_path / "store"), heartbeat_interval=0.05
        ),
        enable_backup_tasks=False,
        max_attempts=3,
        hierarchy=STORM.format(f=2),
    )
    mgr.start(2)
    try:
        mgr.submit(
            WorkItem(
                key="victim",
                spec=("call", _hier_hang_until_killed, (str(marker_dir),), {}),
                callback=cb,
            )
        )
        for i in range(4):
            mgr.submit(
                WorkItem(
                    key=f"pad{i}",
                    spec=("call", _hier_quick, (i,), {}),
                    callback=cb,
                )
            )
        pid_file = marker_dir / "pid"
        deadline = time.monotonic() + 30
        while not pid_file.exists():
            assert time.monotonic() < deadline, "hang task never started"
            time.sleep(0.02)
        os.kill(int(pid_file.read_text()), signal.SIGKILL)
        mgr.drain()
        out = mgr.results()
        assert out["victim"] == "fast"  # re-run by the SURVIVING worker
        for i in range(4):
            assert out[f"pad{i}"] == f"q-{i}"
        assert all(c == 1 for c in counts.values()), counts
        assert set(counts) == set(out)
        assert mgr.heartbeat_expiries >= 1
        assert mgr.scheduler_stats()["mode"] == "hierarchical"
    finally:
        mgr.close()


def test_streaming_pipelines_across_inputs():
    """No global stage barrier: a fast input must finish its LAST stage
    while a slow input is still stuck in an earlier stage."""
    log = []
    lock = threading.Lock()

    def mark(tag, i, x):
        with lock:
            log.append((tag, i, time.monotonic()))
        return x

    def s0_fn(state, **kw):
        i, x = state
        return (i, mark("s0", i, x + 1))

    def s1_fn(state, **kw):
        i, x = state
        if i == 0:
            time.sleep(0.4)  # input 0 straggles in stage 1
        return (i, mark("s1", i, x * 2))

    wf = Workflow(
        stages=(
            StageSpec(name="a", tasks=(TaskSpec("t0", (), fn=s0_fn),)),
            StageSpec(name="b", tasks=(TaskSpec("t1", (), fn=s1_fn),)),
        )
    )
    plan = plan_study(wf, [()], policy="stage")
    stream = execute_study(
        plan,
        [(0, 10), (1, 20)],
        cluster=ClusterSpec(n_workers=2, enable_backup_tasks=False),
    )
    assert stream.outputs[0][0] == (0, 22)
    assert stream.outputs[1][0] == (1, 42)
    t_done = {i: max(t for tag, j, t in log if j == i and tag == "s1") for i in (0, 1)}
    assert t_done[1] < t_done[0], "fast input should overtake the straggler"
