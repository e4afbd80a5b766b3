"""The reference's tests/test_cancellation.py re-targeted at ``repro_torch``
(the import root renamed).

Cancellation race suite (DESIGN.md §18).

``Manager.cancel`` must deliver exactly-once semantics under every race
the service can produce — cancel while queued, cancel mid-lease, cancel
while the key sits in a delegated sub-queue (the steal surface),
double-cancel, cancel-then-resubmit — and behave identically on the
thread, process and socket backends. Each revoked key's callback fires
exactly once with :class:`TaskCancelled`; a poisoned lease's eventual
completion is dropped (never a second callback, never a resurrected
result); and a cancel-forget-resubmit cycle produces the bit-identical
value an uncancelled run would have.
"""

import threading
import time

import pytest

from repro_torch.runtime import (
    Manager,
    ProcessRpcBackend,
    SocketBackend,
    TaskCancelled,
    WorkItem,
)

pytestmark = pytest.mark.filterwarnings("ignore::ResourceWarning")

BACKENDS = ["thread", "process", "socket"]


def _mk_manager(backend, tmp_path, n_workers=2, **mgr_kwargs):
    if backend == "thread":
        mgr = Manager(**mgr_kwargs)
    elif backend == "process":
        mgr = Manager(
            backend=ProcessRpcBackend(
                store_dir=str(tmp_path / "store"),
                heartbeat_interval=0.05,
            ),
            **mgr_kwargs,
        )
    else:
        mgr = Manager(
            backend=SocketBackend(
                store="obj:" + str(tmp_path / "objroot"),
                heartbeat_interval=0.05,
            ),
            **mgr_kwargs,
        )
    mgr.start(n_workers)
    return mgr


# Spawn-picklable task bodies (worker processes re-import this module).


def _double(x):
    return x * 2


def _napper(seconds):
    time.sleep(seconds)
    return "napped"


class _Recorder:
    """Per-key callback journal: every (key, value) settlement in order."""

    def __init__(self):
        self.lock = threading.Lock()
        self.events = {}

    def cb(self, key, value):
        with self.lock:
            self.events.setdefault(key, []).append(value)

    def count(self, key):
        with self.lock:
            return len(self.events.get(key, []))

    def only(self, key):
        with self.lock:
            (value,) = self.events[key]
            return value


@pytest.mark.parametrize("backend", BACKENDS)
def test_cancel_race_matrix(tmp_path, backend):
    """The five-race gauntlet in one session per backend: queued cancel,
    mid-lease cancel, double-cancel, unrelated work undisturbed, then
    cancel→forget→resubmit yielding the bit-identical uncancelled value."""
    rec = _Recorder()
    mgr = _mk_manager(
        backend, tmp_path, n_workers=2, enable_backup_tasks=False
    )
    try:
        # Occupy both workers so later submissions stay QUEUED.
        for i in range(2):
            mgr.submit(
                WorkItem(
                    key=f"blk{i}",
                    spec=("call", _napper, (1.0,), {}),
                    callback=rec.cb,
                )
            )
        deadline = time.monotonic() + 30
        while sum(mgr.dispatch_counts.values()) < 2:
            assert time.monotonic() < deadline, "blockers never leased"
            time.sleep(0.01)
        for i in range(4):
            mgr.submit(
                WorkItem(
                    key=f"q{i}",
                    spec=("call", _double, (i,), {}),
                    callback=rec.cb,
                )
            )

        # Race 1: cancel while queued — purged before any lease exists.
        cancelled = mgr.cancel(["q0", "q1"])
        assert sorted(cancelled) == ["q0", "q1"]
        assert isinstance(rec.only("q0"), TaskCancelled)
        assert isinstance(rec.only("q1"), TaskCancelled)

        # Race 2: cancel mid-lease — the blocker's lease is poisoned; its
        # callback fires TaskCancelled NOW, and the worker's eventual
        # completion (it is still sleeping) must be dropped on arrival.
        assert mgr.cancel(["blk0"]) == ["blk0"]
        assert isinstance(rec.only("blk0"), TaskCancelled)

        # Race 3: double-cancel — second call finds nothing to revoke.
        assert mgr.cancel(["q0", "blk0"]) == []

        # Unsettled, uncancelled work is undisturbed by all of the above.
        mgr.drain()
        assert rec.only("q2") == 4
        assert rec.only("q3") == 6
        assert rec.only("blk1") == "napped"

        # The poisoned blk0 completion has arrived by now (drain outlasts
        # its 1s nap) and was dropped: still exactly one callback.
        assert rec.count("blk0") == 1
        assert mgr.scheduler_stats()["cancelled"] == 3

        # Race 4: cancel-then-resubmit — a clean new lifecycle with the
        # bit-identical value an uncancelled run produces.
        mgr.forget(["q0", "q1", "blk0"])
        mgr.submit(
            WorkItem(
                key="q0",
                spec=("call", _double, (0,), {}),
                callback=rec.cb,
            )
        )
        mgr.drain()
        assert rec.events["q0"][-1] == 0 == _double(0)
        assert rec.count("q0") == 2  # one per lifecycle, never more

        # Exactly-once across the whole gauntlet.
        for key, events in rec.events.items():
            expected = 2 if key == "q0" else 1
            assert len(events) == expected, (key, events)
    finally:
        mgr.close()


@pytest.mark.parametrize("backend", ["thread", "process"])
def test_cancel_in_delegated_subqueue(tmp_path, backend):
    """Cancel reaches work already distributed to a hierarchical
    sub-pump's local queue (the steal surface): queued shards are purged
    from the sub-queues, not just the global queue, and the freed workers
    go on to complete unrelated work."""
    rec = _Recorder()
    mgr = _mk_manager(
        backend,
        tmp_path,
        n_workers=4,
        hierarchy=2,
        enable_backup_tasks=False,
    )
    try:
        for i in range(4):
            mgr.submit(
                WorkItem(
                    key=f"blk{i}",
                    spec=("call", _napper, (0.8,), {}),
                    callback=rec.cb,
                )
            )
        deadline = time.monotonic() + 30
        while sum(mgr.dispatch_counts.values()) < 4:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        # Backlog lands in the sub-pumps' local queues behind the nappers.
        for i in range(12):
            mgr.submit(
                WorkItem(
                    key=f"s{i}",
                    spec=("call", _double, (i,), {}),
                    callback=rec.cb,
                    path=("in", i % 4),
                )
            )
        victims = [f"s{i}" for i in range(0, 12, 2)]
        cancelled = mgr.cancel(victims)
        assert sorted(cancelled) == sorted(victims)
        mgr.drain()
        for i in range(12):
            key = f"s{i}"
            assert rec.count(key) == 1, key
            if key in victims:
                assert isinstance(rec.only(key), TaskCancelled)
            else:
                assert rec.only(key) == 2 * i
    finally:
        mgr.close()


def test_cancel_unknown_and_settled_keys_noop():
    """Cancelling keys that were never submitted, or that already settled,
    revokes nothing and leaves the memoised results intact."""
    rec = _Recorder()
    mgr = Manager()
    mgr.start(1)
    try:
        mgr.submit(WorkItem(key="a", fn=lambda: 7, callback=rec.cb))
        mgr.drain()
        assert mgr.cancel(["a", "ghost"]) == []
        assert mgr.results()["a"] == 7
        assert rec.count("a") == 1
        assert mgr.scheduler_stats()["cancelled"] == 0
    finally:
        mgr.close()


def test_cancel_shared_key_fires_every_subscriber_once():
    """A shared (content-addressed) key with several subscribed callbacks
    settles TaskCancelled to ALL of them, each exactly once."""
    rec = _Recorder()
    mgr = Manager()
    mgr.start(1)
    try:
        mgr.submit(
            WorkItem(
                key="blk",
                fn=lambda: time.sleep(0.8) or "done",
                callback=rec.cb,
            )
        )
        deadline = time.monotonic() + 30
        while sum(mgr.dispatch_counts.values()) < 1:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        journal = []
        lock = threading.Lock()
        for sub in range(3):
            mgr.submit(
                WorkItem(
                    key="shared",
                    fn=lambda: "never-runs",
                    shared=True,
                    callback=lambda k, v, s=sub: (
                        lock.__enter__(),
                        journal.append((s, v)),
                        lock.__exit__(None, None, None),
                    ),
                )
            )
        assert mgr.cancel(["shared"]) == ["shared"]
        mgr.drain()
        with lock:
            assert sorted(s for s, _ in journal) == [0, 1, 2]
            assert all(isinstance(v, TaskCancelled) for _, v in journal)
    finally:
        mgr.close()
