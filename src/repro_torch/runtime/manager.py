"""Manager — the demand-driven scheduler of the runtime (paper §II: RTF
execution model), with the fault-tolerance features a 1000-node deployment
needs:

* demand-driven dispatch — Workers receive the next bucket when free
  (natural load balancing, same as the paper's 92%-efficiency runs);
* heartbeats + retry — a bucket whose Worker misses its heartbeat deadline
  is re-enqueued (at-least-once; results are idempotent because tasks are
  pure functions of (input, params)); the deadline adapts to observed
  bucket times so a long-running bucket (e.g. a first-time jit compile) is
  not mistaken for a dead Worker, and a lease whose Worker is *provably*
  dead (a killed worker process) is re-enqueued immediately;
* straggler mitigation — when the queue is empty and a bucket has been
  running longer than ``straggler_factor`` × the median bucket time, a
  backup copy is launched on an idle Worker; first completion wins (the
  classic demand-driven tail-cloning trick);
* elastic scaling — Workers can join/leave between buckets; the Manager
  only tracks outstanding leases.

Since DESIGN.md §13 the Manager is a **pure scheduler/bookkeeper**: it owns
the queue, lease table, retry/backup policy and result memoisation, and
executes nothing itself. Execution happens behind the
:class:`~repro_torch.runtime.transport.WorkerBackend` protocol — ``Manager()``
defaults to a :class:`~repro_torch.runtime.transport.ThreadBackend` (the
historical in-process Worker pool), and ``Manager(backend=
ProcessRpcBackend(...))`` drives real worker processes through the same
scheduling semantics, results crossing the boundary only as SharedStore
keys. A single pump thread drives the loop: poll completions → settle/fail
→ expire dead/stale leases → offer leases to free workers.

Sessions are **long-lived** (DESIGN.md §10): ``start`` spawns the Worker
pool once, ``submit`` is legal while Workers are running (including from a
completion callback), ``drain`` blocks until every submitted item has a
result, and ``close`` retires the pool — idempotent, callable from any
thread, and safe to race with ``drain`` (an explicit guarded state
transition, not thread-join ordering). The one-shot ``run`` wrapper keeps
the original batch semantics on top of the same machinery. Per-item
completion callbacks fire exactly once per key — on the *first* completion,
under the same lock that records the result — so a raced straggler backup
can never double-report; the callback body runs outside the lock so it may
re-enter ``submit`` (how the streaming executor chains per-input stage
edges).

**Hierarchical scheduling** (DESIGN.md §15): at paper scale (256 nodes ×
28 cores) a single pump thread is the global serialization point, so
``Manager(hierarchy=...)`` splits dispatch across a manager-of-managers:
the leader pump keeps completions, expiry, liveness and settlement (the
bookkeeping that makes settlement exactly-once stays centralised — one
lock, one attempt sequence, first-completion-wins), and delegates
contiguous lease blocks to N *sub-manager pumps*, each owning a shard of
the WorkerBackend pool. Routing is locality-aware — work is sent to the
sub-manager/worker already holding the longest reuse-tree prefix, tracked
in a per-worker affinity map fed by Completion records — and idle pumps
steal the tail half of the most loaded peer's queue. Items move between
queues only under the Manager lock and leases are still minted centrally,
so a stolen item can never settle twice. ``hierarchy=None`` (the default)
keeps the flat single-pump Manager byte-for-byte.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from repro_torch import trace
from repro_torch.runtime.fairshare import FairQueue, TaskCancelled
from repro_torch.runtime.hierarchy import (
    HierarchySpec,
    best_affinity,
    parse_hierarchy,
    path_lcp,
)
from repro_torch.runtime.transport import (
    Completion,
    Lease,
    RemoteTaskError,
    WorkerStatus,
    make_backend,
)

__all__ = ["WorkItem", "Manager", "TaskCancelled", "run_study_distributed"]

# How many queue-head items a sub-pump scans for the best affinity match
# before falling back to FIFO — bounds locality search per dispatch.
_AFFINITY_WINDOW = 8

# How long the pump blocks per completion poll; bounds the latency of
# straggler/heartbeat detection while the system is idle.
_IDLE_TICK = 0.02
# Parked-pump wake cadence: an idle pool still owes the backend a slow
# heartbeat-frame drain (worker stats ride heartbeats, and a straggler
# lease orphaned by cancel/resubmit completes late and must be consumed)
# — so the park is a timed wait, ~25x sparser than the busy-poll tick.
_PARK_TICK = 0.5

# A worker heartbeat younger than this proves its leases live (only for
# backends whose heartbeats keep flowing mid-task); staler workers fall
# back to age-based expiry, so a wedged-but-running process still recovers.
_LIVENESS_FRESH = 5.0

# Session states — the explicit close()/drain() transition guard.
_NEW, _RUNNING, _CLOSING, _CLOSED = "new", "running", "closing", "closed"


@dataclasses.dataclass
class WorkItem:
    key: str
    fn: Optional[Callable[[], Any]] = None
    attempts: int = 0
    started_at: Optional[float] = None
    # Called exactly once, as fn's first completion (or permanent failure,
    # with the Exception as the value) is recorded. Runs on the Manager's
    # pump thread, outside the Manager lock.
    callback: Optional[Callable[[str, Any], None]] = None
    # Picklable task description for backends that cross a process
    # boundary (transport.Lease ships it; fn never leaves this process).
    spec: Optional[tuple] = None
    # Attempt number this key's CURRENT lifecycle started from. Nonzero
    # only after a forgotten key is resubmitted while a prior lifecycle's
    # lease still ran: attempt numbers stay monotonic per key (so lease
    # ids never collide across lifecycles) and the retry budget is
    # measured from this base instead of zero.
    attempt_base: int = 0
    # Reuse-tree prefix of this item (e.g. (input_key, stage, group)): the
    # hierarchical scheduler routes it toward the sub-manager/worker whose
    # affinity shares the longest common prefix. None opts out of locality.
    path: Optional[tuple] = None
    # Fair-share class (DESIGN.md §18): the dispatch queue deficit-round-
    # robins across tenants, so one tenant's backlog cannot starve another.
    # "" is the shared default class (single-study sessions stay pure FIFO).
    tenant: str = ""
    # Within-tenant dispatch priority: higher first, FIFO within a level.
    priority: int = 0
    # Content-addressed sharing (the service's cross-tenant reuse): a shared
    # submission of a key that is already pending SUBSCRIBES its callback to
    # the in-flight lifecycle instead of enqueueing a duplicate execution,
    # and a shared submission of a settled key is served the memoised value
    # immediately. Requires keys derived from task CONTENT, so identical
    # keys always denote identical pure work.
    shared: bool = False
    # The span that caused this item (repro_torch.trace; None while tracing
    # is off): the parent of its bucket.wait and bucket.run spans. queued_ns
    # is when submit took it, cleared by its first lease.
    parent_span: Optional[trace.Span] = None
    queued_ns: Optional[int] = None


def _lease(item: WorkItem) -> Lease:
    return Lease(key=item.key, attempt=item.attempts, fn=item.fn,
                 spec=item.spec, parent_span=item.parent_span)


class _SubPump:
    """One sub-manager pump: a dispatch thread owning a shard of the
    worker pool and a local queue of UNLEASED WorkItems. All queue
    mutation happens under the owning Manager's lock; leases are minted
    by the Manager's central bookkeeping at offer time."""

    __slots__ = (
        "idx", "worker_ids", "queue", "dispatched", "steals",
        "stolen_items", "busy_seconds", "parked_seconds", "parked_since",
        "thread", "dead",
    )

    def __init__(self, idx: int, worker_ids) -> None:
        self.idx = idx
        self.worker_ids = frozenset(worker_ids)
        self.queue: "collections.deque[WorkItem]" = collections.deque()
        self.dispatched = 0
        self.steals = 0        # times this pump stole a block
        self.stolen_items = 0  # items it acquired by stealing
        self.busy_seconds = 0.0
        self.parked_seconds = 0.0  # time parked on the Manager condvar
        # park-in-progress start time, so stats taken MID-park still see
        # the elapsed idle (folded into parked_seconds when the park ends)
        self.parked_since: Optional[float] = None
        self.thread: Optional[threading.Thread] = None
        self.dead = False


class Manager:
    # Total Worker-pool sessions ever started in this process; the
    # differential suite uses deltas of this to prove execute_study spins up
    # ONE session per study instead of one per stage×input.
    sessions_started = 0

    def __init__(
        self,
        *,
        backend: Any = None,
        max_attempts: int = 3,
        heartbeat_timeout: float = 60.0,
        straggler_factor: float = 3.0,
        enable_backup_tasks: bool = True,
        hierarchy: Any = None,
    ):
        self._backend = make_backend(backend)
        self.hierarchy: HierarchySpec = parse_hierarchy(hierarchy)
        self._hier: HierarchySpec = self.hierarchy  # resolved at start()
        self._subs: List[_SubPump] = []
        self._sub_stop = threading.Event()
        self._sub_error: Optional[BaseException] = None  # guard: _lock
        # Block-delegation cursor: the sub currently receiving the leader's
        # contiguous block, and how many items remain in that block.
        self._block_sub: Optional[_SubPump] = None  # guard: _lock
        self._block_left = 0  # guard: _lock
        # worker_id -> reuse-tree path of its last successful completion:
        # the affinity map behind locality-aware dispatch.
        self._affinity: Dict[int, tuple] = {}  # guard: _lock
        # worker_id -> attempt-seconds it has executed (all attempts, both
        # outcomes) — the per-worker occupancy the benchmark reports.
        self._worker_busy: Dict[int, float] = {}  # guard: _lock
        self._n_workers = 0  # guard: _lock
        self._pump_busy = 0.0  # guard: _lock — leader-pump seconds spent doing work
        # Idle-pool accounting (DESIGN.md §18): seconds the leader pump has
        # spent parked on the condition variable with zero pending work, and
        # the start of an in-progress park — scheduler_stats subtracts this
        # from wall time so idle fractions stay honest across the many-job
        # lifetime of a long-lived service session.
        self._pump_parked = 0.0  # guard: _lock
        self._parked_since: Optional[float] = None  # guard: _lock
        self._session_t0: Optional[float] = None  # guard: _lock
        self._session_t1: Optional[float] = None  # guard: _lock
        self.steals = 0  # guard: _lock
        self.steal_items = 0  # guard: _lock
        self.locality_hits = 0  # guard: _lock
        self.locality_misses = 0  # guard: _lock
        self._queue: FairQueue = FairQueue()  # guard: _lock
        self._results: Dict[str, Any] = {}  # guard: _lock
        self._running: Dict[str, WorkItem] = {}  # guard: _lock
        self._attempt_seq: Dict[str, int] = {}  # guard: _lock — highest attempt # issued per key
        # key -> callbacks subscribed to its first completion. A list, not a
        # single slot: shared (content-addressed) submissions subscribe many
        # jobs to one lifecycle; every callback fires exactly once.
        self._callbacks: Dict[str, List[Callable[[str, Any], None]]] = {}  # guard: _lock
        self._pending: set = set()  # guard: _lock — keys submitted, no result yet
        # Keys forgotten while still holding a lease: their bookkeeping is
        # kept for first-completion-wins dedup and released when the last
        # lease settles (drained in _settle), so a long-lived fleet session
        # stays bounded even when forget() races in-flight attempts.
        self._deferred_forget: set = set()  # guard: _lock
        # Lease ids stranded by a key's resubmission (a new lifecycle began
        # while the old lifecycle's attempt still ran): their completions
        # must not settle the new lifecycle, so they are dropped on arrival.
        self._orphaned: set = set()  # guard: _lock
        # Recent-window of winning-attempt durations for the straggler /
        # heartbeat heuristics: bounded so a session spanning thousands of
        # inputs never grows the median computation, with the sorted median
        # cached between appends (the pump polls it every tick).
        self._durations: "collections.deque[float]" = collections.deque(maxlen=512)  # guard: _lock
        self._median_cache: Optional[float] = None  # guard: _lock
        self._busy_total = 0.0  # guard: _lock — lifetime sum (the efficiency numerator)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._pump_thread: Optional[threading.Thread] = None
        self._state = _NEW  # guard: _lock
        self.max_attempts = max_attempts
        self.heartbeat_timeout = heartbeat_timeout
        self.straggler_factor = straggler_factor
        self.enable_backup_tasks = enable_backup_tasks
        self.retries = 0  # guard: _lock
        self.backups_launched = 0  # guard: _lock
        self.heartbeat_expiries = 0  # guard: _lock
        self.cancelled = 0  # guard: _lock — keys revoked via cancel()
        # Leases handed to each backend (keyed by backend name) over this
        # Manager's lifetime — the per-backend dispatch accounting surfaced
        # by study summaries.
        self.dispatch_counts: Dict[str, int] = {}  # guard: _lock
        # Leases minted per fair-share tenant — the service/benchmark proof
        # that deficit-round-robin actually shares the dispatch path.
        self.tenant_dispatch: Dict[str, int] = {}  # guard: _lock

    @property
    def backend(self):
        """The WorkerBackend this session dispatches through."""
        return self._backend

    @property
    def backend_name(self) -> str:
        return getattr(self._backend, "name", type(self._backend).__name__)

    @property
    def is_running(self) -> bool:
        """True between ``start`` and the completion of ``close`` — i.e.
        the session can still execute work."""
        # analysis: ok[locks] deliberately lock-free status probe; _state is
        # a small int and a stale answer is as good as one a tick later
        return self._state in (_RUNNING, _CLOSING)

    @property
    def busy_seconds(self) -> float:
        """Sum of winning-attempt wall-times — the useful-work numerator of
        the parallel-efficiency accounting."""
        with self._lock:
            return self._busy_total

    def scheduler_stats(self) -> Dict[str, Any]:
        """Snapshot of the scheduler's shape and health: hierarchy mode and
        fanout, work-stealing and locality counters, pump occupancy (the
        fraction of session wall-time each pump spent doing scheduling
        work — the serialization metric the hierarchy exists to fix), and
        per-worker busy seconds / mean idle fraction."""
        now = time.monotonic()
        with self._lock:
            t0 = self._session_t0
            t1 = self._session_t1 if self._session_t1 is not None else now
            wall = max(t1 - t0, 1e-9) if t0 is not None else 0.0
            parked = self._pump_parked
            if self._parked_since is not None and self._session_t1 is None:
                parked += now - self._parked_since
            # Idle fractions are measured against ACTIVE wall — session
            # wall minus the time the pump sat parked with zero pending
            # work — so a long-lived session that served three jobs over
            # an hour reports how busy the workers were while there WAS
            # work, not how empty the hour was.
            active = max(wall - parked, 0.0)
            denom = active if active > 1e-9 else wall
            hits, misses = self.locality_hits, self.locality_misses
            worker_busy = dict(self._worker_busy)
            n_workers = max(1, self._n_workers)
            stats: Dict[str, Any] = {
                "mode": "hierarchical" if self._subs else "flat",
                "fanout": len(self._subs) if self._subs else 1,
                "steals": self.steals,
                "steal_items": self.steal_items,
                "locality_hits": hits,
                "locality_misses": misses,
                "locality_hit_rate": (
                    hits / (hits + misses) if (hits + misses) else 0.0
                ),
                "pump_occupancy": self._pump_busy / denom if denom else 0.0,
                "pump_parked_seconds": parked,
                "active_wall_seconds": active,
                "sub_occupancy": [
                    s.busy_seconds / denom if denom else 0.0
                    for s in self._subs
                ],
                "sub_parked_seconds": [
                    s.parked_seconds
                    + (now - s.parked_since if s.parked_since is not None else 0.0)
                    for s in self._subs
                ],
                "dispatched_per_sub": [s.dispatched for s in self._subs],
                "steals_per_sub": [s.steals for s in self._subs],
                "worker_busy_seconds": worker_busy,
                "worker_idle_fraction": (
                    min(
                        1.0,
                        max(
                            0.0,
                            1.0
                            - sum(worker_busy.values()) / (denom * n_workers),
                        ),
                    )
                    if denom
                    else 0.0
                ),
                "wall_seconds": wall,
                "cancelled": self.cancelled,
                "tenant_dispatch": dict(self.tenant_dispatch),
                "tenant_depths": self._queue.depths(),
            }
        return stats

    def _record_duration_locked(self, dur: float) -> None:
        self._durations.append(dur)
        self._busy_total += dur
        self._median_cache = None

    def _median_locked(self) -> Optional[float]:
        if not self._durations:
            return None
        if self._median_cache is None:
            ordered = sorted(self._durations)
            self._median_cache = ordered[len(ordered) // 2]
        return self._median_cache

    # ------------------------------------------------------------------
    # Session lifecycle
    # ------------------------------------------------------------------
    def start(self, n_workers: int) -> None:
        """Spawn the Worker pool through the backend and start the pump.
        One session may span many stages and many inputs; submitting while
        Workers run is the intended usage."""
        with self._cond:
            if self._state in (_RUNNING, _CLOSING):
                raise RuntimeError("Manager session already started")
            prev = self._state
            self._state = _RUNNING
        try:
            self._backend.start(max(1, n_workers))
        except BaseException:
            with self._cond:  # roll back: no zombie "running" session with
                self._state = prev  # no pump to ever settle submissions
                self._cond.notify_all()
            raise
        Manager.sessions_started += 1
        wids = sorted(self._backend.heartbeat_view().keys())
        with self._lock:
            self._n_workers = len(wids) or max(1, n_workers)
            self._session_t0 = time.monotonic()
            self._session_t1 = None
            self._hier = self.hierarchy.resolve(self._n_workers)
            self._sub_error = None
            self._sub_stop = threading.Event()
            self._subs = []
            self._block_sub = None
            self._block_left = 0
            if self._hier.fanout > 1 and wids:
                # contiguous worker-id shards, one per sub-manager pump
                fanout = self._hier.fanout
                n = len(wids)
                self._subs = [
                    _SubPump(g, wids[g * n // fanout: (g + 1) * n // fanout])
                    for g in range(fanout)
                ]
        for sub in self._subs:
            sub.thread = threading.Thread(
                target=self._sub_pump, args=(sub,), daemon=True
            )
            sub.thread.start()
        self._pump_thread = threading.Thread(target=self._pump, daemon=True)
        self._pump_thread.start()

    def submit(self, item: WorkItem) -> None:
        """Enqueue work; legal before ``start`` and while Workers run.
        Re-submitting a key that already has a result is a no-op — EXCEPT
        when that result is a stale memo retained only for a forgotten
        key's still-running lease (deferred forget): the caller has ended
        that lifecycle, so this submission starts a NEW one. The stale
        memo is released, the old lifecycle's leases are orphaned (their
        completions are dropped on arrival — they may have run under a
        different scope, so their values must never settle this
        lifecycle), and attempt numbering continues from the old high
        water mark so lease ids stay unique across lifecycles.

        ``item.shared`` opts into **content-addressed sharing** (DESIGN.md
        §18): a shared submission of a key already pending subscribes its
        callback to the in-flight lifecycle (no duplicate execution), and
        a shared submission of a settled key is served the memoised value
        immediately — the mechanism by which N tenants submitting
        identical pure work pay for it once."""
        memo_value: Any = None
        serve_memo = False
        with self._cond:
            if self._state in (_CLOSING, _CLOSED):
                raise RuntimeError("Manager session is closed")
            if item.key in self._deferred_forget:
                self._deferred_forget.discard(item.key)
                self._results.pop(item.key, None)
                self._callbacks.pop(item.key, None)
                for lid in [
                    lid for lid, it in self._running.items() if it.key == item.key
                ]:
                    self._orphaned.add(lid)
                    del self._running[lid]
                # queued duplicates (heartbeat-expiry re-enqueues racing in
                # after forget) carry the OLD lifecycle's closure — purge
                # every queue they may sit in (global + delegated shards)
                self._queue.remove_keys({item.key})
                for sub in self._subs:
                    if any(it.key == item.key for it in sub.queue):
                        sub.queue = collections.deque(
                            it for it in sub.queue if it.key != item.key
                        )
                item.attempt_base = self._attempt_seq.get(item.key, 0)
            if item.key in self._results:
                if item.shared and item.callback is not None:
                    # served the live memo below, OUTSIDE the lock — the
                    # callback may re-enter submit()
                    serve_memo = True
                    memo_value = self._results[item.key]
                # historical contract: non-shared resubmit of a settled
                # key is a silent no-op
            elif (
                item.shared
                and item.key in self._pending
            ):
                # subscribe to the in-flight lifecycle: exactly-once per
                # subscriber, zero duplicate execution
                if item.callback is not None:
                    self._callbacks.setdefault(item.key, []).append(
                        item.callback
                    )
            else:
                if item.callback is not None:
                    if item.shared:
                        self._callbacks.setdefault(item.key, []).append(
                            item.callback
                        )
                    else:
                        # historical single-slot semantics: the latest
                        # non-shared submission's callback wins
                        self._callbacks[item.key] = [item.callback]
                self._pending.add(item.key)
                if trace.active():
                    item.queued_ns = trace.now_ns()
                self._queue.append(item)
                self._cond.notify_all()
        if serve_memo:
            item.callback(item.key, memo_value)

    def drain(self) -> None:
        """Block until every submitted key has a result (success or
        permanent failure). Workers stay alive — more work may follow.

        When the backend acknowledges completions ahead of their disk
        commit (``async_commit``), drain is also the durability point: it
        invokes the backend's ``barrier()`` so that after it returns, every
        result is resolvable from the store by any process — the same
        contract callers had when workers committed synchronously."""
        with self._cond:
            while self._pending:
                self._cond.wait(_IDLE_TICK)
        barrier = getattr(self._backend, "barrier", None)
        if barrier is not None:
            barrier()

    def close(self) -> None:
        """Retire the Worker pool. Completes everything already submitted
        first (in-flight attempts and queued work all settle), then shuts
        the backend down.

        Idempotent and thread-safe: a second ``close`` — from any thread,
        including one racing ``drain`` — observes the guarded state
        transition and simply waits for the first closer to finish instead
        of double-joining the pool."""
        with self._cond:
            if self._state in (_NEW, _CLOSED):
                self._state = _CLOSED
                self._cond.notify_all()
                return
            if self._state == _CLOSING:
                # another thread owns the shutdown: wait it out
                while self._state != _CLOSED:
                    self._cond.wait(_IDLE_TICK)
                return
            self._state = _CLOSING
            self._cond.notify_all()
            pump = self._pump_thread
        if pump is not None:
            pump.join()
        self._sub_stop.set()
        with self._cond:
            self._cond.notify_all()  # unpark sub-pumps so they see the stop
        for sub in self._subs:
            if sub.thread is not None:
                sub.thread.join()
                sub.thread = None
        self._backend.shutdown()
        with self._cond:
            if self._session_t0 is not None and self._session_t1 is None:
                self._session_t1 = time.monotonic()
            self._state = _CLOSED
            self._pump_thread = None
            self._cond.notify_all()

    def results(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self._results)

    def forget(self, keys) -> None:
        """Release memoised results + attempt bookkeeping for keys whose
        lifecycle is over (drained, consumed). A long-lived session would
        otherwise retain every settled WorkItem's value for its whole life
        — the streaming executor calls this per study when sharing a
        session across an adaptive study's rounds.

        Two races are closed under the lock: stale queued duplicates of a
        forgotten key (heartbeat-expiry re-enqueues) are purged — without
        their memoised result they would re-execute — and a key whose
        losing attempt (straggler backup / presumed-dead original) still
        holds a lease keeps its result, so the late completion dedups via
        first-completion-wins instead of resurrecting a value. Such keys
        join the deferred-forget set and are released when their last lease
        settles."""
        with self._cond:
            keyset = set(keys)
            if not keyset:
                return
            self._queue.remove_keys(keyset)
            for sub in self._subs:
                if any(it.key in keyset for it in sub.queue):
                    sub.queue = collections.deque(
                        it for it in sub.queue if it.key not in keyset
                    )
            leased = {it.key for it in self._running.values()}
            # Keys with an outstanding ORPHANED lease are held too: their
            # drop-marker carries a lease id minted from the key's attempt
            # sequence, so releasing the sequence now would let a future
            # lifecycle re-mint a colliding id and have its completion
            # silently dropped. They drain when the orphan settles/dies.
            orphan_keys = {
                lid.rsplit("#", 1)[0] for lid in self._orphaned
            }
            self._deferred_forget |= keyset & (leased | orphan_keys)
            for k in keyset - leased - orphan_keys:
                self._results.pop(k, None)
                self._attempt_seq.pop(k, None)
                self._callbacks.pop(k, None)

    def cancel(self, keys) -> List[str]:
        """Revoke submitted-but-unsettled keys (DESIGN.md §18): queued
        work is purged from every queue (global + delegated shards), live
        leases are poisoned (their ids join the orphan set, so the
        worker's eventual completion is dropped on arrival — the worker
        itself is not interrupted mid-task), and each revoked key settles
        exactly once with :class:`TaskCancelled` as its value, firing its
        callbacks like any other permanent failure. Keys already settled
        or never submitted are left untouched. Returns the keys actually
        cancelled.

        After cancel, ``forget`` + re-``submit`` of the same key starts a
        clean new lifecycle: attempt numbering continues from the high
        water mark, so a straggling poisoned lease can never collide with
        — or settle — the new lifecycle."""
        cancelled: List[str] = []
        with self._cond:
            keyset = set(keys)
            if not keyset:
                return cancelled
            live = {
                k for k in keyset
                if k in self._pending and k not in self._results
            }
            if not live:
                return cancelled
            self._queue.remove_keys(live)
            for sub in self._subs:
                if any(it.key in live for it in sub.queue):
                    sub.queue = collections.deque(
                        it for it in sub.queue if it.key not in live
                    )
            for lid, it in list(self._running.items()):
                if it.key in live:
                    self._orphaned.add(lid)
                    del self._running[lid]
            cancelled = sorted(live)
            self.cancelled += len(cancelled)
        # settle outside the lock: callbacks may re-enter submit()
        for key in cancelled:
            self._settle(key, 0, TaskCancelled(f"cancelled: {key!r}"), None)
        return cancelled

    def set_tenant_weight(self, tenant: str, weight: float) -> None:
        """Set a fair-share tenant's dispatch quantum (default 1.0; higher
        drains proportionally faster, floor-clamped so every tenant keeps
        making progress)."""
        with self._lock:
            self._queue.set_weight(tenant, weight)

    def _drain_deferred_locked(self, key: str) -> None:
        """Release a deferred-forgotten key's bookkeeping once its LAST
        lease has been returned (caller holds the lock and has already
        popped its own lease). While any other attempt is still in flight
        — including a poisoned orphan whose drop-marker was minted from
        this key's attempt sequence — the bookkeeping must survive so the
        late completion dedups instead of colliding."""
        if key not in self._deferred_forget:
            return
        if any(it.key == key for it in self._running.values()):
            return
        if any(lid.rsplit("#", 1)[0] == key for lid in self._orphaned):
            return
        self._deferred_forget.discard(key)
        self._results.pop(key, None)
        self._attempt_seq.pop(key, None)
        self._callbacks.pop(key, None)

    # ------------------------------------------------------------------
    # Scheduling (pump-side)
    # ------------------------------------------------------------------
    def _next_locked(self) -> Optional[WorkItem]:
        # Dequeue and lease registration are atomic under one lock: a peer
        # observing (queue empty, no leases) under that lock can therefore
        # conclude the system is idle — there is no window where an item has
        # left the queue but is not yet visible in ``_running``. Items whose
        # key already has a result (a raced retry/backup) are dropped here,
        # before any lease exists, so they can never leak one.
        while True:
            if not self._queue:
                item = self._maybe_backup_locked()
                if item is None:
                    return None
                break
            item = self._queue.popleft()
            if item.key not in self._results:
                break
        self._lease_locked(item)
        return item

    def _lease_locked(self, item: WorkItem) -> None:
        """Mint a lease for ``item`` under the Manager lock. Attempt
        numbers are issued centrally — here and ONLY here — so concurrent
        attempts of one key (original + backup, or a stolen re-dispatch)
        always hold distinct leases, whichever pump leases them."""
        if item.queued_ns is not None:
            trace.record("bucket.wait", "manager dispatch", item.queued_ns,
                         trace.now_ns(), item.parent_span, key=item.key)
            item.queued_ns = None
        item.started_at = time.monotonic()
        item.attempts = self._attempt_seq.get(item.key, 0) + 1
        self._attempt_seq[item.key] = item.attempts
        self._running[f"{item.key}#{item.attempts}"] = item
        self.tenant_dispatch[item.tenant] = (
            self.tenant_dispatch.get(item.tenant, 0) + 1
        )

    # -- hierarchical scheduling (leader + sub-manager pumps) ----------
    def _route_locked(self, item: WorkItem) -> Optional[_SubPump]:
        """Pick the sub-manager to delegate ``item`` to: the shard whose
        workers hold the longest reuse-tree prefix of ``item.path`` wins
        (locality); otherwise the leader fills contiguous blocks of
        ``block_size`` into the currently-shortest queue."""
        subs = [s for s in self._subs if not s.dead]
        if not subs:
            return None
        if self._hier.locality and item.path:
            best: Optional[_SubPump] = None
            best_l = 0
            for s in subs:
                l = best_affinity(
                    item.path, [self._affinity.get(w) for w in s.worker_ids]
                )
                if l > best_l:
                    best, best_l = s, l
            if best is not None:
                return best
        if (
            self._block_left <= 0
            or self._block_sub is None
            or self._block_sub.dead
        ):
            self._block_sub = min(subs, key=lambda s: len(s.queue))
            self._block_left = self._hier.block_size
        self._block_left -= 1
        return self._block_sub

    def _distribute_locked(self) -> int:
        """Leader-side delegation: move everything queued globally into the
        sub-manager queues (locality first, contiguous blocks otherwise).
        With nothing queued anywhere, fall back to straggler backup-task
        cloning — the clone is delegated like any other item, and a queued
        clone blocks further cloning of the same key (the all-queues-empty
        guard) until it is leased."""
        moved = 0
        while self._queue:
            item = self._queue.popleft()
            sub = self._route_locked(item)
            if sub is None:  # every sub-pump died; leader will fail over
                self._queue.appendleft(item)
                return moved
            sub.queue.append(item)
            moved += 1
        if moved == 0 and not any(s.queue for s in self._subs):
            clone = self._maybe_backup_locked()
            if clone is not None:
                sub = self._route_locked(clone)
                if sub is not None:
                    sub.queue.append(clone)
                    moved += 1
        return moved

    def _steal_locked(self, thief: _SubPump) -> int:
        """Work stealing: an idle pump takes the tail half of the most
        loaded peer's queue (relative order preserved). Items are unleased
        while queued, and the move happens under the Manager lock, so
        exactly-once settlement is untouched — the thief simply becomes
        the pump that eventually mints the lease."""
        victim: Optional[_SubPump] = None
        for s in self._subs:
            if s is thief or s.dead:
                continue
            if victim is None or len(s.queue) > len(victim.queue):
                victim = s
        if victim is None or len(victim.queue) < max(2, self._hier.steal_min):
            return 0
        n = len(victim.queue) // 2
        stolen = [victim.queue.pop() for _ in range(n)]
        stolen.reverse()
        thief.queue.extend(stolen)
        thief.steals += 1
        thief.stolen_items += n
        self.steals += 1
        self.steal_items += n
        return n

    def _next_sub_locked(
        self, sub: _SubPump, worker_id: Optional[int] = None
    ) -> Optional[WorkItem]:
        """Dequeue-and-lease from a sub-manager's queue. With a target
        worker and locality enabled, the first ``_AFFINITY_WINDOW`` items
        are scanned for the longest prefix match against that worker's
        affinity path; otherwise FIFO. Locality hits/misses are tallied
        here — a hit means the chosen placement shares ≥1 path segment
        with the worker's (or, for shard-batched dispatch, the shard's)
        last completed work."""
        while sub.queue:
            idx = 0
            best_l = 0
            if self._hier.locality and worker_id is not None:
                aff = self._affinity.get(worker_id)
                if aff:
                    window = min(len(sub.queue), _AFFINITY_WINDOW)
                    for j in range(window):
                        it = sub.queue[j]
                        l = path_lcp(it.path, aff)
                        if l > best_l:
                            best_l, idx = l, j
            if idx:
                sub.queue.rotate(-idx)
                item = sub.queue.popleft()
                sub.queue.rotate(idx)
            else:
                item = sub.queue.popleft()
            if item.key in self._results:
                continue
            if self._hier.locality and item.path is not None:
                if worker_id is not None:
                    hit = best_l >= 1
                else:
                    hit = (
                        best_affinity(
                            item.path,
                            [self._affinity.get(w) for w in sub.worker_ids],
                        )
                        >= 1
                    )
                if hit:
                    self.locality_hits += 1
                else:
                    self.locality_misses += 1
            self._lease_locked(item)
            return item
        return None

    def _unlease_locked(self, item: WorkItem) -> None:
        """Revert ``_next_locked`` for a lease no worker accepted (a slot
        vanished between the demand snapshot and the offer — e.g. a worker
        died). The attempt number is returned too: nothing outside this
        process ever observed it."""
        lid = f"{item.key}#{item.attempts}"
        if lid in self._orphaned:
            # the lease was cancelled/orphaned between minting and the
            # rejected offer: the drop-marker has done its job (nothing
            # was ever dispatched) — discard it WITHOUT reverting the
            # attempt sequence, so the marker's id can never be re-minted
            # by the key's next lifecycle.
            self._orphaned.discard(lid)
            self._drain_deferred_locked(item.key)
            return
        self._running.pop(lid, None)
        if self._attempt_seq.get(item.key) == item.attempts:
            self._attempt_seq[item.key] = item.attempts - 1
        if item.key not in self._results:
            self._queue.appendleft(item)

    def _expire_dead_locked(
        self, view: Dict[int, WorkerStatus], to_settle: List
    ) -> None:
        """Re-enqueue leases held by provably-dead workers (a worker
        process that no longer exists). Unlike age-based expiry this is
        immediate — there is no ambiguity to adapt a deadline around. A key
        out of attempts with no other live lease settles as a permanent
        failure (appended to ``to_settle``; the caller settles outside the
        lock)."""
        for status in view.values():
            if status.alive:
                continue
            for lease_id in status.inflight:
                item = self._running.pop(lease_id, None)
                if item is None:
                    # an orphaned lease dies with its worker: no completion
                    # will ever arrive to drain its drop-marker
                    if lease_id in self._orphaned:
                        self._orphaned.discard(lease_id)
                        self._drain_deferred_locked(
                            lease_id.rsplit("#", 1)[0]
                        )
                    continue
                self.heartbeat_expiries += 1
                if item.key in self._results:
                    self._drain_deferred_locked(item.key)
                    continue
                if (
                    self._attempt_seq.get(item.key, 0) - item.attempt_base
                    < self.max_attempts
                ):
                    self.retries += 1
                    self._queue.append(
                        WorkItem(key=item.key, fn=item.fn, spec=item.spec,
                                 attempt_base=item.attempt_base,
                                 path=item.path, tenant=item.tenant,
                                 priority=item.priority,
                                 parent_span=item.parent_span)
                    )
                    self._cond.notify_all()
                elif not any(
                    it.key == item.key for it in self._running.values()
                ):
                    to_settle.append(
                        (
                            item.key,
                            item.attempts,
                            RemoteTaskError(
                                f"worker died holding the last attempt of "
                                f"{item.key!r}"
                            ),
                        )
                    )

    def _expire_heartbeats_locked(
        self, view: Optional[Dict[int, WorkerStatus]] = None
    ) -> None:
        """Re-enqueue leases whose Worker missed the heartbeat deadline.
        The lease is released; if the presumed-dead attempt does return
        later, first-completion-wins dedups it.

        In-process Workers cannot prove liveness while inside a task fn, so
        a long bucket is indistinguishable from a dead Worker by age alone.
        The deadline therefore adapts to observed bucket times — ``max(
        heartbeat_timeout, straggler_factor × median)`` — and with no
        completed-bucket history yet (e.g. the first bucket is a multi-
        minute jit compile) nothing is ever expired.

        ``view`` is passed only by backends whose heartbeats PROVE liveness
        mid-task (the RPC backend's workers sign life from a side thread):
        a lease held by a worker seen alive within ``_LIVENESS_FRESH``
        seconds is never age-expired — a long bucket on a live remote
        worker gets a straggler backup clone, not a revoked lease. A
        wedged worker whose heartbeats stop re-enters age-based expiry.
        (Provably-dead workers are handled separately and immediately by
        ``_expire_dead_locked``.)"""
        median = self._median_locked()
        if median is None:
            return
        deadline = max(self.heartbeat_timeout, self.straggler_factor * median)
        now = time.monotonic()
        proven_live: set = set()
        if view is not None:
            for status in view.values():
                if status.alive and now - status.last_seen <= _LIVENESS_FRESH:
                    proven_live.update(status.inflight)
        for lease, it in list(self._running.items()):
            if it.key in self._results:
                continue
            if lease in proven_live:
                continue
            started = it.started_at or now
            if now - started <= deadline:
                continue
            if (
                self._attempt_seq.get(it.key, 0) - it.attempt_base
                >= self.max_attempts
            ):
                continue
            del self._running[lease]
            self.heartbeat_expiries += 1
            self.retries += 1
            self._queue.append(WorkItem(key=it.key, fn=it.fn, spec=it.spec,
                                        attempt_base=it.attempt_base,
                                        path=it.path, tenant=it.tenant,
                                        priority=it.priority,
                                        parent_span=it.parent_span))
            self._cond.notify_all()

    def _maybe_backup_locked(self) -> Optional[WorkItem]:
        """Clone the longest-running bucket if it looks like a straggler.
        Caller holds ``self._lock``. At most one backup of a key is in
        flight at a time: while original + clone both run, the key holds two
        leases and is skipped."""
        if not self.enable_backup_tasks:
            return None
        if not self._running or len(self._durations) < 2:
            return None
        median = self._median_locked()
        now = time.monotonic()
        candidates = [
            it
            for it in self._running.values()
            if it.key not in self._results
            and sum(1 for other in self._running.values() if other.key == it.key) < 2
            and self._attempt_seq.get(it.key, 0) - it.attempt_base
            < self.max_attempts
        ]
        if not candidates:
            return None
        worst = max(candidates, key=lambda it: now - (it.started_at or now))
        age = now - (worst.started_at or now)
        if age > self.straggler_factor * max(median, 1e-3):
            self.backups_launched += 1
            return WorkItem(key=worst.key, fn=worst.fn, spec=worst.spec,
                            attempt_base=worst.attempt_base,
                            path=worst.path, tenant=worst.tenant,
                            priority=worst.priority,
                            parent_span=worst.parent_span)
        return None

    def _sub_pump(self, sub: _SubPump) -> None:
        """Sub-manager pump thread wrapper: a crashed pump returns its
        unleased work to the leader (which redistributes to surviving
        pumps); when the LAST pump dies the leader fails the session's
        pending work loudly instead of letting drain() hang."""
        try:
            self._sub_pump_loop(sub)
        except BaseException as err:  # noqa: BLE001 — fail over to leader
            with self._cond:
                sub.dead = True
                while sub.queue:
                    self._queue.append(sub.queue.popleft())
                if all(s.dead for s in self._subs):
                    self._sub_error = err
                self._cond.notify_all()

    def _sub_pump_loop(self, sub: _SubPump) -> None:
        backend = self._backend
        offer_to = getattr(backend, "offer_to", None)
        offer_batch = getattr(backend, "offer_batch", None)
        slots = max(1, int(getattr(backend, "slots_per_worker", 1)))
        while not self._sub_stop.is_set():
            # Same idle-pool parking as the leader: with zero pending work
            # the shard pump blocks on the Manager condvar instead of
            # spinning on heartbeat snapshots. Woken by submit()/close()/
            # the leader's delegation notify; state changes and sub-errors
            # break the predicate so shutdown is never missed.
            with self._cond:
                if (
                    self._state == _RUNNING
                    and self._sub_error is None
                    and not self._sub_stop.is_set()
                    and not self._pending
                    and not self._running
                    and not self._queue
                    and not any(s.queue for s in self._subs)
                ):
                    t_park = time.monotonic()
                    sub.parked_since = t_park
                    self._cond.wait()
                    sub.parked_seconds += time.monotonic() - t_park
                    sub.parked_since = None
                    continue
            view = backend.heartbeat_view()
            alive = {
                wid: st
                for wid, st in view.items()
                if wid in sub.worker_ids and st.alive
            }
            if not alive and all(wid in view for wid in sub.worker_ids):
                # the WHOLE shard died (worker death is permanent): this
                # pump can never dispatch again, and peers only steal from
                # queues ≥ steal_min — a single queued item would strand.
                # Retire cleanly: return unleased work to the leader, which
                # redistributes to surviving shards (or, with the pool
                # fully dead, fails pending loudly via its dead-pool path).
                with self._cond:
                    sub.dead = True
                    while sub.queue:
                        self._queue.append(sub.queue.popleft())
                    self._cond.notify_all()
                return
            free = sum(
                max(0, slots - len(st.inflight)) for st in alive.values()
            )
            if free <= 0:
                # all shard slots busy: wait a tick (woken early by any
                # settle/submit notify) instead of a blind sleep
                with self._cond:
                    self._cond.wait(_IDLE_TICK)
                continue
            if self._hier.steal:
                with self._cond:
                    if not sub.queue:
                        self._steal_locked(sub)
            t0 = time.monotonic()
            if offer_batch is not None:
                did = self._sub_dispatch_batched(sub, offer_batch, free)
            else:
                did = self._sub_dispatch_targeted(
                    sub, alive, slots, offer_to
                )
            if did:
                sub.busy_seconds += time.monotonic() - t0
            else:
                with self._cond:
                    self._cond.wait(_IDLE_TICK)

    def _sub_dispatch_targeted(
        self, sub: _SubPump, alive: Dict[int, WorkerStatus], slots: int,
        offer_to,
    ) -> int:
        """Per-worker targeted dispatch (thread backend): each free worker
        in the shard gets the queued item with the longest affinity-prefix
        match. Falls back to untargeted ``offer`` if the backend cannot
        address workers (shard ownership then degrades to advisory)."""
        dispatched = 0
        for wid, st in alive.items():
            if len(st.inflight) >= slots:
                continue
            with self._cond:
                item = self._next_sub_locked(sub, worker_id=wid)
            if item is None:
                break
            lease = _lease(item)
            ok = (
                offer_to(lease, wid)
                if offer_to is not None
                else self._backend.offer(lease)
            )
            if ok:
                dispatched += 1
                with self._cond:
                    sub.dispatched += 1
                    self.dispatch_counts[self.backend_name] = (
                        self.dispatch_counts.get(self.backend_name, 0) + 1
                    )
            else:  # slot vanished since the snapshot (worker death)
                with self._cond:
                    self._unlease_locked(item)
                break
        return dispatched

    def _sub_dispatch_batched(self, sub: _SubPump, offer_batch, free: int) -> int:
        """Shard-restricted batched dispatch (process backend): lease up
        to ``free`` items and hand them to the backend restricted to this
        sub-manager's workers. Shards partition the pool, so concurrent
        sub-pumps touch disjoint worker handles."""
        batch: List[WorkItem] = []
        with self._cond:
            while len(batch) < free:
                item = self._next_sub_locked(sub)
                if item is None:
                    break
                batch.append(item)
        if not batch:
            return 0
        leases = [_lease(it) for it in batch]
        try:
            rejected = {
                lease.lease_id
                for lease in offer_batch(leases, worker_ids=sub.worker_ids)
            }
        except TypeError:  # backend without shard targeting: untargeted
            rejected = {lease.lease_id for lease in offer_batch(leases)}
        accepted = len(batch) - len(rejected)
        with self._cond:
            if accepted:
                sub.dispatched += accepted
                self.dispatch_counts[self.backend_name] = (
                    self.dispatch_counts.get(self.backend_name, 0) + accepted
                )
            for it in reversed(batch):
                if f"{it.key}#{it.attempts}" in rejected:
                    self._unlease_locked(it)
        return accepted

    def _settle(
        self, key: str, attempt: int, value: Any, duration: Optional[float]
    ) -> None:
        """Record a final value (result or permanent failure) for a key and
        fire its callback exactly once. The key stays in ``_pending`` until
        the callback returns, so ``drain`` cannot observe a momentarily-empty
        pending set while a callback is still about to submit downstream
        work (the per-input stage edge of the streaming executor)."""
        cbs: Optional[List[Callable[[str, Any], None]]] = None
        won = False
        with self._cond:
            self._running.pop(f"{key}#{attempt}", None)
            if key not in self._results:  # first completion wins
                won = True
                self._results[key] = value
                if duration is not None and not isinstance(value, Exception):
                    self._record_duration_locked(duration)
                cbs = self._callbacks.pop(key, None)
            self._drain_deferred_locked(key)
            self._cond.notify_all()
        if not won:  # raced duplicate: the winner owns callback + pending
            return
        try:
            if cbs:
                # every subscriber of the lifecycle fires exactly once —
                # shared submissions fan one completion out to many jobs
                for cb in cbs:
                    cb(key, value)
        finally:
            with self._cond:
                self._pending.discard(key)
                self._cond.notify_all()

    def _handle_completion(self, comp: Completion) -> None:
        with self._cond:
            if comp.lease_id in self._orphaned:
                # a lease stranded by its key's resubmission or
                # cancellation (new lifecycle): the value may be from
                # another scope — drop it. The marker may have been the
                # last thing pinning a deferred-forgotten key.
                self._orphaned.discard(comp.lease_id)
                self._drain_deferred_locked(comp.key)
                return
            item = self._running.get(comp.lease_id)
            if comp.worker_id is not None:
                if comp.duration:
                    self._worker_busy[comp.worker_id] = (
                        self._worker_busy.get(comp.worker_id, 0.0)
                        + comp.duration
                    )
                if comp.ok and item is not None and item.path is not None:
                    # feed the affinity map: this worker now holds the
                    # reuse-tree prefix of the work it just finished
                    self._affinity[comp.worker_id] = item.path
        if comp.ok:
            self._settle(comp.key, comp.attempt, comp.value, comp.duration)
            return
        err = comp.exc if comp.exc is not None else RemoteTaskError(
            comp.error or "remote task failed"
        )
        # Lease release and re-enqueue happen under one lock so peers never
        # observe (queue empty, no leases) while a retry is still in flight.
        with self._cond:
            self._running.pop(comp.lease_id, None)
            if (
                item is not None
                and item.attempts - item.attempt_base < self.max_attempts
                and item.key not in self._results
            ):
                self.retries += 1
                # attempt numbers are issued by _next_locked at lease time
                self._queue.append(
                    WorkItem(key=item.key, fn=item.fn, spec=item.spec,
                             attempt_base=item.attempt_base,
                             path=item.path, tenant=item.tenant,
                             priority=item.priority,
                             parent_span=item.parent_span)
                )
                self._cond.notify_all()
                return
            if item is None and comp.key not in self._results:
                # the lease was already expired and re-driven; this late
                # failure report must not settle the key under the retry
                return
            if any(it.key == comp.key for it in self._running.values()):
                # an out-of-attempts failure must not condemn the key while
                # another attempt (straggler original / backup clone) is
                # still live — first COMPLETION wins, and if that attempt
                # also fails, ITS failure settles (it will find no live
                # peer then). Same guard _expire_dead_locked applies.
                return
        self._settle(comp.key, comp.attempt, err, None)

    def _pump(self) -> None:
        """The scheduling loop: one thread drives completions, expiry and
        dispatch for the whole session, leaving execution entirely to the
        backend. A structural backend failure fails the session's pending
        work loudly instead of leaving ``drain`` waiting on a dead pump."""
        try:
            self._pump_loop()
        except BaseException as pump_err:  # noqa: BLE001 — fail pending work
            self._sub_stop.set()
            with self._cond:
                delegated = [it for s in self._subs for it in s.queue]
                stranded = {
                    it.key
                    for it in list(self._queue) + delegated
                    + list(self._running.values())
                } | set(self._pending)
                self._queue.clear()
                for s in self._subs:
                    s.queue.clear()
                self._running.clear()
            for key in stranded:
                self._settle(
                    key, 0,
                    RemoteTaskError(f"dispatch pump failed: {pump_err!r}"),
                    None,
                )
            with self._cond:  # keys that already had results stay settled
                self._pending -= set(self._results)
                self._cond.notify_all()
            raise
        finally:
            self._sub_stop.set()
            with self._cond:
                if self._session_t1 is None:
                    self._session_t1 = time.monotonic()
                if self._parked_since is not None:
                    self._pump_parked += (
                        time.monotonic() - self._parked_since
                    )
                    self._parked_since = None
                self._cond.notify_all()  # unpark sub-pumps: stop is set

    def _pump_loop(self) -> None:
        backend = self._backend
        hier = bool(self._subs)
        while True:
            # Idle-pool parking (DESIGN.md §18): with zero pending work —
            # nothing queued anywhere, no leases in flight — a long-lived
            # session's pump parks on the condition variable instead of
            # busy-polling the backend every tick. submit()/close() wake
            # it with notify_all; the first post-wake completion poll is
            # non-blocking so freshly submitted work dispatches
            # immediately instead of riding out a sleeping poll (this is
            # the adaptive driver's round-boundary stall).
            just_woke = False
            with self._cond:
                if (
                    self._state == _RUNNING
                    and self._sub_error is None
                    and not self._pending
                    and not self._running
                    and not self._orphaned
                    and not self._queue
                    and not any(s.queue for s in self._subs)
                ):
                    if self._parked_since is None:
                        self._parked_since = time.monotonic()
                    # Timed, not indefinite: while parked the pump still
                    # owes the backend a slow drain (heartbeat frames
                    # carry worker stats; a lease orphaned moments before
                    # the pool went idle completes late and its dropped
                    # completion must still be consumed). submit()/close()
                    # notify_all for the instant-wake path.
                    self._cond.wait(_PARK_TICK)
                    just_woke = True
                if self._parked_since is not None:
                    self._pump_parked += (
                        time.monotonic() - self._parked_since
                    )
                    self._parked_since = None
            comps = backend.poll_completions(0.0 if just_woke else _IDLE_TICK)
            t_work = time.monotonic()
            for comp in comps:
                self._handle_completion(comp)
            view = backend.heartbeat_view()
            to_settle: List = []
            with self._cond:
                if self._sub_error is not None:
                    # every sub-manager pump died: nothing can dispatch —
                    # escalate through the pump-failure path (fail pending)
                    raise RuntimeError(
                        "all sub-manager pumps failed"
                    ) from self._sub_error
                self._expire_dead_locked(view, to_settle)
                self._expire_heartbeats_locked(
                    view
                    if getattr(backend, "heartbeats_prove_liveness", False)
                    else None
                )
                if view and not any(st.alive for st in view.values()):
                    # the whole pool is gone (every worker process died):
                    # nothing can ever complete — fail what's left instead
                    # of spinning forever
                    delegated = [it for s in self._subs for it in s.queue]
                    for item in (
                        list(self._queue) + delegated
                        + list(self._running.values())
                    ):
                        if item.key not in self._results:
                            to_settle.append(
                                (
                                    item.key,
                                    item.attempts,
                                    RemoteTaskError(
                                        "every worker died; "
                                        f"{item.key!r} can never complete"
                                    ),
                                )
                            )
                    self._queue.clear()
                    for s in self._subs:
                        s.queue.clear()
                    self._running.clear()
            for key, attempt, err in to_settle:
                self._settle(key, attempt, err, None)
            if hier:
                # manager-of-managers: the leader only delegates; the
                # sub-pumps own demand-driven dispatch for their shards
                # (parked sub-pumps are woken when items land in shards)
                with self._cond:
                    if self._distribute_locked():
                        self._cond.notify_all()
            else:
                # demand-driven dispatch: free slots = per-worker queue
                # depth (slots_per_worker > 1 when the backend batches
                # frames — a worker holds a small backlog so it never
                # idles between round trips; 1 for the historical
                # one-lease-per-worker)
                slots = max(1, int(getattr(backend, "slots_per_worker", 1)))
                free = sum(
                    max(0, slots - len(st.inflight))
                    for st in view.values()
                    if st.alive
                )
                offer_batch = getattr(backend, "offer_batch", None)
                if offer_batch is not None:
                    self._dispatch_batched(offer_batch, free)
                else:
                    while free > 0:
                        with self._cond:
                            item = self._next_locked()
                        if item is None:
                            break
                        lease = _lease(item)
                        if backend.offer(lease):
                            with self._cond:
                                self.dispatch_counts[self.backend_name] = (
                                    self.dispatch_counts.get(self.backend_name, 0)
                                    + 1
                                )
                            free -= 1
                        else:  # slot vanished since snapshot (worker death)
                            with self._cond:
                                self._unlease_locked(item)
                            break
            # A parked pump holds no task state: the last completion holds
            # its outputs and the last lease its input state (tensors on the
            # card), which a long-lived session would otherwise keep.
            comps = comp = lease = item = None
            with self._cond:
                self._pump_busy += time.monotonic() - t_work
                if (
                    self._state == _CLOSING
                    and not self._pending
                    and not self._running
                    and not self._queue
                    and not any(s.queue for s in self._subs)
                ):
                    return

    def _dispatch_batched(self, offer_batch, free: int) -> None:
        """Batched dispatch (DESIGN.md §14): lease up to ``free`` items in
        one pass and hand them to the backend as a single ``offer_batch``
        call — the backend coalesces each worker's share into one frame.
        Rejected leases (slots vanished since the demand snapshot) are
        unleased in reverse lease order, restoring queue position and
        attempt numbers exactly as the one-at-a-time path would."""
        while free > 0:
            batch: List = []
            with self._cond:
                while len(batch) < free:
                    item = self._next_locked()
                    if item is None:
                        break
                    batch.append(item)
            if not batch:
                return
            leases = [_lease(it) for it in batch]
            rejected = {lease.lease_id for lease in offer_batch(leases)}
            accepted = len(batch) - len(rejected)
            if accepted:
                with self._cond:
                    self.dispatch_counts[self.backend_name] = (
                        self.dispatch_counts.get(self.backend_name, 0) + accepted
                    )
            if rejected:
                with self._cond:
                    for it in reversed(batch):
                        if f"{it.key}#{it.attempts}" in rejected:
                            self._unlease_locked(it)
                return
            free -= accepted

    # ------------------------------------------------------------------
    # One-shot batch mode (the pre-streaming API, kept verbatim)
    # ------------------------------------------------------------------
    def run(self, n_workers: int, *, expected: int) -> Dict[str, Any]:
        """Run until ``expected`` distinct results exist."""
        self.start(n_workers)
        try:
            with self._cond:
                while len(self._results) < expected and self._pending:
                    self._cond.wait(_IDLE_TICK)
        finally:
            self.close()
        # analysis: ok[locks] close() joined the pump: no writer is left
        return dict(self._results)


def run_study_distributed(
    buckets: List[Any],
    execute_bucket: Callable[[Any], Dict[int, Any]],
    *,
    n_workers: int = 2,
    manager: Optional[Manager] = None,
) -> Dict[int, Any]:
    """Execute merged-stage buckets across Workers; returns run_id -> output."""
    mgr = manager or Manager()
    for i, b in enumerate(buckets):
        mgr.submit(WorkItem(key=f"bucket{i}", fn=lambda b=b: execute_bucket(b)))
    per_bucket = mgr.run(n_workers, expected=len(buckets))
    out: Dict[int, Any] = {}
    for v in per_bucket.values():
        if isinstance(v, Exception):
            raise v
        out.update(v)
    return out
