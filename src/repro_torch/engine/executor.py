"""execute_plan — the dispatch half of the unified StudyPlanner engine.

``execute_bucket`` replays one bucket's frozen schedule
(:func:`~repro_torch.core.rmsr.replay_schedule`) with the run-level cache plugged
in; it is the unit of work both executors dispatch through the Manager.
``execute_plan`` executes a plan on ONE input and is the K=1 special case
of the streaming dataset executor (:mod:`repro_torch.engine.streaming`): one
persistent Manager session, leaf outputs routed by ``run_id`` into the next
stage's buckets the moment the input's stage closes, so dataflow crosses
stage boundaries without caller wiring.

The run-level :class:`ResultCache` is keyed by ``(input, stage,
upstream-group, trie-path)``: a retried or backup bucket replays its
schedule but every already-computed merged prefix is a cache hit, and
sibling buckets of the same group share prefixes the bucketing could not
merge, while the input segment makes cross-input collisions structurally
impossible. Tasks are pure functions of ``(input, params)``, so cached
reuse is bit-identical to recomputation.
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Dict, Optional, Tuple

from repro_torch.core.rmsr import replay_schedule
from repro_torch.engine.types import BucketPlan, ClusterSpec, StudyPlan, StudyResult
from repro_torch.runtime.storage import HierarchicalStore

__all__ = ["ResultCache", "execute_bucket", "execute_plan"]


class ResultCache:
    """Thread-safe LRU cache of merged-task outputs, bounded in bytes.

    Entries are weighted by the task's declared ``output_bytes`` (the same
    model the schedule's liveness proof uses); an entry larger than the cap
    is never admitted to the RAM tier.

    With a ``spill_store`` (a :class:`repro_torch.runtime.HierarchicalStore`), the
    cache becomes the top of a hierarchy instead of a discard-on-evict LRU:
    evicted and oversized entries are *spilled* to the store (RAM tier +
    content-addressed npz disk tier), and a RAM miss consults the store
    before reporting failure — a rehydrated entry counts as a hit and is
    served from the store (which promotes disk reads into its own
    LRU-bounded RAM tier) without re-entering this cache's declared-bytes
    accounting. This is what carries results across adaptive-study rounds
    and across process restarts (``repro_torch.study``): the store's disk keys
    are content-addressed, so a cache rebuilt over the same directory
    resolves prior-round results instead of recomputing them.

    Counters: ``hits`` (successful lookups, either tier), ``rehydrations``
    (the subset served by the spill store), ``misses`` (failed lookups) and
    ``spills`` (entries written to the store on eviction/oversize).
    """

    def __init__(
        self, max_bytes: int, *, spill_store: Optional[HierarchicalStore] = None
    ):
        self.max_bytes = int(max_bytes)
        self.spill_store = spill_store
        self._entries: "collections.OrderedDict[Tuple, Tuple[Any, int]]" = (
            collections.OrderedDict()
        )  # guard: _lock
        self._bytes = 0  # guard: _lock
        self._lock = threading.Lock()
        self.hits = 0  # guard: _lock
        self.misses = 0  # guard: _lock
        self.spills = 0  # guard: _lock
        self.rehydrations = 0  # guard: _lock

    @staticmethod
    def _store_key(key: Tuple) -> str:
        # repr of the canonical key tuple (strings / numbers / nested
        # tuples) is deterministic across processes; the store content-
        # addresses it on disk (storage.stable_key).
        return repr(key)

    def get(self, key: Tuple) -> Tuple[bool, Any]:
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                self.hits += 1
                return True, self._entries[key][0]
        # store consultation happens OUTSIDE the cache lock: rehydration can
        # be a disk read, and holding the cache-wide lock across it would
        # serialize every worker's cache access behind one npz load.
        if self.spill_store is not None:
            value = self.spill_store.get(self._store_key(key))
            if value is not None:
                # served without re-admission: the declared output_bytes
                # that governed admission is not recoverable here, and
                # re-admitting by measured size would let a deliberately
                # oversized entry slip into the RAM tier. Repeated reads
                # stay cheap — the store promotes disk hits into its own
                # LRU-bounded RAM tier.
                with self._lock:
                    self.hits += 1
                    self.rehydrations += 1
                return True, value
        with self._lock:
            self.misses += 1
        return False, None

    def put(self, key: Tuple, value: Any, nbytes: int) -> None:
        nbytes = max(0, int(nbytes))
        spilled = []
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                return
            if nbytes > self.max_bytes:
                # never admitted to RAM, but too valuable to drop when a
                # spill tier exists (it may be a whole merged prefix)
                if self.spill_store is not None:
                    self.spills += 1
                    spilled.append((key, value))
            else:
                self._entries[key] = (value, nbytes)
                self._bytes += nbytes
                while self._bytes > self.max_bytes and self._entries:
                    k, (v, b) = self._entries.popitem(last=False)
                    self._bytes -= b
                    if self.spill_store is not None:
                        self.spills += 1
                        spilled.append((k, v))
        # Spill I/O runs OUTSIDE the cache lock, mirroring get(): with a
        # SharedStore a spill can be a file-locked disk write, and holding
        # the cache-wide lock across it would serialize every worker. A
        # concurrent get() of a just-evicted, not-yet-spilled key reads as
        # a miss and recomputes — tasks are pure, so that is only wasted
        # work, never a wrong value.
        for k, v in spilled:
            self.spill_store.put(self._store_key(k), v)

    def flush(self) -> int:
        """Write every live entry through to the spill store's **disk**
        tier (durability barrier before persisting a StudyState, and the
        fleet workers' publish point — peers resolve the flushed keys on
        their next store consultation): the cache's RAM entries are pushed
        into the store, then the store's own RAM tier — which also holds
        previously-evicted entries that never reached disk — is persisted
        wholesale. No-op without a spill store; entries stay admitted.

        Returns the number of entries persisted to the disk tier (the
        store-RAM snapshot ``persist_all`` wrote through, which includes
        every cache entry just pushed) — 0 without a spill store. Callers
        surface it in study summaries so a silent no-op flush is visible.
        """
        if self.spill_store is None:
            return 0
        with self._lock:
            snapshot = [(key, value) for key, (value, _) in self._entries.items()]
        for key, value in snapshot:
            self.spill_store.put(self._store_key(key), value)
        return self.spill_store.persist_all()

    def counters(self) -> Dict[str, int]:
        """Point-in-time counter snapshot — the cache half of the RPC
        workers' warm-cache stats (heartbeats ship it; the backend's
        ``stats()`` aggregates it across the pool)."""
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "spills": self.spills,
                "rehydrations": self.rehydrations,
                "entries": len(self._entries),
            }


def execute_bucket(
    bucket: BucketPlan,
    input_state: Any,
    cache: Optional[ResultCache] = None,
    *,
    scope: Optional[Tuple[Any, ...]] = None,
) -> Tuple[Dict[int, Any], int, int]:
    """Replay a bucket's frozen schedule (``rmsr.replay_schedule``) with the
    run-level cache plugged in under ``scope`` (default: the bucket's own
    cache scope; the streaming executor prefixes an input segment). Returns
    ``(run_id -> leaf output, tasks executed, cache hits)``."""
    lookup = store = None
    if cache is not None:
        key_scope = bucket.cache_scope if scope is None else scope

        def lookup(pk):
            return cache.get(key_scope + (pk,))

        def store(pk, out, task, params):
            cache.put(key_scope + (pk,), out, task.bound_bytes(params))

    return replay_schedule(
        bucket.tree, bucket.schedule.order, input_state, lookup=lookup, store=store
    )


def execute_plan(
    plan: StudyPlan,
    input_state: Any,
    *,
    cluster: Optional[ClusterSpec] = None,
    backend: Any = None,
    hierarchy: Any = None,
) -> StudyResult:
    """Execute a :class:`StudyPlan` on one input, returning per-run outputs.

    Results are bit-identical across policies and worker counts: tasks are
    pure, every bucket replays a frozen schedule, and stage routing is keyed
    by ``run_id`` alone. This is ``execute_study`` with a one-element
    dataset — same session machinery, same cache keying, same accounting.
    ``backend`` is the session's WorkerBackend spec (default: in-process
    Worker threads; pass a ``ProcessRpcBackend`` for RPC worker processes);
    ``hierarchy`` is the session's scheduler topology (DESIGN.md §15 —
    flat single pump by default, ``"fanout=N"`` for manager-of-managers).
    """
    from repro_torch.engine.streaming import execute_study  # circular at import time

    stream = execute_study(
        plan, [input_state], cluster=cluster, backend=backend,
        hierarchy=hierarchy,
    )
    only = stream.per_input[0]
    return StudyResult(
        outputs=only.outputs,
        tasks_executed=only.tasks_executed,
        cache_hits=only.cache_hits,
        retries=stream.retries,
        backups_launched=stream.backups_launched,
        wall_seconds=stream.wall_seconds,
        per_stage_executed=only.per_stage_executed,
        cache_misses=stream.cache_misses,
        cache_spills=stream.cache_spills,
        cache_rehydrations=stream.cache_rehydrations,
        backend=stream.backend,
        dispatch_counts=dict(stream.dispatch_counts),
    )
