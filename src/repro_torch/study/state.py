"""Round-persistent state of an adaptive SA study (DESIGN.md §11).

A :class:`StudyState` is everything the :class:`~repro_torch.study.StudyDriver`
carries *between* rounds — the reason round *N+1* is incremental instead of
a from-scratch study:

* the **evaluated map** ``ParamSet → objective`` — proposals a prior round
  already produced are recalled, never re-planned;
* the engine's :class:`~repro_torch.engine.TrieLedger` — the "cached trie" the
  delta plan is annotated against;
* the **persistent result store** — a
  :class:`~repro_torch.runtime.HierarchicalStore` (RAM tier + content-addressed
  npz disk tier) backing the round-shared
  :class:`~repro_torch.engine.ResultCache`, so evicted and prior-round task
  outputs are spilled and rehydrated instead of recomputed;
* one live Manager session (not persisted) spanning every round;
* the science bookkeeping: active/frozen parameters, phase, best point,
  and one :class:`RoundRecord` per completed round.

``save``/``load`` serialise the state to JSON next to the store's disk
directory. Everything in the checkpoint is process-independent — ParamSets,
ledger entries and store keys use deterministic serialisations — so a
resumed study on a fresh process recomputes **zero** already-cached tasks.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.params import ParamSet, ParamSpace
from repro_torch.engine.executor import ResultCache
from repro_torch.engine.planner import TrieLedger
from repro_torch.engine.types import DEFAULT_CACHE_BYTES
from repro_torch.runtime.manager import Manager
from repro_torch.runtime.storage import HierarchicalStore

__all__ = ["RoundRecord", "StudyState"]

STATE_VERSION = 1


def _ps_to_json(ps: ParamSet) -> List[List[Any]]:
    return [[k, v] for k, v in ps]


def _ps_from_json(obj: List[List[Any]]) -> ParamSet:
    return tuple((str(k), v) for k, v in obj)


@dataclasses.dataclass
class RoundRecord:
    """One completed round: what was proposed, what it cost, what it found,
    and what the policy decided. Everything here is JSON-serialisable, and
    ``param_sets`` + ``meta`` are sufficient to replay the round as an
    independent one-shot study (the bit-identicality oracle in tests)."""

    index: int
    kind: str  # sampler name: "moat" | "vbd" | "refine" | "tune"
    param_sets: List[ParamSet]  # the full proposed run-list, in order
    outputs: List[float]  # objective per proposed run (computed or recalled)
    meta: Dict[str, Any]  # sampler metadata (moves / n_base / axis)
    n_proposed: int = 0
    n_new: int = 0  # the delta actually planned this round
    tasks_requested: int = 0  # naive count: proposed runs × workflow tasks
    planned_tasks: int = 0  # delta plan's merged-task count
    planned_known: int = 0  # …of which the ledger already held
    tasks_executed: int = 0  # measured (cache/store hits subtracted)
    cache_hits: int = 0
    wall_seconds: float = 0.0
    analysis: Dict[str, Any] = dataclasses.field(default_factory=dict)
    decision: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_json(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["param_sets"] = [_ps_to_json(ps) for ps in self.param_sets]
        return d

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "RoundRecord":
        d = dict(d)
        d["param_sets"] = [_ps_from_json(ps) for ps in d["param_sets"]]
        return cls(**d)


class StudyState:
    """Cross-round memory of an adaptive study; see module docstring."""

    def __init__(
        self,
        space: ParamSpace,
        *,
        seed: int = 0,
        cache_bytes: int = DEFAULT_CACHE_BYTES,
        store: Optional[HierarchicalStore] = None,
        store_dir: Optional[str] = None,
        store_ram_bytes: int = 256 << 20,
    ):
        self.space = space
        self.seed = seed
        self.cache_bytes = int(cache_bytes)
        self.active: List[str] = list(space.names)
        self.frozen: Dict[str, Any] = {}
        self.phase = "moat"
        self.evaluated: Dict[ParamSet, float] = {}
        self.best: Optional[Tuple[ParamSet, float]] = None
        self.rounds: List[RoundRecord] = []
        self.epoch = 0  # evaluate() calls ever made; prefixes Manager keys
        # The identities of the study's inputs (the cache's input-scope
        # segment). Set by the driver on first use and checked on resume:
        # a state resumed over different/reordered inputs would otherwise
        # silently serve the old inputs' cached results.
        self.input_keys: Optional[List[Any]] = None
        # --- runtime (rebuilt on load, never serialised) ---
        if store is not None:
            self.store = store
        elif store_dir is not None and str(store_dir).startswith("obj:"):
            # "obj:<root>" mounts the object-store tier (§16); ``save``
            # records ``store.disk_dir`` — the spec itself — so a resumed
            # study remounts the same object root with zero recompute
            from repro_torch.runtime.storage import mount_store

            self.store = mount_store(store_dir, store_ram_bytes, writer_id="study")
        else:
            self.store = HierarchicalStore(store_ram_bytes, disk_dir=store_dir)
        self.cache = ResultCache(self.cache_bytes, spill_store=self.store)
        self.ledger = TrieLedger()
        self.manager: Optional[Manager] = None

    # ------------------------------------------------------------------
    # Science bookkeeping
    # ------------------------------------------------------------------
    def record_best(self, ps: ParamSet, y: float, *, maximize: bool) -> bool:
        """Track the incumbent objective; returns True if ``ps`` took it."""
        if self.best is None:
            improved = True
        else:
            improved = y > self.best[1] if maximize else y < self.best[1]
        if improved:
            self.best = (ps, y)
        return improved

    def freeze(self, names: List[str]) -> None:
        """Prune parameters: drop from the active set, pinning each at its
        value in the incumbent best point (an already-evaluated coordinate,
        maximising later trie-prefix overlap) or the space default."""
        anchor = dict(self.best[0]) if self.best else dict(self.space.default())
        for name in names:
            if name in self.active:
                self.active.remove(name)
                self.frozen[name] = anchor[name]

    def merge_fleet(self, payloads: List[Dict[str, Any]]) -> None:
        """Fold fleet-worker round payloads (``repro_torch.study.run_fleet_study``)
        into this state — the fleet-merge path: each worker evaluated a
        shard of the round's delta against the shared store, and the union
        of their evaluated objectives and committed ledger keys is what
        round N+1 proposes and plans against. Objectives are pure functions
        of (input, params), so merge order cannot change a value."""
        for p in payloads:
            for ps_json, y in p.get("evaluated", ()):
                self.evaluated.setdefault(_ps_from_json(ps_json), float(y))
            self.ledger.merge(p.get("ledger", ()))

    @property
    def tasks_requested(self) -> int:
        return sum(r.tasks_requested for r in self.rounds)

    @property
    def tasks_executed(self) -> int:
        return sum(r.tasks_executed for r in self.rounds)

    @property
    def cache_hits(self) -> int:
        return sum(r.cache_hits for r in self.rounds)

    def counters(self) -> Dict[str, Any]:
        """The study-wide reuse accounting reported by summaries."""
        from repro_torch.core.metrics import reuse_factor

        return {
            "rounds": len(self.rounds),
            "tasks_requested": self.tasks_requested,
            "tasks_executed": self.tasks_executed,
            "reuse_factor": reuse_factor(self.tasks_executed, self.tasks_requested),
            "cache_hits": self.cache.hits,
            "cache_misses": self.cache.misses,
            "cache_spills": self.cache.spills,
            "cache_rehydrations": self.cache.rehydrations,
            "store_disk_hits": self.store.disk_hits,
            "ledger_paths": len(self.ledger),
        }

    # ------------------------------------------------------------------
    # Session lifecycle
    # ------------------------------------------------------------------
    def close(self) -> None:
        if self.manager is not None and self.manager.is_running:
            self.manager.close()
        self.manager = None

    # ------------------------------------------------------------------
    # Persistence
    # ------------------------------------------------------------------
    def save(self, path: str) -> None:
        """Checkpoint to JSON; flushes the result cache through to the
        store's disk tier first, so a resumed study rehydrates everything
        this one computed."""
        self.cache.flush()
        # async-commit backends (DESIGN.md §14) ack completions ahead of
        # their disk commit; the barrier makes everything staged durable so
        # a checkpoint never references results newer than the store
        if self.manager is not None and self.manager.is_running:
            barrier = getattr(self.manager.backend, "barrier", None)
            if barrier is not None:
                barrier()
        payload = {
            "version": STATE_VERSION,
            "seed": self.seed,
            "cache_bytes": self.cache_bytes,
            "space": [[p.name, list(p.values)] for p in self.space.params],
            "active": list(self.active),
            "frozen": [[k, v] for k, v in self.frozen.items()],
            "phase": self.phase,
            "epoch": self.epoch,
            "input_keys": self.input_keys,
            "best": None
            if self.best is None
            else [_ps_to_json(self.best[0]), self.best[1]],
            "evaluated": [[_ps_to_json(ps), y] for ps, y in self.evaluated.items()],
            "rounds": [r.to_json() for r in self.rounds],
            "ledger": self.ledger.to_list(),
            "store_dir": self.store.disk_dir,
        }
        p = pathlib.Path(path)
        tmp = p.with_suffix(p.suffix + ".tmp")
        tmp.write_text(json.dumps(payload, indent=1))
        tmp.replace(p)

    @classmethod
    def load(cls, path: str, *, store_dir: Optional[str] = None) -> "StudyState":
        """Rebuild a state from a checkpoint. The result store is re-opened
        on its (content-addressed) disk directory — pass ``store_dir`` to
        override, e.g. after moving the checkpoint."""
        d = json.loads(pathlib.Path(path).read_text())
        if d.get("version") != STATE_VERSION:
            raise ValueError(f"unsupported StudyState version {d.get('version')!r}")
        space = ParamSpace.from_dict({name: vals for name, vals in d["space"]})
        st = cls(
            space,
            seed=d["seed"],
            cache_bytes=d["cache_bytes"],
            store_dir=store_dir or d["store_dir"],
        )
        st.active = list(d["active"])
        st.frozen = {k: v for k, v in d["frozen"]}
        st.phase = d["phase"]
        st.epoch = d["epoch"]
        st.input_keys = d.get("input_keys")
        if d["best"] is not None:
            st.best = (_ps_from_json(d["best"][0]), d["best"][1])
        st.evaluated = {_ps_from_json(ps): y for ps, y in d["evaluated"]}
        st.rounds = [RoundRecord.from_json(r) for r in d["rounds"]]
        st.ledger = TrieLedger.from_list(d["ledger"])
        return st
