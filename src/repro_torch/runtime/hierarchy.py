"""Hierarchy specs for the manager-of-managers scheduler (DESIGN.md §15).

The paper's headline efficiency (>92% at 256 nodes × 28 cores) is out of
reach for a single Manager pump thread: at that scale the pump — not the
workers — is the global serialization point. The companion deployments
(arXiv:1811.11653, arXiv:1612.03413) solve this with a demand-driven
manager *hierarchy*: a leader delegates contiguous blocks of work to N
sub-manager pumps, each owning a shard of the worker pool, with
locality-aware assignment and work stealing between pumps.

This module holds the declarative side of that design — the
:class:`HierarchySpec` dataclass, the ``parse_hierarchy`` spec grammar
(mirroring ``process_flag_kwargs`` for backends), and the reuse-tree
prefix matching used by locality-aware dispatch. The machinery itself
lives in :mod:`repro_torch.runtime.manager`.

Spec grammar (the ``hierarchy=`` argument accepted throughout the engine)::

    None / "flat" / 1      -> flat: the single-pump Manager, byte-for-byte
    4                      -> 4 sub-manager pumps, locality + stealing on
    "4" / "fanout=4"       -> same
    "fanout=4,-steal"      -> 4 pumps, stealing disabled
    "fanout=2,-locality,block=16,steal_min=4"
    "auto"                 -> fanout resolved from the pool size at start()
    HierarchySpec(...)     -> passed through verbatim
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

__all__ = ["HierarchySpec", "parse_hierarchy", "path_lcp"]

# "auto" sizes one sub-pump per this many workers (capped below): small
# pools stay flat, big pools get enough pumps that no single one is the
# serialization point.
_AUTO_WORKERS_PER_PUMP = 8
_AUTO_MAX_FANOUT = 16


@dataclasses.dataclass(frozen=True)
class HierarchySpec:
    """Topology + policy of the hierarchical scheduler.

    ``fanout``     — number of sub-manager pumps; 1 keeps the flat
                     single-pump Manager (the historical code path).
    ``locality``   — route work to the sub-manager/worker already holding
                     the longest reuse-tree prefix (per-worker affinity map
                     fed by Completion records).
    ``steal``      — an idle pump steals the tail half of the most loaded
                     peer's queue (exactly-once settlement is preserved:
                     items move between queues under the Manager lock and
                     only leave a queue when leased).
    ``block_size`` — contiguous lease block the leader delegates to one
                     sub-manager at a time (locality routing overrides).
    ``steal_min``  — never steal from a queue shorter than this.
    ``auto``       — resolve ``fanout`` from the worker-pool size at
                     ``start()`` (one pump per ~8 workers, capped at 16).
    """

    fanout: int = 1
    locality: bool = True
    steal: bool = True
    block_size: int = 8
    steal_min: int = 2
    auto: bool = False

    def resolve(self, n_workers: int) -> "HierarchySpec":
        """Concrete spec for a pool of ``n_workers``: auto-fanout is
        resolved and fanout is clamped so every pump owns ≥1 worker."""
        fanout = self.fanout
        if self.auto:
            fanout = max(1, n_workers // _AUTO_WORKERS_PER_PUMP)
            fanout = min(fanout, _AUTO_MAX_FANOUT)
        fanout = max(1, min(fanout, max(1, n_workers)))
        if fanout == self.fanout and not self.auto:
            return self
        return dataclasses.replace(self, fanout=fanout, auto=False)


def parse_hierarchy(spec: Any) -> HierarchySpec:
    """Normalise any accepted ``hierarchy=`` value to a HierarchySpec."""
    if spec is None:
        return HierarchySpec(fanout=1)
    if isinstance(spec, HierarchySpec):
        return spec
    if isinstance(spec, int):
        return HierarchySpec(fanout=max(1, spec))
    if not isinstance(spec, str):
        raise ValueError(
            f"hierarchy spec must be None, an int fanout, a string, or a "
            f"HierarchySpec; got {type(spec).__name__}"
        )
    text = spec.strip().lower()
    if text in ("", "flat"):
        return HierarchySpec(fanout=1)
    if text == "auto":
        return HierarchySpec(auto=True)
    try:  # bare numeric string, e.g. CLI "--hierarchy 4"
        return HierarchySpec(fanout=max(1, int(text)))
    except ValueError:
        pass
    kwargs: dict = {}
    for token in text.split(","):
        token = token.strip()
        if not token:
            continue
        if token == "-steal":
            kwargs["steal"] = False
        elif token == "+steal" or token == "steal":
            kwargs["steal"] = True
        elif token == "-locality":
            kwargs["locality"] = False
        elif token == "+locality" or token == "locality":
            kwargs["locality"] = True
        elif "=" in token:
            name, _, raw = token.partition("=")
            name = name.strip()
            try:
                value = int(raw)
            except ValueError:
                raise ValueError(
                    f"hierarchy spec {spec!r}: {name}={raw!r} is not an int"
                ) from None
            if name == "fanout":
                kwargs["fanout"] = max(1, value)
            elif name == "block":
                kwargs["block_size"] = max(1, value)
            elif name == "steal_min":
                kwargs["steal_min"] = max(1, value)
            else:
                raise ValueError(
                    f"hierarchy spec {spec!r}: unknown option {name!r}"
                )
        else:
            raise ValueError(
                f"hierarchy spec {spec!r}: unknown token {token!r}"
            )
    return HierarchySpec(**kwargs)


def path_lcp(a: Optional[Sequence[Any]], b: Optional[Sequence[Any]]) -> int:
    """Length of the longest common prefix of two reuse-tree paths (0 when
    either is missing/empty) — the locality metric of affinity dispatch."""
    if not a or not b:
        return 0
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


def best_affinity(
    path: Optional[Tuple],
    affinities: Sequence[Optional[Tuple]],
) -> int:
    """Longest common prefix between ``path`` and any of ``affinities``."""
    if not path:
        return 0
    best = 0
    for aff in affinities:
        l = path_lcp(path, aff)
        if l > best:
            best = l
    return best
