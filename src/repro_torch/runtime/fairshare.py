"""Fair-share dispatch queue — deficit round robin across tenants with
priority buckets inside each tenant (DESIGN.md §18).

The Manager's global queue was a plain FIFO deque, which is exactly right
for a single study but starves everyone else the moment a long-lived
service session multiplexes tenants: one tenant submitting 10k buckets
ahead of a 10-bucket job monopolises every dispatch slot until its backlog
drains. :class:`FairQueue` keeps the deque surface the Manager's dispatch
paths already speak (``append`` / ``appendleft`` / ``popleft`` / ``in`` /
iteration) while making ``popleft`` a **deficit-round-robin** draw across
tenants:

* each tenant owns one logical queue, internally split into priority
  buckets (higher :attr:`~repro_torch.runtime.manager.WorkItem.priority` first,
  FIFO within a priority);
* a round-robin ring visits tenants with queued work; each visit grants
  the tenant its *quantum* (= its weight, default 1.0) of deficit credit,
  and every pop spends 1.0 — so a weight-2 tenant drains twice as fast as
  a weight-1 tenant, and a weight-0.25 tenant still pops once every four
  ring rotations (monotonic progress, never starvation);
* a tenant's unspent credit is capped and zeroed when its queue empties,
  so an idle tenant cannot bank credit and later burst past its share.

With a single tenant (every WorkItem carrying the default ``tenant=""``
and ``priority=0``) the structure degenerates to the exact FIFO order of
the deque it replaces — the single-study schedules, and therefore their
outputs, are unchanged byte for byte.

All mutation happens under the owning Manager's lock (the instance has no
lock of its own), mirroring how the hierarchical sub-queues are guarded.
"""

from __future__ import annotations

import collections
from typing import Dict, Iterator, List, Optional

__all__ = ["FairQueue", "TaskCancelled"]

# Unspent deficit credit a tenant may bank while it has queued work: big
# enough to let a high-weight tenant burst a few items per visit, small
# enough that fairness is enforced within every ring rotation or two.
_DEFICIT_CAP = 8.0


class TaskCancelled(Exception):
    """Settled value of a WorkItem revoked by :meth:`Manager.cancel`: the
    key's callback fires exactly once with this exception, any in-flight
    lease is poisoned (its eventual completion is dropped), and the key
    can be resubmitted as a fresh lifecycle after ``forget``."""


class FairQueue:
    """Deficit-round-robin multi-tenant queue of WorkItems.

    Items must expose ``key``, ``tenant`` and ``priority`` attributes
    (:class:`~repro_torch.runtime.manager.WorkItem` does). Not thread-safe by
    itself — the Manager mutates it under its own lock.
    """

    def __init__(self) -> None:
        # tenant -> priority -> FIFO deque of items
        self._buckets: Dict[str, Dict[int, collections.deque]] = {}
        self._counts: Dict[str, int] = {}
        self._ring: List[str] = []  # tenant visit order (insertion order)
        self._cursor = 0
        self._deficit: Dict[str, float] = {}
        self._weights: Dict[str, float] = {}
        self._len = 0

    # -- configuration --------------------------------------------------
    def set_weight(self, tenant: str, weight: float) -> None:
        """Set a tenant's fair-share quantum (default 1.0). Values below
        a small positive floor are clamped — a zero weight would mean
        literal starvation, and the whole point of DRR is that every
        tenant makes progress."""
        self._weights[tenant] = max(0.05, float(weight))

    # -- deque surface ---------------------------------------------------
    def __len__(self) -> int:
        return self._len

    def __bool__(self) -> bool:
        return self._len > 0

    def __iter__(self) -> Iterator:
        """Snapshot iteration (tenant ring order, priority-major). Used by
        the Manager's purge/failover scans; scheduling order is defined by
        ``popleft``, not by iteration."""
        for tenant in self._ring:
            prios = self._buckets.get(tenant)
            if not prios:
                continue
            for prio in sorted(prios, reverse=True):
                yield from prios[prio]

    def _tenant_of(self, item) -> str:
        return getattr(item, "tenant", "") or ""

    def _ensure_tenant(self, tenant: str) -> None:
        if tenant not in self._buckets:
            self._buckets[tenant] = {}
            self._counts[tenant] = 0
            self._deficit.setdefault(tenant, 0.0)
            self._ring.append(tenant)

    def append(self, item) -> None:
        tenant = self._tenant_of(item)
        self._ensure_tenant(tenant)
        prio = int(getattr(item, "priority", 0) or 0)
        self._buckets[tenant].setdefault(prio, collections.deque()).append(item)
        self._counts[tenant] += 1
        self._len += 1

    def appendleft(self, item) -> None:
        """Return an item to the head of its (tenant, priority) bucket —
        the unlease/revert path. The pop that removed it spent a unit of
        the tenant's deficit; refund it so fairness accounting is exact."""
        tenant = self._tenant_of(item)
        self._ensure_tenant(tenant)
        prio = int(getattr(item, "priority", 0) or 0)
        self._buckets[tenant].setdefault(
            prio, collections.deque()
        ).appendleft(item)
        self._counts[tenant] += 1
        self._len += 1
        self._deficit[tenant] = min(
            self._deficit.get(tenant, 0.0) + 1.0, _DEFICIT_CAP
        )

    def _pop_tenant(self, tenant: str):
        prios = self._buckets[tenant]
        prio = max(prios)
        bucket = prios[prio]
        item = bucket.popleft()
        if not bucket:
            del prios[prio]
        self._counts[tenant] -= 1
        self._len -= 1
        return item

    def popleft(self):
        """DRR draw: the next item the dispatch path should lease."""
        if not self._len:
            raise IndexError("pop from an empty FairQueue")
        ring = self._ring
        n = len(ring)
        if n == 1:  # single tenant: exact FIFO-within-priority, no credit
            return self._pop_tenant(ring[0])
        # Bounded scan: each full rotation grants every backlogged tenant
        # its quantum (>= 0.05), so some deficit reaches 1.0 within at
        # most ceil(1/min_weight) rotations.
        for _ in range(n * 32):
            tenant = ring[self._cursor % n]
            count = self._counts.get(tenant, 0)
            if count and self._deficit.get(tenant, 0.0) >= 1.0:
                self._deficit[tenant] -= 1.0
                item = self._pop_tenant(tenant)
                if not self._counts[tenant]:
                    # an emptied tenant banks nothing: credit accrues only
                    # against real backlog
                    self._deficit[tenant] = 0.0
                    self._cursor = (self._cursor + 1) % n
                elif self._deficit[tenant] < 1.0:
                    # quantum spent: yield the ring to the next tenant (a
                    # high-weight tenant keeps the floor while it can
                    # still afford a pop — that IS its larger share)
                    self._cursor = (self._cursor + 1) % n
                return item
            if count:
                self._deficit[tenant] = min(
                    self._deficit.get(tenant, 0.0)
                    + self._weights.get(tenant, 1.0),
                    _DEFICIT_CAP,
                )
                if self._deficit[tenant] >= 1.0:
                    continue  # spend it on this same visit
            else:
                self._deficit[tenant] = 0.0
            self._cursor = (self._cursor + 1) % n
        # Pathological weights (everyone clamped tiny): degrade to FIFO
        # across the ring rather than spin.
        for tenant in ring:
            if self._counts.get(tenant, 0):
                return self._pop_tenant(tenant)
        raise IndexError("FairQueue length drifted")  # pragma: no cover

    # -- bulk surgery (purge paths) --------------------------------------
    def remove_keys(self, keys) -> int:
        """Drop every queued item whose ``key`` is in ``keys`` (forget /
        cancel / resubmission purges). Returns the number removed."""
        keyset = set(keys)
        removed = 0
        # analysis: ok[spawn] purge sweep, not key derivation — removal is
        # order-independent (membership test against a frozen keyset)
        for tenant, prios in self._buckets.items():
            for prio in list(prios):
                bucket = prios[prio]
                if not any(it.key in keyset for it in bucket):
                    continue
                kept = collections.deque(
                    it for it in bucket if it.key not in keyset
                )
                dropped = len(bucket) - len(kept)
                if kept:
                    prios[prio] = kept
                else:
                    del prios[prio]
                self._counts[tenant] -= dropped
                removed += dropped
        self._len -= removed
        return removed

    def clear(self) -> None:
        for tenant in self._ring:
            self._buckets[tenant] = {}
            self._counts[tenant] = 0
            self._deficit[tenant] = 0.0
        self._len = 0

    # -- introspection ----------------------------------------------------
    def depths(self) -> Dict[str, int]:
        """tenant -> queued items (only tenants with backlog)."""
        return {t: c for t, c in self._counts.items() if c}

    def head_tenant(self) -> Optional[str]:
        for tenant, count in self._counts.items():
            if count:
                return tenant
        return None
