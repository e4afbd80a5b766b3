"""Job registry — the service's bookkeeping core (DESIGN.md §18).

The registry owns three things, all under one lock:

* **job records** — the QUEUED → RUNNING → {DONE, FAILED, CANCELLED}
  lifecycle, per-job progress counters, and retained result payloads;
* **key refcounts** — every WorkItem key a live job references, mapped to
  the set of jobs referencing it. Shared (content-addressed) submissions
  mean one key can serve many jobs; the Manager's memo for a key may be
  released (``forget``) only when the LAST referencing job ends, and a
  key may be *cancelled* only while exactly one live job references it —
  both queries answered here;
* **tenant quotas** — admission control: live-task and retained-result-
  byte budgets per tenant, checked atomically with registration so two
  racing submissions cannot both squeeze under the cap.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional, Set

__all__ = [
    "JobRecord",
    "JobRegistry",
    "QuotaExceeded",
    "TenantQuota",
    "JOB_STATES",
]

# Lifecycle state machine: QUEUED -> RUNNING -> one of the terminal three.
# CANCELLED can be entered from QUEUED or RUNNING; terminal states never
# transition again (cancel on a terminal job is an idempotent no-op).
JOB_STATES = ("QUEUED", "RUNNING", "DONE", "FAILED", "CANCELLED")
_TERMINAL = frozenset(("DONE", "FAILED", "CANCELLED"))


class QuotaExceeded(RuntimeError):
    """Admission rejected: the tenant's live-task, live-job or retained-
    result-byte budget would be exceeded. Nothing was registered."""


@dataclasses.dataclass
class TenantQuota:
    """Per-tenant admission budget.

    max_live_tasks   — total WorkItem keys across the tenant's QUEUED +
                       RUNNING jobs (a submission counts its full task
                       list at admission, before anything is queued).
    max_live_jobs    — concurrent non-terminal jobs.
    max_result_bytes — retained result payload bytes across the tenant's
                       DONE jobs (freed when a job is evicted/forgotten).
    """

    max_live_tasks: int = 200_000
    max_live_jobs: int = 64
    max_result_bytes: int = 256 << 20


@dataclasses.dataclass
class JobRecord:
    """One job's full lifecycle record. Mutable fields are guarded by the
    owning registry's lock; ``cancel_event`` is the cross-thread cancel
    signal the executor polls."""

    job_id: str
    tenant: str
    spec: Any
    prefix: str
    signature: str
    keys: List[str]
    total_tasks: int
    priority: int = 0
    state: str = "QUEUED"
    done_tasks: int = 0
    error: Optional[str] = None
    result: Optional[Dict[str, Any]] = None
    result_bytes: int = 0
    created_at: float = 0.0
    started_at: Optional[float] = None
    finished_at: Optional[float] = None
    cancel_event: threading.Event = dataclasses.field(
        default_factory=threading.Event
    )

    def public(self, *, with_result: bool = False) -> Dict[str, Any]:
        """The wire-safe snapshot of this record (no events/threads)."""
        out = {
            "job_id": self.job_id,
            "tenant": self.tenant,
            "state": self.state,
            "priority": self.priority,
            "total_tasks": self.total_tasks,
            "done_tasks": self.done_tasks,
            "error": self.error,
            "created_at": self.created_at,
            "started_at": self.started_at,
            "finished_at": self.finished_at,
            "signature": self.signature,
        }
        if with_result:
            out["result"] = self.result
        return out


class JobRegistry:
    """Thread-safe job/refcount/quota bookkeeping for one StudyServer."""

    def __init__(self, default_quota: Optional[TenantQuota] = None) -> None:
        self._lock = threading.Lock()
        self._jobs: Dict[str, JobRecord] = {}  # guard: _lock
        # WorkItem key -> ids of live jobs referencing it. The Manager memo
        # behind a key may be forgotten only when this set empties.
        self._key_refs: Dict[str, Set[str]] = {}  # guard: _lock
        self._tenant_seq: Dict[str, int] = {}  # guard: _lock
        self._quotas: Dict[str, TenantQuota] = {}  # guard: _lock
        self._default_quota = default_quota or TenantQuota()

    # ------------------------------------------------------------------
    # Quotas
    # ------------------------------------------------------------------
    def set_quota(self, tenant: str, quota: TenantQuota) -> None:
        with self._lock:
            self._quotas[tenant] = quota

    def _quota_locked(self, tenant: str) -> TenantQuota:
        return self._quotas.get(tenant, self._default_quota)

    def _usage_locked(self, tenant: str) -> Dict[str, int]:
        live_tasks = live_jobs = result_bytes = 0
        for rec in self._jobs.values():
            if rec.tenant != tenant:
                continue
            if rec.state not in _TERMINAL:
                live_jobs += 1
                live_tasks += rec.total_tasks
            result_bytes += rec.result_bytes
        return {
            "live_tasks": live_tasks,
            "live_jobs": live_jobs,
            "result_bytes": result_bytes,
        }

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------
    def admit(
        self,
        tenant: str,
        spec: Any,
        *,
        prefix: str,
        signature: str,
        keys: List[str],
        priority: int = 0,
        est_result_bytes: int = 0,
    ) -> JobRecord:
        """Atomically check the tenant's quota and register the job.
        Raises :class:`QuotaExceeded` without side effects on rejection."""
        with self._lock:
            quota = self._quota_locked(tenant)
            use = self._usage_locked(tenant)
            if use["live_jobs"] + 1 > quota.max_live_jobs:
                raise QuotaExceeded(
                    f"tenant {tenant!r}: {use['live_jobs']} live jobs at the "
                    f"cap of {quota.max_live_jobs}"
                )
            if use["live_tasks"] + len(keys) > quota.max_live_tasks:
                raise QuotaExceeded(
                    f"tenant {tenant!r}: job of {len(keys)} tasks would "
                    f"exceed the live-task budget "
                    f"({use['live_tasks']}/{quota.max_live_tasks} used)"
                )
            if (
                use["result_bytes"] + est_result_bytes
                > quota.max_result_bytes
            ):
                raise QuotaExceeded(
                    f"tenant {tenant!r}: retained results at "
                    f"{use['result_bytes']} bytes; job would exceed the "
                    f"{quota.max_result_bytes}-byte budget"
                )
            seq = self._tenant_seq.get(tenant, 0)
            self._tenant_seq[tenant] = seq + 1
            rec = JobRecord(
                job_id=f"{tenant}/j{seq}",
                tenant=tenant,
                spec=spec,
                prefix=prefix,
                signature=signature,
                keys=list(keys),
                total_tasks=len(keys),
                priority=priority,
                created_at=time.time(),
            )
            self._jobs[rec.job_id] = rec
            for k in rec.keys:
                self._key_refs.setdefault(k, set()).add(rec.job_id)
            return rec

    def get(self, job_id: str) -> JobRecord:
        with self._lock:
            rec = self._jobs.get(job_id)
            if rec is None:
                raise KeyError(f"unknown job {job_id!r}")
            return rec

    def list_jobs(self, tenant: Optional[str] = None) -> List[Dict[str, Any]]:
        with self._lock:
            return [
                rec.public()
                for rec in self._jobs.values()
                if tenant is None or rec.tenant == tenant
            ]

    def mark_running(self, job_id: str) -> None:
        with self._lock:
            rec = self._jobs[job_id]
            if rec.state == "QUEUED":
                rec.state = "RUNNING"
                rec.started_at = time.time()

    def progress(self, job_id: str, done: int) -> None:
        with self._lock:
            rec = self._jobs.get(job_id)
            if rec is not None and rec.state == "RUNNING":
                rec.done_tasks = max(rec.done_tasks, int(done))

    def finish(
        self,
        job_id: str,
        state: str,
        *,
        result: Optional[Dict[str, Any]] = None,
        result_bytes: int = 0,
        error: Optional[str] = None,
    ) -> None:
        """Transition to a terminal state. First terminal transition wins
        (a cancel racing a natural completion cannot flip the verdict)."""
        if state not in _TERMINAL:
            raise ValueError(f"{state!r} is not a terminal job state")
        with self._lock:
            rec = self._jobs[job_id]
            if rec.state in _TERMINAL:
                return
            rec.state = state
            rec.finished_at = time.time()
            rec.result = result
            rec.result_bytes = int(result_bytes)
            rec.error = error
            if state == "DONE":
                rec.done_tasks = rec.total_tasks

    # ------------------------------------------------------------------
    # Key reference counting (the reuse-tree release rule)
    # ------------------------------------------------------------------
    def exclusive_keys(self, job_id: str) -> List[str]:
        """Keys referenced by this job and NO other live job — the only
        keys a cancel may revoke in the Manager (revoking a shared key
        would poison another tenant's subscription)."""
        with self._lock:
            rec = self._jobs.get(job_id)
            if rec is None:
                return []
            return [
                k
                for k in rec.keys
                if self._key_refs.get(k, set()) <= {job_id}
            ]

    def release(self, job_id: str) -> List[str]:
        """Drop the job's key references; returns the keys whose refcount
        hit zero — the caller forgets exactly those in the Manager. Safe
        to call once per job (idempotent: a second call finds no refs)."""
        freed: List[str] = []
        with self._lock:
            rec = self._jobs.get(job_id)
            if rec is None:
                return freed
            for k in rec.keys:
                refs = self._key_refs.get(k)
                if refs is None:
                    continue
                refs.discard(job_id)
                if not refs:
                    del self._key_refs[k]
                    freed.append(k)
        return freed

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            by_state: Dict[str, int] = {}
            for rec in self._jobs.values():
                by_state[rec.state] = by_state.get(rec.state, 0) + 1
            return {
                "jobs": len(self._jobs),
                "by_state": by_state,
                "live_keys": len(self._key_refs),
                "shared_keys": sum(
                    1 for refs in self._key_refs.values() if len(refs) > 1
                ),
            }
