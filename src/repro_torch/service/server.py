"""StudyServer — SA-as-a-service (DESIGN.md §18).

One long-lived server owns ONE persistent Manager session, one shared
:class:`~repro_torch.engine.executor.ResultCache`, and one dataset+workflow; N
tenants submit :class:`~repro_torch.service.spec.StudySpec` jobs against it
asynchronously:

* ``submit(tenant, spec) -> job_id`` — validate, resolve, plan, admission-
  check against the tenant's quota, register, and launch a job thread;
* ``status``/``result``/``cancel``/``list_jobs`` — the async job API;
* cross-tenant reuse — every job submits its WorkItems as **shared**
  (content-addressed key prefix = the spec signature), so identical
  concurrent submissions execute once in the Manager, and overlapping
  ones share task results through the server-wide cache;
* fair-share — each job's WorkItems carry ``tenant``/``priority``, so the
  Manager's deficit-round-robin dispatch keeps one tenant's backlog from
  starving another's;
* cancellation — ``cancel(job_id)`` revokes the job's *exclusive* keys in
  the Manager (queued work purged, in-flight leases poisoned) and signals
  the job thread; keys shared with other live jobs keep running for them.

The wire layer reuses the §16 socket conventions verbatim: length-
prefixed pickle frames over :class:`~repro_torch.runtime.net.SocketConn`,
tagged by ``"t"``.
"""

from __future__ import annotations

import pickle
import socket
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

from repro_torch.engine import ClusterSpec, plan_study
from repro_torch.engine.executor import ResultCache
from repro_torch.engine.streaming import execute_study, study_task_keys
from repro_torch.engine.types import DEFAULT_CACHE_BYTES
from repro_torch.runtime.fairshare import TaskCancelled
from repro_torch.runtime.manager import Manager
from repro_torch.runtime.net import PROTOCOL_VERSION, SocketConn, parse_address
from repro_torch.runtime.transport import _recv_frame, _send_frame
from repro_torch.service.registry import JobRegistry, QuotaExceeded, TenantQuota
from repro_torch.service.spec import SpecError, StudySpec

__all__ = ["StudyServer"]


class StudyServer:
    """A multi-tenant async study server over one workflow and dataset.

    ``build`` semantics mirror the fleet runner: pass ``workflow``,
    ``space``, ``inputs``, ``objective`` (and optionally ``input_keys``)
    directly, or use :meth:`from_build` with a module-level build callable
    returning that mapping.
    """

    def __init__(
        self,
        *,
        workflow: Any,
        space: Any,
        inputs: Sequence[Any],
        objective: Callable[[Any, int], float],
        input_keys: Optional[Sequence[Any]] = None,
        n_workers: int = 2,
        backend: Any = None,
        hierarchy: Any = None,
        cluster: Optional[ClusterSpec] = None,
        cache_bytes: int = DEFAULT_CACHE_BYTES,
        default_quota: Optional[TenantQuota] = None,
    ) -> None:
        self.workflow = workflow
        self.space = space
        self.inputs = list(inputs)
        self.objective = objective
        self.input_keys = (
            list(input_keys)
            if input_keys is not None
            else list(range(len(self.inputs)))
        )
        self.cluster = cluster or ClusterSpec(n_workers=n_workers)
        self.registry = JobRegistry(default_quota)
        self.cache = ResultCache(cache_bytes)
        self._mgr = Manager(
            backend=backend,
            max_attempts=self.cluster.max_attempts,
            heartbeat_timeout=self.cluster.heartbeat_timeout,
            straggler_factor=self.cluster.straggler_factor,
            enable_backup_tasks=self.cluster.enable_backup_tasks,
            hierarchy=hierarchy,
        )
        self._mgr.start(self.cluster.n_workers)
        self._lock = threading.Lock()
        self._threads: Dict[str, threading.Thread] = {}  # guard: _lock
        self._timers: Dict[str, threading.Timer] = {}  # guard: _lock
        self._closed = False  # guard: _lock
        # wire-serving state (None until serve()/serve_background())
        self._srv_sock: Optional[socket.socket] = None  # guard: _lock
        self._serve_stop = threading.Event()
        self._conn_threads: List[threading.Thread] = []  # guard: _lock

    @classmethod
    def from_build(
        cls,
        build: Callable[..., Dict[str, Any]],
        build_kwargs: Optional[Dict[str, Any]] = None,
        **server_kwargs: Any,
    ) -> "StudyServer":
        spec = build(**(build_kwargs or {}))
        return cls(
            workflow=spec["workflow"],
            space=spec["space"],
            inputs=spec["inputs"],
            objective=spec["objective"],
            input_keys=spec.get("input_keys"),
            **server_kwargs,
        )

    @property
    def manager(self) -> Manager:
        return self._mgr

    # ------------------------------------------------------------------
    # The async job API
    # ------------------------------------------------------------------
    def submit(self, tenant: str, spec: StudySpec) -> str:
        """Admit and launch one study job; returns its job id.

        Raises :class:`~repro_torch.service.spec.SpecError` on an unresolvable
        spec and :class:`~repro_torch.service.registry.QuotaExceeded` on an
        over-budget one — both before any work is planned into the pool.
        """
        if not tenant or "/" in tenant:
            raise SpecError("tenant must be a non-empty name without '/'")
        with self._lock:
            if self._closed:
                raise RuntimeError("StudyServer is closed")
        param_sets = spec.resolve(self.space)
        sig = spec.signature(self.space)
        # Content-derived key prefix: equal signatures ⇒ equal WorkItem
        # keys ⇒ the Manager's shared-submission path executes once and
        # fans out to every subscribed job.
        prefix = f"svc:{sig[:16]}:"
        plan = plan_study(
            self.workflow,
            param_sets,
            cluster=self.cluster,
            policy=spec.policy,
            max_bucket_size=spec.max_bucket_size,
            active_paths=spec.active_paths,
        )
        keys = study_task_keys(plan, len(self.inputs), prefix)
        record = self.registry.admit(
            tenant,
            spec,
            prefix=prefix,
            signature=sig,
            keys=keys,
            priority=spec.priority,
        )
        thread = threading.Thread(
            target=self._run_job,
            args=(record.job_id, spec, plan, param_sets, prefix),
            name=f"svc-job-{record.job_id}",
            daemon=True,
        )
        with self._lock:
            if self._closed:
                self.registry.finish(
                    record.job_id, "CANCELLED", error="server closed"
                )
                self.registry.release(record.job_id)
                raise RuntimeError("StudyServer is closed")
            self._threads[record.job_id] = thread
            if spec.timeout_s is not None and spec.timeout_s > 0:
                timer = threading.Timer(
                    spec.timeout_s,
                    self._timeout_job,
                    args=(record.job_id,),
                )
                timer.daemon = True
                self._timers[record.job_id] = timer
                timer.start()
        thread.start()
        return record.job_id

    def _timeout_job(self, job_id: str) -> None:
        try:
            self.cancel(job_id)
        except Exception:  # noqa: BLE001 — watchdog must never raise
            pass

    def _run_job(
        self,
        job_id: str,
        spec: StudySpec,
        plan: Any,
        param_sets: List[Any],
        prefix: str,
    ) -> None:
        record = self.registry.get(job_id)
        try:
            self.registry.mark_running(job_id)
            t0 = time.perf_counter()
            stream = execute_study(
                plan,
                self.inputs,
                cluster=self.cluster,
                cache=self.cache,
                manager=self._mgr,
                input_keys=self.input_keys,
                key_prefix=prefix,
                shared=True,
                tenant=record.tenant,
                priority=spec.priority,
                cancel_event=record.cancel_event,
                on_progress=lambda done, _total: self.registry.progress(
                    job_id, done
                ),
            )
            n_inputs = len(self.inputs)
            payload: Dict[str, Any] = {
                "param_sets": [dict(ps) for ps in param_sets],
                "n_runs": len(param_sets),
                "n_inputs": n_inputs,
                "tasks_executed": stream.tasks_executed,
                "cache_hits": stream.cache_hits,
                "cache_misses": stream.cache_misses,
                "wall_seconds": time.perf_counter() - t0,
                "signature": record.signature,
            }
            if "objective" in spec.metrics or "per_input" in spec.metrics:
                per_input = [
                    [
                        float(self.objective(stream.outputs[i][rid], i))
                        for i in range(n_inputs)
                    ]
                    for rid in range(len(param_sets))
                ]
                if "per_input" in spec.metrics:
                    payload["per_input"] = per_input
                payload["objective"] = [
                    sum(vals) / len(vals) for vals in per_input
                ]
            self.registry.finish(
                job_id,
                "DONE",
                result=payload,
                result_bytes=len(
                    pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
                ),
            )
        except TaskCancelled:
            self.registry.finish(job_id, "CANCELLED", error="cancelled")
        except BaseException as err:  # noqa: BLE001 — job verdicts are data
            self.registry.finish(
                job_id,
                "FAILED",
                error="".join(
                    traceback.format_exception_only(type(err), err)
                ).strip(),
            )
        finally:
            with self._lock:
                timer = self._timers.pop(job_id, None)
            if timer is not None:
                timer.cancel()
            # reuse-tree release rule: forget ONLY keys no live job still
            # references — a sibling job sharing this signature (or a
            # later resubmission racing in) keeps the memos alive
            freed = self.registry.release(job_id)
            if freed and self._mgr.is_running:
                self._mgr.forget(freed)

    def status(self, job_id: str) -> Dict[str, Any]:
        return self.registry.get(job_id).public()

    def result(
        self,
        job_id: str,
        *,
        wait: bool = False,
        timeout: Optional[float] = None,
        poll_s: float = 0.05,
    ) -> Dict[str, Any]:
        """The job's terminal snapshot (``result`` payload included). With
        ``wait`` it blocks until the job leaves the live states (or the
        timeout lapses — the job keeps running; only the wait gives up)."""
        deadline = (
            None if timeout is None else time.monotonic() + max(0.0, timeout)
        )
        while True:
            rec = self.registry.get(job_id)
            snap = rec.public(with_result=True)
            if snap["state"] in ("DONE", "FAILED", "CANCELLED"):
                return snap
            if not wait:
                return snap
            if deadline is not None and time.monotonic() >= deadline:
                return snap
            time.sleep(poll_s)

    def cancel(self, job_id: str) -> Dict[str, Any]:
        """Cancel a job: exclusive keys are revoked in the Manager (queued
        purged, leases poisoned, exactly-once TaskCancelled settlement)
        and the job thread is signalled. Idempotent — cancelling a
        terminal job (or one that finished while the cancel was in
        flight) changes nothing and returns the settled snapshot."""
        rec = self.registry.get(job_id)
        rec.cancel_event.set()
        exclusive = self.registry.exclusive_keys(job_id)
        if exclusive and self._mgr.is_running:
            self._mgr.cancel(exclusive)
        return self.registry.get(job_id).public()

    def list_jobs(self, tenant: Optional[str] = None) -> List[Dict[str, Any]]:
        return self.registry.list_jobs(tenant)

    def set_tenant_weight(self, tenant: str, weight: float) -> None:
        self._mgr.set_tenant_weight(tenant, weight)

    def set_tenant_quota(self, tenant: str, quota: TenantQuota) -> None:
        self.registry.set_quota(tenant, quota)

    def stats(self) -> Dict[str, Any]:
        return {
            "scheduler": self._mgr.scheduler_stats(),
            "registry": self.registry.stats(),
            "cache": {
                "hits": self.cache.hits,
                "misses": self.cache.misses,
                "spills": self.cache.spills,
                "rehydrations": self.cache.rehydrations,
            },
            "n_inputs": len(self.inputs),
            "backend": self._mgr.backend_name,
        }

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------
    def close(self, *, cancel_live: bool = True) -> None:
        """Retire the server: stop the wire listener, cancel (or wait out)
        live jobs, join job threads, and close the Manager session."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            threads = dict(self._threads)
            timers = dict(self._timers)
            self._timers.clear()
        self._serve_stop.set()
        with self._lock:
            srv = self._srv_sock
            self._srv_sock = None
        if srv is not None:
            try:
                srv.close()
            except OSError:
                pass
        for timer in timers.values():
            timer.cancel()
        if cancel_live:
            for job_id in threads:
                try:
                    self.cancel(job_id)
                except KeyError:
                    pass
        for thread in threads.values():
            thread.join(timeout=30.0)
        with self._lock:
            conn_threads = list(self._conn_threads)
            self._conn_threads.clear()
        for thread in conn_threads:
            thread.join(timeout=5.0)
        self._mgr.close()

    def __enter__(self) -> "StudyServer":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    # ------------------------------------------------------------------
    # Wire layer (§16 conventions: length-prefixed pickle frames)
    # ------------------------------------------------------------------
    def serve_background(self, addr: str = "127.0.0.1:0") -> str:
        """Bind and serve on a daemon thread; returns the bound
        ``host:port`` (port 0 asks the OS for an ephemeral one)."""
        host, port = parse_address(addr)
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, port))
        srv.listen(64)
        with self._lock:
            if self._closed:
                srv.close()
                raise RuntimeError("StudyServer is closed")
            self._srv_sock = srv
        bound = f"{host}:{srv.getsockname()[1]}"
        thread = threading.Thread(
            target=self._accept_loop, args=(srv,), daemon=True,
            name="svc-accept",
        )
        thread.start()
        with self._lock:
            self._conn_threads.append(thread)
        return bound

    def serve_forever(self) -> None:
        """Block until the server is closed (after ``serve_background``)."""
        while not self._serve_stop.wait(0.5):
            pass

    def serve(self, addr: str) -> str:
        """Bind and block (the ``python -m repro_torch.service`` entry): a
        convenience over ``serve_background`` + ``serve_forever``."""
        bound = self.serve_background(addr)
        self.serve_forever()
        return bound

    def _accept_loop(self, srv: socket.socket) -> None:
        while not self._serve_stop.is_set():
            try:
                sock, _peer = srv.accept()
            except OSError:
                return  # listener closed
            conn = SocketConn(sock)
            thread = threading.Thread(
                target=self._handle_conn, args=(conn,), daemon=True,
                name="svc-conn",
            )
            thread.start()
            with self._lock:
                if self._closed:
                    conn.close()
                    return
                self._conn_threads.append(thread)

    def _handle_conn(self, conn: SocketConn) -> None:
        """Per-connection request loop. One frame in, one frame out;
        request handling never holds the server lock across a send."""
        send_lock = threading.Lock()
        try:
            _send_frame(
                conn, send_lock, {"t": "svc_hello", "proto": PROTOCOL_VERSION}
            )
            while not self._serve_stop.is_set():
                msg = _recv_frame(conn)
                reply = self._dispatch_frame(msg)
                _send_frame(conn, send_lock, reply)
                if msg.get("t") == "bye":
                    return
        except (EOFError, OSError):
            return  # peer went away; nothing to clean up server-side
        finally:
            conn.close()

    def _dispatch_frame(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        kind = msg.get("t")
        try:
            if kind == "sub":
                spec = StudySpec.from_json(msg["spec"])
                job_id = self.submit(msg["tenant"], spec)
                return {"t": "sub_ok", "job_id": job_id}
            if kind == "stat":
                return {"t": "stat_ok", "job": self.status(msg["job_id"])}
            if kind == "res":
                job = self.result(
                    msg["job_id"],
                    wait=bool(msg.get("wait", False)),
                    timeout=msg.get("timeout"),
                )
                return {"t": "res_ok", "job": job}
            if kind == "cancel":
                return {"t": "cancel_ok", "job": self.cancel(msg["job_id"])}
            if kind == "jobs":
                return {
                    "t": "jobs_ok",
                    "jobs": self.list_jobs(msg.get("tenant")),
                }
            if kind == "weight":
                self.set_tenant_weight(
                    msg["tenant"], float(msg["weight"])
                )
                return {"t": "weight_ok"}
            if kind == "sstats":
                return {"t": "sstats_ok", "stats": self.stats()}
            if kind == "bye":
                return {"t": "bye_ok"}
            return {"t": "err", "error": f"unknown frame tag {kind!r}"}
        except (SpecError, QuotaExceeded, KeyError, RuntimeError) as err:
            return {
                "t": "err",
                "error": f"{type(err).__name__}: {err}",
            }
