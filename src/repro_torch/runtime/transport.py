"""Transport-agnostic Worker backends — the Manager's dispatch boundary
(DESIGN.md §13–§14).

The Manager is a pure scheduler/bookkeeper: it owns the queue, the lease
table, retry/backup/heartbeat policy and result memoisation, and talks to
its Workers exclusively through the :class:`WorkerBackend` protocol::

    start(n) / offer(lease) / poll_completions(timeout) / heartbeat_view()
    / shutdown()

with :class:`Lease` / :class:`Completion` dataclasses as the only currency.
Everything the paper's multi-node deployment needs from the boundary is in
those five calls: demand signalling (``heartbeat_view`` exposes free
slots), at-least-once dispatch (``offer`` may be re-driven after an
expiry), and completion delivery decoupled from scheduling. Two conforming
implementations ship here:

* :class:`ThreadBackend` — the historical behavior: Worker threads in this
  process executing ``Lease.fn`` closures directly. The default, so every
  existing ``Manager()`` caller keeps working unchanged.
* :class:`ProcessRpcBackend` — N ``spawn`` worker *processes* running
  :func:`_rpc_worker_main`, speaking a length-prefixed pickle control plane
  over ``multiprocessing.Connection`` pipes. Control messages carry only
  keys, attempt numbers and small picklable task *specs*. Worker processes
  rebuild their execution context (workflow, inputs) from a spawn-picklable
  ``build`` callable — the same pattern the fleet runner uses — and rebuild
  each StudyPlan deterministically from the plan's ``recipe``, so no
  unpicklable closure ever needs to cross a process boundary.

The process backend's fast path (DESIGN.md §14) is four independently
flag-gated mechanisms, all on by default:

* **batched frames** (``batch_frames``) — the Manager pump hands the
  backend a *batch* of ready leases per tick (``offer_batch``), the
  backend coalesces each worker's share into one ``lease_batch`` frame,
  and workers return ``comp_batch`` frames under a ``max_batch`` /
  ``max_delay_ms`` window: one pickle round trip per batch instead of per
  task, and each worker holds a small queue (``slots_per_worker``) so it
  never idles between frames.
* **warm plans** (``warm_plans``) — workers key rebuilt StudyPlans by
  *recipe content*, not the per-call ``plan_id``, so re-installing an
  identical study (a benchmark loop, an adaptive round over the same
  space) is a plan-cache hit; the ``install_study`` broadcast prewarms the
  cache before the first lease, and hit/miss counters ride heartbeats into
  the backend's ``stats()``. (jit caches warm for free: compiled kernels
  are process-global and keyed by trace shape, not by plan.)
* **shared-memory handoff** (``shm_results``) — array-bearing results
  cross the boundary as one ``multiprocessing.shared_memory`` segment
  referenced by name+offsets+dtypes in the completion frame instead of
  pickle→npz→load through the store, with a structural fallback (object
  payloads, oversize values) to the inline/store path.
* **async commit** (``async_commit``) — workers ack completions without a
  synchronous disk persist; the leader stages each hydrated value in an
  :class:`~repro_torch.runtime.storage.AsyncCommitQueue` whose background
  flusher drains into the store through the existing atomic
  footer-verified protocol. ``barrier()`` (invoked by ``Manager.drain``
  and ``StudyState.save``) is the durability point. Workers that need an
  upstream result another worker produced fetch it from the leader's
  staging tier over the control plane (``fetch``/``fetched`` frames).

Results therefore cross the boundary by shared-memory descriptor, inline
value, or store key — never as ambient pickled state; a crash between ack
and flush costs nothing (the lease-retry path recomputes the pure task).

The frame format is deliberately transport-portable: ``<8-byte LE length>
<pickle payload>`` — ``multiprocessing.Connection`` adds its own framing
today, but the explicit prefix means the same codec drives a raw socket
when workers move to other hosts (the ROADMAP follow-on).
"""

from __future__ import annotations

import collections
import dataclasses
import os
import pathlib
import pickle
import queue
import struct
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import trace
from repro_torch.runtime.tensors import tensor_from_host, tensor_to_host

__all__ = [
    "Lease",
    "Completion",
    "WorkerStatus",
    "WorkerBackend",
    "ThreadBackend",
    "ProcessRpcBackend",
    "RemoteTaskError",
    "TransportError",
    "make_backend",
    "process_flag_kwargs",
    "shm_encode",
    "shm_decode",
]


class TransportError(RuntimeError):
    """A structural failure of the dispatch boundary itself (torn frame,
    spec missing for a cross-process lease) — distinct from a task failing."""


class RemoteTaskError(RuntimeError):
    """A task failed on the far side of the boundary; carries the remote
    traceback text (the original exception object cannot cross the wire)."""


@dataclasses.dataclass
class Lease:
    """One attempt of one key, handed to a backend for execution.

    ``fn`` is the in-process closure (never serialised; ignored by remote
    backends); ``spec`` is the small picklable task description remote
    backends ship instead. A backend consumes whichever representation it
    supports — :class:`ThreadBackend` prefers ``fn``, falling back to the
    portable ``("call", callable, args, kwargs)`` spec form so one WorkItem
    can conform on every backend.
    """

    key: str
    attempt: int
    fn: Optional[Callable[[], Any]] = None
    spec: Optional[Tuple] = None
    # the work item's span (repro_torch.trace), the parent of the
    # ThreadBackend's bucket.run span; never crosses a process boundary
    parent_span: Optional[trace.Span] = None

    @property
    def lease_id(self) -> str:
        return f"{self.key}#{self.attempt}"


@dataclasses.dataclass
class Completion:
    """Terminal report of one lease: a value (hydrated by the backend —
    possibly from the shared store) or a failure. ``exc`` carries the
    original exception object for in-process backends; remote backends can
    only ship ``error`` text, which the Manager wraps in
    :class:`RemoteTaskError`."""

    key: str
    attempt: int
    ok: bool
    value: Any = None
    exc: Optional[BaseException] = None
    error: Optional[str] = None
    store_key: Optional[str] = None
    worker_id: int = -1
    duration: float = 0.0

    @property
    def lease_id(self) -> str:
        return f"{self.key}#{self.attempt}"


@dataclasses.dataclass(frozen=True)
class WorkerStatus:
    """One worker's row in ``heartbeat_view()``: liveness, the monotonic
    timestamp of its last sign of life, and the lease ids it currently
    holds. A dead worker keeps reporting its orphaned leases so the Manager
    can re-enqueue them (idempotently — it pops each from its lease table
    exactly once)."""

    alive: bool
    last_seen: float
    inflight: Tuple[str, ...] = ()


try:  # Protocol is typing-only; keep the module importable everywhere
    from typing import Protocol, runtime_checkable

    @runtime_checkable
    class WorkerBackend(Protocol):
        """The Manager↔Worker contract. Implementations own worker
        lifecycle and execution; the Manager owns every scheduling
        decision.

        Beyond the five methods, two class flags complete the contract:
        ``supports_specs`` (True ⇒ leases are shipped by picklable spec,
        closures never cross — the executor then also requires an
        ``install_study(**study)`` method to broadcast plan recipes before
        any bucket lease references them) and
        ``heartbeats_prove_liveness`` (True ⇒ a fresh ``last_seen`` proves
        a worker's leases live mid-task, sparing them age-based expiry).

        Further methods are optional; the Manager discovers them by
        ``getattr``: ``offer_batch(leases, worker_ids=None) -> rejected``
        (batched dispatch; paired with a ``slots_per_worker`` attribute so
        the pump sizes demand as queue depth, not just free workers;
        ``worker_ids`` restricts a batch to a shard for the hierarchical
        scheduler's sub-manager pumps), ``offer_to(lease, worker_id) ->
        bool`` (locality-targeted single-worker offer, DESIGN.md §15) and
        ``barrier(timeout=None) -> bool`` (durability point for backends
        that acknowledge completions ahead of their disk commit;
        ``Manager.drain`` invokes it when present).
        """

        name: str
        supports_specs: bool
        heartbeats_prove_liveness: bool

        def start(self, n_workers: int) -> None:
            """Bring up the worker pool (idempotent per session; a backend
            may be restarted after ``shutdown``)."""

        def offer(self, lease: Lease) -> bool:
            """Hand a lease to a free worker. Returns False when no worker
            can take it right now (the Manager re-queues the item)."""

        def poll_completions(self, timeout: float) -> List["Completion"]:
            """Block up to ``timeout`` seconds for completions; drain and
            return everything available (possibly empty)."""

        def heartbeat_view(self) -> Dict[int, WorkerStatus]:
            """Per-worker liveness + inflight leases; the basis of the
            Manager's demand, straggler and dead-worker decisions."""

        def shutdown(self) -> None:
            """Retire the pool; outstanding leases may be abandoned."""

except ImportError:  # pragma: no cover - pre-3.8 fallback
    WorkerBackend = object  # type: ignore[misc,assignment]


def run_call_spec(spec: Tuple) -> Any:
    """Execute the portable ``("call", fn, args, kwargs)`` spec form — the
    backend-independent task representation the conformance suite drives
    both backends with."""
    kind = spec[0]
    if kind != "call":
        raise TransportError(f"unsupported lease spec {kind!r} for direct call")
    _, fn, args, kwargs = spec
    return fn(*args, **(kwargs or {}))


def make_backend(spec: Any) -> "WorkerBackend":
    """Resolve a backend spec: ``None``/``"thread"`` → a fresh
    :class:`ThreadBackend`; a :class:`WorkerBackend` instance passes
    through; a zero-arg callable is invoked (factory form). ``"process"``
    (with or without a ``[...]`` flag suffix — see
    :func:`process_flag_kwargs`) cannot be built here — a
    :class:`ProcessRpcBackend` needs a ``build`` for its workers, so the
    caller must construct it."""
    if spec is None or spec == "thread":
        return ThreadBackend()
    if isinstance(spec, str) and spec.startswith("socket"):
        # unlike "process", a socket backend IS constructible by name: the
        # leader only listens — workers bring their own build context when
        # they dial in (or the spec's spawn mode launches loopback workers)
        from repro_torch.runtime.net import SocketBackend, socket_flag_kwargs

        return SocketBackend(**socket_flag_kwargs(spec))
    if isinstance(spec, str):
        raise ValueError(
            f"backend spec {spec!r} is not constructible from a name alone; "
            "pass a ProcessRpcBackend(build=...) instance for process workers"
        )
    if callable(spec) and not hasattr(spec, "offer"):
        return spec()
    return spec


_PROCESS_FLAG_NAMES = {
    "batch": "batch_frames",
    "warm": "warm_plans",
    "shm": "shm_results",
    "async": "async_commit",
}
_PROCESS_TUNABLES = {
    "max_batch": int,
    "max_delay_ms": float,
    "shm_max_bytes": int,
}


def process_flag_kwargs(spec: str) -> Dict[str, Any]:
    """Parse a ``"process[...]"`` backend spec's flag suffix into
    :class:`ProcessRpcBackend` keyword arguments (DESIGN.md §14).

    Grammar: comma-separated tokens inside the brackets, applied left to
    right over the constructor defaults (every mechanism ON). ``batch`` /
    ``warm`` / ``shm`` / ``async`` enable one mechanism, a ``-`` prefix
    disables it, ``all`` / ``none`` set all four at once, and
    ``key=value`` sets a tunable (``max_batch``, ``max_delay_ms``,
    ``shm_max_bytes``). Examples::

        "process"                   -> {}                  (all defaults)
        "process[-async]"           -> async_commit=False
        "process[none,batch]"       -> only batched frames on
        "process[none]"             -> the pre-optimization wire behavior
        "process[max_batch=4]"      -> tuned batching window
    """
    spec = spec.strip()
    if not spec.startswith("process"):
        raise ValueError(f"not a process backend spec: {spec!r}")
    rest = spec[len("process"):]
    if not rest:
        return {}
    if not (rest.startswith("[") and rest.endswith("]")):
        raise ValueError(f"malformed process backend spec: {spec!r}")
    kwargs: Dict[str, Any] = {}
    for token in rest[1:-1].split(","):
        token = token.strip()
        if not token:
            continue
        if "=" in token:
            k, v = (s.strip() for s in token.split("=", 1))
            if k not in _PROCESS_TUNABLES:
                raise ValueError(f"unknown process backend tunable {k!r}")
            kwargs[k] = _PROCESS_TUNABLES[k](v)
            continue
        enable = not token.startswith("-")
        name = token.lstrip("+-")
        if name == "all" or name == "none":
            on = (name == "all") == enable
            for attr in _PROCESS_FLAG_NAMES.values():
                kwargs[attr] = on
        elif name in _PROCESS_FLAG_NAMES:
            kwargs[_PROCESS_FLAG_NAMES[name]] = enable
        else:
            raise ValueError(f"unknown process backend flag {name!r}")
    return kwargs


# ---------------------------------------------------------------------------
# ThreadBackend — the historical in-process Worker pool, behind the API
# ---------------------------------------------------------------------------

_STOP = object()


class ThreadBackend:
    """Worker threads in this process. Leases execute their ``fn`` closure
    (or the portable ``("call", ...)`` spec when no closure is attached);
    values stay on the heap — nothing is serialised. One slot per worker:
    the Manager sees demand as workers with an empty inflight tuple."""

    name = "thread"
    supports_specs = False
    # a thread cannot sign life while inside a task fn, so its heartbeats
    # prove nothing mid-task — the Manager keeps age-based expiry
    heartbeats_prove_liveness = False

    def __init__(self) -> None:
        self._threads: List[threading.Thread] = []
        self._inboxes: List["queue.Queue"] = []
        self._inflight: List[set] = []  # guard: _lock
        self._completions: "queue.Queue[Completion]" = queue.Queue()
        self._lock = threading.Lock()

    def start(self, n_workers: int) -> None:
        if self._threads:
            raise RuntimeError("ThreadBackend already started")
        n = max(1, n_workers)
        self._completions = queue.Queue()
        self._inboxes = [queue.Queue() for _ in range(n)]
        self._inflight = [set() for _ in range(n)]  # analysis: ok[locks] init phase, workers start below
        self._threads = [
            threading.Thread(target=self._worker, args=(i,), daemon=True)
            for i in range(n)
        ]
        for t in self._threads:
            t.start()

    def offer(self, lease: Lease) -> bool:
        with self._lock:
            for wid, t in enumerate(self._threads):
                if t.is_alive() and not self._inflight[wid]:
                    self._inflight[wid].add(lease.lease_id)
                    break
            else:
                return False
        self._inboxes[wid].put(lease)
        return True

    def offer_to(self, lease: Lease, worker_id: int) -> bool:
        """Targeted offer (hierarchical scheduling, DESIGN.md §15): hand
        the lease to ONE specific worker — the one the affinity map says
        already holds the longest reuse-tree prefix. False if that worker
        is dead or busy; the caller keeps the item queued."""
        with self._lock:
            if not (0 <= worker_id < len(self._threads)):
                return False
            t = self._threads[worker_id]
            if not t.is_alive() or self._inflight[worker_id]:
                return False
            self._inflight[worker_id].add(lease.lease_id)
        self._inboxes[worker_id].put(lease)
        return True

    def poll_completions(self, timeout: float) -> List[Completion]:
        out: List[Completion] = []
        try:
            out.append(self._completions.get(timeout=max(0.0, timeout)))
        except queue.Empty:
            return out
        while True:
            try:
                out.append(self._completions.get_nowait())
            except queue.Empty:
                return out

    def heartbeat_view(self) -> Dict[int, WorkerStatus]:
        now = time.monotonic()
        with self._lock:
            return {
                wid: WorkerStatus(
                    alive=t.is_alive(),
                    last_seen=now,
                    inflight=tuple(self._inflight[wid]),
                )
                for wid, t in enumerate(self._threads)
            }

    def shutdown(self) -> None:
        for inbox in self._inboxes:
            inbox.put(_STOP)
        for t in self._threads:
            t.join()
        self._threads = []
        self._inboxes = []
        self._inflight = []  # analysis: ok[locks] teardown, workers joined above

    def _worker(self, wid: int) -> None:
        inbox = self._inboxes[wid]
        while True:
            lease = inbox.get()
            if lease is _STOP:
                return
            t0 = time.monotonic()
            try:
                with trace.span("bucket.run", "manager dispatch", lease.parent_span,
                                key=lease.key):
                    if lease.fn is not None:
                        value = lease.fn()
                    else:
                        value = run_call_spec(lease.spec)
            except Exception as e:  # noqa: BLE001 — the Manager owns retry
                comp = Completion(
                    key=lease.key, attempt=lease.attempt, ok=False, exc=e,
                    error=repr(e), worker_id=wid,
                    duration=time.monotonic() - t0,
                )
            else:
                comp = Completion(
                    key=lease.key, attempt=lease.attempt, ok=True, value=value,
                    worker_id=wid, duration=time.monotonic() - t0,
                )
            with self._lock:
                self._inflight[wid].discard(lease.lease_id)
            self._completions.put(comp)
            # An idle worker holds no task state: the lease's closure holds
            # its input state and the completion its outputs, tensors on
            # the card that a long-lived session would otherwise keep until
            # this worker's next lease.
            lease = comp = value = None


# ---------------------------------------------------------------------------
# Wire codec: length-prefixed pickle frames
# ---------------------------------------------------------------------------

_FRAME_HEADER = struct.Struct("<Q")


def _send_frame(conn, lock: threading.Lock, obj: Any) -> None:
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    frame = _FRAME_HEADER.pack(len(payload)) + payload
    with lock:
        # analysis: ok[blocking] this IS the frame-send serialization lock:
        # its whole job is to hold across the write so concurrent senders
        # cannot interleave torn frames on one connection; it guards no
        # other state and is never nested inside another lock
        conn.send_bytes(frame)


def _recv_frame(conn) -> Any:
    frame = conn.recv_bytes()
    if len(frame) < _FRAME_HEADER.size:
        raise TransportError("short frame")
    (length,) = _FRAME_HEADER.unpack(frame[: _FRAME_HEADER.size])
    if length != len(frame) - _FRAME_HEADER.size:
        raise TransportError(
            f"torn frame: header says {length}, got {len(frame) - _FRAME_HEADER.size}"
        )
    return pickle.loads(frame[_FRAME_HEADER.size:])


def _result_store_key(session: str, work_key: str, plan_id: Optional[str] = None) -> str:
    """Store key a worker commits a lease's result under. Keyed by the WORK
    key, not the lease id: racing attempts of one key compute the same pure
    value, so the SharedStore's per-key lock elides the double-write — but
    scoped by the backend **session nonce** (and, for bucket leases, the
    plan id) so a restarted backend or a second plan sharing one session
    can never be served a previous lifetime's entry as if it were its own.
    (Cross-round/cross-worker reuse does not live here: it flows through
    the workers' task-level ResultCache keys, which are deliberately
    session-independent.)"""
    if plan_id is not None:
        return f"rpc:{session}:{plan_id}:{work_key}"
    return f"rpc:{session}:{work_key}"


# ---------------------------------------------------------------------------
# Shared-memory result codec (the `shm_results` handoff path)
# ---------------------------------------------------------------------------

_SHM_ALIGN = 64  # cache-line align each array so reads never split lines


class _NotShmEncodable(Exception):
    """Internal: the value contains something only pickle can carry."""


def _shm_attach(name: str):
    """Attach to an existing segment WITHOUT registering it with the
    resource_tracker. The tracker's ledger must balance exactly one
    register (the creator's, implicit in ``SharedMemory(create=True)`` —
    the crash backstop: if every process dies, the tracker unlinks the
    leftovers) against exactly one unregister (implicit in whichever
    process calls ``unlink()``). A plain attach ALSO registers on
    Python < 3.13, which would double-count and make the tracker log
    KeyErrors at exit — so register is swapped for a no-op across the
    attach call. Safe here because every attach in this module happens on
    a single thread per process (the worker main loop / the leader pump)."""
    from multiprocessing import resource_tracker, shared_memory

    orig = resource_tracker.register
    resource_tracker.register = lambda *a, **k: None  # type: ignore[assignment]
    try:
        return shared_memory.SharedMemory(name=name)
    finally:
        resource_tracker.register = orig  # type: ignore[assignment]


def _shm_template(value: Any, arrays: List[np.ndarray]) -> Tuple:
    """Flatten ``value`` into a picklable template tree + a flat list of
    contiguous arrays (appended to ``arrays``). Raises
    :class:`_NotShmEncodable` for anything outside the structural subset:
    None/bool/int/float/str/bytes scalars, list/tuple/dict containers
    (primitive keys), and array-likes with non-object, round-trippable
    dtypes."""
    tag: Optional[Tuple[str, str]] = None
    if isinstance(value, np.ndarray):
        a = value
    elif isinstance(value, torch.Tensor):
        # from the host (bf16 as its 16-bit view), rebuilt as a tensor of
        # this dtype on this device type
        try:
            a, dtype, device = tensor_to_host(value)
        except TypeError:
            raise _NotShmEncodable from None
        tag = (dtype, device)
    elif value is None or isinstance(value, (bool, int, float, complex, str, bytes)):
        # note: np.float64 IS a float subclass — it rides the template
        # verbatim (pickled exactly), which round-trips bit-identically
        return ("s", value)
    elif hasattr(value, "__array__"):
        a = np.asarray(value)  # jax arrays, np scalars — matches the npz path
    elif isinstance(value, dict):
        items = []
        for k, v in value.items():
            if not (k is None or isinstance(k, (bool, int, float, str, bytes, tuple))):
                raise _NotShmEncodable
            items.append((k, _shm_template(v, arrays)))
        return ("d", items)
    elif isinstance(value, tuple):
        return ("t", [_shm_template(v, arrays) for v in value])
    elif isinstance(value, list):
        return ("l", [_shm_template(v, arrays) for v in value])
    else:
        raise _NotShmEncodable
    if a.dtype.hasobject or np.dtype(a.dtype.str) != a.dtype:
        raise _NotShmEncodable  # object/structured dtypes: pickle's job
    c = np.ascontiguousarray(a)
    if c.shape != a.shape:
        c = c.reshape(a.shape)  # ascontiguousarray promotes 0-d to (1,)
    arrays.append(c)
    if tag is not None:
        return ("T", len(arrays) - 1, *tag)
    return ("a", len(arrays) - 1)


def _shm_rebuild(node: Tuple, arrays: List[np.ndarray]) -> Any:
    tag = node[0]
    if tag == "s":
        return node[1]
    if tag == "a":
        return arrays[node[1]]
    if tag == "T":
        return tensor_from_host(arrays[node[1]], node[2], node[3])
    if tag == "d":
        return {k: _shm_rebuild(v, arrays) for k, v in node[1]}
    if tag == "t":
        return tuple(_shm_rebuild(v, arrays) for v in node[1])
    if tag == "l":
        return [_shm_rebuild(v, arrays) for v in node[1]]
    raise TransportError(f"corrupt shm template tag {tag!r}")


def shm_encode(value: Any, name: str, *, max_bytes: int) -> Optional[Dict[str, Any]]:
    """Copy ``value``'s arrays into ONE shared-memory segment ``name`` and
    return the wire descriptor (template tree + per-array offset/shape/
    dtype), or None when the value is not shm-eligible (no arrays, object
    payloads, total bytes over ``max_bytes``, or segment creation failed) —
    the caller falls back to the inline/store path. Ownership passes to the
    receiver: ``shm_decode`` unlinks after copying, the backend's shutdown
    sweep catches segments nobody decoded, and the creator's
    resource_tracker registration is the crash backstop (see
    :func:`_shm_attach` for the ledger discipline)."""
    arrays: List[np.ndarray] = []
    try:
        tree = _shm_template(value, arrays)
    except _NotShmEncodable:
        return None
    if not arrays:
        return None  # pure scalars/containers: the frame itself is cheaper
    offsets: List[int] = []
    total = 0
    for a in arrays:
        total = (total + _SHM_ALIGN - 1) & ~(_SHM_ALIGN - 1)
        offsets.append(total)
        total += a.nbytes
    if total == 0 or total > max_bytes:
        return None
    try:
        from multiprocessing import shared_memory

        seg = shared_memory.SharedMemory(name=name, create=True, size=total)
    except Exception:  # noqa: BLE001 — ENOSPC/EEXIST etc: fall back
        return None
    try:
        for a, off in zip(arrays, offsets):
            if a.nbytes == 0:
                continue
            dest = np.frombuffer(seg.buf, dtype=a.dtype, count=a.size, offset=off)
            dest[:] = a.reshape(-1)
            del dest
        return {
            "shm": name,
            "size": total,
            "tree": tree,
            "arrays": [
                (off, tuple(a.shape), a.dtype.str)
                for a, off in zip(arrays, offsets)
            ],
        }
    except Exception:  # noqa: BLE001 — never let the codec kill a worker
        try:
            seg.unlink()
        except Exception:  # noqa: BLE001
            pass
        return None
    finally:
        try:
            seg.close()
        except Exception:  # noqa: BLE001
            pass


def shm_decode(desc: Dict[str, Any], *, unlink: bool = True) -> Any:
    """Rebuild the value from a :func:`shm_encode` descriptor: attach the
    segment, copy every array out (the result owns its memory), and unlink
    the segment (default — the handoff is one-shot). Raises if the segment
    is gone, which the backend turns into a lease failure → retry."""
    seg = _shm_attach(desc["shm"])
    try:
        arrays: List[np.ndarray] = []
        for off, shape, dtype in desc["arrays"]:
            dt = np.dtype(dtype)
            count = int(np.prod(shape, dtype=np.int64)) if shape else 1
            if count == 0:
                arrays.append(np.empty(shape, dtype=dt))
                continue
            view = np.frombuffer(seg.buf, dtype=dt, count=count, offset=off)
            arrays.append(view.reshape(shape).copy())
            del view
        return _shm_rebuild(desc["tree"], arrays)
    finally:
        try:
            seg.close()
        except Exception:  # noqa: BLE001
            pass
        if unlink:
            try:
                seg.unlink()
            except Exception:  # noqa: BLE001 — already gone is fine
                pass


def _shm_unlink_by_name(name: str) -> None:
    """Best-effort unlink of a segment nobody will ever decode."""
    try:
        seg = _shm_attach(name)
    except Exception:  # noqa: BLE001 — already gone
        return
    try:
        seg.close()
        seg.unlink()
    except Exception:  # noqa: BLE001
        pass


# ---------------------------------------------------------------------------
# The worker process main loop
# ---------------------------------------------------------------------------

_PLAN_META_MAX = 16  # plan_id → study metadata rows kept per worker
_PLAN_CACHE_MAX = 8  # built plans kept per worker (recipe-content keyed)
_FETCH_TIMEOUT = 30.0  # upstream fetch-from-leader wait before failing


def _recipe_key(recipe: Dict[str, Any]) -> str:
    """Content key of a plan recipe. Recipes are pure primitives (tuples of
    ``(name, value)`` ParamSets, numbers, strings — planner contract), so
    ``repr`` is deterministic across processes and sessions; two installs
    of structurally identical studies share one built plan."""
    return repr(sorted((k, repr(v)) for k, v in recipe.items()))


class _RpcWorker:
    """One spawn worker's whole life: build the execution context, mount
    the SharedStore, then serve lease/lease_batch frames until told to
    stop. A failing ``build`` is parked and surfaced as a failure on every
    lease (the fleet-runner pattern: a raising child would just die
    silently). A daemon heartbeat thread keeps signing life — and shipping
    the worker's counters — even while a task runs, so the leader can tell
    "busy on a long bucket" from "dead"."""

    def __init__(
        self,
        conn,
        worker_id: int,
        session: str,
        build: Optional[Callable[..., Dict[str, Any]]],
        build_kwargs: Optional[Dict[str, Any]],
        store_dir: str,
        store_ram_bytes: int,
        cache_bytes: int,
        heartbeat_interval: float,
        options: Optional[Dict[str, Any]] = None,
    ) -> None:
        self.conn = conn
        self.wid = worker_id
        self.session = session
        self.heartbeat_interval = heartbeat_interval
        opts = dict(options or {})
        self.opt_batch = bool(opts.get("batch", False))
        self.opt_warm = bool(opts.get("warm", False))
        self.opt_shm = bool(opts.get("shm", False))
        self.opt_async = bool(opts.get("async", False))
        self.max_batch = max(1, int(opts.get("max_batch", 16)))
        self.max_delay_ms = float(opts.get("max_delay_ms", 2.0))
        self.shm_max_bytes = int(opts.get("shm_max_bytes", 64 << 20))
        self._send_lock = threading.Lock()
        self._pending: "collections.deque[Dict[str, Any]]" = collections.deque()
        self._comp_buf: List[Dict[str, Any]] = []
        self._comp_t0 = 0.0
        self._fetched: Dict[str, Dict[str, Any]] = {}
        self._stop = False
        self._shm_seq = 0
        # single-writer counters: only the serve thread increments; the
        # heartbeat thread snapshots racily (stale ints are fine). Every
        # key is preset here so no increment ever RESIZES the dict under
        # the heartbeat thread's iteration — including "reconnects",
        # which run_worker bumps on a dict transplanted from the previous
        # connection's worker while its heartbeat thread may still be
        # draining.
        self.counters: Dict[str, int] = {
            "leases_run": 0,
            "plan_builds": 0,
            "plan_hits": 0,
            "shm_sends": 0,
            "inline_sends": 0,
            "store_sends": 0,
            "none_sends": 0,
            "comp_frames": 0,
            "comp_batched": 0,
            "fetches": 0,
            "reconnects": 0,
        }
        self.workflow = None
        self.inputs: List[Any] = []
        self.ctx_stats: Optional[Callable[[], Dict[str, Any]]] = None
        self.store = None
        self.cache = None
        self.ctx_error: Optional[str] = None
        self._plan_meta: "collections.OrderedDict[str, Dict[str, Any]]" = (
            collections.OrderedDict()
        )
        self._plan_cache: "collections.OrderedDict[str, Dict[str, Any]]" = (
            collections.OrderedDict()
        )
        try:
            spec = build(**(build_kwargs or {})) if build is not None else {}
            from repro_torch.runtime.storage import mount_store

            # store_dir is a SPEC: a plain directory mounts the flocked
            # SharedStore, "obj:<root>" the object-store tier (§16) — the
            # same string the leader mounted, shipped verbatim
            self.store = mount_store(
                store_dir, store_ram_bytes, writer_id=f"rpcw{worker_id}"
            )
            from repro_torch.engine.executor import ResultCache

            self.cache = ResultCache(cache_bytes, spill_store=self.store)
            self.workflow = spec.get("workflow")
            self.inputs = list(spec.get("inputs") or ())
            # the build's own report (its device, its kernel launches),
            # shipped with the counters
            self.ctx_stats = spec.get("stats")
        except BaseException:  # noqa: BLE001 — park and report per-lease
            self.ctx_error = traceback.format_exc()

    # -- wire helpers ---------------------------------------------------
    def _send(self, obj: Dict[str, Any]) -> None:
        _send_frame(self.conn, self._send_lock, obj)

    def _dispatch(self, msg: Dict[str, Any]) -> None:
        kind = msg.get("t")
        if kind == "stop":
            self._stop = True
        elif kind == "lease":
            self._pending.append(msg)
        elif kind == "lease_batch":
            self._pending.extend(msg["leases"])
        elif kind == "study":
            self._install(msg)
        elif kind == "fetched":
            self._fetched[msg["key"]] = msg

    def _pump_recv(self, timeout: float) -> bool:
        """Drain every frame the pipe has ready (blocking up to ``timeout``
        for the first); False means the leader hung up."""
        try:
            if not self.conn.poll(timeout):
                return True
            while True:
                self._dispatch(_recv_frame(self.conn))
                if not self.conn.poll():
                    return True
        except (EOFError, OSError):
            return False

    # -- study install / plan cache -------------------------------------
    def _install(self, msg: Dict[str, Any]) -> None:
        if self.ctx_error is not None:
            return
        try:
            recipe = msg["recipe"]
            rk = _recipe_key(recipe)
            warm_hit = self.opt_warm and rk in self._plan_cache
            # publish point: push the previous study's cached task outputs
            # through to the store's disk tier so peers — and a resumed
            # study over this store_dir — rehydrate instead of recomputing
            # (the fleet workers' per-round flush, same rule). A warm
            # re-install of an identical recipe skips it — the previous
            # install of this very study already published, and the
            # session-exit flush remains the backstop — so a benchmark
            # loop's timed window is not billed for fsyncing history.
            if self.cache is not None and not warm_hit:
                self.cache.flush()
            self._plan_meta[msg["plan_id"]] = {
                "recipe": recipe,
                "recipe_key": rk,
                "key_prefix": msg["key_prefix"],
                "input_keys": list(msg["input_keys"]),
                "cache_enabled": bool(msg["cache_enabled"]),
            }
            while len(self._plan_meta) > _PLAN_META_MAX:
                self._plan_meta.popitem(last=False)
            # prewarm: build (or re-hit) the plan NOW, on the broadcast,
            # so the first lease of the study pays nothing
            if warm_hit:
                self._plan_cache.move_to_end(rk)
                self.counters["plan_hits"] += 1
            else:
                self._plan_cache[rk] = self._build_plan(recipe)
                self.counters["plan_builds"] += 1
                while len(self._plan_cache) > _PLAN_CACHE_MAX:
                    self._plan_cache.popitem(last=False)
        except BaseException:  # noqa: BLE001
            self.ctx_error = traceback.format_exc()

    def _build_plan(self, recipe: Dict[str, Any]) -> Dict[str, Any]:
        """Rebuild a StudyPlan from its recipe against this worker's
        workflow. Planning is deterministic (sorted group keys, no RNG), so
        every worker and the leader hold structurally identical plans —
        which is what lets a lease name a bucket by ``(plan_id, input,
        stage, bucket)`` alone. The ``rid_maps`` index (run_id → bucket
        position per stage) makes upstream routing O(1) per lease."""
        from repro_torch.engine.planner import plan_study
        from repro_torch.engine.types import MemoryBudget

        if self.workflow is None:
            raise TransportError(
                "lease needs a workflow but the backend's build() returned none"
            )
        plan = plan_study(
            self.workflow,
            recipe["param_sets"],
            memory=MemoryBudget(
                bytes=recipe["memory_bytes"], cache_bytes=recipe["cache_bytes"]
            ),
            policy=recipe["policy"],
            max_bucket_size=recipe["max_bucket_size"],
            active_paths=recipe["active_paths"],
            workers=recipe["workers"],
        )
        rid_maps = [
            {rid: j for j, b in enumerate(sp.buckets) for rid in b.run_ids}
            for sp in plan.stages
        ]
        return {"plan": plan, "rid_maps": rid_maps}

    def _plan_for(self, plan_id: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        meta = self._plan_meta.get(plan_id)
        if meta is None:
            raise TransportError(f"unknown plan {plan_id!r} (study not installed)")
        entry = self._plan_cache.get(meta["recipe_key"])
        if entry is not None:
            self._plan_cache.move_to_end(meta["recipe_key"])
            self.counters["plan_hits"] += 1
            return meta, entry
        # evicted (or install raced an eviction): rebuild on demand
        entry = self._build_plan(meta["recipe"])
        self.counters["plan_builds"] += 1
        self._plan_cache[meta["recipe_key"]] = entry
        while len(self._plan_cache) > _PLAN_CACHE_MAX:
            self._plan_cache.popitem(last=False)
        return meta, entry

    # -- lease execution -------------------------------------------------
    def _run_lease(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        t0 = time.monotonic()
        base = {"t": "comp", "wid": self.wid, "key": msg["key"],
                "attempt": msg["attempt"]}
        if self.ctx_error is not None:
            return {**base, "ok": False,
                    "error": f"worker context failed to build:\n{self.ctx_error}"}
        try:
            reply = self._execute(msg["key"], msg["spec"])
            self.counters["leases_run"] += 1
            return {**base, "ok": True,
                    "duration": time.monotonic() - t0, **reply}
        except BaseException:  # noqa: BLE001 — report, don't die
            return {**base, "ok": False, "error": traceback.format_exc(),
                    "duration": time.monotonic() - t0}

    def _execute(self, work_key: str, spec: Tuple) -> Dict[str, Any]:
        """Run one lease spec and pick the result's route across the
        boundary: shm descriptor, inline value, or store key — per the
        backend flags (see the module docstring's handoff matrix)."""
        kind = spec[0]
        plan_scope: Optional[str] = None
        if kind == "call":
            value = run_call_spec(spec)
            meta: Dict[str, Any] = {"wrap": "raw"}
        elif kind == "bucket":
            _, plan_id, input_idx, si, bi = spec
            pm, entry = self._plan_for(plan_id)
            plan_scope = plan_id
            plan = entry["plan"]
            bucket = plan.stages[si].buckets[bi]
            prefix = pm["key_prefix"]
            if si == 0:
                src = self.inputs[input_idx]
            else:
                prev = plan.stages[si - 1]
                rid0 = bucket.run_ids[0]
                bj = entry["rid_maps"][si - 1][rid0]
                up_key = _result_store_key(
                    self.session,
                    f"{prefix}in{input_idx}:{prev.index}:{prev.stage.name}:{bj}",
                    plan_id,
                )
                src = self._resolve_upstream(up_key)[rid0]
            from repro_torch.engine.executor import execute_bucket

            value, executed, hits = execute_bucket(
                bucket,
                src,
                self.cache if pm["cache_enabled"] else None,
                scope=("input", pm["input_keys"][input_idx]) + bucket.cache_scope,
            )
            meta = {"wrap": "bucket", "executed": executed, "hits": hits}
        else:
            raise TransportError(f"unknown lease spec kind {kind!r}")
        if value is None:
            # a legitimate None result: the store cannot represent it (a
            # get returning None means "missing"), so it rides the
            # completion as an explicit marker instead of a store key
            meta["none"] = True
            self.counters["none_sends"] += 1
            return meta
        store_key = _result_store_key(self.session, work_key, plan_scope)
        # RAM tier always: same-worker downstream buckets resolve locally
        self.store.put(store_key, value)
        meta["store_key"] = store_key
        if not self.opt_async:
            # the original durability contract: on disk BEFORE the ack
            self.store.persist(store_key)
            meta["committed"] = True
        if self.opt_shm:
            desc = self._shm_ship(value)
            if desc is not None:
                meta["shm"] = desc
                self.counters["shm_sends"] += 1
                return meta
        if self.opt_async:
            # leader stages it for the background flusher; the frame is
            # the handoff
            meta["inline"] = True
            meta["value"] = value
            self.counters["inline_sends"] += 1
        else:
            self.counters["store_sends"] += 1
        return meta

    def _shm_ship(self, value: Any) -> Optional[Dict[str, Any]]:
        self._shm_seq += 1
        name = f"rtf_{self.session}_{self.wid}_{self._shm_seq}"
        return shm_encode(value, name, max_bytes=self.shm_max_bytes)

    def _resolve_upstream(self, up_key: str) -> Any:
        value = self.store.get(up_key)
        if value is not None:
            return value
        if self.opt_async:
            # async mode: the value may only exist in the leader's staging
            # tier (acked but not yet flushed) — fetch it over the wire
            value = self._fetch(up_key)
            if value is not None:
                return value
        raise TransportError(
            f"upstream result {up_key!r} not resolvable from the store"
        )

    def _fetch(self, key: str) -> Optional[Any]:
        self.counters["fetches"] += 1
        self._send({"t": "fetch", "wid": self.wid, "key": key})
        deadline = time.monotonic() + _FETCH_TIMEOUT
        while time.monotonic() < deadline:
            msg = self._fetched.pop(key, None)
            if msg is not None:
                if not msg.get("found"):
                    return None
                value = msg["value"]
                # cache locally: sibling buckets of this stage resolve free
                self.store.put(key, value)
                return value
            if self._stop:
                return None
            try:
                if self.conn.poll(0.05):
                    self._dispatch(_recv_frame(self.conn))
            except (EOFError, OSError):
                return None
        raise TransportError(f"fetch of upstream {key!r} timed out")

    # -- completion shipping ---------------------------------------------
    def _unlink_comp_shm(self, comp: Dict[str, Any]) -> None:
        desc = comp.get("shm")
        if desc:
            _shm_unlink_by_name(desc["shm"])

    def _to_store_route(self, comp: Dict[str, Any]) -> Dict[str, Any]:
        """Demote an unpicklable inline completion to the store route:
        persist now, strip the payload."""
        comp = dict(comp)
        value = comp.pop("value", None)
        comp.pop("inline", None)
        try:
            if comp.get("store_key") and value is not None:
                self.store.persist(comp["store_key"])
                comp["committed"] = True
            return comp
        except BaseException:  # noqa: BLE001
            return {**{k: comp[k] for k in ("t", "wid", "key", "attempt")},
                    "ok": False, "error": traceback.format_exc()}

    def _flush_comps(self, buf: List[Dict[str, Any]]) -> bool:
        """Ship buffered completions: one ``comp_batch`` frame when
        batching, individual ``comp`` frames otherwise. Unpicklable inline
        values demote to the store route; a dead pipe unlinks any shm
        segments the leader will never decode. False = leader gone."""
        if not buf:
            return True
        try:
            if self.opt_batch:
                self._send({"t": "comp_batch", "wid": self.wid, "comps": buf})
                self.counters["comp_frames"] += 1
                self.counters["comp_batched"] += len(buf)
            else:
                for comp in buf:
                    self._send(comp)
                    self.counters["comp_frames"] += 1
            return True
        except (pickle.PicklingError, TypeError, AttributeError):
            ok = True
            for comp in buf:
                try:
                    self._send(comp)
                    self.counters["comp_frames"] += 1
                except (pickle.PicklingError, TypeError, AttributeError):
                    try:
                        self._send(self._to_store_route(comp))
                        self.counters["comp_frames"] += 1
                    except (OSError, ValueError, BrokenPipeError):
                        self._unlink_comp_shm(comp)
                        ok = False
                except (OSError, ValueError, BrokenPipeError):
                    self._unlink_comp_shm(comp)
                    ok = False
            return ok
        except (OSError, ValueError, BrokenPipeError):
            for comp in buf:
                self._unlink_comp_shm(comp)
            return False

    def _buffer_comp(self, reply: Dict[str, Any]) -> bool:
        if not self.opt_batch:
            return self._flush_comps([reply])
        if not self._comp_buf:
            self._comp_t0 = time.monotonic()
        self._comp_buf.append(reply)
        return True

    def _flush_due(self) -> bool:
        if not self._comp_buf:
            return False
        if len(self._comp_buf) >= self.max_batch:
            return True
        if not self._pending:  # nothing left to coalesce with
            return True
        return (time.monotonic() - self._comp_t0) * 1000.0 >= self.max_delay_ms

    # -- main loop --------------------------------------------------------
    def _stats_snapshot(self) -> Dict[str, Any]:
        out: Dict[str, Any] = dict(self.counters)
        try:
            if self.cache is not None:
                out["cache"] = self.cache.counters()
            if self.store is not None:
                out["store"] = self.store.counters()
            if self.ctx_stats is not None:
                out["build"] = self.ctx_stats()
        except BaseException:  # noqa: BLE001 — stats must never kill hb
            pass
        return out

    def serve(self) -> None:
        hb_stop = threading.Event()

        def _heartbeats() -> None:
            while not hb_stop.wait(self.heartbeat_interval):
                try:
                    self._send({"t": "hb", "wid": self.wid,
                                "stats": self._stats_snapshot()})
                except (OSError, ValueError, BrokenPipeError):
                    return
                except BaseException:  # noqa: BLE001 — pickling stats &c.
                    pass

        threading.Thread(target=_heartbeats, daemon=True).start()
        try:
            self._send({"t": "hello", "wid": self.wid, "pid": os.getpid()})
            while True:
                idle = not self._pending and not self._comp_buf
                if not self._pump_recv(0.2 if idle else 0.0):
                    break  # leader hung up
                if self._stop:
                    self._flush_comps(self._comp_buf)
                    self._comp_buf = []
                    # a last heartbeat: the counters as the worker retires,
                    # which the leader's shutdown reads before it joins
                    try:
                        self._send({"t": "hb", "wid": self.wid,
                                    "stats": self._stats_snapshot()})
                    except (OSError, ValueError, BrokenPipeError):
                        pass
                    break  # queued leases are abandoned; retry re-drives
                if self._pending:
                    if not self._buffer_comp(self._run_lease(self._pending.popleft())):
                        break
                if self._flush_due():
                    buf, self._comp_buf = self._comp_buf, []
                    if not self._flush_comps(buf):
                        break
        finally:
            hb_stop.set()
            if self._comp_buf:
                self._flush_comps(self._comp_buf)
                self._comp_buf = []
            try:
                # durability barrier at session end: without it every
                # cached task output this worker never evicted would die
                # with the process, silently voiding zero-recompute resume
                if self.cache is not None:
                    self.cache.flush()
            except BaseException:  # noqa: BLE001 — shutdown must not raise
                pass
            try:
                self.conn.close()
            except OSError:
                pass


def _rpc_worker_main(
    conn,
    worker_id: int,
    session: str,
    build: Optional[Callable[..., Dict[str, Any]]],
    build_kwargs: Optional[Dict[str, Any]],
    store_dir: str,
    store_ram_bytes: int,
    cache_bytes: int,
    heartbeat_interval: float,
    options: Optional[Dict[str, Any]] = None,
) -> None:
    """Entry point of one spawn worker (see :class:`_RpcWorker`)."""
    _RpcWorker(
        conn, worker_id, session, build, build_kwargs, store_dir,
        store_ram_bytes, cache_bytes, heartbeat_interval, options,
    ).serve()


# ---------------------------------------------------------------------------
# ProcessRpcBackend — spawn workers behind the pickle control plane
# ---------------------------------------------------------------------------


def worker_context(mp_context: str):
    """The ``multiprocessing`` context worker processes start from. ``fork``
    is refused where a CUDA card is present: a forked child cannot use a
    CUDA context its parent holds, and the workers' builds put their inputs
    on the card (``spawn``, the default, starts each worker fresh)."""
    import multiprocessing

    if mp_context == "fork" and torch.cuda.is_available():
        raise ValueError(
            "mp_context='fork' with a CUDA card present: worker processes "
            "open their own CUDA contexts and must start with 'spawn'"
        )
    return multiprocessing.get_context(mp_context)


def stop_processes(procs, *, grace: float = 5.0) -> None:
    """Bounded worker-process teardown, shared by the process and socket
    backends: a cooperative join window of ``grace`` seconds for the whole
    pool, then ``terminate()`` (SIGTERM) for laggards, then ``kill()``
    (SIGKILL) for anything that ignores SIGTERM — a stuck worker (wedged in
    an uninterruptible task, masking signals) can delay teardown by at most
    ``grace + ~3s``, never hang it."""
    deadline = time.monotonic() + max(0.0, grace)
    for proc in procs:
        proc.join(timeout=max(0.0, deadline - time.monotonic()))
        if proc.is_alive():
            proc.terminate()
            proc.join(timeout=2.0)
        if proc.is_alive():  # ignored SIGTERM: escalate
            try:
                proc.kill()
            except (OSError, AttributeError):
                pass
            proc.join(timeout=1.0)


class _WorkerHandle:
    __slots__ = ("wid", "proc", "conn", "alive", "last_seen", "inflight", "pid")

    def __init__(self, wid, proc, conn):
        self.wid = wid
        self.proc = proc
        self.conn = conn
        self.alive = True
        self.last_seen = time.monotonic()
        self.inflight: Dict[str, Lease] = {}
        self.pid: Optional[int] = None


_MISSING = object()


class ProcessRpcBackend:
    """N ``spawn`` worker processes serving leases over a length-prefixed
    pickle control plane, with the four flag-gated fast-path mechanisms of
    DESIGN.md §14 (batched frames, warm plans, shared-memory handoff,
    async commit) — see the module docstring for the full matrix. All four
    default ON; ``process_flag_kwargs`` parses the ``"process[...]"``
    string syntax into these constructor flags.

    ``build`` is a spawn-picklable callable (module-level; kwargs picklable)
    returning ``{"workflow": ..., "inputs": [...]}`` — each worker calls it
    once to construct its own process-local execution context, exactly like
    the fleet runner's ``build``. Backends that only serve portable
    ``("call", fn, args, kwargs)`` specs may pass ``build=None``.
    """

    name = "process"
    supports_specs = True
    # workers heartbeat from a side thread even mid-task, so a fresh
    # heartbeat PROVES the lease live: the Manager spares such leases from
    # age-based expiry (long buckets get backup clones, not revocations)
    heartbeats_prove_liveness = True

    def __init__(
        self,
        build: Optional[Callable[..., Dict[str, Any]]] = None,
        build_kwargs: Optional[Dict[str, Any]] = None,
        *,
        store_dir: Optional[str] = None,
        store_ram_bytes: int = 256 << 20,
        cache_bytes: Optional[int] = None,
        mp_context: str = "spawn",
        heartbeat_interval: float = 0.25,
        batch_frames: bool = True,
        warm_plans: bool = True,
        shm_results: bool = True,
        async_commit: bool = True,
        max_batch: int = 16,
        max_delay_ms: float = 2.0,
        shm_max_bytes: int = 64 << 20,
        shutdown_grace: float = 5.0,
    ) -> None:
        from repro_torch.engine.types import DEFAULT_CACHE_BYTES

        self.build = build
        self.build_kwargs = dict(build_kwargs or {})
        self._owns_store_dir = store_dir is None
        if store_dir is None:
            import tempfile

            store_dir = tempfile.mkdtemp(prefix="rtf_rpc_")
        self.store_dir = store_dir
        self.store_ram_bytes = int(store_ram_bytes)
        self.cache_bytes = int(cache_bytes or DEFAULT_CACHE_BYTES)
        self.mp_context = mp_context
        self.heartbeat_interval = float(heartbeat_interval)
        self.batch_frames = bool(batch_frames)
        self.warm_plans = bool(warm_plans)
        self.shm_results = bool(shm_results)
        self.async_commit = bool(async_commit)
        self.max_batch = max(1, int(max_batch))
        self.max_delay_ms = float(max_delay_ms)
        self.shm_max_bytes = int(shm_max_bytes)
        self.shutdown_grace = float(shutdown_grace)
        self._handles: List[_WorkerHandle] = []
        self._studies: List[Dict[str, Any]] = []  # replayed on (re)start
        self._store = None  # leader-side mount, lazy
        self._flusher = None  # AsyncCommitQueue when async_commit
        self._live_shm: set = set()  # segments named in undecoded frames
        self._worker_stats: Dict[int, Dict[str, Any]] = {}  # guard: _state_lock
        self._counters: Dict[str, int] = {  # guard: _state_lock
            "lease_frames": 0,
            "lease_batches": 0,
            "comp_batches": 0,
            "fetch_serves": 0,
            "shm_recv": 0,
        }
        # _lock serializes frame SENDS (it is the lock _send_frame takes
        # around conn.send_bytes); _state_lock guards leader-side mutable
        # state. Keeping them separate means no counter bump ever waits on
        # socket I/O — and no socket I/O ever runs under the state lock.
        self._lock = threading.Lock()
        self._state_lock = threading.Lock()
        # Session nonce scoping every result store key: minted per start(),
        # so a restarted backend (or another leader over one store_dir) can
        # never read a previous lifetime's result as its own.
        self._session = ""

    # -- leader-side store mount (result hydration) ---------------------
    @property
    def store(self):
        if self._store is None:
            from repro_torch.runtime.storage import mount_store

            self._store = mount_store(
                self.store_dir, self.store_ram_bytes, writer_id="rpc-leader"
            )
        return self._store

    @property
    def slots_per_worker(self) -> int:
        """Queue depth the Manager pump may keep per worker: with batched
        frames a worker holds a small backlog so it never idles between
        round trips; without, the historical one-lease-per-worker."""
        return self.max_batch if self.batch_frames else 1

    def worker_pids(self) -> List[Optional[int]]:
        """Spawned worker process ids (test/ops hook — e.g. fault injection
        by SIGKILL)."""
        return [h.proc.pid for h in self._handles]

    # -- WorkerBackend protocol -----------------------------------------
    def start(self, n_workers: int) -> None:
        if self._handles:
            raise RuntimeError("ProcessRpcBackend already started")
        import uuid

        mp = worker_context(self.mp_context)

        self._session = uuid.uuid4().hex[:12]
        self._worker_stats = {}  # analysis: ok[locks] init phase, workers spawn below
        if self.async_commit:
            from repro_torch.runtime.storage import AsyncCommitQueue

            self._flusher = AsyncCommitQueue(self.store)
        options = {
            "batch": self.batch_frames,
            "warm": self.warm_plans,
            "shm": self.shm_results,
            "async": self.async_commit,
            "max_batch": self.max_batch,
            "max_delay_ms": self.max_delay_ms,
            "shm_max_bytes": self.shm_max_bytes,
        }
        handles = []
        for wid in range(max(1, n_workers)):
            parent, child = mp.Pipe(duplex=True)
            proc = mp.Process(
                target=_rpc_worker_main,
                args=(
                    child, wid, self._session, self.build, self.build_kwargs,
                    self.store_dir, self.store_ram_bytes, self.cache_bytes,
                    self.heartbeat_interval, options,
                ),
                daemon=True,
            )
            proc.start()
            child.close()
            handles.append(_WorkerHandle(wid, proc, parent))
        self._handles = handles
        for study in self._studies:  # restart: re-install session context
            self._broadcast({"t": "study", **study})

    def install_study(self, **study: Any) -> None:
        """Broadcast a study context (plan recipe + key prefix + input keys)
        to every worker; pipes are ordered, so any lease sent afterwards
        finds the plan installed — and with ``warm_plans`` the broadcast is
        the prewarm: workers build (or recipe-hit) the plan on receipt,
        before the first lease arrives."""
        self._studies.append(dict(study))
        if len(self._studies) > 8:
            self._studies = self._studies[-8:]
        self._broadcast({"t": "study", **study})

    def _broadcast(self, msg: Dict[str, Any]) -> None:
        for h in self._handles:
            if not h.alive:
                continue
            try:
                _send_frame(h.conn, self._lock, msg)
            except (OSError, ValueError, BrokenPipeError):
                h.alive = False

    def offer(self, lease: Lease) -> bool:
        return not self.offer_batch([lease])

    def offer_batch(
        self, leases: List[Lease], worker_ids=None
    ) -> List[Lease]:
        """Distribute a batch of leases across workers with spare queue
        depth — one ``lease_batch`` frame per worker (when batching) —
        and return the leases no worker could take (the Manager unleases
        them). Least-loaded workers are filled first, round-robin, so a
        burst spreads instead of piling onto worker 0.

        ``worker_ids`` restricts the batch to a shard of the pool — the
        hierarchical scheduler's sub-manager pumps each own a disjoint
        shard, so their concurrent ``offer_batch`` calls touch disjoint
        worker handles (frame sends stay serialised by the send lock)."""
        for lease in leases:
            if lease.spec is None:
                raise TransportError(
                    f"lease {lease.key!r} has no picklable spec: the process "
                    "backend cannot ship closures across the boundary"
                )
        slots = self.slots_per_worker
        # inflight maps are written here (sub-pump threads) and popped by
        # the leader pump's hydration: capacity math runs under the state
        # lock so neither side sees a map mid-mutation
        with self._state_lock:
            ws = [
                h for h in self._handles
                if h.alive and h.proc.is_alive() and len(h.inflight) < slots
                and (worker_ids is None or h.wid in worker_ids)
            ]
            ws.sort(key=lambda h: len(h.inflight))
            caps = {h.wid: slots - len(h.inflight) for h in ws}
        if not ws:
            return list(leases)
        assigned: Dict[int, List[Lease]] = {h.wid: [] for h in ws}
        rejected: List[Lease] = []
        i = 0
        for lease in leases:
            for _ in range(len(ws)):
                h = ws[i % len(ws)]
                i += 1
                if caps[h.wid] > 0:
                    assigned[h.wid].append(lease)
                    caps[h.wid] -= 1
                    break
            else:
                rejected.append(lease)
        for h in ws:
            batch = assigned[h.wid]
            if not batch:
                continue
            frames = 1 if (self.batch_frames and len(batch) > 1) else len(batch)
            try:
                if self.batch_frames and len(batch) > 1:
                    _send_frame(
                        h.conn, self._lock,
                        {"t": "lease_batch",
                         "leases": [
                             {"key": l.key, "attempt": l.attempt, "spec": l.spec}
                             for l in batch
                         ]},
                    )
                else:
                    for l in batch:
                        _send_frame(
                            h.conn, self._lock,
                            {"t": "lease", "key": l.key, "attempt": l.attempt,
                             "spec": l.spec},
                        )
            except (OSError, ValueError, BrokenPipeError):
                h.alive = False
                rejected.extend(batch)
                continue
            with self._state_lock:
                self._counters["lease_frames"] += frames
                if self.batch_frames and len(batch) > 1:
                    self._counters["lease_batches"] += 1
                for l in batch:
                    h.inflight[l.lease_id] = l
        return rejected

    def poll_completions(self, timeout: float) -> List[Completion]:
        import multiprocessing.connection as mpc

        live = [h for h in self._handles if h.alive]
        if not live:
            time.sleep(min(max(timeout, 0.0), 0.05))
            return []
        ready = mpc.wait([h.conn for h in live], timeout=max(0.0, timeout))
        by_conn = {h.conn: h for h in live}
        out: List[Completion] = []
        for conn in ready:
            h = by_conn[conn]
            try:
                while True:
                    msg = _recv_frame(conn)
                    h.last_seen = time.monotonic()
                    kind = msg.get("t")
                    if kind == "comp":
                        out.append(self._hydrate(h, msg))
                    elif kind == "comp_batch":
                        with self._state_lock:
                            self._counters["comp_batches"] += 1
                        for m in msg["comps"]:
                            out.append(self._hydrate(h, m))
                    elif kind == "fetch":
                        self._serve_fetch(h, msg["key"])
                    elif kind == "hb":
                        stats = msg.get("stats")
                        if stats:
                            with self._state_lock:
                                self._worker_stats[h.wid] = stats
                    elif kind == "hello":
                        h.pid = msg.get("pid")
                    if not conn.poll():
                        break
            except (EOFError, OSError):
                h.alive = False
        return out

    def _serve_fetch(self, h: _WorkerHandle, key: str) -> None:
        """Answer a worker's upstream fetch from the staging tier (acked
        but not yet durable) or the store — the async-commit counterpart of
        cross-worker resolution through the disk tier."""
        value = self._flusher.peek(key) if self._flusher is not None else None
        if value is None:
            value = self.store.get(key)
        with self._state_lock:
            self._counters["fetch_serves"] += 1
        try:
            _send_frame(
                h.conn, self._lock,
                {"t": "fetched", "key": key, "found": value is not None,
                 "value": value},
            )
        except (OSError, ValueError, BrokenPipeError):
            h.alive = False

    def _hydrate(self, h: _WorkerHandle, msg: Dict[str, Any]) -> Completion:
        """Turn a wire completion into a Manager-facing one: resolve the
        value by whichever route it took (shm segment, inline payload, or
        store key), stage not-yet-durable values for the background
        flusher, and re-wrap bucket results into the executor's
        ``(outputs, executed, hits)`` shape."""
        with self._state_lock:
            h.inflight.pop(f"{msg['key']}#{msg['attempt']}", None)
        if not msg.get("ok"):
            return Completion(
                key=msg["key"], attempt=msg["attempt"], ok=False,
                error=msg.get("error") or "remote task failed",
                worker_id=h.wid, duration=float(msg.get("duration", 0.0)),
            )
        if msg.get("none"):  # an explicit None result (never stored)
            return Completion(
                key=msg["key"], attempt=msg["attempt"], ok=True, value=None,
                worker_id=h.wid, duration=float(msg.get("duration", 0.0)),
            )
        store_key = msg.get("store_key")
        value = _MISSING
        desc = msg.get("shm")
        if desc is not None:
            name = desc["shm"]
            self._live_shm.add(name)
            try:
                value = shm_decode(desc)
                with self._state_lock:
                    self._counters["shm_recv"] += 1
            except BaseException:  # noqa: BLE001 — fall back to the store
                value = _MISSING
            finally:
                self._live_shm.discard(name)
        elif msg.get("inline"):
            value = msg["value"]
        if value is _MISSING:
            value = self.store.get(store_key)
            if value is None and self._flusher is not None:
                value = self._flusher.peek(store_key)
            if value is None:
                return Completion(
                    key=msg["key"], attempt=msg["attempt"], ok=False,
                    error=f"result {store_key!r} missing from the store",
                    worker_id=h.wid, duration=float(msg.get("duration", 0.0)),
                )
        if self._flusher is not None and not msg.get("committed"):
            # stage the RAW value (workers fetch/rehydrate the unwrapped
            # form); the flusher makes it durable in the background
            self._flusher.stage(store_key, value)
        if msg.get("wrap") == "bucket":
            value = (value, int(msg["executed"]), int(msg["hits"]))
        return Completion(
            key=msg["key"], attempt=msg["attempt"], ok=True, value=value,
            store_key=store_key, worker_id=h.wid,
            duration=float(msg.get("duration", 0.0)),
        )

    def heartbeat_view(self) -> Dict[int, WorkerStatus]:
        view = {}
        for h in self._handles:
            alive = h.alive and h.proc.is_alive()
            if not alive:
                h.alive = False
            # snapshot under the state lock: a sub-pump inserting into this
            # map mid-tuple() would raise "dict changed size during iteration"
            with self._state_lock:
                inflight = tuple(h.inflight)
            view[h.wid] = WorkerStatus(
                alive=alive, last_seen=h.last_seen, inflight=inflight
            )
        return view

    def barrier(self, timeout: Optional[float] = None) -> bool:
        """Durability point: block until every staged completion is in the
        store's disk tier (no-op → True when async commit is off).
        ``Manager.drain`` and ``StudyState.save`` call this."""
        if self._flusher is None:
            return True
        return self._flusher.barrier(timeout)

    def stats(self) -> Dict[str, Any]:
        """Leader counters + flag settings + an across-the-pool aggregate
        of the workers' heartbeat-shipped counters (plan cache hits/builds,
        handoff route counts, task-cache and store tiers)."""
        with self._state_lock:
            per_worker = [dict(s) for s in self._worker_stats.values()]
            leader = dict(self._counters)
        worker_agg: Dict[str, Any] = {}
        for stats in per_worker:
            _merge_int_tree(worker_agg, stats)
        out: Dict[str, Any] = {
            "backend": self.name,
            "workers": len(self._handles),
            "flags": {
                "batch_frames": self.batch_frames,
                "warm_plans": self.warm_plans,
                "shm_results": self.shm_results,
                "async_commit": self.async_commit,
            },
            "leader": leader,
            "worker": worker_agg,
        }
        if self._flusher is not None:
            out["flusher"] = {
                "staged": self._flusher.staged,
                "committed": self._flusher.committed,
                "errors": self._flusher.errors,
                "staged_peak": self._flusher.staged_peak,
                "pending": self._flusher.pending(),
            }
        return out

    def shutdown(self) -> None:
        """Retire the pool: flush the staging tier (bounded — a wedged
        store write cannot hang teardown), stop workers with a bounded
        join (terminate → kill escalation for hung ones, so
        ``Manager.close()`` can never hang a fleet teardown), then sweep
        this session's transient state — store entries AND any leftover
        shared-memory segments, so repeated runs can't leak ``/dev/shm``."""
        if self._flusher is not None:
            # staged-but-unflushed completions reach disk before the
            # flusher retires; a poisoned entry is dropped, a wedged one
            # abandoned at the deadline — neither hangs
            try:
                self._flusher.close(flush=True, timeout=self.shutdown_grace * 2)
            except BaseException:  # noqa: BLE001
                pass
            self._flusher = None
        for h in self._handles:
            if h.alive:
                try:
                    _send_frame(h.conn, self._lock, {"t": "stop"})
                except (OSError, ValueError, BrokenPipeError):
                    pass
        # within the same grace: read each worker's last frames until it
        # hangs up, so stats() keeps its final counters (a heartbeat only
        # reaches the leader while it polls)
        deadline = time.monotonic() + self.shutdown_grace
        for h in self._handles:
            self._drain_final_stats(h, deadline)
        stop_processes([h.proc for h in self._handles],
                       grace=max(0.0, deadline - time.monotonic()))
        for h in self._handles:
            try:
                h.conn.close()
            except OSError:
                pass
        self._handles = []
        self._purge_session_entries()
        self._sweep_shm()

    def _drain_final_stats(self, h: _WorkerHandle, deadline: float) -> None:
        """After the stop frame: read what a worker still sends until it
        hangs up or ``deadline`` passes, keeping its heartbeat counters
        (the last one it sends as it retires carries its final counts)."""
        try:
            while h.conn.poll(max(0.0, deadline - time.monotonic())):
                msg = _recv_frame(h.conn)
                if msg.get("t") == "hb" and msg.get("stats"):
                    with self._state_lock:
                        self._worker_stats[h.wid] = msg["stats"]
        except (EOFError, OSError, TransportError):
            pass

    def _purge_session_entries(self) -> None:
        """Best-effort removal of THIS session's ``rpc:<session>:…`` result
        entries from the store. They are transient transport payloads — the
        session nonce makes them unreachable to any future session, so on a
        caller-owned persistent ``store_dir`` (an adaptive study's reuse
        pool) they would otherwise accumulate as dead weight forever. The
        durable cross-round reuse pool (the workers' task-level cache keys)
        is untouched. Entries a kill orphans are leaked until the directory
        is retired — the manifest still records them for audit."""
        if not self._session:
            return
        prefix = f"rpc:{self._session}:"
        try:
            for key in self.store.committed_keys():
                if key.startswith(prefix):
                    self.store.delete(key)
        except OSError:  # pragma: no cover - purge is best-effort
            pass

    def _sweep_shm(self) -> None:
        """Unlink every shared-memory segment this session may have left
        behind: tracked in-frame names first, then a ``/dev/shm`` scan for
        the session's deterministic ``rtf_<session>_…`` prefix (covers
        segments a killed worker created but never reported)."""
        if not self._session:
            return
        names = set(self._live_shm)
        self._live_shm = set()
        prefix = f"rtf_{self._session}_"
        shm_root = pathlib.Path("/dev/shm")
        try:
            if shm_root.is_dir():
                names.update(
                    p.name for p in shm_root.iterdir()
                    if p.name.startswith(prefix)
                )
        except OSError:  # pragma: no cover - scan is best-effort
            pass
        for name in names:
            _shm_unlink_by_name(name)

    def cleanup(self) -> None:
        """Remove the backend's store directory IF this backend created it
        (default tempdir mode) and no workers are running. ``shutdown``
        deliberately leaves the store readable — callers often inspect
        committed results after a session retires — so owners of throwaway
        backends (the app-level ``backend="process"`` paths call this) must
        cleanup explicitly; a caller-supplied ``store_dir`` is never
        touched (it is the caller's reuse pool)."""
        if not self._owns_store_dir or self._handles:
            return
        import shutil

        self._store = None
        shutil.rmtree(self.store_dir, ignore_errors=True)


def _merge_int_tree(dst: Dict[str, Any], src: Dict[str, Any]) -> None:
    """Sum ``src``'s numeric leaves into ``dst`` (nested dicts recurse) —
    how per-worker counter snapshots aggregate into pool stats."""
    for k, v in src.items():
        if isinstance(v, dict):
            _merge_int_tree(dst.setdefault(k, {}), v)
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            dst[k] = dst.get(k, 0) + v
