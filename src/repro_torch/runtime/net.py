"""Raw-socket control plane: the WorkerBackend that leaves the host
(DESIGN.md §16).

The frame codec was transport-portable from day one — ``<8-byte LE length>
<pickle payload>`` (see ``runtime.transport``) — and this module is the
promised payoff: the SAME frames (``study``/``lease``/``lease_batch``/
``comp``/``comp_batch``/``hb``/``fetch``/``fetched``/``stop``) driven over
TCP instead of ``multiprocessing`` pipes, so every §14 fast path (batched
frames, warm plan caches, async commit + leader fetch) survives the hop
off-host unchanged. What sockets add over pipes is a *membership* problem,
solved by three new frame kinds that exist only at connection setup:

* ``register`` — a worker dials the leader and introduces itself:
  protocol version, requested worker id (None on first contact, its
  assigned id on reconnect), pid, and a capability map;
* ``welcome`` — the leader accepts: assigned worker id, session nonce,
  the §14 option flags, the store SPEC to mount (a plain directory for a
  shared filesystem, ``obj:<root>`` for the object tier — workers need no
  shared working directory beyond that store root), and the heartbeat
  interval. Everything a worker needs to serve leases rides this one
  frame, so remote hosts join a fleet knowing only an address;
* ``reject`` — a protocol-version mismatch is refused at the handshake,
  before any lease could cross a wire the two sides parse differently.

**Reconnect-with-backoff.** A worker that loses its TCP connection keeps
its execution context (workflow, store mount, plan caches, task cache) and
re-dials with exponential backoff, re-registering under the SAME worker
id. Its in-flight leases were abandoned with the connection: the leader
marks the id dead on the broken socket and keeps reporting the orphaned
lease ids through ``heartbeat_view`` (as a tombstone row once the id
re-registers), so the Manager's existing dead-worker expiry re-enqueues
them — the recovery path is byte-for-byte the SIGKILL path, which is the
point: a network partition and a dead host are indistinguishable to the
scheduler, and both already work.

**Worker entrypoint.** ``python -m repro_torch.runtime.net worker --connect
HOST:PORT [--build module:callable]`` joins any listening leader from any
host; ``--build repro_torch.app.pipeline:pathology_rpc_build`` (its
keyword arguments as a JSON object in ``--kwargs``) gives a worker the
pathology study. The
leader's default mode spawns its workers locally as processes that connect
back over loopback TCP — the same code path end to end, which is what the
conformance suite (``tests/test_torch_net.py``) pins down.
"""

from __future__ import annotations

import os
import queue
import select
import socket
import struct
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.runtime.transport import (
    Completion,
    Lease,
    TransportError,
    WorkerStatus,
    _recv_frame,
    _RpcWorker,
    _send_frame,
    stop_processes,
    worker_context,
)

__all__ = [
    "PROTOCOL_VERSION",
    "SocketBackend",
    "SocketConn",
    "parse_address",
    "run_worker",
    "socket_flag_kwargs",
]

PROTOCOL_VERSION = 1

_FRAME_HEADER = struct.Struct("<Q")
_MAX_FRAME = 1 << 32  # sanity bound: a torn/foreign header must not OOM us
_HANDSHAKE_TIMEOUT = 10.0


def parse_address(addr: str) -> Tuple[str, int]:
    """``"host:port"`` → ``(host, port)`` (the only address syntax the
    control plane speaks; port 0 asks the OS for an ephemeral one)."""
    host, sep, port = addr.rpartition(":")
    if not sep or not host:
        raise ValueError(f"address must be 'host:port', got {addr!r}")
    return host, int(port)


class SocketConn:
    """A TCP socket behind the ``multiprocessing.Connection`` surface the
    frame codec already drives (``send_bytes``/``recv_bytes``/``poll``/
    ``close``) — which is what lets :class:`~repro_torch.runtime.transport.
    _RpcWorker` serve leases over a socket UNCHANGED. ``recv_bytes``
    returns header+payload exactly as a pipe delivery would, so
    ``_recv_frame``'s torn-frame validation applies to both transports."""

    def __init__(self, sock: socket.socket) -> None:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.settimeout(None)  # blocking; poll() provides the timeouts
        self._sock = sock

    def fileno(self) -> int:
        return self._sock.fileno()

    def _recv_exact(self, n: int) -> bytes:
        chunks: List[bytes] = []
        got = 0
        while got < n:
            chunk = self._sock.recv(n - got)
            if not chunk:
                raise EOFError("peer closed the connection")
            chunks.append(chunk)
            got += len(chunk)
        return b"".join(chunks)

    def recv_bytes(self) -> bytes:
        header = self._recv_exact(_FRAME_HEADER.size)
        (length,) = _FRAME_HEADER.unpack(header)
        if length > _MAX_FRAME:
            raise TransportError(f"frame length {length} over the wire bound")
        return header + self._recv_exact(length)

    def send_bytes(self, frame: bytes) -> None:
        self._sock.sendall(frame)

    def poll(self, timeout: float = 0.0) -> bool:
        try:
            ready, _, _ = select.select([self._sock], [], [], max(0.0, timeout))
        except (OSError, ValueError):
            raise EOFError("connection closed while polling")
        return bool(ready)

    def close(self) -> None:
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# Spec grammar: "socket[host:port,flags...]"
# ---------------------------------------------------------------------------

_SOCKET_FLAG_NAMES = {
    "batch": "batch_frames",
    "warm": "warm_plans",
    "async": "async_commit",
}
_SOCKET_TUNABLES = {
    "max_batch": int,
    "max_delay_ms": float,
    "register_timeout": float,
    "store": str,
}


def socket_flag_kwargs(spec: str) -> Dict[str, Any]:
    """Parse a ``"socket[...]"`` backend spec into :class:`SocketBackend`
    keyword arguments — the same grammar as ``process_flag_kwargs`` plus an
    address. The first bare ``host:port`` token is the bind address; flag
    tokens toggle the §14 mechanisms that survive sockets (``batch`` /
    ``warm`` / ``async``; ``shm`` is rejected — shared memory does not
    cross hosts); ``external`` switches off local worker spawning (workers
    join by dialing the address, ``start(n)`` blocks until n registered);
    ``key=value`` sets a tunable (``max_batch``, ``max_delay_ms``,
    ``register_timeout``, ``store=<spec>``). Examples::

        "socket"                          -> loopback, spawn local workers
        "socket[127.0.0.1:7077]"          -> bind a fixed port
        "socket[0.0.0.0:7077,external]"   -> listen for remote workers
        "socket[store=obj:/data/sa]"      -> fleet over the object tier
    """
    spec = spec.strip()
    if not spec.startswith("socket"):
        raise ValueError(f"not a socket backend spec: {spec!r}")
    rest = spec[len("socket"):]
    if not rest:
        return {}
    if not (rest.startswith("[") and rest.endswith("]")):
        raise ValueError(f"malformed socket backend spec: {spec!r}")
    kwargs: Dict[str, Any] = {}
    for token in rest[1:-1].split(","):
        token = token.strip()
        if not token:
            continue
        if "=" in token:
            k, v = (s.strip() for s in token.split("=", 1))
            if k not in _SOCKET_TUNABLES:
                raise ValueError(f"unknown socket backend tunable {k!r}")
            kwargs[k] = _SOCKET_TUNABLES[k](v)
            continue
        if ":" in token:
            kwargs["bind"] = token
            continue
        enable = not token.startswith("-")
        name = token.lstrip("+-")
        if name == "external":
            kwargs["spawn_workers"] = not enable
        elif name == "all" or name == "none":
            on = (name == "all") == enable
            for attr in _SOCKET_FLAG_NAMES.values():
                kwargs[attr] = on
        elif name in _SOCKET_FLAG_NAMES:
            kwargs[_SOCKET_FLAG_NAMES[name]] = enable
        elif name == "shm":
            raise ValueError(
                "shm is not a socket backend flag: shared-memory handoff "
                "does not cross hosts"
            )
        else:
            raise ValueError(f"unknown socket backend flag {name!r}")
    return kwargs


# ---------------------------------------------------------------------------
# Worker side: dial, register, serve, reconnect
# ---------------------------------------------------------------------------


def _backoff_delays(base: float, cap: float):
    delay = base
    while True:
        yield delay
        delay = min(cap, delay * 2)


def run_worker(
    address: str,
    *,
    build: Optional[Callable[..., Dict[str, Any]]] = None,
    build_kwargs: Optional[Dict[str, Any]] = None,
    worker_id: Optional[int] = None,
    store: Optional[str] = None,
    store_ram_bytes: int = 256 << 20,
    cache_bytes: Optional[int] = None,
    max_dial_failures: int = 30,
    backoff: float = 0.2,
    backoff_max: float = 5.0,
) -> int:
    """One socket worker's whole life: dial the leader, register (under
    ``worker_id`` when reconnecting), build the execution context ONCE,
    then serve lease frames until a clean ``stop``. A lost connection
    triggers reconnect-with-backoff under the same assigned id — the
    context (workflow, store mount, plan caches, task cache) survives the
    reconnect; only the in-flight leases are abandoned, and those the
    leader re-enqueues through the heartbeat path. Returns the worker id
    it served under (useful to callers persisting identity across runs).

    ``store`` overrides the welcome frame's store spec (operators mounting
    the object root at a host-specific path); by default the worker mounts
    exactly what the leader names.
    """
    from repro_torch.engine.types import DEFAULT_CACHE_BYTES

    # frame-consumer: welcome,reject via reply
    host, port = parse_address(address)
    wid = worker_id
    ctx: Optional[_RpcWorker] = None
    delays = _backoff_delays(backoff, backoff_max)
    dial_failures = 0
    while True:
        try:
            sock = socket.create_connection((host, port), timeout=_HANDSHAKE_TIMEOUT)
        except OSError:
            dial_failures += 1
            if dial_failures >= max_dial_failures:
                raise TransportError(
                    f"leader at {address} unreachable after "
                    f"{dial_failures} attempts"
                )
            time.sleep(next(delays))
            continue
        conn = SocketConn(sock)
        lock = threading.Lock()
        try:
            _send_frame(conn, lock, {
                "t": "register",
                "proto": PROTOCOL_VERSION,
                "wid": wid,
                "pid": os.getpid(),
                "caps": {"specs": True, "batch": True, "reconnect": True},
            })
            if not conn.poll(_HANDSHAKE_TIMEOUT):
                raise EOFError("handshake timed out")
            reply = _recv_frame(conn)
        except (EOFError, OSError):
            conn.close()
            time.sleep(next(delays))
            continue
        if reply.get("t") == "reject":
            conn.close()
            raise TransportError(
                f"leader rejected registration: {reply.get('reason')!r}"
            )
        if reply.get("t") != "welcome":
            conn.close()
            time.sleep(next(delays))
            continue
        wid = int(reply["wid"])
        worker = _RpcWorker(
            conn,
            wid,
            reply["session"],
            build if ctx is None else None,  # build exactly once
            build_kwargs,
            store or reply["store"],
            int(reply.get("store_ram_bytes", store_ram_bytes)),
            int(reply.get("cache_bytes", cache_bytes or DEFAULT_CACHE_BYTES)),
            float(reply.get("hb", 0.25)),
            reply.get("options"),
        )
        if ctx is not None:
            # reconnect: transplant the built context — workflow, inputs,
            # store mount (its RAM tier still holds upstream results),
            # task cache, plan caches, counters — into the new connection's
            # serving loop; only the wire is new
            worker.workflow = ctx.workflow
            worker.inputs = ctx.inputs
            worker.ctx_stats = ctx.ctx_stats
            worker.store = ctx.store
            worker.cache = ctx.cache
            worker.ctx_error = ctx.ctx_error
            worker._plan_meta = ctx._plan_meta
            worker._plan_cache = ctx._plan_cache
            worker.counters = ctx.counters
            worker.counters["reconnects"] = worker.counters.get("reconnects", 0) + 1
        ctx = worker
        delays = _backoff_delays(backoff, backoff_max)  # connected: reset
        dial_failures = 0
        worker.serve()  # until stop frame or connection loss
        if worker._stop:
            return wid  # clean retirement
        time.sleep(next(delays))


def _socket_worker_main(
    address: str,
    build: Optional[Callable[..., Dict[str, Any]]],
    build_kwargs: Optional[Dict[str, Any]],
    store_ram_bytes: int,
    cache_bytes: Optional[int],
) -> None:
    """Spawn entrypoint for the leader's local (loopback-TCP) workers."""
    try:
        run_worker(
            address,
            build=build,
            build_kwargs=build_kwargs,
            store_ram_bytes=store_ram_bytes,
            cache_bytes=cache_bytes,
        )
    except TransportError:
        pass  # leader gone / rejected: the process just retires


# ---------------------------------------------------------------------------
# Leader side: SocketBackend
# ---------------------------------------------------------------------------


class _SocketHandle:
    __slots__ = (
        "wid", "conn", "send_lock", "alive", "last_seen", "inflight",
        "pid", "caps", "generation", "proc",
    )

    def __init__(self, wid: int) -> None:
        self.wid = wid
        self.conn: Optional[SocketConn] = None
        self.send_lock = threading.Lock()
        self.alive = False
        self.last_seen = time.monotonic()
        self.inflight: Dict[str, Lease] = {}
        self.pid: Optional[int] = None
        self.caps: Dict[str, Any] = {}
        self.generation = 0
        self.proc = None  # spawn mode only; remote workers have no proc


class SocketBackend:
    """Spec-capable :class:`WorkerBackend` over a TCP control plane — the
    multi-host counterpart of :class:`ProcessRpcBackend` (same frames, same
    store-key result discipline, same §14 fast paths minus shared memory,
    which cannot cross hosts).

    The leader listens on ``bind`` (``host:port``; port 0 → ephemeral, the
    bound address is ``self.address``). Two membership modes:

    * **spawn mode** (default): ``start(n)`` launches n local worker
      processes that connect back over loopback TCP — same wire end to
      end, zero deployment ceremony; the conformance suite runs here;
    * **external mode** (``spawn_workers=False``, spec flag ``external``):
      ``start(n)`` only listens, blocking until n remote workers have
      dialed in (``python -m repro_torch.runtime.net worker --connect ...``).
      Workers may keep joining after start — a late registration is
      welcomed, receives every installed study, and starts taking leases.

    Worker ids are leader-assigned at registration and sticky: a
    reconnecting worker presents its id and resumes under it. The broken
    connection's in-flight leases are surfaced to the Manager as a DEAD
    tombstone row in ``heartbeat_view`` until their re-enqueue is observed
    — never attributed to the live, reconnected row, so the prove-liveness
    heartbeat policy can't accidentally shelter abandoned work.
    """

    name = "socket"
    supports_specs = True
    heartbeats_prove_liveness = True

    def __init__(
        self,
        bind: str = "127.0.0.1:0",
        *,
        build: Optional[Callable[..., Dict[str, Any]]] = None,
        build_kwargs: Optional[Dict[str, Any]] = None,
        store: Optional[str] = None,
        store_ram_bytes: int = 256 << 20,
        cache_bytes: Optional[int] = None,
        spawn_workers: bool = True,
        mp_context: str = "spawn",
        heartbeat_interval: float = 0.25,
        batch_frames: bool = True,
        warm_plans: bool = True,
        async_commit: bool = True,
        max_batch: int = 16,
        max_delay_ms: float = 2.0,
        register_timeout: float = 60.0,
        shutdown_grace: float = 5.0,
    ) -> None:
        from repro_torch.engine.types import DEFAULT_CACHE_BYTES

        self.bind = bind
        self.build = build
        self.build_kwargs = dict(build_kwargs or {})
        self._owns_store_dir = store is None
        if store is None:
            import tempfile

            store = tempfile.mkdtemp(prefix="rtf_sock_")
        self.store_spec = store
        self.store_ram_bytes = int(store_ram_bytes)
        self.cache_bytes = int(cache_bytes or DEFAULT_CACHE_BYTES)
        self.spawn_workers = bool(spawn_workers)
        self.mp_context = mp_context
        self.heartbeat_interval = float(heartbeat_interval)
        self.batch_frames = bool(batch_frames)
        self.warm_plans = bool(warm_plans)
        self.async_commit = bool(async_commit)
        self.max_batch = max(1, int(max_batch))
        self.max_delay_ms = float(max_delay_ms)
        self.register_timeout = float(register_timeout)
        self.shutdown_grace = float(shutdown_grace)
        self.address: Optional[str] = None  # bound host:port after start()
        self._listener: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        # _handles/_tombstones and every per-handle inflight map are guarded
        # by _lock: reader threads (handshake, death/tombstoning) and the
        # pump (offers, hydration) race over them.
        self._handles: Dict[int, _SocketHandle] = {}  # guard: _lock
        self._tombstones: "Dict[int, Tuple[float, Tuple[str, ...]]]" = {}  # guard: _lock
        self._next_wid = 0  # guard: _lock
        self._next_tomb = -1  # guard: _lock
        self._studies: List[Dict[str, Any]] = []  # guard: _lock
        self._store = None
        self._flusher = None
        self._rx: "queue.Queue[Tuple[_SocketHandle, Dict[str, Any]]]" = queue.Queue()
        self._lock = threading.Lock()
        self._registered = threading.Condition(self._lock)
        self._closing = False  # guard: _lock
        self._session = ""
        self._procs: List[Any] = []
        self._worker_stats: Dict[int, Dict[str, Any]] = {}  # guard: _lock
        self._counters: Dict[str, int] = {  # guard: _lock
            "lease_frames": 0,
            "lease_batches": 0,
            "comp_batches": 0,
            "fetch_serves": 0,
            "registrations": 0,
            "reconnects": 0,
            "rejects": 0,
            "disconnects": 0,
        }

    # -- leader-side store mount ----------------------------------------
    @property
    def store(self):
        if self._store is None:
            from repro_torch.runtime.storage import mount_store

            self._store = mount_store(
                self.store_spec, self.store_ram_bytes, writer_id="sock-leader"
            )
        return self._store

    @property
    def slots_per_worker(self) -> int:
        return self.max_batch if self.batch_frames else 1

    def worker_pids(self) -> List[Optional[int]]:
        with self._lock:
            return [h.pid for h in self._handles.values()]

    def _options(self) -> Dict[str, Any]:
        return {
            "batch": self.batch_frames,
            "warm": self.warm_plans,
            "shm": False,  # shared memory does not cross hosts
            "async": self.async_commit,
            "max_batch": self.max_batch,
            "max_delay_ms": self.max_delay_ms,
        }

    # -- WorkerBackend protocol -----------------------------------------
    def start(self, n_workers: int) -> None:
        if self._listener is not None:
            raise RuntimeError("SocketBackend already started")
        import uuid

        mp = worker_context(self.mp_context) if self.spawn_workers else None

        n = max(1, n_workers)
        self._session = uuid.uuid4().hex[:12]
        # init-phase reset: the accept thread (and so every reader) starts
        # a few lines below; no concurrent access is possible yet
        self._closing = False  # analysis: ok[locks] init phase
        self._worker_stats = {}  # analysis: ok[locks] init phase
        self._handles = {}  # analysis: ok[locks] init phase
        self._tombstones = {}  # analysis: ok[locks] init phase
        self._next_wid = 0  # analysis: ok[locks] init phase
        self._rx = queue.Queue()
        if self.async_commit:
            from repro_torch.runtime.storage import AsyncCommitQueue

            self._flusher = AsyncCommitQueue(self.store)
        host, port = parse_address(self.bind)
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        listener.bind((host, port))
        listener.listen(128)
        self._listener = listener
        self.address = f"{host}:{listener.getsockname()[1]}"
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="rtf-sock-accept", daemon=True
        )
        self._accept_thread.start()
        if mp is not None:
            self._procs = []
            for _ in range(n):
                proc = mp.Process(
                    target=_socket_worker_main,
                    args=(
                        self.address, self.build, self.build_kwargs,
                        self.store_ram_bytes, self.cache_bytes,
                    ),
                    daemon=True,
                )
                proc.start()
                self._procs.append(proc)
        else:
            self._procs = []
        deadline = time.monotonic() + self.register_timeout
        with self._registered:
            while len(self._handles) < n:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TransportError(
                        f"only {len(self._handles)}/{n} workers registered "
                        f"within {self.register_timeout:.0f}s at {self.address}"
                    )
                self._registered.wait(min(left, 0.2))
        if self.spawn_workers:
            # attribute spawned procs to their registered handles (by pid)
            # so shutdown can escalate on exactly the right process
            with self._lock:
                by_pid = {p.pid: p for p in self._procs}
                for h in self._handles.values():
                    h.proc = by_pid.get(h.pid)

    # -- accept / handshake ----------------------------------------------
    def _accept_loop(self) -> None:
        # analysis: ok[locks] lock-free poll of the shutdown flag: a stale
        # read costs one extra accept() round, and closing the listener
        # unblocks accept() with OSError anyway
        while not self._closing:
            try:
                sock, _peer = self._listener.accept()
            except OSError:
                return  # listener closed: shutdown
            threading.Thread(
                target=self._handshake, args=(sock,), daemon=True
            ).start()

    def _handshake(self, sock: socket.socket) -> None:
        # frame-consumer: register via msg
        conn = SocketConn(sock)
        try:
            if not conn.poll(_HANDSHAKE_TIMEOUT):
                conn.close()
                return
            msg = _recv_frame(conn)
        except (EOFError, OSError, TransportError):
            conn.close()
            return
        if msg.get("t") != "register":
            conn.close()
            return
        if msg.get("proto") != PROTOCOL_VERSION:
            # version skew is refused BEFORE any lease can cross a wire the
            # two sides would parse differently
            with self._lock:
                self._counters["rejects"] += 1
            try:
                _send_frame(conn, threading.Lock(), {
                    "t": "reject",
                    "proto": PROTOCOL_VERSION,
                    "reason": (
                        f"protocol version mismatch: leader speaks "
                        f"{PROTOCOL_VERSION}, worker sent {msg.get('proto')!r}"
                    ),
                })
            except (OSError, ValueError, BrokenPipeError):
                pass
            conn.close()
            return
        requested = msg.get("wid")
        with self._registered:
            if self._closing:
                conn.close()
                return
            if isinstance(requested, int) and requested in self._handles:
                h = self._handles[requested]  # reconnect under the same id
                if h.conn is not None:
                    try:
                        h.conn.close()
                    except OSError:
                        pass
                self._tombstone_locked(h)
                self._counters["reconnects"] += 1
            else:
                h = _SocketHandle(self._next_wid)
                self._next_wid += 1
                self._handles[h.wid] = h
            h.conn = conn
            h.alive = True
            h.generation += 1
            h.last_seen = time.monotonic()
            h.pid = msg.get("pid")
            h.caps = dict(msg.get("caps") or {})
            generation = h.generation
            self._counters["registrations"] += 1
            studies = list(self._studies)
            self._registered.notify_all()
        try:
            _send_frame(conn, h.send_lock, {
                "t": "welcome",
                "proto": PROTOCOL_VERSION,
                "wid": h.wid,
                "session": self._session,
                "store": self.store_spec,
                "store_ram_bytes": self.store_ram_bytes,
                "cache_bytes": self.cache_bytes,
                "hb": self.heartbeat_interval,
                "options": self._options(),
            })
            # replay installed studies so a late joiner / reconnector can
            # serve any lease the Manager re-drives at it
            for study in studies:
                _send_frame(conn, h.send_lock, {"t": "study", **study})
        except (OSError, ValueError, BrokenPipeError):
            self._mark_dead(h, generation)
            return
        threading.Thread(
            target=self._reader_loop, args=(h, conn, generation),
            name=f"rtf-sock-r{h.wid}", daemon=True,
        ).start()

    def _tombstone_locked(self, h: _SocketHandle) -> None:
        """Park a broken connection's in-flight lease ids on a synthetic
        dead worker row (caller holds the lock). ``heartbeat_view`` reports
        tombstones as dead workers holding those leases, which is exactly
        the shape the Manager's dead-worker expiry already consumes — and
        because the row is never the reconnected (live) id, fresh
        heartbeats can't shelter the abandoned leases from re-enqueue."""
        if h.inflight:
            self._tombstones[self._next_tomb] = (
                time.monotonic(), tuple(h.inflight)
            )
            self._next_tomb -= 1
            h.inflight = {}
        while len(self._tombstones) > 64:  # drop the oldest; long observed
            oldest = min(self._tombstones, key=lambda k: self._tombstones[k][0])
            del self._tombstones[oldest]

    def _mark_dead(self, h: _SocketHandle, generation: int) -> None:
        with self._lock:
            if h.generation != generation:
                return  # a reconnect already superseded this connection
            if h.alive:
                h.alive = False
                self._counters["disconnects"] += 1
            self._tombstone_locked(h)
        if h.conn is not None:
            try:
                h.conn.close()
            except OSError:
                pass

    # -- per-connection reader -------------------------------------------
    def _reader_loop(self, h: _SocketHandle, conn: SocketConn, generation: int) -> None:
        try:
            while True:
                msg = _recv_frame(conn)
                h.last_seen = time.monotonic()
                kind = msg.get("t")
                if kind == "hb":
                    stats = msg.get("stats")
                    if stats:
                        with self._lock:
                            self._worker_stats[h.wid] = stats
                elif kind == "fetch":
                    self._serve_fetch(h, msg["key"])
                elif kind == "hello":
                    h.pid = msg.get("pid")
                else:
                    self._rx.put((h, msg))
        except (EOFError, OSError, TransportError):
            self._mark_dead(h, generation)

    def _serve_fetch(self, h: _SocketHandle, key: str) -> None:
        value = self._flusher.peek(key) if self._flusher is not None else None
        if value is None:
            value = self.store.get(key)
        with self._lock:
            self._counters["fetch_serves"] += 1
        try:
            _send_frame(h.conn, h.send_lock, {
                "t": "fetched", "key": key, "found": value is not None,
                "value": value,
            })
        except (OSError, ValueError, BrokenPipeError):
            pass  # the reader thread will observe the death

    # -- study broadcast --------------------------------------------------
    def install_study(self, **study: Any) -> None:
        with self._lock:
            self._studies.append(dict(study))
            if len(self._studies) > 8:
                self._studies = self._studies[-8:]
            targets = [h for h in self._handles.values() if h.alive]
        msg = {"t": "study", **study}
        for h in targets:
            try:
                _send_frame(h.conn, h.send_lock, msg)
            except (OSError, ValueError, BrokenPipeError):
                pass  # reader marks it dead; reconnect replays the study

    # -- dispatch ----------------------------------------------------------
    def offer(self, lease: Lease) -> bool:
        return not self.offer_batch([lease])

    def offer_batch(self, leases: List[Lease], worker_ids=None) -> List[Lease]:
        for lease in leases:
            if lease.spec is None:
                raise TransportError(
                    f"lease {lease.key!r} has no picklable spec: the socket "
                    "backend cannot ship closures across hosts"
                )
        slots = self.slots_per_worker
        # capacity math runs under the lock (reader threads tombstone and
        # reset inflight maps concurrently); the sends must NOT — they are
        # socket I/O serialized only by each handle's send_lock
        with self._lock:
            ws = [
                h for h in self._handles.values()
                if h.alive and len(h.inflight) < slots
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
                        h.conn, h.send_lock,
                        {"t": "lease_batch",
                         "leases": [
                             {"key": l.key, "attempt": l.attempt, "spec": l.spec}
                             for l in batch
                         ]},
                    )
                else:
                    for l in batch:
                        _send_frame(
                            h.conn, h.send_lock,
                            {"t": "lease", "key": l.key, "attempt": l.attempt,
                             "spec": l.spec},
                        )
            except (OSError, ValueError, BrokenPipeError):
                rejected.extend(batch)
                continue
            with self._lock:
                self._counters["lease_frames"] += frames
                if self.batch_frames and len(batch) > 1:
                    self._counters["lease_batches"] += 1
                if not h.alive:
                    # the worker died mid-send: its reader thread already
                    # tombstoned (and may have reset) h.inflight — recording
                    # these leases now would strand them invisibly, outside
                    # both the tombstone row and the live handle's view
                    rejected.extend(batch)
                    continue
                for l in batch:
                    h.inflight[l.lease_id] = l
        return rejected

    def offer_to(self, lease: Lease, worker_id: int) -> bool:
        return not self.offer_batch([lease], worker_ids={worker_id})

    # -- completion intake -------------------------------------------------
    def poll_completions(self, timeout: float) -> List[Completion]:
        out: List[Completion] = []
        try:
            h, msg = self._rx.get(timeout=max(0.0, timeout))
        except queue.Empty:
            return out
        while True:
            kind = msg.get("t")
            if kind == "comp":
                out.append(self._hydrate(h, msg))
            elif kind == "comp_batch":
                with self._lock:
                    self._counters["comp_batches"] += 1
                for m in msg["comps"]:
                    out.append(self._hydrate(h, m))
            try:
                h, msg = self._rx.get_nowait()
            except queue.Empty:
                return out

    def _hydrate(self, h: _SocketHandle, msg: Dict[str, Any]) -> Completion:
        """Wire completion → Manager completion: identical to the process
        backend's hydration minus the shared-memory route (results cross
        hosts as store keys, inline staged values, or explicit None)."""
        with self._lock:
            h.inflight.pop(f"{msg['key']}#{msg['attempt']}", None)
        if not msg.get("ok"):
            return Completion(
                key=msg["key"], attempt=msg["attempt"], ok=False,
                error=msg.get("error") or "remote task failed",
                worker_id=h.wid, duration=float(msg.get("duration", 0.0)),
            )
        if msg.get("none"):
            return Completion(
                key=msg["key"], attempt=msg["attempt"], ok=True, value=None,
                worker_id=h.wid, duration=float(msg.get("duration", 0.0)),
            )
        store_key = msg.get("store_key")
        if msg.get("inline"):
            value = msg["value"]
        else:
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
            self._flusher.stage(store_key, value)
        if msg.get("wrap") == "bucket":
            value = (value, int(msg["executed"]), int(msg["hits"]))
        return Completion(
            key=msg["key"], attempt=msg["attempt"], ok=True, value=value,
            store_key=store_key, worker_id=h.wid,
            duration=float(msg.get("duration", 0.0)),
        )

    # -- liveness ----------------------------------------------------------
    def heartbeat_view(self) -> Dict[int, WorkerStatus]:
        view: Dict[int, WorkerStatus] = {}
        with self._lock:
            for h in self._handles.values():
                view[h.wid] = WorkerStatus(
                    alive=h.alive, last_seen=h.last_seen,
                    inflight=tuple(h.inflight),
                )
            for tid, (t_dead, leases) in self._tombstones.items():
                view[tid] = WorkerStatus(
                    alive=False, last_seen=t_dead, inflight=leases
                )
        return view

    def barrier(self, timeout: Optional[float] = None) -> bool:
        if self._flusher is None:
            return True
        return self._flusher.barrier(timeout)

    def stats(self) -> Dict[str, Any]:
        from repro_torch.runtime.transport import _merge_int_tree

        with self._lock:
            per_worker = [dict(s) for s in self._worker_stats.values()]
            n_workers = len(self._handles)
            leader = dict(self._counters)
        worker_agg: Dict[str, Any] = {}
        for stats in per_worker:
            _merge_int_tree(worker_agg, stats)
        out: Dict[str, Any] = {
            "backend": self.name,
            "address": self.address,
            "workers": n_workers,
            "flags": {
                "batch_frames": self.batch_frames,
                "warm_plans": self.warm_plans,
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

    # -- fault-injection / ops hooks ---------------------------------------
    def disconnect(self, worker_id: int) -> bool:
        """Force-close a worker's connection WITHOUT stopping its process —
        a modelled network partition (test/ops hook). The worker observes
        EOF and re-dials with backoff under its id; its in-flight leases
        ride a tombstone row into the Manager's re-enqueue path."""
        with self._lock:
            h = self._handles.get(worker_id)
            if h is None or h.conn is None:
                return False
            conn, generation = h.conn, h.generation
        conn.close()  # the reader thread unblocks and marks it dead
        self._mark_dead(h, generation)
        return True

    # -- teardown ----------------------------------------------------------
    def shutdown(self) -> None:
        """Retire the fleet: bounded staging flush, ``stop`` frames to
        every live worker, close the listener (no new registrations), stop
        spawned local processes with the bounded terminate→kill escalation,
        then purge this session's transient store entries. Remote workers
        that miss the stop frame observe the closed socket and — finding
        the leader gone for good — exhaust their dial retries and retire."""
        if self._flusher is not None:
            try:
                self._flusher.close(flush=True, timeout=self.shutdown_grace * 2)
            except BaseException:  # noqa: BLE001
                pass
            self._flusher = None
        with self._lock:
            self._closing = True
            handles = list(self._handles.values())
        for h in handles:
            if h.alive and h.conn is not None:
                try:
                    _send_frame(h.conn, h.send_lock, {"t": "stop"})
                except (OSError, ValueError, BrokenPipeError):
                    pass
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
            self._listener = None
        # within the same grace: let each reader thread take its worker's
        # last heartbeat (its final counters) and see it hang up
        deadline = time.monotonic() + self.shutdown_grace
        while time.monotonic() < deadline:
            with self._lock:
                if not any(h.alive for h in handles):
                    break
            time.sleep(0.01)
        stop_processes(self._procs, grace=max(0.0, deadline - time.monotonic()))
        self._procs = []
        for h in handles:
            if h.conn is not None:
                try:
                    h.conn.close()
                except OSError:
                    pass
        with self._lock:
            self._handles = {}
            self._tombstones = {}
        self.address = None
        self._purge_session_entries()

    def _purge_session_entries(self) -> None:
        if not self._session:
            return
        prefix = f"rpc:{self._session}:"
        try:
            for key in self.store.committed_keys():
                if key.startswith(prefix):
                    self.store.delete(key)
        except OSError:  # pragma: no cover - purge is best-effort
            pass

    def cleanup(self) -> None:
        """Drop the backend-owned throwaway store (tempdir mode only; a
        caller-named store spec is the caller's reuse pool)."""
        with self._lock:
            has_handles = bool(self._handles)
        if not self._owns_store_dir or has_handles:
            return
        import shutil

        self._store = None
        shutil.rmtree(self.store_spec, ignore_errors=True)


# ---------------------------------------------------------------------------
# CLI: `python -m repro_torch.runtime.net worker --connect HOST:PORT`
# ---------------------------------------------------------------------------


def _resolve_build(spec: Optional[str]) -> Optional[Callable[..., Dict[str, Any]]]:
    """``"module:callable"`` → the callable (the worker's execution-context
    factory; must be importable on the worker host)."""
    if spec is None:
        return None
    mod_name, sep, attr = spec.partition(":")
    if not sep or not attr:
        raise ValueError(f"--build must be 'module:callable', got {spec!r}")
    import importlib

    obj = importlib.import_module(mod_name)
    for part in attr.split("."):
        obj = getattr(obj, part)
    if not callable(obj):
        raise ValueError(f"{spec!r} does not name a callable")
    return obj


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(
        prog="repro_torch.runtime.net",
        description="Socket-fleet tools (DESIGN.md §16)",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    w = sub.add_parser("worker", help="join a listening leader by address")
    w.add_argument("--connect", required=True, metavar="HOST:PORT",
                   help="the leader's control-plane address")
    w.add_argument("--build", default=None, metavar="MODULE:CALLABLE",
                   help="execution-context factory (importable here); "
                        "omit for fleets serving only portable call specs")
    w.add_argument("--kwargs", default=None, metavar="JSON",
                   help="JSON object of keyword arguments for --build")
    w.add_argument("--id", type=int, default=None,
                   help="re-register under a previously assigned worker id")
    w.add_argument("--store", default=None,
                   help="override the welcome frame's store spec (plain "
                        "directory or obj:<root>) for host-specific mounts")
    w.add_argument("--ram-bytes", type=int, default=256 << 20)
    w.add_argument("--cache-bytes", type=int, default=None)
    args = ap.parse_args(argv)
    if args.cmd == "worker":
        build_kwargs = json.loads(args.kwargs) if args.kwargs else None
        try:
            wid = run_worker(
                args.connect,
                build=_resolve_build(args.build),
                build_kwargs=build_kwargs,
                worker_id=args.id,
                store=args.store,
                store_ram_bytes=args.ram_bytes,
                cache_bytes=args.cache_bytes,
            )
        except TransportError as e:
            print(f"worker retired: {e}")
            return 1
        except KeyboardInterrupt:
            return 130
        print(f"worker {wid} retired cleanly")
        return 0
    return 2  # pragma: no cover - argparse enforces the subcommand


if __name__ == "__main__":
    raise SystemExit(main())
