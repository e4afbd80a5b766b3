"""Hierarchical storage for inter-stage data objects (paper §II: RAM and
disk tiers managed by the runtime; stages communicate by reading/writing
data objects rather than messaging).

The RAM tier is capacity-bounded; overflowing objects spill to the disk tier
(npz files). Disk filenames are **content-addressed** — the sha256 of the
(deterministically serialised) key — so a store re-opened on the same
directory by a *different process* resolves the same keys to the same files
(Python's built-in ``hash`` is salted per process and is useless here).
This is what lets a resumed SA study (``repro_torch.study.StudyState``) rehydrate
prior-round results instead of recomputing them.

Crash safety (DESIGN.md §12): every disk write goes to a ``.tmp`` sibling,
is fsynced, and lands via ``os.replace`` — a killed writer can leave only
an orphaned ``.tmp``, never a truncated entry under the final name. Each
entry additionally carries a fixed-size footer (magic + payload length +
sha256) verified on load; an entry failing verification — however it got
there — is *quarantined* (moved aside), counted on the ``corrupt`` counter
and reported as a miss, so a poisoned directory self-heals by recomputing.

:class:`SharedStore` layers cross-process coordination on top: a per-key
advisory file lock (``fcntl.flock``) so N writers over one directory never
double-write an entry, and an append-only last-writer-wins manifest
(``manifest.jsonl``) recording every committed key for audit/accounting —
the fleet runner (``repro_torch.study.run_fleet_study``) mounts one SharedStore
per process; each round's delta plans against the union of every worker's
TrieLedger entries, and the store serves the corresponding outputs.

The RMSR schedule exists precisely to keep the working set inside the RAM
tier — the paper notes that spilling every task output of a fine-grain stage
costs more than recomputing (§III), which is why memory-bounded scheduling
beats a disk cache for *intra-round* traffic; the disk tier earns its keep
across rounds and process restarts, where recomputation would repeat whole
stages.
"""

from __future__ import annotations

import collections
import contextlib
import hashlib
import io
import json
import os
import pathlib
import pickle
import struct
import tempfile
import threading
import time
from typing import Any, Callable, Dict, Iterator, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.runtime.tensors import tensor_from_host, tensor_to_host

try:  # advisory file locks are POSIX-only; SharedStore degrades gracefully
    import fcntl
except ImportError:  # pragma: no cover - non-POSIX
    fcntl = None  # type: ignore[assignment]

__all__ = [
    "AsyncCommitQueue",
    "HierarchicalStore",
    "SharedStore",
    "mount_store",
    "stable_key",
]

# Entry footer: | payload bytes | magic (8) | payload length (8, LE) |
# sha256(payload) (32) |. The payload is a complete npz archive; loads slice
# it back out, so nothing ever parses the footer as zip data.
_FOOTER_MAGIC = b"RTFSTRv1"
_FOOTER_SIZE = len(_FOOTER_MAGIC) + 8 + 32

_QUARANTINE_DIR = "quarantine"


def stable_key(key: Any) -> str:
    """Deterministic content address of a (possibly nested-tuple) key.

    ``repr`` of the canonical key types used by the engine cache — strings,
    ints, floats, bools and tuples thereof — is stable across processes,
    unlike ``hash``. sha256 keeps filenames short and collision-free.
    """
    return hashlib.sha256(repr(key).encode()).hexdigest()


def mount_store(
    spec: Optional[str],
    ram_bytes: int,
    *,
    writer_id: Optional[str] = None,
) -> "HierarchicalStore":
    """Resolve a store SPEC into a mounted cross-process store.

    ``None`` or a plain directory path mounts the flock-coordinated
    :class:`SharedStore` on that directory (the single-host default);
    ``"obj:<root>"`` mounts the object-store tier — an
    :class:`~repro_torch.runtime.objstore.ObjectBackedStore` over a
    :class:`~repro_torch.runtime.objstore.LocalFSObjectStore` rooted at
    ``<root>`` — which needs no shared filesystem semantics beyond the
    object API (DESIGN.md §16). The spec is a plain string, so it crosses
    spawn and TCP boundaries verbatim: RPC and socket workers mount
    exactly the tier the leader named. Every mounted store exposes the
    spec back as ``.disk_dir``, so a recorded mount re-resolves here.
    """
    if spec is not None and spec.startswith("obj:"):
        from repro_torch.runtime.objstore import LocalFSObjectStore, ObjectBackedStore

        root = spec[len("obj:"):]
        if not root:
            raise ValueError(f"object store spec names no root: {spec!r}")
        return ObjectBackedStore(
            ram_bytes,
            LocalFSObjectStore(root),
            spec=spec,
            writer_id=writer_id,
        )
    return SharedStore(ram_bytes, disk_dir=spec, writer_id=writer_id)


# npz entry naming the entries that were torch tensors: a JSON object of
# ``{entry: [dtype, device type]}`` as uint8 bytes
_TENSORS = "__torch_tensors__"


def _serialise(v: Any) -> bytes:
    """npz for array payloads (dicts of str→array, arrays); a pickle
    fallback — stored as a uint8 array under ``__pickled__`` so the entry
    stays a plain npz archive — for everything else. The fallback is what
    lets RPC worker results (arbitrary Python values, dicts keyed by int
    run_id) cross the store **bit-exactly**: coercing a Python int through
    ``np.asarray`` would silently wrap at 64 bits, which the conformance
    suite's collision-sensitive integer workloads would detect.

    A torch tensor, of any dtype and on any device, is stored from the host
    (bf16 as its 16-bit view) with its dtype and device type under
    ``__torch_tensors__``, and :func:`_deserialise` rebuilds it as a tensor
    on that device type."""
    def _is_array(x: Any) -> bool:
        # genuinely array-like only (ndarray / tensor / np scalar): coercing
        # a Python scalar through np.asarray would change its type (and wrap
        # a large int), breaking the bit-exact round-trip contract
        return isinstance(x, (np.ndarray, torch.Tensor)) or hasattr(x, "__array__")

    def _host(x: Any) -> Tuple[np.ndarray, Optional[Tuple[str, str]]]:
        if isinstance(x, torch.Tensor):
            arr, dtype, device = tensor_to_host(x)
            return arr, (dtype, device)
        return np.asarray(x), None

    buf = io.BytesIO()
    named = None
    if isinstance(v, dict) and v and all(isinstance(k, str) for k in v):
        if _TENSORS not in v and all(_is_array(vv) for vv in v.values()):
            named = v
    elif _is_array(v):
        named = {"__value__": v}
    if named is not None:
        try:
            host = {k: _host(x) for k, x in named.items()}
        except TypeError:  # a tensor dtype with no host form: pickle it
            host = None
        if host is not None and not any(a.dtype.hasobject for a, _ in host.values()):
            arrs = {k: a for k, (a, _) in host.items()}
            tags = {k: tag for k, (_, tag) in host.items() if tag is not None}
            if tags:
                arrs[_TENSORS] = np.frombuffer(json.dumps(tags).encode(), dtype=np.uint8)
            np.savez(buf, **arrs)
            return buf.getvalue()
    blob = pickle.dumps(v, protocol=pickle.HIGHEST_PROTOCOL)
    np.savez(buf, __pickled__=np.frombuffer(blob, dtype=np.uint8))
    return buf.getvalue()


def _deserialise(payload: bytes) -> Any:
    """The inverse of :func:`_serialise`. Raises on a payload that does
    not parse (the caller treats that as corruption)."""
    with np.load(io.BytesIO(payload)) as z:
        if "__pickled__" in z:
            return pickle.loads(z["__pickled__"].tobytes())
        tags = json.loads(z[_TENSORS].tobytes()) if _TENSORS in z.files else {}

        def get(k: str) -> Any:
            return tensor_from_host(z[k], *tags[k]) if k in tags else z[k]

        if "__value__" in z:
            return get("__value__")
        return {k: get(k) for k in z.files if k != _TENSORS}


def _pack_entry(payload: bytes) -> bytes:
    return (
        payload
        + _FOOTER_MAGIC
        + struct.pack("<Q", len(payload))
        + hashlib.sha256(payload).digest()
    )


def _has_footer_magic(data: bytes) -> bool:
    return (
        len(data) >= _FOOTER_SIZE
        and data[-_FOOTER_SIZE:][:8] == _FOOTER_MAGIC
    )


def _probe_footer(path: pathlib.Path) -> str:
    """Classify an on-disk entry by its footer WITHOUT reading the payload
    (the shared primitive under both the read-side ``contains`` probe and
    the write-side commit probe): ``"missing"`` (unreadable/absent),
    ``"short"`` (smaller than a footer — no real npz is), ``"legacy"``
    (no magic: a pre-footer entry, np.load is its verifier), ``"bad-length"``
    (magic present, recorded length disagrees with file size: torn), or
    ``"ok"`` (footer structurally valid; the digest is checked on load)."""
    try:
        size = path.stat().st_size
        if size < _FOOTER_SIZE:
            return "short"
        with open(path, "rb") as f:
            f.seek(size - _FOOTER_SIZE)
            footer = f.read(_FOOTER_SIZE)
    except OSError:
        return "missing"
    if footer[:8] != _FOOTER_MAGIC:
        return "legacy"
    (length,) = struct.unpack("<Q", footer[8:16])
    return "ok" if length + _FOOTER_SIZE == size else "bad-length"


def _footer_ok(data: bytes) -> Optional[bytes]:
    """Return the verified payload of a footered entry, or None if ``data``
    is not a well-formed (length- and digest-checked) entry."""
    if not _has_footer_magic(data):
        return None
    payload, footer = data[:-_FOOTER_SIZE], data[-_FOOTER_SIZE:]
    (length,) = struct.unpack("<Q", footer[8:16])
    if length != len(payload):
        return None
    if hashlib.sha256(payload).digest() != footer[16:]:
        return None
    return payload


class AsyncCommitQueue:
    """In-memory staging tier + background flusher in front of a store
    (DESIGN.md §14: the RPC backend's async commit fast path).

    ``stage(key, value)`` records the value in the staging dict and enqueues
    it; a daemon flusher thread drains the queue into the store through the
    existing crash-safe protocol (``put`` + ``persist`` — serialise → tmp
    sibling → fsync → atomic rename → footer-verified entry), then drops the
    staged copy. Between ``stage`` and the flush landing, ``peek`` serves
    the value from memory — the read-your-writes window the RPC leader uses
    to answer worker fetches for not-yet-durable upstream results.

    ``barrier()`` blocks until everything staged so far is durably
    committed (the ``drain()``/``StudyState.save`` durability call): after
    it returns, a store re-opened on the directory resolves every staged
    key. A flush failure is counted (``errors``) and the entry is dropped
    from staging so the barrier can never hang on a poisoned value —
    durability degrades to the lease-retry path (tasks are pure; a
    recompute republishes the same bytes).
    """

    def __init__(self, store: "HierarchicalStore"):
        self._store = store
        self._staged: Dict[str, Any] = {}  # guard: _lock
        self._queue: "collections.deque[str]" = collections.deque()  # guard: _lock
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._thread: Optional[threading.Thread] = None
        self._closed = False  # guard: _lock
        self.staged = 0  # guard: _lock
        self.committed = 0  # guard: _lock
        self.errors = 0  # guard: _lock
        self.staged_peak = 0  # guard: _lock

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._drain_loop, name="rtf-flusher", daemon=True
            )
            self._thread.start()

    def stage(self, key: str, value: Any) -> None:
        """Record ``value`` for durable commit; returns immediately."""
        with self._cond:
            if self._closed:
                raise RuntimeError("AsyncCommitQueue is closed")
            self._staged[key] = value
            self._queue.append(key)
            self.staged += 1
            self.staged_peak = max(self.staged_peak, len(self._staged))
            self._ensure_thread()
            self._cond.notify_all()

    def peek(self, key: str) -> Optional[Any]:
        """The staged-but-not-yet-durable value of ``key``, or None."""
        with self._lock:
            return self._staged.get(key)

    def pending(self) -> int:
        with self._lock:
            return len(self._staged)

    def _drain_loop(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait(0.1)
                if not self._queue:
                    return  # closed and drained
                key = self._queue.popleft()
                value = self._staged.get(key)
            if value is not None:
                try:
                    self._store.put(key, value)
                    self._store.persist(key)
                    with self._cond:
                        self.committed += 1
                except BaseException:  # noqa: BLE001 — see class docstring
                    with self._cond:
                        self.errors += 1
            # drop the staged copy only after the disk commit (peek must
            # keep serving the value until the store can)
            with self._cond:
                self._staged.pop(key, None)
                self._cond.notify_all()

    def barrier(self, timeout: Optional[float] = None) -> bool:
        """Block until every staged entry is durably committed (or
        dropped after a flush failure). Returns False on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            self._ensure_thread()
            while self._staged:
                if deadline is not None and time.monotonic() >= deadline:
                    return False
                self._cond.wait(0.05)
        return True

    def close(self, flush: bool = True, timeout: Optional[float] = None) -> None:
        """Retire the flusher; with ``flush`` (default) drains first.
        ``timeout`` bounds the drain — a flusher wedged inside a hung store
        write must not be able to hang a fleet teardown (the backend
        ``shutdown`` path passes one; the entries it abandons are staged
        pure values the lease-retry path can always recompute)."""
        if flush:
            self.barrier(timeout)
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=5.0)


class HierarchicalStore:
    """RAM tier (LRU, byte-bounded) over a content-addressed npz disk tier.

    ``hits`` counts RAM-tier hits, ``disk_hits`` disk-tier rehydrations,
    ``misses`` keys found in neither tier, ``spills`` RAM→disk evictions,
    ``corrupt`` disk entries that failed verification and were quarantined.
    """

    def __init__(self, ram_bytes: int = 1 << 30, disk_dir: Optional[str] = None):
        self.ram_bytes = ram_bytes
        self._ram: "collections.OrderedDict[str, Any]" = collections.OrderedDict()  # guard: _lock
        self._sizes: Dict[str, int] = {}  # guard: _lock
        self._used = 0  # guard: _lock
        self._disk = pathlib.Path(disk_dir or tempfile.mkdtemp(prefix="rtf_store_"))
        self._disk.mkdir(parents=True, exist_ok=True)
        self._lock = threading.Lock()
        self.spills = 0  # guard: _lock
        self.hits = 0  # guard: _lock
        self.disk_hits = 0  # guard: _lock
        self.misses = 0  # guard: _lock
        self.corrupt = 0  # guard: _lock
        # Test/fault-injection hook: called with the tmp path after the tmp
        # file is written+fsynced but BEFORE os.replace publishes it — the
        # window a mid-write kill lands in. Raising here models the kill.
        self.fault_after_tmp_write: Optional[Callable[[pathlib.Path], None]] = None

    @property
    def disk_dir(self) -> str:
        return str(self._disk)

    @staticmethod
    def _nbytes(obj: Any) -> int:
        if hasattr(obj, "nbytes"):
            return int(obj.nbytes)
        if isinstance(obj, dict):
            return sum(HierarchicalStore._nbytes(v) for v in obj.values())
        return 64

    def _path(self, key: str) -> pathlib.Path:
        return self._disk / f"{stable_key(key)}.npz"

    def put(self, key: str, obj: Any) -> None:
        with self._lock:
            if key in self._ram:
                self._used -= self._sizes.pop(key)
                del self._ram[key]
            size = self._nbytes(obj)
            evicted = self._evict_for(size)
            self._ram[key] = obj
            self._ram.move_to_end(key)
            self._sizes[key] = size
            self._used += size
        self._write_evicted(evicted)

    def _write_evicted(self, evicted) -> None:
        """Write spilled entries OUTSIDE the store lock (disk writes are
        fsync-heavy and, for SharedStore, flocked — holding the store-wide
        lock across them would serialize every reader). In the window
        between eviction and landing, a concurrent get() of an evicted key
        reads as a miss and recomputes — tasks are pure, so that is only
        wasted work, never a wrong value."""
        for k, v in evicted:
            self._write_disk(k, v)

    # ------------------------------------------------------------------
    # Crash-safe disk writes: tmp sibling + fsync + atomic rename
    # ------------------------------------------------------------------
    def _atomic_write(self, path: pathlib.Path, blob: bytes) -> None:
        """Publish ``blob`` under ``path`` atomically: a reader either sees
        the complete previous entry or the complete new one, never a
        truncation — a killed writer leaves only an orphaned ``.tmp``."""
        # pid+tid-unique: disk writes run outside the store lock, so two
        # threads may write the same key concurrently — each needs its own
        # tmp file or the loser's os.replace finds its tmp renamed away
        tmp = path.with_name(
            f"{path.name}.{os.getpid()}.{threading.get_ident()}.tmp"
        )
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        if self.fault_after_tmp_write is not None:
            self.fault_after_tmp_write(tmp)
        os.replace(tmp, path)
        self._fsync_dir()

    def _fsync_dir(self) -> None:
        try:
            dfd = os.open(self._disk, os.O_RDONLY)
        except OSError:  # pragma: no cover - platform without dir fds
            return
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)

    def _write_disk(self, key: str, v: Any) -> None:
        self._atomic_write(self._path(key), _pack_entry(_serialise(v)))
        self._write_key_sidecar(key)

    def _write_key_sidecar(self, key: str) -> None:
        """Best-effort ``<sha>.key`` reverse-mapping for humans debugging a
        store directory; nothing reads it, so it gets a plain write (no
        tmp/fsync) and only once per key."""
        sidecar = self._disk / f"{stable_key(key)}.key"
        try:
            if not sidecar.exists():
                sidecar.write_text(key)
        except OSError:  # pragma: no cover - diagnostics only
            pass

    # ------------------------------------------------------------------
    # Verified disk reads + quarantine
    # ------------------------------------------------------------------
    def _maybe_quarantine(self, path: pathlib.Path) -> bool:
        """Move a failed-verification entry aside (never delete: the bytes
        are evidence); the key then reads as a miss and the next put
        republishes a good entry — the self-heal path. Re-verifies first:
        a peer may have replaced the bad file with a freshly committed good
        entry between our failed read and now, and quarantining THAT would
        lose a committed entry. Returns True only if a file was actually
        moved; callers count ``corrupt`` then. SharedStore overrides this
        to re-verify under the per-key write lock, closing the race
        completely."""
        return self._quarantine_if_still_bad(path)

    def _quarantine_if_still_bad(self, path: pathlib.Path) -> bool:
        try:
            data = path.read_bytes()
        except OSError:
            return False  # gone (peer quarantined or deleted it)
        if _footer_ok(data) is not None:
            return False  # repaired underneath us: keep it
        qdir = self._disk / _QUARANTINE_DIR
        try:
            qdir.mkdir(exist_ok=True)
            os.replace(path, qdir / f"{path.name}.{time.time_ns()}")
            return True
        except OSError:  # racing quarantiners: the loser's replace fails
            return False

    def _load_disk_unlocked(self, path: pathlib.Path) -> Tuple[str, Any]:
        """Load + verify one disk entry WITHOUT the store lock (callers
        update counters under it afterwards). Returns ``("ok", value)``,
        ``("missing", None)``, or — after quarantining the file —
        ``("corrupt", None)`` for truncation, bit-rot or zero-byte files.

        An entry carrying the footer magic must pass length+sha; a
        footer-less file is a **legacy** (pre-footer) entry, for which
        ``np.load`` itself is the verifier — a torn legacy write fails to
        parse and is quarantined, a complete one is accepted, so a store
        directory written before the footer protocol still resumes with
        zero recomputation. The legacy path never applies to footered
        entries: a bit-flipped payload could still parse, so a failed
        digest is final."""
        for _ in range(3):  # retry when a peer repairs the entry under us
            try:
                data = path.read_bytes()
            except OSError:
                return "missing", None
            if _has_footer_magic(data):
                payload = _footer_ok(data)
                if payload is None:
                    if self._maybe_quarantine(path):
                        return "corrupt", None
                    continue  # entry changed since our read: re-read
            else:
                payload = data  # legacy entry: parse failure == corrupt
            try:
                return "ok", _deserialise(payload)
            except Exception:  # noqa: BLE001 — parse failure is corruption
                if self._maybe_quarantine(path):
                    return "corrupt", None
                continue
        return "corrupt", None  # kept changing underneath us: give up

    def _disk_entry_ok(self, path: pathlib.Path) -> bool:
        """Cheap existence+integrity probe for ``contains`` (runs OUTSIDE
        the store lock — it touches the filesystem): footer magic +
        recorded length vs file size (no digest). Quarantines on failure so
        ``contains`` never reports a torn entry as present. A footer-less
        file big enough to be a legacy npz is reported present
        optimistically — ``get`` fully validates."""
        status = _probe_footer(path)
        if status == "ok":
            return True
        if status == "legacy":
            return True  # pre-footer entry: np.load verifies on get
        if status == "missing":
            return False
        # "short" / "bad-length": a torn entry — quarantine and report absent
        if self._maybe_quarantine(path):
            with self._lock:
                self.corrupt += 1
        return False

    def _evict_for(self, incoming: int):  # holds: _lock
        """LRU-evict under the caller-held store lock; returns the evicted
        ``(key, value)`` pairs for the caller to write to disk AFTER
        releasing the lock (see ``_write_evicted``)."""
        evicted = []
        while self._used + incoming > self.ram_bytes and self._ram:
            k, v = self._ram.popitem(last=False)  # LRU
            self._used -= self._sizes.pop(k)
            self.spills += 1
            evicted.append((k, v))
        return evicted

    def persist(self, key: str) -> None:
        """Write a RAM-resident object to the disk tier without evicting it
        (a durability flush, e.g. before a StudyState checkpoint)."""
        with self._lock:
            value = self._ram.get(key)
        if value is not None:
            self._write_disk(key, value)

    def persist_all(self) -> int:
        """Write every RAM-resident object to the disk tier (durability
        barrier: after this, a store re-opened on the directory resolves
        everything this one holds). The writes run outside the store lock —
        they are fsync-heavy and, for SharedStore, flocked. Returns the
        number of entries written through (for SharedStore an entry a peer
        already committed counts too: it is durable either way)."""
        with self._lock:
            snapshot = list(self._ram.items())
        for k, v in snapshot:
            self._write_disk(k, v)
        return len(snapshot)

    def contains(self, key: str) -> bool:
        with self._lock:
            if key in self._ram:
                return True
        # the disk probe (footer read, possibly a quarantine — for
        # SharedStore a flocked one) runs OUTSIDE the store lock: holding
        # it across file I/O would serialize every RAM-tier reader
        return self._disk_entry_ok(self._path(key))

    def get(self, key: str) -> Optional[Any]:
        with self._lock:
            if key in self._ram:
                self.hits += 1
                self._ram.move_to_end(key)
                return self._ram[key]
        # the disk load (read + digest + np.load) runs OUTSIDE the store
        # lock — holding it across file I/O would serialize every worker's
        # store consultation behind one rehydration
        status, value = self._load_disk_unlocked(self._path(key))
        with self._lock:
            if key in self._ram:  # raced: a peer thread promoted it first
                self.hits += 1
                self._ram.move_to_end(key)
                return self._ram[key]
            if status == "ok":
                self.disk_hits += 1
                # promote into the (LRU-bounded) RAM tier: a hot spilled
                # entry must not pay deserialisation on every read
                size = self._nbytes(value)
                evicted = self._evict_for(size)
                self._ram[key] = value
                self._sizes[key] = size
                self._used += size
            elif status == "corrupt":
                self.corrupt += 1
                self.misses += 1
            else:
                self.misses += 1
        if status == "ok":
            self._write_evicted(evicted)
            return value
        return None

    def delete(self, key: str) -> None:
        with self._lock:
            if key in self._ram:
                self._used -= self._sizes.pop(key)
                del self._ram[key]
        # the disk unlink runs OUTSIDE the store lock (same rationale as
        # _write_evicted); a concurrent reader of the doomed key sees the
        # entry or a miss, both of which it already had to handle
        self._path(key).unlink(missing_ok=True)

    @property
    def used_bytes(self) -> int:
        return self._used  # analysis: ok[locks] racy int read, diagnostics only

    def counters(self) -> Dict[str, int]:
        """Point-in-time counter snapshot (the RPC workers ship this in
        their heartbeat stats; study summaries aggregate it)."""
        with self._lock:
            return {
                "hits": self.hits,
                "disk_hits": self.disk_hits,
                "misses": self.misses,
                "spills": self.spills,
                "corrupt": self.corrupt,
            }


class SharedStore(HierarchicalStore):
    """A :class:`HierarchicalStore` that N processes can safely mount on ONE
    directory (DESIGN.md §12).

    Readers need no coordination: entries land via atomic rename, so a read
    sees a complete entry or nothing. Writers coordinate per key:

    * an advisory ``fcntl.flock`` on ``locks/<sha>.lock`` serialises writers
      of one key, and a writer that finds a valid committed entry under the
      lock skips its own write (``dedup_writes`` counter) — values are pure
      functions of the key, so the first committed entry is THE entry;
    * every commit appends one JSON line to ``manifest.jsonl`` (under the
      manifest lock, fsynced): ``{key, sha, len, writer, seq, ts}``. Replays
      are last-writer-wins, so the manifest is idempotent under retries and
      tolerates a torn final line (a killed appender). ``committed_keys()``
      folds it into the set of keys the directory serves — an audit /
      accounting view (the fleet runner reports it; round planning unions
      TrieLedger entries shipped in worker payloads, a different namespace
      from store keys). The entry files remain the ground truth: they
      self-verify on read.
    """

    def __init__(
        self,
        ram_bytes: int = 1 << 30,
        disk_dir: Optional[str] = None,
        *,
        writer_id: Optional[str] = None,
    ):
        super().__init__(ram_bytes, disk_dir)
        self.writer_id = writer_id or f"pid{os.getpid()}"
        self._locks_dir = self._disk / "locks"
        self._locks_dir.mkdir(exist_ok=True)
        self._manifest = self._disk / "manifest.jsonl"
        self._manifest_lockfile = self._disk / "manifest.lock"
        self._seq = 0
        self.dedup_writes = 0  # guard: _counters_lock (peer-committed write elisions)
        # shas this instance has itself committed (or seen committed): the
        # re-flush fast path — a repeated persist_all skips them without
        # even taking the flock. Guarded by its own lock because writes now
        # run outside the store-wide lock.
        self._persisted: Set[str] = set()  # guard: _counters_lock
        self._counters_lock = threading.Lock()

    @contextlib.contextmanager
    def _flock(self, path: pathlib.Path) -> Iterator[None]:
        if fcntl is None:  # pragma: no cover - non-POSIX fallback
            yield
            return
        fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            yield
        finally:
            # closing drops the flock; each acquisition opens a fresh fd, so
            # two threads of one process exclude each other too
            os.close(fd)

    def _key_lockfile(self, key: str) -> pathlib.Path:
        return self._locks_dir / f"{stable_key(key)}.lock"

    def _write_disk(self, key: str, v: Any) -> None:
        sha = stable_key(key)
        with self._counters_lock:
            if sha in self._persisted:
                return  # this instance already committed it; rename is final
        path = self._path(key)
        with self._flock(self._key_lockfile(key)):
            # strict commit probe: only a structurally-valid FOOTERED entry
            # counts as committed — legacy and torn files fail it and are
            # overwritten with a fresh footered entry (repair-on-write),
            # unlike the read path's optimistic legacy handling
            if _probe_footer(path) == "ok":
                # a peer committed first; values are pure functions of the
                # key, so ours is identical — elide the double-write
                with self._counters_lock:
                    self.dedup_writes += 1
                    self._persisted.add(sha)
                return
            blob = _pack_entry(_serialise(v))
            self._atomic_write(path, blob)
            self._write_key_sidecar(key)
            self._manifest_append(key, len(blob) - _FOOTER_SIZE)
        with self._counters_lock:
            self._persisted.add(sha)

    def _maybe_quarantine(self, path: pathlib.Path) -> bool:
        """Quarantine under the per-key write lock: with the flock held no
        peer can be mid-commit, so the re-verify inside
        ``_quarantine_if_still_bad`` conclusively distinguishes 'still the
        bad bytes' from 'a peer just repaired it' — a committed entry can
        never be swept into quarantine."""
        with self._flock(self._locks_dir / f"{path.stem}.lock"):
            did = self._quarantine_if_still_bad(path)
        if did:
            with self._counters_lock:
                self._persisted.discard(path.stem)
        return did

    def delete(self, key: str) -> None:
        super().delete(key)
        with self._counters_lock:
            self._persisted.discard(stable_key(key))

    def _manifest_append(self, key: str, payload_len: int) -> None:
        self._seq += 1
        line = (
            json.dumps(
                {
                    "key": key,
                    "sha": stable_key(key),
                    "len": payload_len,
                    "writer": self.writer_id,
                    "seq": self._seq,
                    "ts": time.time(),
                }
            )
            + "\n"
        )
        with self._flock(self._manifest_lockfile):
            with open(self._manifest, "a+b") as f:
                # A writer killed mid-append can leave a TORN final line
                # with no trailing newline. Appending straight after it
                # would merge our valid record onto the torn fragment,
                # producing one unparseable line — replay would then drop a
                # GOOD commit record, not just the torn one. Terminate the
                # fragment first so our record starts a fresh line.
                end = f.seek(0, os.SEEK_END)
                if end > 0:
                    f.seek(end - 1)
                    if f.read(1) != b"\n":
                        f.write(b"\n")
                f.write(line.encode())
                f.flush()
                os.fsync(f.fileno())

    def manifest_records(self) -> Dict[str, Dict[str, Any]]:
        """Fold the manifest into its last-writer-wins view: key → the most
        recent commit record. Unparseable lines (a torn final append from a
        killed writer) are skipped — the entry files themselves are the
        ground truth and self-verify on read."""
        records: Dict[str, Dict[str, Any]] = {}
        try:
            with self._flock(self._manifest_lockfile):
                text = self._manifest.read_text()
        except OSError:
            return records
        for line in text.splitlines():
            try:
                rec = json.loads(line)
                records[rec["key"]] = rec
            except (ValueError, KeyError, TypeError):
                continue
        return records

    def committed_keys(self) -> Set[str]:
        """Keys the directory's manifest says are committed — the basis of
        the fleet's cross-process ledger union."""
        return set(self.manifest_records())
