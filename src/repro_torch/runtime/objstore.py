"""S3-style object store + the store tier that rides on it (DESIGN.md §16).

Multi-host fleets cannot assume a shared filesystem: the SharedStore's
coordination primitives (``fcntl.flock`` per-key locks, an appendable
``manifest.jsonl``) only work when every writer mounts one directory. What
every real deployment *does* have is an object store — S3, GCS, MinIO — a
flat keyspace of immutable blobs with ``get/put/list/head`` and
*conditional* writes. This module defines that contract and plugs it in
BEHIND the existing footer-verified entry protocol, so the paper's storage
semantics survive the hop off-host unchanged:

* :class:`ObjectStore` — the minimal API (``get``/``put``/``list``/
  ``head`` plus ETag-conditional ``put_if_absent``). Two implementations
  ship: :class:`LocalFSObjectStore`, a reference implementation rooted at a
  directory whose conditional create is an atomic ``os.link`` (so N
  *processes* — or N hosts over a mounted share — get real
  create-if-absent semantics), and :class:`InMemoryObjectStore`, the
  in-process fake the tests drive (with corruption/fault hooks no real
  backend would expose).
* :class:`ObjectBackedStore` — a :class:`~repro_torch.runtime.storage.
  HierarchicalStore` whose *disk tier* is an object store. Entries keep
  the exact ``_pack_entry`` layout (npz payload + magic/length/sha256
  footer) as object bodies under content-addressed keys
  (``entries/<sha256(key)>``), so corruption detection, quarantine-on-
  corrupt self-healing and bit-exact hydration are byte-for-byte the
  protocol of DESIGN.md §12 — only the medium changed. Cross-host write
  dedup needs no lock at all: values are pure functions of the key, so
  ``put_if_absent`` IS the coordination — the first committed object wins
  and every later writer elides its double-write (the ``dedup_writes``
  counter, same meaning as the flock path's). Entries decode through the
  storage codec (``storage._deserialise``), so a torch tensor comes back
  as a tensor of its dtype on its device type.

Spec strings make the tier reachable from every surface that accepts a
``store_dir``: ``"obj:<root>"`` mounts an :class:`ObjectBackedStore` over
a :class:`LocalFSObjectStore` at ``<root>`` (see
:func:`repro_torch.runtime.storage.mount_store`); a plain path keeps mounting
the flock-coordinated :class:`~repro_torch.runtime.storage.SharedStore`. The
string crosses spawn and TCP boundaries verbatim, which is how RPC and
socket workers mount the same tier the leader did.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import pathlib
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.runtime.storage import (
    HierarchicalStore,
    _deserialise,
    _footer_ok,
    _pack_entry,
    _serialise,
    stable_key,
)

__all__ = [
    "ObjectMeta",
    "ObjectStore",
    "LocalFSObjectStore",
    "InMemoryObjectStore",
    "ObjectBackedStore",
]


def _etag(data: bytes) -> str:
    """Content ETag — sha256 hex, the strong validator S3 calls an entity
    tag. Conditional writes compare these, never mtimes."""
    return hashlib.sha256(data).hexdigest()


def _check_key(key: str) -> str:
    if not key or key.startswith("/") or ".." in key.split("/"):
        raise ValueError(f"illegal object key {key!r}")
    return key


@dataclasses.dataclass(frozen=True)
class ObjectMeta:
    """``head`` result: existence proof + size + the content ETag."""

    size: int
    etag: str


class ObjectStore:
    """The S3-shaped contract every backing implementation satisfies.

    Keys are ``/``-separated paths in a flat namespace (no directories —
    ``list`` is a prefix scan). Objects are immutable blobs: ``put``
    replaces whole objects atomically, ``put_if_absent`` creates-if-absent
    atomically and reports the survivor's ETag — the primitive that
    replaces per-key file locks for cross-host dedup.
    """

    def get(self, key: str) -> Optional[bytes]:
        """The object's bytes, or None when absent."""
        raise NotImplementedError

    def put(self, key: str, data: bytes) -> str:
        """Store ``data`` under ``key`` (unconditional replace); returns
        the new object's ETag."""
        raise NotImplementedError

    def put_if_absent(self, key: str, data: bytes) -> Tuple[bool, str]:
        """Atomic create-if-absent. Returns ``(created, etag)`` where
        ``etag`` names the object that now exists — ours when we won the
        race, the incumbent's when we lost. Losing is not an error: for
        content-addressed pure values it means a peer already committed
        the identical entry."""
        raise NotImplementedError

    def head(self, key: str) -> Optional[ObjectMeta]:
        """Size + ETag without the body, or None when absent."""
        raise NotImplementedError

    def list(self, prefix: str = "") -> List[str]:
        """Every key under ``prefix``, sorted (deterministic across
        implementations so replays/audits are stable)."""
        raise NotImplementedError

    def delete(self, key: str) -> bool:
        """Remove ``key``; False when it was already absent."""
        raise NotImplementedError


class LocalFSObjectStore(ObjectStore):
    """Reference implementation over a directory tree.

    Every object lands crash-safely (tmp sibling + fsync + atomic
    publish), and ``put_if_absent`` is an ``os.link`` of the fsynced tmp
    file onto the final name — link(2) fails with EEXIST atomically even
    across processes and network mounts, giving true conditional-create
    without any lock file. ETags are content sha256; ``head`` reads the
    body to compute one (a reference implementation trades that cost for
    zero metadata bookkeeping — a real backend serves ETags from its
    index).
    """

    def __init__(self, root: str) -> None:
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def _path(self, key: str) -> pathlib.Path:
        return self.root / _check_key(key)

    def _write_tmp(self, path: pathlib.Path, data: bytes) -> pathlib.Path:
        path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(prefix=f".{path.name}.", dir=path.parent)
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return pathlib.Path(tmp)

    def get(self, key: str) -> Optional[bytes]:
        try:
            return self._path(key).read_bytes()
        except OSError:
            return None

    def put(self, key: str, data: bytes) -> str:
        path = self._path(key)
        tmp = self._write_tmp(path, data)
        os.replace(tmp, path)
        return _etag(data)

    def put_if_absent(self, key: str, data: bytes) -> Tuple[bool, str]:
        path = self._path(key)
        tmp = self._write_tmp(path, data)
        try:
            os.link(tmp, path)  # atomic create-if-absent, even cross-host
        except FileExistsError:
            existing = self.get(key)
            if existing is not None:
                return False, _etag(existing)
            # raced a delete between link and get: retry as the creator
            os.replace(tmp, path)
            return True, _etag(data)
        finally:
            try:
                os.unlink(tmp)
            except OSError:
                pass
        return True, _etag(data)

    def head(self, key: str) -> Optional[ObjectMeta]:
        data = self.get(key)
        if data is None:
            return None
        return ObjectMeta(size=len(data), etag=_etag(data))

    def list(self, prefix: str = "") -> List[str]:
        out: List[str] = []
        for dirpath, _dirs, files in os.walk(self.root):
            rel = pathlib.Path(dirpath).relative_to(self.root)
            for name in files:
                if name.startswith("."):
                    continue  # in-flight tmp siblings are not objects
                key = name if rel == pathlib.Path(".") else f"{rel.as_posix()}/{name}"
                if key.startswith(prefix):
                    out.append(key)
        return sorted(out)

    def delete(self, key: str) -> bool:
        try:
            self._path(key).unlink()
            return True
        except OSError:
            return False


class InMemoryObjectStore(ObjectStore):
    """In-process fake for tests: a dict behind a lock, plus the fault
    hooks a real backend would never expose — ``corrupt(key)`` flips bytes
    in place (models bit-rot the footer check must catch) and
    ``fail_puts_once`` injects one transient put failure."""

    def __init__(self) -> None:
        self._objects: Dict[str, bytes] = {}  # guard: _lock
        self._lock = threading.Lock()
        self.puts = 0  # guard: _lock
        self.gets = 0  # guard: _lock
        self.conditional_losses = 0  # guard: _lock
        self.fail_puts_once = False

    def _maybe_fail(self) -> None:  # holds: _lock
        if self.fail_puts_once:
            self.fail_puts_once = False
            raise OSError("injected object-store put failure")

    def get(self, key: str) -> Optional[bytes]:
        with self._lock:
            self.gets += 1
            return self._objects.get(_check_key(key))

    def put(self, key: str, data: bytes) -> str:
        with self._lock:
            self._maybe_fail()
            self._objects[_check_key(key)] = bytes(data)
            self.puts += 1
            return _etag(data)

    def put_if_absent(self, key: str, data: bytes) -> Tuple[bool, str]:
        with self._lock:
            self._maybe_fail()
            key = _check_key(key)
            existing = self._objects.get(key)
            if existing is not None:
                self.conditional_losses += 1
                return False, _etag(existing)
            self._objects[key] = bytes(data)
            self.puts += 1
            return True, _etag(data)

    def head(self, key: str) -> Optional[ObjectMeta]:
        with self._lock:
            data = self._objects.get(_check_key(key))
        if data is None:
            return None
        return ObjectMeta(size=len(data), etag=_etag(data))

    def list(self, prefix: str = "") -> List[str]:
        with self._lock:
            return sorted(k for k in self._objects if k.startswith(prefix))

    def delete(self, key: str) -> bool:
        with self._lock:
            return self._objects.pop(_check_key(key), None) is not None

    def corrupt(self, key: str) -> None:
        """Flip the first byte of ``key``'s body (test hook)."""
        with self._lock:
            data = bytearray(self._objects[_check_key(key)])
            data[0] ^= 0xFF
            self._objects[key] = bytes(data)


# ---------------------------------------------------------------------------
# ObjectBackedStore: the §12 entry protocol over an ObjectStore
# ---------------------------------------------------------------------------

_ENTRY_PREFIX = "entries/"
_KEY_PREFIX = "keys/"
_QUAR_PREFIX = "quarantine/"


class ObjectBackedStore(HierarchicalStore):
    """A :class:`~repro_torch.runtime.storage.HierarchicalStore` whose disk tier
    is an :class:`ObjectStore` — the no-shared-filesystem SharedStore.

    Object layout (all content-addressed by ``stable_key``):

    * ``entries/<sha>`` — the footer-verified entry bytes, byte-identical
      to what the filesystem tier writes to ``<sha>.npz``;
    * ``keys/<sha>`` — the human-readable key (the sidecar AND the commit
      record: ``committed_keys()`` folds this prefix, playing the
      manifest's audit role without an appendable file);
    * ``quarantine/<sha>.<ns>`` — entries that failed footer verification,
      moved aside as evidence exactly like the directory tier's
      ``quarantine/`` (the key then reads as a miss and the next write
      self-heals it).

    Writer coordination is ``put_if_absent`` instead of ``flock``: the
    first committed object is THE entry (values are pure functions of the
    key), every losing writer counts a ``dedup_writes`` and moves on. The
    crash window matches §12's: a writer killed mid-``put`` publishes
    nothing (object puts are atomic), a writer killed between the entry
    put and the key-record put leaves a servable entry that simply isn't
    listed in ``committed_keys()`` until a peer re-commits it — entries
    stay the ground truth, the key index stays advisory, exactly the
    manifest's contract.
    """

    def __init__(
        self,
        ram_bytes: int = 1 << 30,
        objstore: Optional[ObjectStore] = None,
        *,
        spec: Optional[str] = None,
        writer_id: Optional[str] = None,
    ):
        # the base class's disk directory is never written — every
        # disk-tier hook below routes to the object store instead — but
        # ``_path()`` still names entries ``<sha>.npz``, which keys them
        super().__init__(ram_bytes, disk_dir=None)
        self.objstore = objstore if objstore is not None else InMemoryObjectStore()
        self._spec = spec
        self.writer_id = writer_id or f"pid{os.getpid()}"
        self.dedup_writes = 0  # guard: _counters_lock
        self._persisted: set = set()  # guard: _counters_lock
        self._counters_lock = threading.Lock()

    @property
    def disk_dir(self) -> str:
        """The mount SPEC (``obj:<root>``) rather than a directory: what
        ``StudyState.save`` records and fleet/RPC workers remount."""
        if self._spec is not None:
            return self._spec
        root = getattr(self.objstore, "root", None)
        if root is not None:
            return f"obj:{root}"
        return f"obj+mem:{id(self.objstore):x}"

    # -- write side: the conditional create replaces the flock -----------
    def _write_disk(self, key: str, v: Any) -> None:
        sha = stable_key(key)
        with self._counters_lock:
            if sha in self._persisted:
                return  # this instance already committed it
        blob = _pack_entry(_serialise(v))
        created, _ = self.objstore.put_if_absent(_ENTRY_PREFIX + sha, blob)
        if not created:
            with self._counters_lock:
                self.dedup_writes += 1
        # commit record (advisory, like the manifest): conditional and
        # idempotent, and written by dedup LOSERS too — that re-commit is
        # what heals the crash window of a writer killed between the entry
        # put and the key-record put
        self.objstore.put_if_absent(_KEY_PREFIX + sha, key.encode())
        with self._counters_lock:
            self._persisted.add(sha)

    # -- read side: same footer verification, object quarantine ----------
    def _load_disk_unlocked(self, path: pathlib.Path) -> Tuple[str, Any]:
        sha = path.stem  # HierarchicalStore._path names entries <sha>.npz
        data = self.objstore.get(_ENTRY_PREFIX + sha)
        if data is None:
            return "missing", None
        payload = _footer_ok(data)
        if payload is None:
            self._quarantine_object(sha, data)
            return "corrupt", None
        try:
            # the storage codec's decoder: entries that were torch tensors
            # come back as tensors on their device type
            return "ok", _deserialise(payload)
        except Exception:  # noqa: BLE001 — parse failure is corruption
            self._quarantine_object(sha, data)
            return "corrupt", None

    def _quarantine_object(self, sha: str, data: bytes) -> None:
        """Move the bad object aside (never discard evidence) and delete
        the entry so the key reads as a miss until a writer self-heals it.
        The quarantining instance forgets its own commit so IT can be that
        writer."""
        try:
            self.objstore.put(f"{_QUAR_PREFIX}{sha}.{time.time_ns()}", data)
            self.objstore.delete(_ENTRY_PREFIX + sha)
            self.objstore.delete(_KEY_PREFIX + sha)
        except OSError:  # pragma: no cover - quarantine is best-effort
            pass
        with self._counters_lock:
            self._persisted.discard(sha)

    def _disk_entry_ok(self, path: pathlib.Path) -> bool:
        # optimistic presence probe (a byte-exact check would turn every
        # contains() into a full GET); get() verifies the footer in full
        return self.objstore.head(_ENTRY_PREFIX + path.stem) is not None

    def delete(self, key: str) -> None:
        with self._lock:
            if key in self._ram:
                self._used -= self._sizes.pop(key)
                del self._ram[key]
        sha = stable_key(key)
        self.objstore.delete(_ENTRY_PREFIX + sha)
        self.objstore.delete(_KEY_PREFIX + sha)
        with self._counters_lock:
            self._persisted.discard(sha)

    # -- audit view (the manifest's role) --------------------------------
    def committed_keys(self) -> set:
        out = set()
        for obj_key in self.objstore.list(_KEY_PREFIX):
            body = self.objstore.get(obj_key)
            if body is not None:
                out.add(body.decode(errors="replace"))
        return out

    def manifest_records(self) -> Dict[str, Dict[str, Any]]:
        """Manifest-shaped view for callers that audit commit records: one
        row per committed key (the object tier keeps no per-write history,
        so ``seq``/``ts``/``writer`` are absent by design)."""
        records: Dict[str, Dict[str, Any]] = {}
        for obj_key in self.objstore.list(_KEY_PREFIX):
            body = self.objstore.get(obj_key)
            if body is None:
                continue
            key = body.decode(errors="replace")
            sha = obj_key[len(_KEY_PREFIX):]
            meta = self.objstore.head(_ENTRY_PREFIX + sha)
            records[key] = {
                "key": key,
                "sha": sha,
                "len": meta.size if meta else None,
            }
        return records
