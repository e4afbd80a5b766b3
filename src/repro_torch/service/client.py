"""ServiceClient — the tenant-side handle to a remote StudyServer.

One TCP connection, the §16 length-prefixed pickle frame codec, strict
request/response: every call sends one ``"t"``-tagged frame and blocks
for the one reply. Server-side failures arrive as ``{"t": "err"}`` frames
and surface here as :class:`ServiceError`, so a tenant's bad spec or
blown quota reads as an exception, not a dict to inspect.
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Any, Dict, List, Optional

from repro_torch.runtime.net import PROTOCOL_VERSION, SocketConn, parse_address
from repro_torch.runtime.transport import _recv_frame, _send_frame
from repro_torch.service.spec import StudySpec

__all__ = ["ServiceClient", "ServiceError"]


class ServiceError(RuntimeError):
    """The server rejected or failed a request (bad spec, unknown job,
    quota exceeded, protocol mismatch)."""


class ServiceClient:
    """Blocking client for one tenant against one StudyServer address.

    Thread-safe: a lock serializes request/response pairs, so one client
    may be shared by a tenant's polling and submitting threads.
    """

    def __init__(
        self, addr: str, tenant: str, *, connect_timeout: float = 10.0
    ) -> None:
        self.tenant = tenant
        host, port = parse_address(addr)
        sock = socket.create_connection((host, port), timeout=connect_timeout)
        self._conn = SocketConn(sock)
        self._lock = threading.Lock()
        self._send_lock = threading.Lock()
        # frame-consumer: svc_hello via hello
        hello = _recv_frame(self._conn)
        if hello.get("t") != "svc_hello":
            raise ServiceError(f"unexpected greeting frame: {hello!r}")
        if hello.get("proto") != PROTOCOL_VERSION:
            raise ServiceError(
                f"protocol mismatch: server speaks {hello.get('proto')}, "
                f"client speaks {PROTOCOL_VERSION}"
            )

    # ------------------------------------------------------------------
    def _rpc(self, msg: Dict[str, Any], ok_tag: str) -> Dict[str, Any]:
        # frame-consumer: sub_ok,stat_ok,res_ok,cancel_ok,jobs_ok,weight_ok,sstats_ok,bye_ok,err via reply
        with self._lock:
            # analysis: ok[blocking] the request/response round-trip IS what
            # this lock serializes — interleaved frames from two threads
            # would pair replies to the wrong calls
            _send_frame(self._conn, self._send_lock, msg)
            reply = _recv_frame(self._conn)  # analysis: ok[blocking] see above
        kind = reply.get("t")
        if kind == "err":
            raise ServiceError(reply.get("error", "unknown server error"))
        if kind != ok_tag:
            raise ServiceError(
                f"expected {ok_tag!r} reply, got {kind!r}"
            )
        return reply

    # ------------------------------------------------------------------
    # The job API over the wire
    # ------------------------------------------------------------------
    def submit(self, spec: StudySpec) -> str:
        reply = self._rpc(
            {"t": "sub", "tenant": self.tenant, "spec": spec.to_json()},
            "sub_ok",
        )
        return reply["job_id"]

    def status(self, job_id: str) -> Dict[str, Any]:
        return self._rpc({"t": "stat", "job_id": job_id}, "stat_ok")["job"]

    def result(
        self,
        job_id: str,
        *,
        wait: bool = True,
        timeout: Optional[float] = None,
        poll_s: float = 0.2,
    ) -> Dict[str, Any]:
        """Terminal snapshot of the job. ``wait`` polls client-side (one
        short server round-trip per poll — the connection is never parked
        in a long server-side wait, so cancels and status checks from
        other threads keep flowing)."""
        deadline = (
            None if timeout is None else time.monotonic() + max(0.0, timeout)
        )
        while True:
            reply = self._rpc(
                {"t": "res", "job_id": job_id, "wait": False}, "res_ok"
            )
            job = reply["job"]
            if job["state"] in ("DONE", "FAILED", "CANCELLED"):
                return job
            if not wait:
                return job
            if deadline is not None and time.monotonic() >= deadline:
                return job
            time.sleep(poll_s)

    def cancel(self, job_id: str) -> Dict[str, Any]:
        return self._rpc({"t": "cancel", "job_id": job_id}, "cancel_ok")[
            "job"
        ]

    def list_jobs(
        self, *, all_tenants: bool = False
    ) -> List[Dict[str, Any]]:
        msg: Dict[str, Any] = {"t": "jobs"}
        if not all_tenants:
            msg["tenant"] = self.tenant
        return self._rpc(msg, "jobs_ok")["jobs"]

    def set_tenant_weight(self, weight: float, tenant: str = "") -> None:
        self._rpc(
            {
                "t": "weight",
                "tenant": tenant or self.tenant,
                "weight": float(weight),
            },
            "weight_ok",
        )

    def server_stats(self) -> Dict[str, Any]:
        return self._rpc({"t": "sstats"}, "sstats_ok")["stats"]

    def close(self) -> None:
        try:
            self._rpc({"t": "bye"}, "bye_ok")
        except (ServiceError, EOFError, OSError):
            pass
        self._conn.close()

    def __enter__(self) -> "ServiceClient":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
