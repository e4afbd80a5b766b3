"""The reference's tests/test_net.py re-targeted at ``repro_torch`` (the
import root renamed; the study generator is ``test_torch_study_gen``).

Multi-host substrate tests (DESIGN.md §16), the socket part: the
``"socket[...]"`` spec grammar and the raw-socket WorkerBackend (the
object-store part is in tests/test_torch_objstore.py).

* **SocketBackend faults** — protocol-version mismatch rejected at the
  handshake; a mid-lease TCP disconnect re-enqueues the lease to a
  survivor while the disconnected worker reconnects under its old id; and
  the acceptance scenario: a loopback fleet over the object tier
  (no shared working directory beyond the store root) survives one
  SIGKILLed AND one disconnected worker with exactly-once callbacks, then
  runs a study bit-identical to the thread backend in the same degraded
  session.

Task functions are module-level and data-only where they cross the spawn
boundary (socket workers re-import this module in fresh interpreters).
"""

import os
import pathlib
import random
import signal
import socket
import threading
import time

import pytest

from repro_torch.engine import ClusterSpec, execute_study, plan_study
from repro_torch.runtime import (
    Manager,
    SocketBackend,
    WorkItem,
    socket_flag_kwargs,
)
from repro_torch.runtime.net import PROTOCOL_VERSION, SocketConn, parse_address
from repro_torch.runtime.transport import _recv_frame, _send_frame

from test_torch_study_gen import (
    mix_study_build,
    naive_outputs,
    random_layout,
    random_param_sets,
    workflow_from_layout,
)

pytestmark = pytest.mark.filterwarnings("ignore::ResourceWarning")


# ---------------------------------------------------------------------------
# Spawn-picklable task functions
# ---------------------------------------------------------------------------


def _quick(tag):
    time.sleep(0.01)
    return f"q-{tag}"


def _hang_until_killed(marker_dir):
    """First execution anywhere in the fleet: record our pid and hang (the
    test SIGKILLs us). Later executions return fast — the survivor path."""
    marker = pathlib.Path(marker_dir) / "kill_pid"
    if not marker.exists():
        # write-then-rename: the test polls for existence, so the pid must
        # be complete the instant the path appears
        tmp = marker.with_suffix(".tmp")
        tmp.write_text(str(os.getpid()))
        os.replace(tmp, marker)
        time.sleep(60.0)
        return "hung"
    return "fast"


def _slow_first(marker_dir):
    """First execution sleeps long enough for the test to cut its worker's
    connection mid-lease; the survivor's re-run returns immediately."""
    marker = pathlib.Path(marker_dir) / "slow"
    try:
        fd = os.open(marker, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        os.close(fd)
    except FileExistsError:
        return "done"
    time.sleep(2.0)
    return "done"


# ---------------------------------------------------------------------------
# Spec grammar
# ---------------------------------------------------------------------------


class TestSocketSpecGrammar:
    def test_address_flags_and_tunables(self):
        assert socket_flag_kwargs("socket") == {}
        kw = socket_flag_kwargs("socket[0.0.0.0:7077,external,-async]")
        assert kw == {
            "bind": "0.0.0.0:7077",
            "spawn_workers": False,
            "async_commit": False,
        }
        kw = socket_flag_kwargs("socket[none,batch,max_batch=4,store=obj:/d/s]")
        assert kw["batch_frames"] is True
        assert kw["warm_plans"] is False and kw["async_commit"] is False
        assert kw["max_batch"] == 4 and kw["store"] == "obj:/d/s"

    def test_rejections(self):
        with pytest.raises(ValueError):
            socket_flag_kwargs("socket[shm]")  # shm cannot cross hosts
        with pytest.raises(ValueError):
            socket_flag_kwargs("socket[bogus]")
        with pytest.raises(ValueError):
            socket_flag_kwargs("socket[unknown=1]")
        with pytest.raises(ValueError):
            socket_flag_kwargs("process[batch]")
        with pytest.raises(ValueError):
            parse_address("no-port")


# ---------------------------------------------------------------------------
# SocketBackend: handshake + network faults
# ---------------------------------------------------------------------------


def _mk_socket_manager(tmp_path, n_workers=2, *, build=None, build_kwargs=None,
                       **mgr_kwargs):
    mgr = Manager(
        backend=SocketBackend(
            build=build,
            build_kwargs=build_kwargs,
            store=f"obj:{tmp_path / 'objroot'}",
            heartbeat_interval=0.05,
        ),
        **mgr_kwargs,
    )
    mgr.start(n_workers)
    return mgr


def test_protocol_version_mismatch_rejected_at_handshake(tmp_path):
    mgr = _mk_socket_manager(tmp_path, 1)
    backend = mgr.backend
    try:
        host, port = parse_address(backend.address)
        conn = SocketConn(socket.create_connection((host, port), timeout=5))
        try:
            _send_frame(conn, threading.Lock(), {
                "t": "register", "proto": PROTOCOL_VERSION + 99,
                "wid": None, "pid": os.getpid(), "caps": {},
            })
            assert conn.poll(5.0)
            reply = _recv_frame(conn)
        finally:
            conn.close()
        assert reply["t"] == "reject"
        assert "protocol version mismatch" in reply["reason"]
        assert reply["proto"] == PROTOCOL_VERSION  # tells the worker what to speak
        assert backend.stats()["leader"]["rejects"] == 1
        # the refused dialer never became a worker
        assert len([s for s in backend.heartbeat_view().values() if s.alive]) == 1
        # ...and the fleet still works
        mgr.submit(WorkItem(key="k", spec=("call", _quick, ("x",), {})))
        mgr.drain()
        assert mgr.results()["k"] == "q-x"
    finally:
        mgr.close()
        backend.cleanup()


def _wait_for(pred, timeout, what):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.02)


def test_mid_lease_disconnect_survivor_completes_and_worker_reconnects(tmp_path):
    """Cut the TCP connection under a running lease: the lease rides a
    tombstone row into the Manager's dead-worker expiry and a SURVIVOR
    completes it (exactly-once callback), while the disconnected worker
    re-registers under its old id with backoff — the fleet ends at full
    strength with the same worker-id set."""
    marker_dir = tmp_path / "marker"
    marker_dir.mkdir()
    fired = {}
    mgr = _mk_socket_manager(
        tmp_path, 2, enable_backup_tasks=False, max_attempts=3
    )
    backend = mgr.backend
    wids_before = sorted(
        wid for wid, st in backend.heartbeat_view().items() if st.alive
    )
    try:
        def cb(key, value):
            fired[key] = fired.get(key, 0) + 1

        mgr.submit(WorkItem(key="victim", callback=cb,
                            spec=("call", _slow_first, (str(marker_dir),), {})))
        for i in range(3):
            mgr.submit(WorkItem(key=f"pad{i}", callback=cb,
                                spec=("call", _quick, (i,), {})))

        def victim_holder():
            for wid, st in backend.heartbeat_view().items():
                if wid >= 0 and st.alive and any(
                    lid.startswith("victim#") for lid in st.inflight
                ):
                    return wid
            return None

        _wait_for(lambda: victim_holder() is not None, 15, "victim leased")
        wid = victim_holder()
        assert backend.disconnect(wid) is True  # the modelled partition
        mgr.drain()
        out = mgr.results()
        assert out["victim"] == "done"  # completed by the survivor
        for i in range(3):
            assert out[f"pad{i}"] == f"q-{i}"
        assert all(n == 1 for n in fired.values()), fired  # exactly once
        assert len(fired) == 4
        assert mgr.retries >= 1 or mgr.heartbeat_expiries >= 1
        # the partitioned worker re-registers under the SAME id
        _wait_for(
            lambda: backend.stats()["leader"]["reconnects"] >= 1,
            20, "worker reconnect",
        )
        _wait_for(
            lambda: sorted(
                w for w, st in backend.heartbeat_view().items()
                if w >= 0 and st.alive
            ) == wids_before,
            20, "fleet back to full strength",
        )
        # and serves new work after reconnecting
        mgr.submit(WorkItem(key="after", spec=("call", _quick, ("z",), {})))
        mgr.drain()
        assert mgr.results()["after"] == "q-z"
    finally:
        mgr.close()
        backend.cleanup()


def test_acceptance_fleet_survives_sigkill_and_disconnect(tmp_path):
    """Acceptance: ≥2 workers joined by TCP against an
    ObjectStore-backed store — no shared working directory beyond the
    store root — survive one SIGKILLed and one DISCONNECTED worker with
    exactly-once callbacks, and the same degraded session then executes a
    study bit-identical to the thread backend."""
    rng = random.Random(816)
    layout, names, cards = random_layout(rng, max_stages=3)
    wf = workflow_from_layout(layout)
    sets = random_param_sets(rng, names, cards, 8)
    inputs = [3, 8, 21]
    oracles = [naive_outputs(wf, sets, x) for x in inputs]

    marker_dir = tmp_path / "marker"
    marker_dir.mkdir()
    fired = {}
    mgr = _mk_socket_manager(
        tmp_path, 3,
        build=mix_study_build,
        build_kwargs={"layout": layout, "inputs": inputs},
        enable_backup_tasks=False,
        max_attempts=3,
    )
    backend = mgr.backend
    try:
        def cb(key, value):
            fired[key] = fired.get(key, 0) + 1

        mgr.submit(WorkItem(key="killed", callback=cb,
                            spec=("call", _hang_until_killed,
                                  (str(marker_dir),), {})))
        mgr.submit(WorkItem(key="cut", callback=cb,
                            spec=("call", _slow_first, (str(marker_dir),), {})))
        for i in range(4):
            mgr.submit(WorkItem(key=f"pad{i}", callback=cb,
                                spec=("call", _quick, (i,), {})))

        pid_file = marker_dir / "kill_pid"
        _wait_for(pid_file.exists, 30, "hang task to start")
        victim_pid = int(pid_file.read_text())

        def cut_holder():
            for wid, st in backend.heartbeat_view().items():
                if wid >= 0 and st.alive and any(
                    lid.startswith("cut#") for lid in st.inflight
                ):
                    return wid
            return None

        _wait_for(lambda: cut_holder() is not None, 15, "cut task leased")
        cut_wid = cut_holder()
        os.kill(victim_pid, signal.SIGKILL)  # fault 1: a dead host
        assert backend.disconnect(cut_wid)   # fault 2: a network partition
        mgr.drain()
        out = mgr.results()
        assert out["killed"] == "fast"  # re-run by a surviving worker
        assert out["cut"] == "done"
        for i in range(4):
            assert out[f"pad{i}"] == f"q-{i}"
        assert all(n == 1 for n in fired.values()), fired  # exactly once
        assert len(fired) == 6
        # the killed worker stays dead; the partitioned one rejoins
        _wait_for(
            lambda: sum(
                1 for w, st in backend.heartbeat_view().items()
                if w >= 0 and st.alive
            ) == 2,
            20, "fleet to settle at two live workers",
        )
        # the SAME degraded session now runs a study — bit-identical to
        # the thread backend (= the naive oracle)
        plan = plan_study(wf, sets, policy="hybrid", max_bucket_size=3)
        thread_stream = execute_study(
            plan, inputs,
            cluster=ClusterSpec(n_workers=2, enable_backup_tasks=False),
        )
        sock_stream = execute_study(plan, inputs, manager=mgr, key_prefix="a:")
        assert sock_stream.backend == "socket"
        for i in range(len(inputs)):
            assert sock_stream.outputs[i] == oracles[i], i
            assert sock_stream.outputs[i] == thread_stream.outputs[i], i
        # everything durable lives under the object root: entries +
        # commit records, with the session's transient rpc: payloads
        # purged at close (asserted after close below)
        store = backend.store
        assert any(k.startswith("rpc:") for k in store.committed_keys())
    finally:
        mgr.close()
    try:
        purged = [k for k in backend.store.committed_keys()
                  if k.startswith("rpc:")]
        assert purged == []
    finally:
        backend.cleanup()


def test_worker_ids_sticky_and_tombstones_expire_from_view(tmp_path):
    """White-box: after a reconnect the handle keeps its wid and the
    orphaned leases appear ONLY on a negative tombstone row (never on the
    live row) — the invariant that keeps prove-liveness heartbeats from
    sheltering abandoned work."""
    mgr = _mk_socket_manager(tmp_path, 2, enable_backup_tasks=False)
    backend = mgr.backend
    try:
        wids = sorted(w for w in backend.heartbeat_view() if w >= 0)
        assert wids == [0, 1]
        assert backend.disconnect(wids[0])
        _wait_for(
            lambda: backend.stats()["leader"]["reconnects"] >= 1,
            20, "reconnect",
        )
        _wait_for(
            lambda: sorted(
                w for w, st in backend.heartbeat_view().items()
                if w >= 0 and st.alive
            ) == wids,
            20, "same ids after reconnect",
        )
        view = backend.heartbeat_view()
        for wid, st in view.items():
            if wid < 0:  # tombstone rows are dead by construction
                assert not st.alive
        pids = backend.worker_pids()
        assert len(pids) == 2 and all(isinstance(p, int) for p in pids)
    finally:
        mgr.close()
        backend.cleanup()
