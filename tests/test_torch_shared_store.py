"""The reference's tests/test_shared_store.py re-targeted at ``repro_torch`` (the
import root renamed; the study generator is ``test_torch_study_gen``).

Crash-safe, cross-process SharedStore suite.

Covers the on-disk protocol of DESIGN.md §12: atomic tmp+rename writes (a
killed writer leaves no readable garbage), footer-verified loads with
quarantine-on-corrupt (a poisoned directory self-heals by recomputing),
per-key file locks + manifest (no double-writes across processes), the
Manager.forget deferred-release fix, and the fleet acceptance: two
StudyDriver processes pooling one store directory produce bit-identical SA
indices to the single-process run with strictly fewer combined tasks than
two independent studies — and zero corrupt-entry reads after a mid-write
kill is injected.
"""

import json
import multiprocessing
import os
import pathlib
import threading
import time

import numpy as np
import pytest

from repro_torch.core import ParamSpace, StageSpec, TaskSpec, Workflow
from repro_torch.runtime.manager import Manager, WorkItem
from repro_torch.runtime.storage import HierarchicalStore, SharedStore, stable_key
from repro_torch.study import StudyDriver, run_fleet_study
from repro_torch.study.state import StudyState

# ---------------------------------------------------------------------------
# Spawn-picklable helpers (must be module-level: fleet workers re-import
# this module in a fresh interpreter)
# ---------------------------------------------------------------------------

WEIGHTS = (8.0, 0.0, 2.0, 0.01)
SPACE_DICT = {f"p{i}": [0.0, 1.0, 2.0, 3.0] for i in range(4)}
SPACE = ParamSpace.from_dict(SPACE_DICT)


def tiny_build():
    """Fleet ``build`` for the 2-stage synthetic workflow used across the
    driver tests: param-free norm (×2) then 4 seg tasks adding w_i·p_i."""

    def make_fn(i):
        def fn(x, **kw):
            return x + WEIGHTS[i] * sum(kw.values())

        return fn

    norm = StageSpec(
        name="norm",
        tasks=(TaskSpec("normalize", (), fn=lambda x: x * 2.0, cost=1.0,
                        output_bytes=8),),
    )
    seg = StageSpec(
        name="seg",
        tasks=tuple(
            TaskSpec(name=f"seg_t{i}", param_names=(f"p{i}",), fn=make_fn(i),
                     cost=1.0, output_bytes=64)
            for i in range(4)
        ),
    )
    return {
        "workflow": Workflow(stages=(norm, seg)),
        "space": SPACE,
        "inputs": [1.0],
        "objective": lambda out, i: float(out),
    }


def _stress_writer(store_dir: str, writer: int, n_keys: int, n_iters: int) -> None:
    """Hammer one store directory with overlapping keys; record what this
    process observed into a per-writer report file."""
    store = SharedStore(1 << 20, disk_dir=store_dir, writer_id=f"w{writer}")
    bad_reads = 0
    for it in range(n_iters):
        for k in range(n_keys):
            key = f"stress:{k}"
            value = np.full((64,), float(k), np.float32)
            store.put(key, value)
            store.persist(key)
            got = store.get(key)
            if got is None or not np.array_equal(np.asarray(got), value):
                bad_reads += 1
    report = {
        "bad_reads": bad_reads,
        "corrupt": store.corrupt,
        "dedup_writes": store.dedup_writes,
    }
    out = pathlib.Path(store_dir) / f"report_w{writer}.json"
    out.write_text(json.dumps(report))


def _killed_writer(store_dir: str, kill_on: int) -> None:
    """Write entries until the ``kill_on``-th disk write, then die between
    tmp-write and rename — the torn-write window a SIGKILL lands in."""
    store = SharedStore(1 << 20, disk_dir=store_dir, writer_id="victim")
    writes = {"n": 0}

    def fault(tmp_path):
        writes["n"] += 1
        if writes["n"] >= kill_on:
            os._exit(42)  # hard kill: no cleanup, tmp file left behind

    store.fault_after_tmp_write = fault
    for k in range(kill_on + 5):
        store.put(f"victim:{k}", np.full((32,), float(k), np.float32))
        store.persist(f"victim:{k}")
    os._exit(0)  # unreachable when kill_on fires


# ---------------------------------------------------------------------------
# Atomic writes
# ---------------------------------------------------------------------------


class TestAtomicWrites:
    def test_crash_between_tmp_and_rename_leaves_no_entry(self, tmp_path):
        """The satellite bugfix: np.savez used to write in place, so a
        mid-write crash left a truncated entry. Now the final name appears
        only via os.replace — a fault before the rename leaves nothing."""
        store = HierarchicalStore(1 << 20, disk_dir=str(tmp_path))

        def boom(tmp):
            raise RuntimeError("simulated kill")

        store.fault_after_tmp_write = boom
        store.put("k", np.arange(32, dtype=np.float32))
        with pytest.raises(RuntimeError, match="simulated kill"):
            store.persist("k")

        reopened = HierarchicalStore(1 << 20, disk_dir=str(tmp_path))
        assert not reopened.contains("k")
        assert reopened.get("k") is None
        assert reopened.corrupt == 0  # orphan tmp is ignored, not corrupt
        assert list(tmp_path.glob("*.tmp"))  # the orphan is still there

        # recompute-on-miss: a clean rewrite publishes normally
        store.fault_after_tmp_write = None
        store.persist("k")
        fresh = HierarchicalStore(1 << 20, disk_dir=str(tmp_path))
        np.testing.assert_array_equal(
            np.asarray(fresh.get("k")), np.arange(32, dtype=np.float32)
        )

    def test_rewrite_over_existing_entry_is_atomic(self, tmp_path):
        store = HierarchicalStore(1 << 20, disk_dir=str(tmp_path))
        store.put("k", np.zeros(8, np.float32))
        store.persist("k")

        def boom(tmp):
            raise RuntimeError("kill")

        store.fault_after_tmp_write = boom
        with pytest.raises(RuntimeError):
            store.persist("k")
        # the previous complete entry survives the torn rewrite
        reopened = HierarchicalStore(1 << 20, disk_dir=str(tmp_path))
        np.testing.assert_array_equal(
            np.asarray(reopened.get("k")), np.zeros(8, np.float32)
        )
        assert reopened.corrupt == 0


# ---------------------------------------------------------------------------
# Corruption detection + quarantine
# ---------------------------------------------------------------------------


class TestCorruptionQuarantine:
    def _entry_path(self, tmp_path, key):
        return tmp_path / f"{stable_key(key)}.npz"

    def _poisoned_store(self, tmp_path, mutate):
        store = HierarchicalStore(1 << 20, disk_dir=str(tmp_path))
        store.put("k", np.arange(64, dtype=np.float32))
        store.persist("k")
        path = self._entry_path(tmp_path, "k")
        mutate(path)
        return HierarchicalStore(1 << 20, disk_dir=str(tmp_path))

    @pytest.mark.parametrize(
        "mutate",
        [
            pytest.param(lambda p: p.write_bytes(b""), id="zero-byte"),
            pytest.param(
                lambda p: p.write_bytes(p.read_bytes()[: p.stat().st_size // 2]),
                id="truncated",
            ),
            pytest.param(lambda p: p.write_bytes(b"garbage" * 100), id="garbage"),
        ],
    )
    def test_bad_entry_is_a_miss_and_quarantined(self, tmp_path, mutate):
        reopened = self._poisoned_store(tmp_path, mutate)
        assert reopened.get("k") is None
        assert reopened.misses == 1
        assert reopened.corrupt == 1
        assert not self._entry_path(tmp_path, "k").exists()  # moved aside
        assert list((tmp_path / "quarantine").iterdir())
        # self-heal: recompute-on-miss republishes a valid entry
        reopened.put("k", np.arange(64, dtype=np.float32))
        reopened.persist("k")
        fresh = HierarchicalStore(1 << 20, disk_dir=str(tmp_path))
        assert fresh.contains("k")
        np.testing.assert_array_equal(
            np.asarray(fresh.get("k")), np.arange(64, dtype=np.float32)
        )
        assert fresh.corrupt == 0

    def test_bitflip_fails_sha_check(self, tmp_path):
        def flip(p):
            data = bytearray(p.read_bytes())
            data[len(data) // 3] ^= 0xFF
            p.write_bytes(bytes(data))

        reopened = self._poisoned_store(tmp_path, flip)
        assert reopened.get("k") is None
        assert reopened.corrupt == 1

    def test_contains_does_not_trust_exists(self, tmp_path):
        """The satellite bugfix: contains() used to be path.exists(), so a
        torn entry read as present and the later np.load crashed."""
        reopened = self._poisoned_store(tmp_path, lambda p: p.write_bytes(b""))
        assert self._entry_path(tmp_path, "k").exists()  # the torn entry IS there
        assert not reopened.contains("k")
        assert reopened.corrupt == 1
        assert not self._entry_path(tmp_path, "k").exists()  # quarantined

    def test_legacy_footerless_entry_still_resumes(self, tmp_path):
        """Migration: entries written before the footer protocol (plain
        np.savez, no footer) must still load — np.load is their verifier —
        so a pre-footer store directory resumes with zero recomputation
        and zero corrupt counts."""
        value = np.arange(24, dtype=np.float32)
        legacy = tmp_path / f"{stable_key('old')}.npz"
        np.savez(legacy, __value__=value)  # the old in-place write format
        store = HierarchicalStore(1 << 20, disk_dir=str(tmp_path))
        assert store.contains("old")
        np.testing.assert_array_equal(np.asarray(store.get("old")), value)
        assert store.corrupt == 0 and store.disk_hits == 1

    def test_torn_legacy_entry_is_corrupt(self, tmp_path):
        value = np.arange(512, dtype=np.float32)
        legacy = tmp_path / f"{stable_key('old')}.npz"
        np.savez(legacy, __value__=value)
        legacy.write_bytes(legacy.read_bytes()[: legacy.stat().st_size // 2])
        store = HierarchicalStore(1 << 20, disk_dir=str(tmp_path))
        assert store.get("old") is None
        assert store.corrupt == 1

    def test_valid_entries_unaffected_by_neighbor_corruption(self, tmp_path):
        store = HierarchicalStore(1 << 20, disk_dir=str(tmp_path))
        store.put("good", np.ones(16, np.float32))
        store.put("bad", np.ones(16, np.float32))
        store.persist_all()
        (tmp_path / f"{stable_key('bad')}.npz").write_bytes(b"x")
        reopened = HierarchicalStore(1 << 20, disk_dir=str(tmp_path))
        np.testing.assert_array_equal(
            np.asarray(reopened.get("good")), np.ones(16, np.float32)
        )
        assert reopened.get("bad") is None
        assert reopened.corrupt == 1


# ---------------------------------------------------------------------------
# SharedStore: locks + manifest
# ---------------------------------------------------------------------------


class TestSharedStore:
    def test_manifest_records_commits_last_writer_wins(self, tmp_path):
        s1 = SharedStore(1 << 20, disk_dir=str(tmp_path), writer_id="w1")
        s1.put("a", np.ones(8, np.float32))
        s1.put("b", np.zeros(8, np.float32))
        s1.persist_all()
        assert s1.committed_keys() == {"a", "b"}
        records = s1.manifest_records()
        assert records["a"]["writer"] == "w1"
        assert records["a"]["sha"] == stable_key("a")

    def test_second_writer_skips_committed_entry(self, tmp_path):
        s1 = SharedStore(1 << 20, disk_dir=str(tmp_path), writer_id="w1")
        s1.put("x", np.ones(8, np.float32))
        s1.persist("x")
        s2 = SharedStore(1 << 20, disk_dir=str(tmp_path), writer_id="w2")
        s2.put("x", np.ones(8, np.float32))
        s2.persist("x")
        assert s2.dedup_writes == 1
        # one manifest record: the dedup'd write never appended
        assert [r["writer"] for r in s2.manifest_records().values()] == ["w1"]

    def test_torn_manifest_line_is_skipped(self, tmp_path):
        s1 = SharedStore(1 << 20, disk_dir=str(tmp_path), writer_id="w1")
        s1.put("a", np.ones(8, np.float32))
        s1.persist("a")
        with open(tmp_path / "manifest.jsonl", "a") as f:
            f.write('{"key": "torn-half')  # killed appender
        s2 = SharedStore(1 << 20, disk_dir=str(tmp_path))
        assert s2.committed_keys() == {"a"}

    def test_append_after_truncated_tail_does_not_poison_replay(self, tmp_path):
        """Crash mid-append leaves a partial final line WITHOUT a newline;
        the next writer's append must repair the tail (terminate the torn
        line) instead of concatenating onto it — otherwise the torn bytes
        swallow the NEW record and replay loses a committed key."""
        s1 = SharedStore(1 << 20, disk_dir=str(tmp_path), writer_id="w1")
        s1.put("a", np.ones(8, np.float32))
        s1.persist("a")
        manifest = tmp_path / "manifest.jsonl"
        with open(manifest, "a") as f:
            f.write('{"key": "torn-half')  # killed mid-append, no newline
        s2 = SharedStore(1 << 20, disk_dir=str(tmp_path), writer_id="w2")
        s2.put("b", np.zeros(8, np.float32))
        s2.persist("b")
        assert s2.committed_keys() == {"a", "b"}
        records = s2.manifest_records()
        assert records["b"]["writer"] == "w2"
        # replay across a fresh mount agrees (the repair is on disk)
        s3 = SharedStore(1 << 20, disk_dir=str(tmp_path))
        assert s3.committed_keys() == {"a", "b"}
        # the torn line was terminated, not extended: three distinct lines,
        # with the partial one isolated in the middle
        lines = manifest.read_text().splitlines()
        assert len(lines) == 3
        assert lines[1] == '{"key": "torn-half'

    def test_quarantined_entry_recommitted_after_recompute(self, tmp_path):
        s1 = SharedStore(1 << 20, disk_dir=str(tmp_path), writer_id="w1")
        s1.put("x", np.ones(8, np.float32))
        s1.persist("x")
        (tmp_path / f"{stable_key('x')}.npz").write_bytes(b"")
        s2 = SharedStore(1 << 20, disk_dir=str(tmp_path), writer_id="w2")
        assert s2.get("x") is None and s2.corrupt == 1
        s2.put("x", np.ones(8, np.float32))
        s2.persist("x")  # entry gone from disk -> real rewrite, new manifest row
        assert s2.manifest_records()["x"]["writer"] == "w2"
        s3 = SharedStore(1 << 20, disk_dir=str(tmp_path))
        np.testing.assert_array_equal(
            np.asarray(s3.get("x")), np.ones(8, np.float32)
        )

    def test_torn_legacy_entry_repaired_on_write(self, tmp_path):
        """A torn pre-footer file under a key's final name must not block
        the commit of a freshly recomputed value: the write-path probe is
        strict (footer required), so the torn bytes are overwritten."""
        torn = tmp_path / f"{stable_key('x')}.npz"
        torn.write_bytes(b"half-an-old-npz-archive" * 4)  # >= footer size
        s = SharedStore(1 << 20, disk_dir=str(tmp_path), writer_id="w1")
        s.put("x", np.ones(8, np.float32))
        s.persist("x")
        assert s.dedup_writes == 0  # torn entry did NOT read as committed
        assert s.committed_keys() == {"x"}
        fresh = SharedStore(1 << 20, disk_dir=str(tmp_path))
        np.testing.assert_array_equal(
            np.asarray(fresh.get("x")), np.ones(8, np.float32)
        )
        assert fresh.corrupt == 0

    def test_repeated_flush_skips_own_committed_entries(self, tmp_path):
        """persist_all is called once per fleet round; already-committed
        entries are skipped via the persisted-keys fast path and are NOT
        counted as dedup_writes (that counter means a PEER won the race)."""
        s = SharedStore(1 << 20, disk_dir=str(tmp_path), writer_id="w1")
        for i in range(4):
            s.put(f"k{i}", np.full((8,), i, np.float32))
        s.persist_all()
        s.persist_all()
        s.persist_all()
        assert s.dedup_writes == 0
        assert len(s.manifest_records()) == 4

    def test_intra_process_writer_threads_exclude_each_other(self, tmp_path):
        """flock is taken on a fresh fd per write, so two stores in ONE
        process (threads) also serialise on a key."""
        stores = [
            SharedStore(1 << 20, disk_dir=str(tmp_path), writer_id=f"t{i}")
            for i in range(2)
        ]
        errs = []

        def work(s):
            try:
                for it in range(20):
                    s.put("hot", np.full((128,), it, np.float32))
                    s.persist("hot")
                    assert s.get("hot") is not None
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        threads = [threading.Thread(target=work, args=(s,)) for s in stores]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert errs == []
        fresh = SharedStore(1 << 20, disk_dir=str(tmp_path))
        assert fresh.get("hot") is not None and fresh.corrupt == 0

    def test_two_process_stress_no_corrupt_reads(self, tmp_path):
        """Acceptance: two processes hammering one directory with
        overlapping keys — every read sees a complete entry, zero corrupt."""
        ctx = multiprocessing.get_context("spawn")
        procs = [
            ctx.Process(target=_stress_writer, args=(str(tmp_path), i, 8, 4))
            for i in range(2)
        ]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=120)
            assert p.exitcode == 0
        reports = [
            json.loads((tmp_path / f"report_w{i}.json").read_text())
            for i in range(2)
        ]
        assert all(r["bad_reads"] == 0 for r in reports)
        assert all(r["corrupt"] == 0 for r in reports)
        # and the directory is fully readable afterwards
        fresh = SharedStore(1 << 20, disk_dir=str(tmp_path))
        for k in range(8):
            got = fresh.get(f"stress:{k}")
            np.testing.assert_array_equal(
                np.asarray(got), np.full((64,), float(k), np.float32)
            )
        assert fresh.corrupt == 0

    def test_killed_writer_mid_write_poisons_nothing(self, tmp_path):
        """Acceptance: kill a writer in the tmp-write→rename window, reopen
        the directory — zero corrupt reads, the unpublished key is a miss
        (recompute-on-miss), every previously-committed key still loads."""
        ctx = multiprocessing.get_context("spawn")
        p = ctx.Process(target=_killed_writer, args=(str(tmp_path), 5))
        p.start()
        p.join(timeout=120)
        assert p.exitcode == 42  # died inside the torn-write window
        assert list(tmp_path.glob("*.tmp"))  # the torn write's leftover

        fresh = SharedStore(1 << 20, disk_dir=str(tmp_path))
        served = 0
        for k in range(10):
            got = fresh.get(f"victim:{k}")
            if got is not None:
                served += 1
                np.testing.assert_array_equal(
                    np.asarray(got), np.full((32,), float(k), np.float32)
                )
        assert fresh.corrupt == 0  # zero corrupt-entry reads
        assert served < 10  # the in-flight write (and later ones) are misses
        # manifest agrees with what is actually readable
        assert len(fresh.committed_keys()) == served


# ---------------------------------------------------------------------------
# Manager.forget deferred release (satellite bugfix)
# ---------------------------------------------------------------------------


class TestForgetLeasedKeys:
    def test_forget_while_leased_releases_after_settle(self):
        release = threading.Event()
        entered = threading.Event()

        def slow():
            entered.set()
            release.wait(10)
            return "v"

        mgr = Manager(enable_backup_tasks=False)
        mgr.start(1)
        try:
            mgr.submit(WorkItem(key="slow", fn=slow))
            assert entered.wait(5)  # the lease is now held
            mgr.forget(["slow"])
            with mgr._lock:
                assert "slow" in mgr._deferred_forget
            release.set()
            mgr.drain()
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline:
                with mgr._lock:
                    if (
                        not mgr._results
                        and not mgr._attempt_seq
                        and not mgr._deferred_forget
                    ):
                        break
                time.sleep(0.01)
            assert mgr.results() == {}
            with mgr._lock:
                assert mgr._attempt_seq == {}
                assert mgr._callbacks == {}
                assert mgr._deferred_forget == set()
        finally:
            release.set()
            mgr.close()

    def test_forget_settled_keys_still_immediate(self):
        mgr = Manager(enable_backup_tasks=False)
        mgr.start(1)
        try:
            mgr.submit(WorkItem(key="a", fn=lambda: 1))
            mgr.drain()
            assert mgr.results() == {"a": 1}
            mgr.forget(["a"])
            assert mgr.results() == {}
            with mgr._lock:
                assert mgr._attempt_seq == {}
        finally:
            mgr.close()


# ---------------------------------------------------------------------------
# Fleet study acceptance
# ---------------------------------------------------------------------------


def _single_process_state(max_rounds):
    build = tiny_build()
    driver = StudyDriver(
        build["workflow"], build["space"], build["inputs"],
        objective=build["objective"], seed=13, n_boot=16,
    )
    try:
        return driver.run(max_rounds=max_rounds)
    finally:
        driver.close()


class TestFleetStudy:
    MAX_ROUNDS = 3

    def test_fleet_bit_identical_and_strictly_fewer_combined_tasks(
        self, tmp_path
    ):
        """Acceptance: two StudyDriver processes pooling one store
        directory — bit-identical SA indices to the single-process run,
        strictly fewer combined tasks than 2 independent studies, zero
        corrupt reads."""
        single = _single_process_state(self.MAX_ROUNDS)
        fleet_state, fleet = run_fleet_study(
            tiny_build,
            n_procs=2,
            store_dir=str(tmp_path / "store"),
            max_rounds=self.MAX_ROUNDS,
            seed=13,
            n_boot=16,
        )
        # bit-identical objectives and SA indices, round by round
        assert fleet_state.evaluated == single.evaluated
        assert len(fleet_state.rounds) == len(single.rounds)
        for fr, sr in zip(fleet_state.rounds, single.rounds):
            assert fr.kind == sr.kind
            assert fr.param_sets == sr.param_sets
            assert fr.outputs == sr.outputs  # bit-identical objectives
            assert fr.analysis == sr.analysis  # bit-identical indices
            assert fr.decision == sr.decision
        assert fleet_state.active == single.active
        assert fleet_state.best == single.best

        # strictly fewer combined tasks than 2 independent studies
        independent_total = 2 * single.tasks_executed
        assert 0 < fleet["tasks_executed"] < independent_total

        # zero corrupt-entry reads anywhere in the fleet
        assert fleet["corrupt"] == 0
        assert fleet["committed_keys"] > 0

    def test_fleet_on_a_directory_with_an_injected_mid_write_kill(
        self, tmp_path
    ):
        """Acceptance tail: inject a mid-write kill into the store dir
        FIRST, then run the fleet on the poisoned directory — it completes
        with zero corrupt reads and the same results (self-heal by
        recompute)."""
        store_dir = tmp_path / "store"
        store_dir.mkdir()
        ctx = multiprocessing.get_context("spawn")
        p = ctx.Process(target=_killed_writer, args=(str(store_dir), 2))
        p.start()
        p.join(timeout=120)
        assert p.exitcode == 42
        assert list(store_dir.glob("*.tmp"))

        single = _single_process_state(2)
        fleet_state, fleet = run_fleet_study(
            tiny_build,
            n_procs=2,
            store_dir=str(store_dir),
            max_rounds=2,
            seed=13,
            n_boot=16,
        )
        assert fleet["corrupt"] == 0
        assert fleet_state.evaluated == single.evaluated
        for fr, sr in zip(fleet_state.rounds, single.rounds):
            assert fr.outputs == sr.outputs and fr.analysis == sr.analysis

    def test_fleet_round_records_account_all_shards(self, tmp_path):
        fleet_state, fleet = run_fleet_study(
            tiny_build,
            n_procs=2,
            store_dir=str(tmp_path / "store"),
            max_rounds=2,
            seed=13,
            n_boot=16,
        )
        assert fleet_state.tasks_executed == fleet["tasks_executed"]
        for r in fleet_state.rounds:
            assert r.n_proposed > 0
            assert r.tasks_executed >= 0
        # the leader state checkpoints like any StudyState
        ckpt = tmp_path / "state.json"
        fleet_state.save(str(ckpt))
        st2 = StudyState.load(str(ckpt))
        assert st2.evaluated == fleet_state.evaluated
        assert st2.ledger.to_list() == fleet_state.ledger.to_list()


# ---------------------------------------------------------------------------
# Lock-discipline regressions: disk I/O must not run under the
# store lock. These pin the behavior the static analyzer flagged — a slow
# disk probe or unlink must never stall RAM-tier readers on other threads.
# ---------------------------------------------------------------------------


class _GatedDiskStore(HierarchicalStore):
    """HierarchicalStore whose disk presence probe blocks on an event —
    models a slow/contended filesystem (NFS stall, flocked quarantine)."""

    def __init__(self, tmp):
        super().__init__(1 << 20, disk_dir=str(tmp))
        self.probe_entered = threading.Event()
        self.probe_gate = threading.Event()

    def _disk_entry_ok(self, path):
        self.probe_entered.set()
        assert self.probe_gate.wait(10), "probe gate never released"
        return False


class TestStoreLockDiscipline:
    def test_slow_disk_probe_does_not_stall_ram_tier(self, tmp_path):
        """contains() used to hold the store lock across the disk probe:
        one slow footer read serialized every put/get in the process."""
        store = _GatedDiskStore(tmp_path / "store")
        t = threading.Thread(target=store.contains, args=("absent-key",))
        t.start()
        try:
            assert store.probe_entered.wait(10)
            # the probe is parked mid-I/O; the RAM tier must stay live
            t0 = time.monotonic()
            store.put("hot", np.arange(4))
            assert store.get("hot") is not None
            assert store.counters()["hits"] == 1
            assert time.monotonic() - t0 < 5.0, (
                "RAM-tier ops blocked behind the disk probe: contains() is "
                "holding the store lock across disk I/O again"
            )
        finally:
            store.probe_gate.set()
            t.join(10)
        assert not t.is_alive()

    def test_delete_removes_both_tiers(self, tmp_path):
        store = HierarchicalStore(1 << 20, disk_dir=str(tmp_path / "store"))
        store.put("k", np.arange(8))
        store.persist_all()
        assert store.contains("k")
        store.delete("k")
        assert not store.contains("k")
        assert store.get("k") is None
        # idempotent: a second delete of a gone key is a no-op, not an error
        store.delete("k")
