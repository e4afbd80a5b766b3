"""The reference's tests/test_service.py re-targeted at ``repro_torch`` (the
import root renamed; the study generator is ``test_torch_study_gen``), and
the port's service held to the reference's on the same studies.

SA-as-a-service suite (DESIGN.md §18).

Acceptance scenario and unit coverage for the multi-tenant study server:

* **bit-identical** — a job's objective vector equals the naive oracle
  computed outside the service (exact integer workloads, `==` not ≈);
* **executes once** — two tenants submitting equal-signature specs
  concurrently share one execution (combined dispatch < sum asserted);
* **cross-tenant reuse** — an overlapping later spec reuses the shared
  ResultCache (fewer misses than a standalone run of the same plan);
* **cancellation** — cancelling one tenant's job mid-study frees its
  queued work without perturbing the other tenant's results;
* **fair share** — a low-weight tenant's small job completes while a
  heavy tenant's backlog is still draining (monotonic progress, no
  starvation), plus FairQueue unit laws;
* **quotas, wire protocol, timeouts, idle-pool accounting.**

Added for the port: ``StudySpec.signature`` gives the reference's digest
for every sampler, and the pathology service
(``pathology_service_build`` at 32², two tiles, on the CPU) gives the
reference service's signatures, objectives, task and cache counts and
dispatch counts with ``==``. The JAX package is imported inside those
tests only.
"""

import gc
import threading
import time

import pytest
import torch

from repro_torch.core.params import ParamSpace
from repro_torch.engine import ClusterSpec, ResultCache, execute_study, plan_study
from repro_torch.engine.streaming import study_task_keys
from repro_torch.runtime import Manager, WorkItem
from repro_torch.runtime.fairshare import FairQueue
from repro_torch.service import (
    QuotaExceeded,
    ServiceClient,
    ServiceError,
    SpecError,
    StudyServer,
    StudySpec,
    TenantQuota,
)

from test_torch_study_gen import naive_outputs, sleep_workflow, workflow_from_layout

pytestmark = pytest.mark.filterwarnings("ignore::ResourceWarning")


# ---------------------------------------------------------------------------
# Fixtures: fast integer-mixing service + a sleepy one for race windows
# ---------------------------------------------------------------------------

_LAYOUT = [
    [("s0t0", ("a",), 1.0, 64), ("s0t1", ("b",), 1.0, 64)],
    [("s1t0", ("c", "d"), 1.0, 64)],
]
_SPACE = ParamSpace.from_dict(
    {"a": [0, 1, 2], "b": [0, 1, 2], "c": [0, 1], "d": [0, 1, 2]}
)
_INPUTS = [3, 8]

_SLEEP_SPACE = ParamSpace.from_dict(
    {"sp0": [0, 1, 2, 3], "sp1": [0, 1, 2, 3]}
)


def _int_objective(leaf, input_index):
    return float(leaf % 997)


def _oracle_objective(workflow, runs, inputs):
    """Expected per-run objective vector, straight-line, outside the
    engine entirely."""
    per_input = [naive_outputs(workflow, runs, x) for x in inputs]
    return [
        sum(_int_objective(per_input[i][rid], i) for i in range(len(inputs)))
        / len(inputs)
        for rid in range(len(runs))
    ]


@pytest.fixture
def server():
    srv = StudyServer(
        workflow=workflow_from_layout(_LAYOUT),
        space=_SPACE,
        inputs=_INPUTS,
        objective=_int_objective,
        n_workers=2,
    )
    yield srv
    srv.close()


@pytest.fixture
def sleepy_server():
    srv = StudyServer(
        workflow=sleep_workflow([0.03, 0.03]),
        space=_SLEEP_SPACE,
        inputs=[5],
        objective=_int_objective,
        n_workers=2,
    )
    yield srv
    srv.close()


# ---------------------------------------------------------------------------
# StudySpec: validation, wire form, signature semantics
# ---------------------------------------------------------------------------


def test_spec_validation_rejects_bad_specs():
    for bad in [
        StudySpec(sampler="nope"),
        StudySpec(sampler="explicit", param_sets=None),
        StudySpec(policy="nope"),
        StudySpec(priority=99),
        StudySpec(sampler="moat", n_trajectories=0),
        StudySpec(bounds={"ghost": [1]}),
        StudySpec(bounds={"a": []}),
        StudySpec(sampler="explicit", param_sets=[{"ghost": 1}]),
        StudySpec(sampler="grid", names=["ghost"]),
    ]:
        with pytest.raises(SpecError):
            bad.resolve(_SPACE)


def test_spec_wire_form_roundtrip_and_unknown_fields():
    spec = StudySpec(
        sampler="grid", names=["a", "c"], bounds={"a": [0, 2]}, priority=3
    )
    assert StudySpec.from_json(spec.to_json()) == spec
    with pytest.raises(SpecError):
        StudySpec.from_json({"sampler": "grid", "warp_speed": 9})


def test_spec_resolution_fills_defaults_and_caps_runs():
    runs = StudySpec(
        sampler="explicit", param_sets=[{"a": 2}, {"a": 1, "d": 2}]
    ).resolve(_SPACE)
    defaults = dict(_SPACE.default())
    assert dict(runs[0])["a"] == 2
    assert dict(runs[0])["b"] == defaults["b"]
    assert dict(runs[1])["d"] == 2
    # grid over bounded sub-space
    grid = StudySpec(sampler="grid", names=["a", "c"], bounds={"a": [0, 1]})
    assert len(grid.resolve(_SPACE)) == 2 * 2
    # the run-count guardrail fires before anything is planned
    wide = ParamSpace.from_dict({f"w{i}": list(range(10)) for i in range(5)})
    with pytest.raises(SpecError):
        StudySpec(sampler="grid").resolve(wide)


def test_spec_signature_content_addressing():
    base = StudySpec(sampler="grid", names=["a", "b"])
    same_work = StudySpec(
        sampler="grid", names=["a", "b"], priority=5, timeout_s=9.0,
        metrics=["objective", "per_input"], poll_s=1.0,
    )
    # dispatch-only fields do not change WHAT is computed
    assert base.signature(_SPACE) == same_work.signature(_SPACE)
    for different in [
        StudySpec(sampler="grid", names=["a", "c"]),
        StudySpec(sampler="grid", names=["a", "b"], policy="rmsr"),
        StudySpec(sampler="grid", names=["a", "b"], bounds={"a": [0, 1]}),
        StudySpec(sampler="grid", names=["a", "b"], max_bucket_size=2),
    ]:
        assert base.signature(_SPACE) != different.signature(_SPACE)
    # explicit spec listing the same runs the grid denotes = same work
    grid_runs = base.resolve(_SPACE)
    explicit = StudySpec(
        sampler="explicit", param_sets=[dict(ps) for ps in grid_runs]
    )
    assert explicit.signature(_SPACE) == base.signature(_SPACE)


# ---------------------------------------------------------------------------
# The job API: results bit-identical to the oracle
# ---------------------------------------------------------------------------


def test_job_lifecycle_and_bit_identical_objective(server):
    spec = StudySpec(
        sampler="explicit",
        param_sets=[{"a": 0, "b": 1}, {"a": 2, "c": 1, "d": 2}, {}],
        metrics=["objective", "per_input"],
    )
    job = server.submit("alice", spec)
    assert job == "alice/j0"
    snap = server.result(job, wait=True, timeout=120)
    assert snap["state"] == "DONE"
    assert snap["done_tasks"] == snap["total_tasks"] > 0

    runs = spec.resolve(_SPACE)
    expected = _oracle_objective(workflow_from_layout(_LAYOUT), runs, _INPUTS)
    assert snap["result"]["objective"] == expected  # exact, not approx
    assert len(snap["result"]["per_input"]) == len(runs)
    assert snap["result"]["n_inputs"] == len(_INPUTS)
    # the registry released every key at job end
    assert server.registry.stats()["live_keys"] == 0
    jobs = server.list_jobs("alice")
    assert [j["job_id"] for j in jobs] == [job]


def test_identical_specs_execute_once_combined_lt_sum(sleepy_server):
    srv = sleepy_server
    mgr = srv.manager
    # Baseline: one tenant alone, a same-shape different-signature spec.
    warm = StudySpec(sampler="grid", bounds={"sp0": [0, 1], "sp1": [0, 1]})
    d0 = sum(mgr.dispatch_counts.values())
    assert srv.result(
        srv.submit("alice", warm), wait=True, timeout=120
    )["state"] == "DONE"
    single = sum(mgr.dispatch_counts.values()) - d0
    assert single > 0

    # Two tenants, equal signature, concurrent: one execution, two jobs.
    spec = StudySpec(sampler="grid", bounds={"sp0": [2, 3], "sp1": [2, 3]})
    d1 = sum(mgr.dispatch_counts.values())
    ja = srv.submit("alice", spec)
    jb = srv.submit("bob", spec)
    ra = srv.result(ja, wait=True, timeout=120)
    rb = srv.result(jb, wait=True, timeout=120)
    combined = sum(mgr.dispatch_counts.values()) - d1
    assert ra["state"] == "DONE" and rb["state"] == "DONE"
    assert ra["result"]["objective"] == rb["result"]["objective"]
    assert ra["signature"] == rb["signature"]
    # the tentpole claim: combined tasks < sum of independent submissions
    assert combined < 2 * single, (combined, single)


def test_overlapping_specs_reuse_shared_cache(server):
    rows_a = [{"a": i, "b": 0} for i in range(3)]
    rows_b = [{"a": i, "b": 0} for i in range(2)] + [{"a": 0, "b": 1}]
    spec_a = StudySpec(sampler="explicit", param_sets=rows_a)
    spec_b = StudySpec(sampler="explicit", param_sets=rows_b)
    assert spec_a.signature(_SPACE) != spec_b.signature(_SPACE)

    assert server.result(
        server.submit("alice", spec_a), wait=True, timeout=120
    )["state"] == "DONE"
    misses_before = server.cache.misses
    hits_before = server.cache.hits
    rb = server.result(server.submit("bob", spec_b), wait=True, timeout=120)
    assert rb["state"] == "DONE"
    service_misses = server.cache.misses - misses_before

    # Standalone: the same plan against a COLD cache.
    runs_b = spec_b.resolve(_SPACE)
    plan_b = plan_study(
        server.workflow, runs_b, cluster=server.cluster,
        policy=spec_b.policy, active_paths=spec_b.active_paths,
    )
    cold = ResultCache(1 << 20)
    stream = execute_study(
        plan_b, _INPUTS, cluster=ClusterSpec(n_workers=2), cache=cold,
        input_keys=server.input_keys,
    )
    # bit-identical across the reuse boundary, and cheaper than standalone
    assert rb["result"]["objective"] == _oracle_objective(
        server.workflow, runs_b, _INPUTS
    )
    assert stream.cache_misses == cold.misses
    assert service_misses < cold.misses, (service_misses, cold.misses)
    assert server.cache.hits > hits_before


# ---------------------------------------------------------------------------
# Cancellation: frees the pool without perturbing the other tenant
# ---------------------------------------------------------------------------


def test_cancel_mid_study_leaves_other_tenant_unperturbed(sleepy_server):
    srv = sleepy_server
    big = StudySpec(sampler="grid")  # 16 runs of sleepy tasks
    small = StudySpec(
        sampler="explicit",
        param_sets=[{"sp0": 0, "sp1": 0}, {"sp0": 1, "sp1": 1}],
    )
    ja = srv.submit("hog", big)
    jb = srv.submit("mouse", small)
    # let the big job actually get airborne, then revoke it
    deadline = time.monotonic() + 30
    while srv.status(ja)["state"] == "QUEUED":
        assert time.monotonic() < deadline
        time.sleep(0.005)
    time.sleep(0.05)
    cancelled_snap = srv.cancel(ja)
    assert cancelled_snap["state"] in ("RUNNING", "CANCELLED")

    ra = srv.result(ja, wait=True, timeout=60)
    rb = srv.result(jb, wait=True, timeout=120)
    assert ra["state"] == "CANCELLED"
    assert ra["result"] is None
    # the other tenant's study is untouched — exact oracle agreement
    assert rb["state"] == "DONE"
    assert rb["result"]["objective"] == _oracle_objective(
        srv.workflow, small.resolve(_SLEEP_SPACE), [5]
    )
    # cancel is idempotent
    assert srv.cancel(ja)["state"] == "CANCELLED"
    # the pool is actually free: no pending backlog, refs all released
    deadline = time.monotonic() + 10
    while srv.manager.scheduler_stats()["tenant_depths"]:
        assert time.monotonic() < deadline, "queued work never freed"
        time.sleep(0.02)
    assert srv.registry.stats()["live_keys"] == 0
    assert srv.manager.scheduler_stats()["cancelled"] > 0


def test_timeout_cancels_job(sleepy_server):
    spec = StudySpec(sampler="grid", timeout_s=0.15)
    job = sleepy_server.submit("t", spec)
    snap = sleepy_server.result(job, wait=True, timeout=60)
    assert snap["state"] == "CANCELLED"


# ---------------------------------------------------------------------------
# Fair share: the low-weight tenant still progresses
# ---------------------------------------------------------------------------


def test_fair_share_small_tenant_finishes_under_heavy_backlog(sleepy_server):
    srv = sleepy_server
    srv.set_tenant_weight("hog", 1.0)
    srv.set_tenant_weight("mouse", 0.25)
    # three distinct-signature grid jobs = a real backlog for the hog
    hog_jobs = [
        srv.submit("hog", StudySpec(sampler="grid")),
        srv.submit("hog", StudySpec(sampler="grid", bounds={"sp0": [0, 1, 2]})),
        srv.submit("hog", StudySpec(sampler="grid", bounds={"sp1": [1, 2, 3]})),
    ]
    mouse_job = srv.submit(
        "mouse",
        StudySpec(
            sampler="explicit",
            param_sets=[{"sp0": 0, "sp1": 0}, {"sp0": 3, "sp1": 3}],
        ),
    )
    rm = srv.result(mouse_job, wait=True, timeout=120)
    assert rm["state"] == "DONE"
    # monotonic progress: the mouse's 2 runs finished while (or before)
    # the hog's ~48-run backlog drained — never starved behind it
    hogs = [srv.result(j, wait=True, timeout=240) for j in hog_jobs]
    assert all(r["state"] == "DONE" for r in hogs)
    assert rm["finished_at"] <= max(r["finished_at"] for r in hogs)
    dispatch = srv.manager.scheduler_stats()["tenant_dispatch"]
    assert dispatch.get("mouse", 0) > 0 and dispatch.get("hog", 0) > 0


def test_fairqueue_unit_laws():
    class Item:
        def __init__(self, key, tenant="", priority=0):
            self.key, self.tenant, self.priority = key, tenant, priority

    # single tenant degenerates to exact FIFO
    q = FairQueue()
    for i in range(5):
        q.append(Item(f"k{i}"))
    assert [q.popleft().key for _ in range(5)] == [f"k{i}" for i in range(5)]

    # equal weights interleave 1:1
    q = FairQueue()
    for i in range(6):
        q.append(Item(f"a{i}", "A"))
    for i in range(6):
        q.append(Item(f"b{i}", "B"))
    order = [q.popleft().tenant for _ in range(12)]
    for window in range(0, 12, 2):
        assert set(order[window:window + 2]) == {"A", "B"}, order

    # 2:1 weight drains twice as fast, low weight still progresses
    q = FairQueue()
    q.set_weight("A", 2.0)
    q.set_weight("B", 0.25)
    for i in range(12):
        q.append(Item(f"a{i}", "A"))
    for i in range(3):
        q.append(Item(f"b{i}", "B"))
    order = [q.popleft().tenant for _ in range(15)]
    assert order.index("B") <= 8  # no starvation
    assert order.count("A") == 12 and order.count("B") == 3

    # priority beats FIFO within one tenant
    q = FairQueue()
    q.append(Item("lo", "T", priority=0))
    q.append(Item("hi", "T", priority=5))
    assert q.popleft().key == "hi"

    # appendleft refunds the spent deficit; remove_keys purges exactly
    q = FairQueue()
    for i in range(4):
        q.append(Item(f"x{i}", "X"))
    head = q.popleft()
    q.appendleft(head)
    assert q.popleft().key == head.key
    assert q.remove_keys({"x1", "x3"}) == 2  # x0 already consumed
    assert len(q) == 1
    assert q.depths() == {"X": 1}


# ---------------------------------------------------------------------------
# Quotas
# ---------------------------------------------------------------------------


def test_quota_rejection_is_atomic(sleepy_server):
    srv = sleepy_server
    srv.set_tenant_quota("q", TenantQuota(max_live_jobs=1))
    j0 = srv.submit("q", StudySpec(sampler="grid"))
    with pytest.raises(QuotaExceeded):
        srv.submit("q", StudySpec(sampler="grid", bounds={"sp0": [0]}))
    srv.cancel(j0)
    assert srv.result(j0, wait=True, timeout=60)["state"] == "CANCELLED"
    # terminal jobs free their live-job slot
    j2 = srv.submit("q", StudySpec(sampler="grid", bounds={"sp0": [0]}))
    assert srv.result(j2, wait=True, timeout=120)["state"] == "DONE"

    srv.set_tenant_quota("tiny", TenantQuota(max_live_tasks=1))
    with pytest.raises(QuotaExceeded):
        srv.submit("tiny", StudySpec(sampler="grid"))
    # other tenants are not affected by 'tiny's budget
    j3 = srv.submit("other", StudySpec(sampler="grid", bounds={"sp1": [1]}))
    assert srv.result(j3, wait=True, timeout=120)["state"] == "DONE"


def test_study_task_keys_matches_execution_exactly(server):
    """The registry's admission-time key list is exactly the key set the
    executor submits (quota accounting and cancellation both hang off
    this equality)."""
    spec = StudySpec(sampler="explicit", param_sets=[{"a": 1}, {"b": 2}])
    runs = spec.resolve(_SPACE)
    plan = plan_study(
        server.workflow, runs, cluster=server.cluster, policy=spec.policy,
        active_paths=spec.active_paths,
    )
    keys = study_task_keys(plan, len(_INPUTS), "svc:x:")
    assert len(keys) == len(set(keys))
    mgr = Manager()
    mgr.start(2)
    try:
        execute_study(
            plan, _INPUTS, manager=mgr, key_prefix="svc:x:",
            input_keys=server.input_keys,
        )
    finally:
        # On a loaded machine a straggler backup of a settled key can still
        # hold a lease when execute_study returns; forget() keeps that key's
        # result until the lease settles. close() returns once no lease is
        # left, so the results are read after it.
        mgr.close()
    # every submitted key was enumerated, nothing extra
    assert set(mgr.results()) == set()  # executor forgets on exit
    # a backup is a second dispatch of an enumerated key, not another key
    dispatched = sum(mgr.dispatch_counts.values()) - mgr.backups_launched
    assert dispatched <= len(keys)


# ---------------------------------------------------------------------------
# Wire protocol
# ---------------------------------------------------------------------------


def test_wire_client_roundtrip(server):
    addr = server.serve_background("127.0.0.1:0")
    alice = ServiceClient(addr, "alice")
    bob = ServiceClient(addr, "bob")
    try:
        spec = StudySpec(
            sampler="explicit", param_sets=[{"a": 1}, {"c": 1}]
        )
        job = alice.submit(spec)
        snap = alice.status(job)
        assert snap["tenant"] == "alice"
        res = alice.result(job, timeout=120, poll_s=0.02)
        assert res["state"] == "DONE"
        assert res["result"]["objective"] == _oracle_objective(
            server.workflow, spec.resolve(_SPACE), _INPUTS
        )
        # bob sees only his own jobs unless he asks for all
        assert bob.list_jobs() == []
        assert [j["job_id"] for j in bob.list_jobs(all_tenants=True)] == [job]
        bob.set_tenant_weight(2.0)
        stats = bob.server_stats()
        assert stats["registry"]["jobs"] == 1
        assert "scheduler" in stats and "cache" in stats

        # error frames surface as ServiceError, connection stays usable
        with pytest.raises(ServiceError):
            alice.status("alice/ghost")
        with pytest.raises(ServiceError):
            alice.submit(StudySpec(sampler="grid", names=["ghost"]))
        assert alice.status(job)["state"] == "DONE"
    finally:
        alice.close()
        bob.close()


def test_wire_cancel_and_quota_over_socket(sleepy_server):
    addr = sleepy_server.serve_background("127.0.0.1:0")
    sleepy_server.set_tenant_quota("w", TenantQuota(max_live_jobs=1))
    client = ServiceClient(addr, "w")
    try:
        job = client.submit(StudySpec(sampler="grid"))
        with pytest.raises(ServiceError) as err:
            client.submit(StudySpec(sampler="grid", bounds={"sp0": [0]}))
        assert "QuotaExceeded" in str(err.value)
        snap = client.cancel(job)
        assert snap["state"] in ("RUNNING", "CANCELLED", "QUEUED")
        assert client.result(job, timeout=60)["state"] == "CANCELLED"
    finally:
        client.close()


def test_submit_rejects_bad_tenant_and_closed_server():
    srv = StudyServer(
        workflow=workflow_from_layout(_LAYOUT),
        space=_SPACE,
        inputs=_INPUTS,
        objective=_int_objective,
        n_workers=1,
    )
    with pytest.raises(SpecError):
        srv.submit("", StudySpec(sampler="grid", names=["a"]))
    with pytest.raises(SpecError):
        srv.submit("a/b", StudySpec(sampler="grid", names=["a"]))
    srv.close()
    with pytest.raises(RuntimeError):
        srv.submit("alice", StudySpec(sampler="grid", names=["a"]))


# ---------------------------------------------------------------------------
# Idle-pool accounting: parked pumps, honest stats
# ---------------------------------------------------------------------------


def test_idle_pool_parks_and_stats_report_active_wall():
    mgr = Manager()
    mgr.start(2)
    try:
        done = threading.Event()
        mgr.submit(
            WorkItem(key="w0", fn=lambda: 1, callback=lambda k, v: done.set())
        )
        assert done.wait(30)
        mgr.drain()
        time.sleep(0.4)  # a multi-job lifetime's idle gap
        stats = mgr.scheduler_stats()
        # the pump parked for (nearly) the whole idle window instead of
        # spinning, and idle time is excluded from the occupancy base
        assert stats["pump_parked_seconds"] > 0.25
        assert stats["active_wall_seconds"] < stats["wall_seconds"]
        assert 0.0 <= stats["worker_idle_fraction"] <= 1.0
        assert stats["pump_occupancy"] <= 1.5  # sane against ACTIVE wall

        # a second job after the idle gap still executes immediately
        t0 = time.monotonic()
        mgr.submit(WorkItem(key="w1", fn=lambda: 2))
        mgr.drain()
        assert time.monotonic() - t0 < 5.0
        assert mgr.results()["w1"] == 2
        parked_after = mgr.scheduler_stats()["pump_parked_seconds"]
        assert parked_after >= stats["pump_parked_seconds"] - 1e-6
    finally:
        mgr.close()


def test_idle_pool_parks_hierarchical_subpumps():
    mgr = Manager(hierarchy=2)
    mgr.start(4)
    try:
        for i in range(8):
            mgr.submit(WorkItem(key=f"k{i}", fn=lambda i=i: i * 3))
        mgr.drain()
        time.sleep(0.35)
        stats = mgr.scheduler_stats()
        assert stats["mode"] == "hierarchical"
        assert len(stats["sub_parked_seconds"]) == 2
        assert all(p >= 0.0 for p in stats["sub_parked_seconds"])
        assert sum(stats["sub_parked_seconds"]) > 0.2
        assert mgr.results() == {f"k{i}": i * 3 for i in range(8)}
    finally:
        mgr.close()


# ---------------------------------------------------------------------------
# The port against the reference service
# ---------------------------------------------------------------------------

_INT_SPACE = {"a": [0, 1, 2], "b": [0, 1, 2], "c": [0, 1], "d": [0, 1, 2]}


def _spaces(name):
    """(port's space, reference's space): the integer space built on each
    side, or each package's own Table I space."""
    from repro.app.pipeline import TABLE1_SPACE as J_TABLE1
    from repro.core.params import ParamSpace as JSpace

    from repro_torch.app import TABLE1_SPACE

    if name == "table1":
        return TABLE1_SPACE, J_TABLE1
    return ParamSpace.from_dict(_INT_SPACE), JSpace.from_dict(_INT_SPACE)


_SIGNATURE_CASES = {
    "explicit": ("int", dict(sampler="explicit", param_sets=[{"a": 2}, {"b": 1, "d": 0}])),
    "grid": ("int", dict(sampler="grid", names=["a", "c"])),
    "grid-bounds": ("int", dict(sampler="grid", bounds={"a": [0, 2], "d": [1]}, policy="rmsr")),
    "moat": ("int", dict(sampler="moat", n_trajectories=3, seed=5)),
    "explicit-table1": ("table1", dict(sampler="explicit",
                                       param_sets=[{"T1": 3.5, "G1": 40}, {"FH": 8}],
                                       max_bucket_size=2)),
    "grid-table1": ("table1", dict(sampler="grid", names=["T1", "G1"],
                                   bounds={"T1": [2.5, 3.0, 3.5, 4.0], "G1": [5, 10, 15, 20]})),
    "moat-table1": ("table1", dict(sampler="moat", n_trajectories=1, seed=3)),
    "moat-bounds-table1": ("table1", dict(sampler="moat", n_trajectories=2, seed=11,
                                          bounds={"G1": [10, 20, 30]}, active_paths=None)),
}


@pytest.mark.parametrize("json_round_trip", [False, True], ids=["spec", "json"])
@pytest.mark.parametrize("case", sorted(_SIGNATURE_CASES))
def test_signature_matches_reference(case, json_round_trip):
    from repro.service import StudySpec as JStudySpec

    space_name, fields = _SIGNATURE_CASES[case]
    spec = StudySpec(**fields)
    ref = JStudySpec(**fields)
    if json_round_trip:
        spec = StudySpec.from_json(spec.to_json())
        ref = JStudySpec.from_json(ref.to_json())
    space, jspace = _spaces(space_name)
    assert [list(ps) for ps in spec.resolve(space)] == [list(ps) for ps in ref.resolve(jspace)]
    assert spec.signature(space) == ref.signature(jspace)


# One scenario on each side, in this order: a solo MOAT job, an explicit
# two-run job (the shared cache now warm), then two tenants submitting an
# equal MOAT spec at once.
_SOLO = dict(sampler="moat", n_trajectories=1, seed=3, metrics=["objective", "per_input"])
_EXPLICIT = dict(sampler="explicit", param_sets=[{"T1": 3.5, "G1": 40}, {"FH": 8, "RC": 4}],
                 metrics=["objective", "per_input"])
_SHARED = dict(sampler="moat", n_trajectories=1, seed=11, metrics=["objective", "per_input"])
_VALUES = ("signature", "param_sets", "n_runs", "n_inputs", "per_input", "objective")
_COUNTS = ("tasks_executed", "cache_hits", "cache_misses")


def _service_scenario(server, spec_cls):
    def dispatched():
        return sum(server.manager.dispatch_counts.values())

    out = {}
    d0 = dispatched()
    out["solo"] = server.result(server.submit("solo", spec_cls(**_SOLO)), wait=True, timeout=600)
    out["single"] = dispatched() - d0
    out["explicit"] = server.result(
        server.submit("solo", spec_cls(**_EXPLICIT)), wait=True, timeout=600
    )
    d1 = dispatched()
    ja = server.submit("alice", spec_cls(**_SHARED))
    jb = server.submit("bob", spec_cls(**_SHARED))
    out["alice"] = server.result(ja, wait=True, timeout=600)
    out["bob"] = server.result(jb, wait=True, timeout=600)
    out["combined"] = dispatched() - d1
    out["live_keys"] = server.registry.stats()["live_keys"]
    return out


@pytest.fixture(scope="module", params=[1, 2], ids=["1worker", "2workers"])
def pathology_services(request):
    from repro.app.pipeline import pathology_service_build as j_build
    from repro.service import StudyServer as JServer
    from repro.service import StudySpec as JStudySpec

    from repro_torch.app.pipeline import pathology_service_build

    n_workers = request.param
    port = StudyServer.from_build(
        pathology_service_build, {"size": 32, "n_tiles": 2, "device": "cpu"},
        n_workers=n_workers,
    )
    try:
        got = _service_scenario(port, StudySpec)
    finally:
        port.close()
    ref = JServer.from_build(j_build, {"size": 32, "n_tiles": 2}, n_workers=n_workers)
    try:
        want = _service_scenario(ref, JStudySpec)
    finally:
        ref.close()
    return n_workers, got, want


@pytest.mark.parametrize("job", ["solo", "explicit", "alice", "bob"])
def test_pathology_service_matches_reference(pathology_services, job):
    n_workers, got, want = pathology_services
    assert got[job]["state"] == want[job]["state"] == "DONE", got[job]["error"]
    res, ref = got[job]["result"], want[job]["result"]
    for key in _VALUES:
        assert res[key] == ref[key], key
    # Every run list needs the same tasks on both sides, executed or hit.
    assert res["tasks_executed"] + res["cache_hits"] == ref["tasks_executed"] + ref["cache_hits"]
    if n_workers == 1:
        # One worker runs the buckets in one order on both sides. With two,
        # sibling buckets that share a cached prefix race to it, and the
        # split between executed and hit varies from run to run in the
        # reference itself. A job's cache_misses is the shared cache's
        # count over the job's life: bob's starts while alice's execution
        # is under way, so it is compared for the jobs that run alone.
        for key in _COUNTS if job != "bob" else _COUNTS[:2]:
            assert res[key] == ref[key], key
    # the payload is plain Python numbers: no tensor rides the wire
    for row in res["per_input"]:
        assert all(type(v) is float for v in row)
    assert all(type(v) is float for v in res["objective"])


def test_pathology_service_dispatch_matches_reference(pathology_services):
    _, got, want = pathology_services
    assert got["single"] == want["single"] > 0
    assert got["combined"] == want["combined"]
    assert got["combined"] < 2 * got["single"]
    assert got["alice"]["result"]["objective"] == got["bob"]["result"]["objective"]
    assert got["live_keys"] == want["live_keys"] == 0


def test_pathology_service_build_needs_a_device_without_cuda():
    from repro_torch.app.pipeline import pathology_service_build

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: None means the card there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pathology_service_build(size=8, n_tiles=1)
    built = pathology_service_build(size=8, n_tiles=1, device="cpu")
    assert built["inputs"][0]["raw"].device.type == "cpu"
    assert built["input_keys"] == ["tile0"]


def _live_storages():
    out = set()
    for obj in gc.get_objects():
        if type(obj) is torch.Tensor or type(obj) is torch.nn.Parameter:
            out.add(obj.untyped_storage().data_ptr())
    return out


def test_released_jobs_leave_no_task_state():
    """A long-lived server keeps its build (tiles, reference masks) and what
    its cache holds, and nothing else: once every job is terminal and
    released, no task state is alive, so on the card the device memory
    comes back. With a cache that admits nothing, that is the build's
    tensors alone; the idle workers and the parked pump hold neither their
    last lease's input state nor their last completion's outputs."""
    from repro_torch.app.pipeline import pathology_service_build

    srv = StudyServer.from_build(
        pathology_service_build, {"size": 32, "n_tiles": 1, "device": "cpu"},
        n_workers=2, cache_bytes=1,
    )
    try:
        gc.collect()
        built = _live_storages()
        done = srv.result(srv.submit("a", StudySpec(**_SOLO)), wait=True, timeout=300)
        assert done["state"] == "DONE"
        sweep = srv.submit("b", StudySpec(sampler="grid", names=["T1", "G1"],
                                          bounds={"T1": [2.5, 3.0], "G1": [5, 10]}))
        while srv.status(sweep)["state"] == "QUEUED":
            time.sleep(0.005)
        srv.cancel(sweep)
        assert srv.result(sweep, wait=True, timeout=60)["state"] in ("CANCELLED", "DONE")
        deadline = time.monotonic() + 30
        while True:  # a poisoned lease's task runs on to its end
            gc.collect()
            extra = _live_storages() - built
            if not extra or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        assert not extra, f"{len(extra)} task tensors still alive"
        assert srv.registry.stats()["live_keys"] == 0
    finally:
        srv.close()
