"""Two timing effects of the study service's runtime, on the CPU.

``keys``: the body of ``test_study_task_keys_matches_execution_exactly``
(tests/test_service.py, re-targeted in tests/test_torch_service.py) in a
loop, beside ``--burners`` busy processes. Each iteration executes a
two-input study of integer tasks on a fresh two-worker Manager and reads
what is left of it twice: right after ``execute_study`` returns (the
reference test's order) and after ``Manager.close()``, which returns once
no lease is left (the port's). A straggler backup launched near the end of
the study can still hold a lease at the first read: ``forget`` keeps that
key's result until the lease settles, and the clone is one more dispatch.

``counts``: the pathology service at 32², two tiles, on the CPU, the same
jobs as tests/test_torch_service.py (a solo MOAT job, an explicit two-run
job, alice and bob submitting one MOAT spec at once), ``--repeats`` times
with one and with two thread workers, printing each job's
``tasks_executed / cache_hits / cache_misses``.

``dispatch``: the scenario of ``_service_scenario`` in
tests/test_torch_service.py (the same jobs, two thread workers) in a loop,
``--repeats`` times, beside ``--burners`` busy processes. Each iteration
reads the Manager's dispatches and straggler backups over the solo job
(``single``) and over alice's and bob's (``combined``), and counts the
iterations whose raw dispatches differ from the quiet machine's (6 and 6)
and whether they still do once the backups are taken off.

    PYTHONPATH=src python tools/service_under_load.py keys --iters 1500 --burners 24
    PYTHONPATH=src python tools/service_under_load.py counts --repeats 4
    PYTHONPATH=src python tools/service_under_load.py dispatch --repeats 100 --burners 24
"""

from __future__ import annotations

import argparse
import collections
import functools
import multiprocessing
import zlib

from repro_torch.core import StageSpec, TaskSpec, Workflow
from repro_torch.core.params import ParamSpace
from repro_torch.engine import ClusterSpec, execute_study, plan_study
from repro_torch.engine.streaming import study_task_keys
from repro_torch.runtime import Manager
from repro_torch.service import StudyServer, StudySpec

PRIME = (1 << 61) - 1


def _mix(stage: int, task: int, x: int, **kw) -> int:
    tag = repr((stage, task, tuple(sorted(kw.items())))).encode()
    return (x * 1048573 + zlib.crc32(tag)) % PRIME


def _burn(stop) -> None:
    while not stop.is_set():
        sum(range(100_000))


class _Burners:
    """``n`` busy processes for the life of a ``with`` block."""

    def __init__(self, n: int) -> None:
        self.stop = multiprocessing.Event()
        self.procs = [multiprocessing.Process(target=_burn, args=(self.stop,)) for _ in range(n)]

    def __enter__(self):
        for p in self.procs:
            p.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop.set()
        for p in self.procs:
            p.join()


def keys(iters: int, burners: int) -> None:
    layout = [[("a",), ("b",)], [("c", "d")]]
    wf = Workflow(stages=tuple(
        StageSpec(name=f"stage{si}", tasks=tuple(
            TaskSpec(name=f"s{si}t{ti}", param_names=names,
                     fn=functools.partial(_mix, si, ti), cost=1.0, output_bytes=64)
            for ti, names in enumerate(tasks)))
        for si, tasks in enumerate(layout)))
    space = ParamSpace.from_dict({"a": [0, 1, 2], "b": [0, 1, 2], "c": [0, 1], "d": [0, 1, 2]})
    spec = StudySpec(sampler="explicit", param_sets=[{"a": 1}, {"b": 2}])
    plan = plan_study(wf, spec.resolve(space), cluster=ClusterSpec(n_workers=2),
                      policy=spec.policy, active_paths=spec.active_paths)
    n_keys = len(study_task_keys(plan, 2, "svc:x:"))
    early = late = over = backups = 0
    with _Burners(burners):
        for _ in range(iters):
            mgr = Manager()
            mgr.start(2)
            try:
                execute_study(plan, [3, 8], manager=mgr, key_prefix="svc:x:", input_keys=[0, 1])
                early += bool(mgr.results())
            finally:
                mgr.close()
            late += bool(mgr.results())
            over += sum(mgr.dispatch_counts.values()) > n_keys
            backups += mgr.backups_launched
    print(f"iterations {iters}, busy processes {burners}, cpus {multiprocessing.cpu_count()}: "
          f"results left right after execute_study {early}, after close {late}; "
          f"dispatches > {n_keys} keys {over}; backups launched {backups}")


# the jobs of tests/test_torch_service.py's scenario
_METRICS = ["objective", "per_input"]
_SPECS = {
    "solo": dict(sampler="moat", n_trajectories=1, seed=3, metrics=_METRICS),
    "explicit": dict(sampler="explicit", param_sets=[{"T1": 3.5, "G1": 40}, {"FH": 8, "RC": 4}],
                     metrics=_METRICS),
    "shared": dict(sampler="moat", n_trajectories=1, seed=11, metrics=_METRICS),
}


def _scenario(n_workers: int):
    """The scenario on a fresh pathology service at 32², two tiles, on the
    CPU: the solo job, the explicit one, then alice and bob's shared one.
    Returns ({job: result}, the Manager's (dispatches, backups launched)
    before the solo job and after each of the three steps)."""
    from repro_torch.app.pipeline import pathology_service_build

    srv = StudyServer.from_build(
        pathology_service_build, {"size": 32, "n_tiles": 2, "device": "cpu"},
        n_workers=n_workers)
    mgr = srv.manager
    reads = []

    def read():
        reads.append((sum(mgr.dispatch_counts.values()), mgr.backups_launched))

    def run(spec, **tenants):  # {job: tenant}, submitted at once
        jobs = {name: srv.submit(t, StudySpec(**_SPECS[spec])) for name, t in tenants.items()}
        out = {name: srv.result(j, wait=True, timeout=600)["result"] for name, j in jobs.items()}
        read()
        return out

    try:
        read()
        results = run("solo", solo="solo")
        results.update(run("explicit", explicit="solo"))
        results.update(run("shared", alice="alice", bob="bob"))
    finally:
        srv.close()
    return results, reads


def counts(repeats: int) -> None:
    for n_workers in (1, 2):
        for _ in range(repeats):
            results, _ = _scenario(n_workers)
            line = [f"{name} {r['tasks_executed']}/{r['cache_hits']}/{r['cache_misses']}"
                    for name, r in results.items()]
            print(f"workers {n_workers}: " + ", ".join(line), flush=True)


def dispatch(repeats: int, burners: int) -> None:
    quiet = {"single": 6, "combined": 6}  # both services' counts on an idle machine
    raw_off = collections.Counter()
    net_off = collections.Counter()
    backups = collections.Counter()
    seen = collections.defaultdict(collections.Counter)
    with _Burners(burners):
        for _ in range(repeats):
            _, reads = _scenario(2)
            for name, (a, b) in (("single", (0, 1)), ("combined", (2, 3))):
                raw, nb = reads[b][0] - reads[a][0], reads[b][1] - reads[a][1]
                raw_off[name] += raw != quiet[name]
                net_off[name] += raw - nb != quiet[name]
                backups[name] += nb
                seen[name][raw] += 1
    print(f"iterations {repeats}, busy processes {burners}, cpus {multiprocessing.cpu_count()}")
    for name in quiet:
        print(f"{name}: raw dispatches {dict(sorted(seen[name].items()))}; raw != {quiet[name]} "
              f"in {raw_off[name]}; backups launched {backups[name]}; raw - backups != "
              f"{quiet[name]} in {net_off[name]}")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("mode", choices=["keys", "counts", "dispatch"])
    parser.add_argument("--iters", type=int, default=1500)
    parser.add_argument("--burners", type=int, default=24)
    parser.add_argument("--repeats", type=int, default=4)
    args = parser.parse_args()
    if args.mode == "keys":
        keys(args.iters, args.burners)
    elif args.mode == "dispatch":
        dispatch(args.repeats, args.burners)
    else:
        counts(args.repeats)


if __name__ == "__main__":
    main()
