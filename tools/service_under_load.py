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

    PYTHONPATH=src python tools/service_under_load.py keys --iters 1500 --burners 24
    PYTHONPATH=src python tools/service_under_load.py counts --repeats 4
"""

from __future__ import annotations

import argparse
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
    stop = multiprocessing.Event()
    procs = [multiprocessing.Process(target=_burn, args=(stop,)) for _ in range(burners)]
    for p in procs:
        p.start()
    early = late = over = backups = 0
    try:
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
    finally:
        stop.set()
        for p in procs:
            p.join()
    print(f"iterations {iters}, busy processes {burners}, cpus {multiprocessing.cpu_count()}: "
          f"results left right after execute_study {early}, after close {late}; "
          f"dispatches > {n_keys} keys {over}; backups launched {backups}")


def counts(repeats: int) -> None:
    from repro_torch.app.pipeline import pathology_service_build

    specs = {
        "solo": dict(sampler="moat", n_trajectories=1, seed=3),
        "explicit": dict(sampler="explicit",
                         param_sets=[{"T1": 3.5, "G1": 40}, {"FH": 8, "RC": 4}]),
        "shared": dict(sampler="moat", n_trajectories=1, seed=11),
    }
    for n_workers in (1, 2):
        for _ in range(repeats):
            srv = StudyServer.from_build(
                pathology_service_build, {"size": 32, "n_tiles": 2, "device": "cpu"},
                n_workers=n_workers)
            try:
                jobs = {"solo": srv.submit("solo", StudySpec(**specs["solo"]))}
                srv.result(jobs["solo"], wait=True)
                jobs["explicit"] = srv.submit("solo", StudySpec(**specs["explicit"]))
                srv.result(jobs["explicit"], wait=True)
                jobs["alice"] = srv.submit("alice", StudySpec(**specs["shared"]))
                jobs["bob"] = srv.submit("bob", StudySpec(**specs["shared"]))
                line = []
                for name, job in jobs.items():
                    res = srv.result(job, wait=True)["result"]
                    line.append(f"{name} {res['tasks_executed']}/{res['cache_hits']}/"
                                f"{res['cache_misses']}")
            finally:
                srv.close()
            print(f"workers {n_workers}: " + ", ".join(line), flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("mode", choices=["keys", "counts"])
    parser.add_argument("--iters", type=int, default=1500)
    parser.add_argument("--burners", type=int, default=24)
    parser.add_argument("--repeats", type=int, default=4)
    args = parser.parse_args()
    if args.mode == "keys":
        keys(args.iters, args.burners)
    else:
        counts(args.repeats)


if __name__ == "__main__":
    main()
