"""Hierarchical workflow abstraction (paper §II): coarse-grain *stages*, each
an internal pipeline of fine-grain *tasks*, each task parameterised by a
subset of the application parameters.

A :class:`StageSpec` is a linear chain of :class:`TaskSpec` (the paper's
Fig 1/Fig 5 segmentation stage: Seg0..Seg6). When several stage *instances*
(stage + bound parameter set) are merged for computation reuse, the chain
becomes a tree (trie over per-task parameter values) — see ``reuse.py``.

Tasks carry two cost annotations used by the schedulers:
  * ``cost``         — relative compute cost (seconds or abstract units),
  * ``output_bytes`` — size of the task's output buffer, used by the RMSR
                       liveness/memory model.
Both may be callables of the bound parameter values, supporting
heterogeneous-memory tasks (a beyond-paper generalisation; the paper assumes
homogeneous tasks, §III last paragraph).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.params import ParamSet

__all__ = ["TaskSpec", "StageSpec", "StageInstance", "Workflow", "task_key"]


@dataclasses.dataclass(frozen=True)
class TaskSpec:
    """A fine-grain task inside a stage.

    ``fn(state, **params) -> state`` is the actual computation (a JAX-jittable
    transformation of the inter-task payload). ``param_names`` is the subset
    of application parameters this task consumes — the reuse trie keys each
    tree level by the values of exactly these parameters.
    """

    name: str
    param_names: Tuple[str, ...]
    fn: Optional[Callable[..., Any]] = None
    cost: Any = 1.0  # float | Callable[[Dict[str, Any]], float]
    output_bytes: Any = 0  # int | Callable[[Dict[str, Any]], int]

    def bound_cost(self, params: Dict[str, Any]) -> float:
        return float(self.cost(params) if callable(self.cost) else self.cost)

    def bound_bytes(self, params: Dict[str, Any]) -> int:
        ob = self.output_bytes
        return int(ob(params) if callable(ob) else ob)


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """A coarse-grain stage: an ordered pipeline of tasks."""

    name: str
    tasks: Tuple[TaskSpec, ...]

    @property
    def param_names(self) -> Tuple[str, ...]:
        seen: List[str] = []
        for t in self.tasks:
            for p in t.param_names:
                if p not in seen:
                    seen.append(p)
        return tuple(seen)


def task_key(task: TaskSpec, params: ParamSet) -> Tuple[Any, ...]:
    """The reuse key of a task instance: the values of the parameters the
    task consumes (paper §II-B: tasks are duplicates iff their consumed
    parameter values coincide — upstream agreement is enforced by trie
    position, see ``reuse.py``)."""
    d = dict(params)
    return tuple((n, d[n]) for n in task.param_names if n in d)


@dataclasses.dataclass(frozen=True)
class StageInstance:
    """A stage bound to one parameter set (one SA run of that stage)."""

    stage: StageSpec
    params: ParamSet
    run_id: int  # which SA run (parameter set index) this instance belongs to

    def task_keys(self) -> Tuple[Tuple[Any, ...], ...]:
        return tuple(task_key(t, self.params) for t in self.stage.tasks)


@dataclasses.dataclass
class Workflow:
    """An application workflow: ordered stages + the instances of an SA study.

    ``instantiate`` expands (stages × parameter sets) into stage instances;
    downstream reuse analysis operates per stage family (instances of the
    same StageSpec are candidates for dedup/merging; paper §II-B).
    """

    stages: Tuple[StageSpec, ...]

    def instantiate(self, param_sets: Sequence[ParamSet]) -> Dict[str, List[StageInstance]]:
        out: Dict[str, List[StageInstance]] = {s.name: [] for s in self.stages}
        for run_id, ps in enumerate(param_sets):
            for s in self.stages:
                out[s.name].append(StageInstance(s, ps, run_id))
        return out

    def total_task_count(self, n_runs: int) -> int:
        return n_runs * sum(len(s.tasks) for s in self.stages)
