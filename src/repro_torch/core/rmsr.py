"""RMSR — Runtime Memory-Efficient Scheduler for Reuse (paper §III, Alg. 1).

The paper's insight: execute a merged stage's task tree **depth-first with at
most ``active_paths`` concurrently-active root→leaf paths**, so peak memory is
bounded by ``active_paths`` (× path-local state) *independently* of how many
stage instances were merged (``MaxBucketSize``). Arbitrarily aggressive
merging — hence maximal computation reuse — becomes feasible under a fixed
memory budget.

TPU adaptation (see DESIGN.md §2): XLA programs are static, so the paper's
run-time worklist (stack + dependency counters, Alg. 1) is executed
*ahead-of-time* here to produce a static schedule with an exact liveness
proof. The same traversal, parameterised by queue discipline, also models
RTMA's execution (breadth-eligible ⇒ width-proportional memory), which gives
a single engine for the paper's Fig 6/7 comparisons:

  * ``discipline="lifo"``  — RMSR: LIFO stack ⇒ depth-first (Alg. 1 line 6).
  * ``discipline="fifo"``  — RTMA: level-order ⇒ the whole frontier is live.

Liveness rule: a node's output buffer becomes live when the node executes and
is freed once its last child has executed (children consume the parent output
as input); leaf outputs are reduced (Dice) / emitted immediately.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch import trace
from repro_torch.core.reuse import ReuseNode, ReuseTree

__all__ = [
    "ScheduleResult",
    "rmsr_schedule",
    "simulate_execution",
    "tree_peak_bytes",
    "min_active_paths",
    "replay_schedule",
    "execute_merged_stage",
]


def _node_bytes(node: ReuseNode, tree: ReuseTree) -> int:
    task = tree.stage.tasks[node.depth]
    params = dict(node.instances[0].params)
    return task.bound_bytes(params)


def _node_cost(node: ReuseNode, tree: ReuseTree) -> float:
    task = tree.stage.tasks[node.depth]
    params = dict(node.instances[0].params)
    return task.bound_cost(params)


@dataclasses.dataclass
class ScheduleResult:
    order: List[ReuseNode]
    peak_bytes: int
    peak_paths: int
    makespan: float
    total_cost: float


def _children_sorted(node: ReuseNode) -> List[ReuseNode]:
    return [node.children[k] for k in sorted(node.children.keys(), key=repr)]


def simulate_execution(
    tree: ReuseTree,
    workers: int,
    *,
    discipline: str = "lifo",
    cost_fn: Optional[Callable[[ReuseNode], float]] = None,
    bytes_fn: Optional[Callable[[ReuseNode], int]] = None,
) -> ScheduleResult:
    """Discrete-event simulation of Alg. 1 with ``workers`` threads/paths.

    Emits the execution order, exact peak live bytes, peak concurrently-open
    paths, and the makespan under the per-task costs — used both as the AOT
    schedule compiler (order) and as the Fig 6/7 performance model.
    """
    if discipline not in ("lifo", "fifo"):
        raise ValueError(discipline)
    cost_fn = cost_fn or (lambda n: _node_cost(n, tree))
    bytes_fn = bytes_fn or (lambda n: _node_bytes(n, tree))

    ready: List[ReuseNode] = _children_sorted(tree.root)[::-1]
    running: List[Tuple[float, int, ReuseNode]] = []  # (finish_time, tiebreak, node)
    executed_children: Dict[int, int] = {}
    live: Dict[int, int] = {}
    order: List[ReuseNode] = []
    t = 0.0
    live_bytes = 0
    peak_bytes = 0
    peak_paths = 0
    total_cost = 0.0
    tiebreak = 0

    def _start(node: ReuseNode) -> None:
        nonlocal live_bytes, peak_bytes, total_cost, tiebreak
        order.append(node)
        b = bytes_fn(node)
        live[node.uid] = b
        live_bytes += b
        # the parent's buffer is also live while this node runs; it already is.
        peak_bytes = max(peak_bytes, live_bytes)
        c = cost_fn(node)
        total_cost += c
        tiebreak += 1
        heapq.heappush(running, (t + c, tiebreak, node))

    def _finish(node: ReuseNode) -> None:
        nonlocal live_bytes
        parent = node.parent
        if parent is not None and parent.depth >= 0:
            executed_children[parent.uid] = executed_children.get(parent.uid, 0) + 1
            if executed_children[parent.uid] == len(parent.children):
                live_bytes -= live.pop(parent.uid)
        if node.is_leaf:
            live_bytes -= live.pop(node.uid)
        else:
            kids = _children_sorted(node)
            if discipline == "lifo":
                ready.extend(kids[::-1])
            else:
                ready.extend(kids)

    while ready or running:
        while ready and len(running) < workers:
            node = ready.pop() if discipline == "lifo" else ready.pop(0)
            _start(node)
            peak_paths = max(peak_paths, len(running))
        if not running:
            break
        t, _, node = heapq.heappop(running)
        _finish(node)

    return ScheduleResult(
        order=order,
        peak_bytes=peak_bytes,
        peak_paths=peak_paths,
        makespan=t,
        total_cost=total_cost,
    )


def rmsr_schedule(tree: ReuseTree, active_paths: int = 1) -> ScheduleResult:
    """The RMSR static schedule (Alg. 1, AOT): depth-first, ≤ active_paths."""
    return simulate_execution(tree, active_paths, discipline="lifo")


def tree_peak_bytes(tree: ReuseTree, *, discipline: str = "fifo", workers: int = 10**9) -> int:
    """Peak memory of executing a merged tree under RTMA semantics (all
    branches eligible): this is what limits MaxBucketSize in the paper."""
    return simulate_execution(tree, workers, discipline=discipline).peak_bytes


def min_active_paths(tree: ReuseTree, budget_bytes: int) -> Optional[int]:
    """Largest active_paths whose RMSR peak fits the budget (None if even a
    single path exceeds it).

    Peak bytes is monotone non-decreasing in active_paths (more concurrently
    open root→leaf paths can only add live buffers), so a doubling probe
    followed by a binary search over the last gap finds the exact maximum —
    not just the last fitting power of two. active_paths beyond the leaf
    count cannot open further paths, so the search is capped there.
    """
    leaves = max(1, len(tree.leaves()))

    def fits(p: int) -> bool:
        return simulate_execution(tree, p, discipline="lifo").peak_bytes <= budget_bytes

    if not fits(1):
        return None
    lo = 1  # largest known to fit
    hi: Optional[int] = None  # smallest known not to fit
    probe = 2
    while hi is None and probe < leaves:
        if fits(probe):
            lo = probe
            probe *= 2
        else:
            hi = probe
    if hi is None:
        if fits(leaves):
            return leaves
        hi = leaves
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if fits(mid):
            lo = mid
        else:
            hi = mid
    return lo


# ---------------------------------------------------------------------------
# Real executor: walks a frozen schedule calling the (jitted) task functions.
# ---------------------------------------------------------------------------

def replay_schedule(
    tree: ReuseTree,
    order: Sequence[ReuseNode],
    input_state: Any,
    *,
    lookup: Optional[Callable[[Tuple], Tuple[bool, Any]]] = None,
    store: Optional[Callable[[Tuple, Any, Any, Dict[str, Any]], None]] = None,
) -> Tuple[Dict[int, Any], int, int]:
    """Replay a frozen schedule over a merged task tree.

    Each trie node runs ``task.fn(parent_output, **bound_params)`` exactly
    once — this *is* the computation reuse. Buffers are dropped per the
    liveness rule (a parent output dies with its last child), so the
    Python-side peak matches the schedule's proof.

    ``lookup(path_key) -> (hit, value)`` / ``store(path_key, value, task,
    params)`` optionally plug a result cache in (the engine's run-level
    cache); the path key is the tuple of trie keys from the root.

    Returns ``({run_id: leaf output}, tasks executed, cache hits)``.
    """
    outputs: Dict[int, Any] = {}
    results: Dict[int, Any] = {}
    remaining: Dict[int, int] = {}
    path_keys: Dict[int, Tuple] = {}
    executed = 0
    hits = 0
    for node in order:
        task = tree.stage.tasks[node.depth]
        parent = node.parent
        at_root = parent is None or parent.depth < 0
        pk = (path_keys[parent.uid] if not at_root else ()) + (node.key,)
        path_keys[node.uid] = pk
        params = {
            k: v for k, v in dict(node.instances[0].params).items()
            if k in task.param_names
        }
        hit = False
        out = None
        if lookup is not None:
            hit, out = lookup(pk)
        if hit:
            hits += 1
        else:
            src = input_state if at_root else outputs[parent.uid]
            with trace.span(task.name, "pathology tasks"):
                out = task.fn(src, **params) if task.fn is not None else src
            executed += 1
            if store is not None:
                store(pk, out, task, params)
        if node.is_leaf:
            for inst in node.instances:
                results[inst.run_id] = out
        else:
            outputs[node.uid] = out
            remaining[node.uid] = len(node.children)
        if not at_root:
            remaining[parent.uid] -= 1
            if remaining[parent.uid] == 0:
                del outputs[parent.uid]  # liveness: parent freed
    trace.count(executed=executed, hits=hits)
    return results, executed, hits


def execute_merged_stage(
    tree: ReuseTree,
    input_state: Any,
    *,
    active_paths: int = 1,
    collect: str = "leaf",
) -> Dict[int, Any]:
    """Execute a merged stage's task tree with RMSR's depth-first order.

    ``input_state`` is the stage input (e.g. the normalised image tile).
    Returns {run_id: leaf output} for every merged stage instance.
    """
    results, _, _ = replay_schedule(
        tree, rmsr_schedule(tree, active_paths).order, input_state
    )
    return results
