"""Discrete-event simulator of the Manager-Worker cluster at paper scale
(256 nodes × 28 cores) — drives the fig8 multi-node scalability benchmark.

Cost model: per-bucket compute times come from *measured* JAX task
wall-times composed over the bucket's merged task tree (the same model the
paper's gains rest on: reuse changes WHICH tasks run, not how fast a task
is). Per-bucket dispatch latency and per-tile I/O are charged per the RTF's
demand-driven protocol; node_speed jitter injects stragglers.
"""

from __future__ import annotations

import collections
import dataclasses
import heapq
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "ClusterSim",
    "simulate_cluster",
    "StreamSim",
    "simulate_stream",
    "AutotuneResult",
    "autotune_stream",
]


@dataclasses.dataclass
class ClusterSim:
    makespan: float
    busy_time: float
    n_nodes: int
    cores_per_node: int

    @property
    def parallel_efficiency(self) -> float:
        return self.busy_time / (self.makespan * self.n_nodes * self.cores_per_node)


def simulate_cluster(
    bucket_costs: Sequence[float],
    *,
    n_nodes: int,
    cores_per_node: int = 28,
    dispatch_latency: float = 2e-3,
    io_per_bucket: float = 0.05,
    node_speed_sigma: float = 0.03,
    seed: int = 0,
) -> ClusterSim:
    """Demand-driven list scheduling of buckets onto node-cores.

    Each core pulls the next bucket when free (the RTF protocol). Node speed
    is jittered (shared-memory/I-O contention, the paper's §IV-D explanation
    for sub-ideal multicore speedups is modelled as a per-node slowdown).
    """
    rng = np.random.default_rng(seed)
    speeds = 1.0 + rng.normal(0, node_speed_sigma, n_nodes).clip(-0.2, 0.2)
    # executor heap: (free_time, core_id); cores indexed node-major
    n_cores = n_nodes * cores_per_node
    heap = [(0.0, i) for i in range(n_cores)]
    heapq.heapify(heap)
    busy = 0.0
    makespan = 0.0
    for cost in sorted(bucket_costs, reverse=True):  # LPT demand-driven
        t, core = heapq.heappop(heap)
        node = core // cores_per_node
        dur = cost / speeds[node] + io_per_bucket
        end = t + dispatch_latency + dur
        busy += dur
        makespan = max(makespan, end)
        heapq.heappush(heap, (end, core))
    return ClusterSim(
        makespan=makespan,
        busy_time=busy,
        n_nodes=n_nodes,
        cores_per_node=cores_per_node,
    )


@dataclasses.dataclass
class StreamSim:
    """Result of :func:`simulate_stream` — the streaming dataset executor at
    paper scale (many tiles through one multi-stage plan), including the
    hierarchical-scheduler observables (DESIGN.md §15): pump occupancy,
    steal counts and locality hit-rate."""

    makespan: float
    busy_time: float
    n_inputs: int
    n_nodes: int
    cores_per_node: int
    fanout: int = 1
    # scheduling-event seconds accumulated by the BUSIEST pump — the
    # serialization metric; occupancy near 1.0 means that pump is the
    # bottleneck, exactly what the flat Manager hits at 256 nodes.
    pump_busy: float = 0.0
    steals: int = 0
    steal_items: int = 0
    locality_hits: int = 0
    locality_misses: int = 0

    @property
    def parallel_efficiency(self) -> float:
        from repro_torch.core.metrics import parallel_efficiency

        return parallel_efficiency(
            self.busy_time, self.makespan, self.n_nodes * self.cores_per_node
        )

    @property
    def throughput(self) -> float:
        from repro_torch.core.metrics import throughput

        return throughput(self.n_inputs, self.makespan)

    @property
    def pump_occupancy(self) -> float:
        """Busiest pump's scheduling-work fraction of the makespan."""
        return self.pump_busy / self.makespan if self.makespan else 0.0

    @property
    def worker_idle_fraction(self) -> float:
        """Mean fraction of the makespan a core spent idle."""
        return 1.0 - self.parallel_efficiency

    @property
    def locality_hit_rate(self) -> float:
        total = self.locality_hits + self.locality_misses
        return self.locality_hits / total if total else 0.0


def simulate_stream(
    stage_bucket_costs: Sequence[Sequence[float]],
    n_inputs: int,
    *,
    n_nodes: int,
    cores_per_node: int = 28,
    dispatch_latency: float = 2e-3,
    io_per_bucket: float = 0.05,
    node_speed_sigma: float = 0.03,
    input_cost_sigma: float = 0.05,
    seed: int = 0,
    barrier: bool = False,
    fanout: int = 1,
    pump_service: float = 0.0,
    steal_latency: float = 2e-3,
    steal: bool = True,
    locality: bool = False,
    locality_io_factor: float = 0.1,
) -> StreamSim:
    """Discrete-event model of ``execute_study`` at paper scale.

    ``stage_bucket_costs[s]`` is the per-bucket compute cost list of stage
    *s* of ONE input's plan (the frozen schedules' makespans); every input
    replays the same plan with a per-input cost jitter (tile content
    varies). Dependency structure mirrors the executor: with
    ``barrier=False`` (streaming), stage *s+1* buckets of input *i* become
    ready when input *i* finishes stage *s* — inputs pipeline freely across
    stages. With ``barrier=True`` (the pre-streaming global barrier), stage
    *s+1* opens only after EVERY input finished stage *s* — the idle tail
    this executor removed. Cores pull ready buckets demand-driven (RTF).

    **Hierarchy model** (DESIGN.md §15). ``fanout`` pumps each own a
    contiguous core shard; every scheduling event — a dispatch *or* a
    completion settle — occupies the owning pump for ``pump_service``
    seconds (the measured per-event cost of the Python pump: poll, lock,
    lease bookkeeping, callback). A bucket's start is therefore delayed
    behind its pump's backlog: with one pump and thousands of cores the
    pump queue, not the workers, sets the makespan — the flat-Manager
    collapse the hierarchy fixes. An idle pump whose queue ran dry steals
    the tail half of the most loaded peer's queue, paying
    ``steal_latency`` of pump time. With ``locality=True``, follow-on
    buckets are routed to the shard (and, when one is idle, the node)
    that ran the input's previous stage; a node-local hit pays
    ``io_per_bucket × locality_io_factor`` instead of the full remote
    fetch. Defaults (``fanout=1, pump_service=0, locality=False``)
    reproduce the pre-hierarchy model exactly.
    """
    stage_bucket_costs = [list(s) for s in stage_bucket_costs]
    if any(not s for s in stage_bucket_costs):
        # an empty stage would stall its dependents silently (no completion
        # event ever opens stage s+1) — reject degenerate plans loudly
        raise ValueError("every stage needs at least one bucket cost")
    rng = np.random.default_rng(seed)
    speeds = 1.0 + rng.normal(0, node_speed_sigma, n_nodes).clip(-0.2, 0.2)
    jitter = 1.0 + rng.normal(0, input_cost_sigma, n_inputs).clip(-0.5, 0.5)
    n_stages = len(stage_bucket_costs)
    n_cores = n_nodes * cores_per_node
    fanout = max(1, min(int(fanout), n_cores))

    def shard_of_core(core: int) -> int:
        return core * fanout // n_cores

    # per-shard ready queues + idle core pools (contiguous shards)
    ready: List["collections.deque"] = [collections.deque() for _ in range(fanout)]
    idle: List["collections.deque"] = [collections.deque() for _ in range(fanout)]
    for c in range(n_cores):
        idle[shard_of_core(c)].append(c)
    pump_free = [0.0] * fanout   # time each pump is next available
    pump_busy = [0.0] * fanout   # scheduling-event seconds per pump
    # input -> (node, shard) of its most recent completed bucket — the
    # affinity map locality routing consults
    aff_node = np.full(n_inputs, -1, dtype=np.int64)
    aff_shard = np.full(n_inputs, -1, dtype=np.int64)

    remaining = np.zeros((n_inputs, n_stages), dtype=np.int64)
    stage_open = np.zeros(n_stages, dtype=np.int64)  # inputs not yet done (barrier)

    def route(i: int) -> int:
        if locality and aff_shard[i] >= 0:
            return int(aff_shard[i])
        return min(range(fanout), key=lambda g: (len(ready[g]), g))

    def enqueue(i: int, s: int) -> None:
        g = route(i)
        for c in stage_bucket_costs[s]:
            ready[g].append((i, s, c * jitter[i]))
        remaining[i, s] = len(stage_bucket_costs[s])

    for s in range(n_stages):
        stage_open[s] = n_inputs
    for i in range(n_inputs):
        enqueue(i, 0)

    running: List = []  # (end_time, tiebreak, input, stage, core)
    t = 0.0
    busy = 0.0
    tiebreak = 0
    steals = steal_items = 0
    loc_hits = loc_misses = 0

    def take_core(g: int, i: int) -> int:
        """Pick an idle core from shard g — preferring the input's
        affinity node when locality dispatch is on."""
        if locality and aff_node[i] >= 0:
            target = int(aff_node[i])
            for j, c in enumerate(idle[g]):
                if c // cores_per_node == target:
                    idle[g].rotate(-j)
                    core = idle[g].popleft()
                    idle[g].rotate(j)
                    return core
        return idle[g].popleft()

    def dispatch() -> None:
        nonlocal busy, tiebreak, steals, steal_items, loc_hits, loc_misses
        for g in range(fanout):
            while idle[g]:
                if not ready[g]:
                    if not (steal and fanout > 1):
                        break
                    victim = -1
                    for h in range(fanout):
                        if h != g and len(ready[h]) > (
                            len(ready[victim]) if victim >= 0 else 1
                        ):
                            victim = h
                    if victim < 0:
                        break
                    n = len(ready[victim]) // 2
                    chunk = [ready[victim].pop() for _ in range(n)]
                    chunk.reverse()
                    ready[g].extend(chunk)
                    pump_free[g] = max(pump_free[g], t) + steal_latency
                    pump_busy[g] += steal_latency
                    steals += 1
                    steal_items += n
                i, s, cost = ready[g].popleft()
                core = take_core(g, i)
                node = core // cores_per_node
                io = io_per_bucket
                if locality and aff_node[i] >= 0:
                    if node == aff_node[i]:
                        io = io_per_bucket * locality_io_factor
                        loc_hits += 1
                    else:
                        loc_misses += 1
                dur = cost / speeds[node] + io
                start = max(t, pump_free[g])  # pump serialization point
                pump_free[g] = start + pump_service
                pump_busy[g] += pump_service
                busy += dur
                tiebreak += 1
                heapq.heappush(
                    running,
                    (start + pump_service + dispatch_latency + dur,
                     tiebreak, i, s, core),
                )

    dispatch()
    while running:
        t, _, i, s, core = heapq.heappop(running)
        g = shard_of_core(core)
        idle[g].append(core)
        # the settle is a scheduling event too: it occupies the pump
        pump_free[g] = max(pump_free[g], t) + pump_service
        pump_busy[g] += pump_service
        aff_node[i] = core // cores_per_node
        aff_shard[i] = g
        remaining[i, s] -= 1
        if remaining[i, s] == 0 and s + 1 < n_stages:
            if barrier:
                stage_open[s] -= 1
                if stage_open[s] == 0:  # last input closes the global barrier
                    for j in range(n_inputs):
                        enqueue(j, s + 1)
            else:
                enqueue(i, s + 1)  # per-input dependency edge
        dispatch()

    return StreamSim(
        makespan=t,
        busy_time=busy,
        n_inputs=n_inputs,
        n_nodes=n_nodes,
        cores_per_node=cores_per_node,
        fanout=fanout,
        pump_busy=max(pump_busy) if pump_busy else 0.0,
        steals=steals,
        steal_items=steal_items,
        locality_hits=loc_hits,
        locality_misses=loc_misses,
    )


@dataclasses.dataclass
class AutotuneResult:
    """Outcome of :func:`autotune_stream`: the (bucket size, fanout) pair
    with the smallest simulated makespan, plus the full search table."""

    bucket_size: int
    fanout: int
    sim: StreamSim
    # (bucket_size, fanout, makespan, parallel_efficiency) per candidate
    table: List[Tuple[int, int, float, float]]


def autotune_stream(
    costs_by_bucket_size: Dict[int, Sequence[Sequence[float]]],
    n_inputs: int,
    *,
    n_nodes: int,
    fanouts: Sequence[int] = (1, 2, 4, 8, 16),
    **sim_kwargs,
) -> AutotuneResult:
    """Autotune bucket size × pump fan-out on the validated stream model.

    ``costs_by_bucket_size`` maps a candidate ``max_bucket_size`` to the
    re-planned ``stage_bucket_costs`` it produces (the caller re-plans;
    bucket size changes WHICH schedules exist, so it cannot be derived
    here). Every (bucket size, fanout) pair is simulated and the smallest
    makespan wins — the trade this searches is real: small buckets load-
    balance better but multiply scheduling events (pump-bound at high core
    counts), large buckets starve the pump less but serialise more work
    per bucket. Fan-out is clamped to the core count by the simulator."""
    if not costs_by_bucket_size:
        raise ValueError("need at least one bucket-size candidate")
    best: Optional[Tuple[int, int, StreamSim]] = None
    table: List[Tuple[int, int, float, float]] = []
    for bucket_size in sorted(costs_by_bucket_size):
        costs = costs_by_bucket_size[bucket_size]
        for f in fanouts:
            sim = simulate_stream(
                costs, n_inputs, n_nodes=n_nodes, fanout=f, **sim_kwargs
            )
            table.append(
                (bucket_size, f, sim.makespan, sim.parallel_efficiency)
            )
            if best is None or sim.makespan < best[2].makespan:
                best = (bucket_size, f, sim)
    assert best is not None
    return AutotuneResult(
        bucket_size=best[0], fanout=best[1], sim=best[2], table=table
    )
