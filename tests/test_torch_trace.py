"""The port's tracer (``repro_torch.trace``): its clock is the profiler's,
the profiler turns it on, the pathology path's spans nest as the work is
caused, a label loop counts its host syncs, and tracing changes no output."""

import collections
import functools
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch import trace
from repro_torch.app import TABLE1_SPACE, ops, pipeline, run_dataset_study, synthetic_tile
from repro_torch.core import halton_sequence
from repro_torch.engine import ClusterSpec


def _kineto_events(prof, device_type):
    return [(ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
            for ev in prof.profiler.kineto_results.events() if ev.device_type() == device_type]


def test_now_ns_is_the_profilers_clock():
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    a = torch.randn(64, 64)
    torch.mm(a, a)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.recording():
            with trace.span("mm", "test"):
                torch.mm(a, a)
    (sp,) = trace.records()
    (mm,) = [ev for ev in _kineto_events(prof, DeviceType.CPU) if ev[0] == "aten::mm"]
    assert sp.start_ns <= mm[1] <= mm[2] <= sp.end_ns


def test_the_profiler_turns_recording_on():
    """Under ``torch.profiler`` the boundaries record without ``recording()``;
    after it they record nothing, and the next ``recording()`` drops them."""
    from torch.profiler import ProfilerActivity, profile

    with trace.recording():
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        assert trace.active()
        with trace.span("profiled", "test"):
            trace.count(n=1)
    assert not trace.active()
    with trace.span("after", "test"):
        pass
    (sp,) = trace.records()
    assert sp.name == "profiled" and sp.attrs == {"n": 1}
    with trace.recording():
        pass
    assert trace.records() == []


@pytest.fixture(scope="module")
def tiles():
    return [synthetic_tile(64, 64, seed=s) for s in (3, 4)]


@pytest.fixture(scope="module")
def param_sets():
    return [TABLE1_SPACE.default()] + list(TABLE1_SPACE.quantise(halton_sequence(5, TABLE1_SPACE.dim)))


def _descendants(spans, root):
    children = collections.defaultdict(list)
    for sp in spans:
        children[sp.parent].append(sp)
    out, todo = [], [root.id]
    while todo:
        for sp in children[todo.pop()]:
            out.append(sp)
            todo.append(sp.id)
    return out


def test_spans_nest_as_the_work_is_caused(tiles, param_sets, monkeypatch):
    # without straggler backups, each bucket runs once and its tasks are
    # exactly the ones the study counts
    monkeypatch.setattr(pipeline, "ClusterSpec",
                        functools.partial(ClusterSpec, enable_backup_tasks=False))
    with trace.recording():
        out = run_dataset_study(tiles, param_sets, n_workers=2, device="cpu")
    spans = trace.records()
    by_name = collections.defaultdict(list)
    for sp in spans:
        by_name[sp.name].append(sp)
    (study,) = by_name["study"]
    assert study.parent == 0 and study.attrs == {"tiles": 2, "runs": 2 * len(param_sets)}
    assert all(sp.study == study.id for sp in spans)
    for name in ("plan", "execute", "reference", "score"):
        (sp,) = by_name[name]
        assert sp.parent == study.id and study.start_ns <= sp.start_ns <= sp.end_ns <= study.end_ns
    assert by_name["score"][0].attrs == {"readbacks": 2 * len(param_sets)}

    task_names = {t.name for stage in pipeline.build_workflow(64, 64).stages for t in stage.tasks}
    ids = {sp.id: sp for sp in spans}
    tasks = [sp for sp in spans if sp.name in task_names]
    assert tasks and all(ids[sp.parent].name == "bucket.run" for sp in tasks)
    under = {name: [sp for sp in _descendants(spans, by_name[name][0]) if sp.name in task_names]
             for name in ("execute", "reference")}
    assert len(under["execute"]) == out["tasks_executed"]
    assert len(under["reference"]) == 8 * len(tiles)  # normalize and seven segmentation tasks
    assert len(under["execute"]) + len(under["reference"]) == len(tasks)
    for run in by_name["bucket.run"]:
        assert ids[run.parent].name in ("execute", "reference")
        assert run.attrs["executed"] == sum(1 for sp in tasks if sp.parent == run.id)
        assert run.thread != study.thread  # a worker thread

    # a bucket's key is unique within its execute_study call, whose span is the parent
    waits = {(sp.parent, sp.attrs["key"]): sp for sp in by_name["bucket.wait"]}
    runs = {(sp.parent, sp.attrs["key"]): sp for sp in by_name["bucket.run"]}
    assert waits.keys() == runs.keys() and len(runs) == len(by_name["bucket.run"])
    for key, run in runs.items():
        assert waits[key].start_ns <= waits[key].end_ns <= run.start_ns


def _serpentine(h, w):
    """A one-pixel corridor: rows 0, 2, 4, ... open, joined at the right end
    and the left end in turn."""
    mask = np.zeros((h, w), bool)
    for y in range(0, h, 2):
        mask[y, :] = True
        if y + 1 < h:
            mask[y + 1, w - 1 if (y // 2) % 2 == 0 else 0] = True
    return mask


def _longest_geodesic(mask, start, conn):
    """Breadth-first search through the mask from ``start``."""
    steps = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
             if (dy, dx) != (0, 0) and (conn == 8 or dy == 0 or dx == 0)]
    dist = {start: 0}
    frontier = [start]
    while frontier:
        nxt = []
        for y, x in frontier:
            for dy, dx in steps:
                p = (y + dy, x + dx)
                if (0 <= p[0] < mask.shape[0] and 0 <= p[1] < mask.shape[1] and mask[p]
                        and p not in dist):
                    dist[p] = dist[(y, x)] + 1
                    nxt.append(p)
        frontier = nxt
    assert len(dist) == mask.sum()  # one component
    return max(dist.values())


@pytest.mark.parametrize("conn", [4, 8])
def test_a_label_loop_counts_one_sync_a_step(conn):
    mask = _serpentine(9, 12)
    first = tuple(int(i) for i in np.argwhere(mask)[0])  # the lowest flat index
    want = _longest_geodesic(mask, first, conn) + 1  # and the pass that changes nothing
    with trace.recording():
        labels = ops.label_components(torch.from_numpy(mask), conn=conn)
    (loop,) = trace.records()
    assert loop.name == "label_loop" and loop.attrs == {"steps": want}
    assert bool((labels[torch.from_numpy(mask)] == 0).all())


def test_tracing_changes_no_output(tiles, param_sets):
    with trace.recording():
        pass
    off = run_dataset_study(tiles, param_sets, n_workers=2, device="cpu")
    assert trace.records() == []
    with trace.recording():
        on = run_dataset_study(tiles, param_sets, n_workers=2, device="cpu")
    assert trace.records()
    assert on["dice"] == off["dice"]
    assert all(np.array_equal(a, b) for a, b in zip(on["reference_masks"], off["reference_masks"]))


def test_spans_of_two_threads_keep_their_own_parents():
    seen = {}

    def worker(parent):
        with trace.span("child", "test", parent) as sp:
            with trace.span("grandchild", "test") as inner:
                seen["inner"] = inner
            seen["child"] = sp

    with trace.recording():
        with trace.span("root", "test") as root:
            t = threading.Thread(target=worker, args=(trace.current(),))
            t.start()
            t.join()
            trace.count(n=2)
            trace.count(n=3)
    assert seen["child"].parent == root.id and seen["inner"].parent == seen["child"].id
    assert seen["child"].study == seen["inner"].study == root.id
    assert root.attrs == {"n": 5}
    assert trace.current() is None


def test_many_threads_lose_no_span():
    """More threads than cores open and close spans at once under a short
    switch interval: every span is recorded once, with its own id, under
    its own thread's parent, with its counts."""
    n_threads, per_thread = 32, 300
    errors = []

    def worker():
        try:
            with trace.span("outer", "test") as outer:
                for _ in range(per_thread):
                    with trace.span("inner", "test") as inner:
                        trace.count(n=1)
                    assert inner.parent == outer.id and inner.attrs == {"n": 1}
        except AssertionError as e:
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with trace.recording():
            threads = [threading.Thread(target=worker) for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors
    spans = trace.records()
    assert len(spans) == n_threads * (per_thread + 1)
    assert len({sp.id for sp in spans}) == len(spans)
    outer = {sp.id: sp.thread for sp in spans if sp.name == "outer"}
    assert all(outer[sp.parent] == sp.thread for sp in spans if sp.name == "inner")


@pytest.mark.gpu
def test_a_kernels_device_interval_lies_inside_its_span():
    """On the card: a span around one ``morph_recon`` launch, closed after a
    sync and recorded because the profiler is on, holds the kernel's device
    interval as ``torch.profiler`` stamps it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import morph_recon

    rng = np.random.default_rng(0)
    mask = torch.from_numpy(rng.uniform(0, 100, (512, 512)).astype(np.float32)).cuda()
    marker = torch.clamp_min(mask - 20.0, 0.0)
    morph_recon.morph_reconstruct_cuda(marker, mask, conn=8)  # loads the library
    torch.cuda.synchronize()
    with trace.recording():
        pass
    with profile(activities=[ProfilerActivity.CUDA]) as prof:  # records without recording()
        with trace.span("launch", "test"):
            morph_recon.morph_reconstruct_cuda(marker, mask, conn=8)
            torch.cuda.synchronize()
    (sp,) = trace.records()
    kernels = [ev for ev in _kineto_events(prof, DeviceType.CUDA)
               if "recon_kernel" in ev[0]]
    assert kernels
    for _, start, end in kernels:
        assert sp.start_ns <= start <= end <= sp.end_ns
