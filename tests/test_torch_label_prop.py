"""The label loops' CUDA kernel (``repro_torch.kernels.label_prop``) against
their Python loops in ``repro_torch.app.ops``, its plain versions, and those
against the JAX package's ``label_components`` and ``watershed_split``.

The machine with the card has no JAX, so the card tests (marker ``gpu``)
hold the kernel to the Python loops, run on the card and on the CPU, with
``torch.equal``; the CPU tests hold the Python loops to JAX on the same
cases, which closes the chain. The CPU tests also cover the dispatch, the
wrapper's checks and the ``label_loop`` span's counts."""

import threading

import numpy as np
import pytest
import torch

from repro_torch import trace
from repro_torch.app import ops
from repro_torch.kernels import component_sizes, label_prop, ops as kops


@pytest.fixture(scope="module")
def jops():
    """The JAX side, imported here so that the card tests run where jax is
    not installed."""
    from repro.app import ops as jax_ops

    return jax_ops


# -- cases ------------------------------------------------------------------


def random_mask(h, w, seed, p=0.55):
    return np.random.default_rng(seed).uniform(size=(h, w)) < p


def serpentine(h, w):
    """A one-pixel corridor down the image: rows 0, 2, 4, ... open, joined
    at the right and the left end in turn (a geodesic of about h * w / 2)."""
    m = np.zeros((h, w), bool)
    m[::2] = True
    for y in range(1, h, 2):
        m[y, w - 1 if (y // 2) % 2 == 0 else 0] = True
    return m


def spiral(n):
    """A one-pixel-wide square spiral from (0, 0) inwards, its arms one
    pixel apart."""
    m = np.zeros((n, n), bool)
    y, x, dy, dx = 0, 0, 0, 1
    m[0, 0] = True
    while True:
        for _ in range(2):  # straight on, else turn right
            ny, nx, fy, fx = y + dy, x + dx, y + 2 * dy, x + 2 * dx
            ahead_free = not (0 <= fy < n and 0 <= fx < n and m[fy, fx])
            if 0 <= ny < n and 0 <= nx < n and not m[ny, nx] and ahead_free:
                y, x = ny, nx
                m[y, x] = True
                break
            dy, dx = dx, -dy
        else:
            return m


def discs(h, w, centres, r):
    yy, xx = np.mgrid[0:h, 0:w]
    return np.any([(yy - cy) ** 2 + (xx - cx) ** 2 < r * r for cy, cx in centres], axis=0)


def component_cases():
    """(name, mask): random masks, long diameters, empty and full, thin
    and ragged shapes (sizes no multiple of the kernel's 32 x 128 tile)."""
    return [
        ("random 65x33", random_mask(65, 33, 1)),
        ("random 31x1000", random_mask(31, 1000, 2, p=0.6)),
        ("random 130x257", random_mask(130, 257, 3, p=0.45)),
        ("serpentine 64x96", serpentine(64, 96)),
        ("spiral 63", spiral(63)),
        ("empty 40x52", np.zeros((40, 52), bool)),
        ("full 40x52", np.ones((40, 52), bool)),
        ("row 1x300", random_mask(1, 300, 4, p=0.8)),
        ("column 300x1", random_mask(300, 1, 5, p=0.8)),
        ("full row 1x257", np.ones((1, 257), bool)),
        ("discs 33x129", discs(33, 129, [(16, 20), (16, 45), (10, 100)], 12)),
    ]


def watershed_cases():
    """(name, mask): two and three floods colliding, plateau maxima (a
    rectangle's ridge), random, thin, empty and full."""
    rect = np.zeros((30, 70), bool)
    rect[5:17, 4:60] = True
    return [
        ("two discs 24x40", discs(24, 40, [(12, 13), (12, 27)], 8)),
        ("three discs 40x97", discs(40, 97, [(20, 20), (20, 40), (22, 62)], 12)),
        ("rectangle plateau 30x70", rect),
        ("random 40x52", random_mask(40, 52, 10, p=0.7)),
        ("random 65x33", random_mask(65, 33, 8, p=0.75)),
        ("row 1x300", random_mask(1, 300, 6, p=0.9)),
        ("column 300x1", random_mask(300, 1, 7, p=0.9)),
        ("empty 40x52", np.zeros((40, 52), bool)),
        ("full 40x52", np.ones((40, 52), bool)),
    ]


def flood_cases():
    """(name, seeds, pre) for the flood alone: plateau seeds (several
    pixels of one label), floods colliding, random seeds, thin shapes."""
    out = []
    h, w = 40, 60
    big = h * w
    pre = np.ones((h, w), bool)
    seeds = np.full((h, w), big, np.int32)
    seeds[10:13, 10:13] = 10 * w + 10  # a 3 x 3 plateau, one label
    seeds[30, 40:45] = 30 * w + 40  # a line plateau
    out.append(("plateau seeds 40x60", seeds, pre))
    pre = discs(24, 40, [(12, 13), (12, 27)], 8)
    seeds = np.full(pre.shape, pre.size, np.int32)
    seeds[12, 13], seeds[12, 27] = 12 * 40 + 13, 12 * 40 + 27
    out.append(("two floods 24x40", seeds, pre))
    rng = np.random.default_rng(11)
    pre = random_mask(70, 130, 12, p=0.65)
    seeds = np.where(pre & (rng.uniform(size=pre.shape) < 0.01),
                     np.arange(pre.size, dtype=np.int32).reshape(pre.shape), pre.size)
    out.append(("random seeds 70x130", seeds.astype(np.int32), pre))
    pre = spiral(31)
    seeds = np.full(pre.shape, pre.size, np.int32)
    seeds[0, 0] = 0
    ys, xs = np.nonzero(pre)
    seeds[ys[len(ys) // 2], xs[len(xs) // 2]] = 7  # a second seed halfway along
    out.append(("spiral two seeds 31", seeds, pre))
    pre = np.ones((1, 200), bool)
    seeds = np.full((1, 200), 200, np.int32)
    seeds[0, 0], seeds[0, 199] = 5, 3
    out.append(("row ends 1x200", seeds, pre))
    out.append(("column ends 200x1", seeds.reshape(200, 1).copy(), pre.reshape(200, 1).copy()))
    out.append(("empty pre 20x20", np.full((20, 20), 400, np.int32), np.zeros((20, 20), bool)))
    return out


def _ids(cases):
    return [c[0] for c in cases]


# -- the Python loops against JAX (CPU) -------------------------------------


@pytest.mark.parametrize("conn", [4, 8])
@pytest.mark.parametrize("case", component_cases(), ids=_ids(component_cases()))
def test_plain_label_components_equal_jax(jops, case, conn):
    import jax.numpy as jnp

    _, mask = case
    want = np.asarray(jops.label_components(jnp.asarray(mask), conn=conn))
    got = ops.label_components(torch.from_numpy(mask), conn=conn).numpy()
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("conn", [4, 8])
@pytest.mark.parametrize("case", watershed_cases(), ids=_ids(watershed_cases()))
def test_plain_watershed_split_equals_jax(jops, case, conn):
    import jax.numpy as jnp

    _, mask = case
    want = np.asarray(jops.watershed_split(jnp.asarray(mask), 5, conn=conn))
    got = ops.watershed_split(torch.from_numpy(mask), 5, conn=conn).numpy()
    np.testing.assert_array_equal(got, want)


def test_the_long_cases_are_long():
    """The spiral and the serpentine are one component each, one pixel
    wide, with a geodesic of about half their pixels."""
    for mask in (spiral(63), serpentine(64, 96)):
        t = torch.from_numpy(mask)
        with trace.recording():
            labels = ops.label_components(t, conn=8)
        (loop,) = trace.records()
        assert bool((labels[t] == 0).all())
        assert loop.attrs["steps"] > mask.sum() // 3


# -- the dispatch, the wrapper's checks, the span (CPU) ---------------------


class _Plain:
    """The label loops on their Python versions, whatever the tensors'
    device (``kops._on_card`` false)."""

    def __enter__(self):
        self._saved = kops._on_card
        kops._on_card = lambda t, use_kernel=None: False

    def __exit__(self, *exc):
        kops._on_card = self._saved


def test_cpu_tensors_take_the_python_loops():
    mask = torch.from_numpy(random_mask(40, 52, 10, p=0.7))
    before = label_prop.LAUNCHES.value
    with trace.recording():
        ops.watershed_split(mask, 5, conn=8)
    loops = [sp for sp in trace.records() if sp.name == "label_loop"]
    assert label_prop.LAUNCHES.value == before
    assert len(loops) == 3  # two labellings and the flood
    assert all(sp.attrs["steps"] > 0 and "launches" not in sp.attrs for sp in loops)


def test_the_span_counts_a_launch_and_no_sync_on_the_kernel_path(monkeypatch):
    """With the tensors taken for a card's, each loop is one call of the
    kernel's wrapper inside its ``label_loop`` span (steps 0, launches 1),
    and the results are the wrappers'."""
    mask = torch.from_numpy(discs(24, 40, [(12, 13), (12, 27)], 8))
    want = ops.watershed_split(mask, 5, conn=8)
    calls = []

    def fake(name, plain):
        def call(*args, conn):
            calls.append((name, trace.current()))
            with _Plain():
                return plain(*args, conn)
        return call

    monkeypatch.setattr(label_prop, "label_components_cuda",
                        fake("component", lambda m, conn: ops.label_components(m, conn=conn)))
    monkeypatch.setattr(label_prop, "flood_cuda", fake("flood", ops._flood))

    def size_filter(labels, lo, hi=None):  # the watershed's pre mask, on its plain version
        with _Plain():
            return (labels >= 0) & (ops.component_sizes(labels) >= lo)

    monkeypatch.setattr(component_sizes, "size_filter_cuda", size_filter)
    monkeypatch.setattr(kops, "_on_card", lambda t, use_kernel=None: True)
    with trace.recording():
        with trace.span("task", "test") as task:
            got = ops.watershed_split(mask, 5, conn=8)
    assert torch.equal(got, want)
    assert [name for name, _ in calls] == ["component", "component", "flood"]
    outer = [sp for sp in trace.records() if sp.name == "label_loop" and sp.parent == task.id]
    assert len(outer) == 3
    assert all(sp.attrs == {"steps": 0, "launches": 1} and sp.layer == "pathology tasks"
               for sp in outer)
    assert [sp.id for _, sp in calls] == [sp.id for sp in sorted(outer, key=lambda s: s.start_ns)]


def test_wrapper_refuses_cpu_tensors():
    mask = torch.zeros((8, 8), dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        label_prop.label_components_cuda(mask)
    with pytest.raises(ValueError, match="CUDA"):
        label_prop.flood_cuda(torch.zeros((8, 8), dtype=torch.int32), mask)


def test_wrapper_refuses_other_dtypes_shapes_and_layouts():
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="2-D"):
        label_prop.label_components_cuda(torch.zeros((2, 8, 8), dtype=torch.bool))
    with pytest.raises(ValueError, match="connectivity"):
        label_prop.label_components_cuda(torch.zeros((8, 8), dtype=torch.bool), conn=6)
    # 46341² pixels: past int32's labels, refused before the device is asked
    with pytest.raises(ValueError, match="int32"):
        label_prop.label_components_cuda(torch.empty((46341, 46341), dtype=torch.bool, **meta))
    with pytest.raises(ValueError, match="int32"):
        label_prop.flood_cuda(torch.empty((1, 2**31 - 1), dtype=torch.int32, **meta),
                              torch.empty((1, 2**31 - 1), dtype=torch.bool, **meta))


def test_wrapper_refuses_wrong_dtypes_and_layouts_on_a_card_device():
    """The dtype and layout checks, reached with tensors that report a CUDA
    device (the checks read only the device's type, dtype, shape and
    strides)."""

    class Fake:
        def __init__(self, t):
            self._t = t
            self.device = torch.device("cuda", 0)
            self.shape, self.dtype = t.shape, t.dtype

        def dim(self):
            return self._t.dim()

        def is_contiguous(self):
            return self._t.is_contiguous()

    good = Fake(torch.zeros((8, 8), dtype=torch.bool))
    with pytest.raises(TypeError, match="bool"):
        label_prop.label_components_cuda(Fake(torch.zeros((8, 8), dtype=torch.uint8)))
    with pytest.raises(TypeError, match="int32"):
        label_prop.flood_cuda(Fake(torch.zeros((8, 8), dtype=torch.int64)), good)
    with pytest.raises(ValueError, match="contiguous"):
        label_prop.label_components_cuda(Fake(torch.zeros((8, 16), dtype=torch.bool)[:, ::2]))
    with pytest.raises(ValueError, match="contiguous"):
        label_prop.flood_cuda(Fake(torch.zeros((8, 8), dtype=torch.int32)),
                              Fake(torch.zeros((8, 8), dtype=torch.bool).t()))
    with pytest.raises(ValueError, match="must match"):
        label_prop.flood_cuda(Fake(torch.zeros((8, 9), dtype=torch.int32)), good)


# -- the kernel on a card ---------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _plain_steps(fn, *args, **kw):
    """``fn``'s result with the Python loops, and each loop's steps."""
    with _Plain(), trace.recording():
        out = fn(*args, **kw)
    return out, [sp.attrs["steps"] for sp in sorted(trace.records(), key=lambda s: s.start_ns)
                 if sp.name == "label_loop"]


def _kernel_steps(fn, *args, **kw):
    """``fn``'s result on the kernel, its launches, and the steps the
    kernel counted on the card."""
    torch.cuda.synchronize()
    launches, steps = label_prop.LAUNCHES.value, label_prop.STEPS.value
    with trace.recording():
        out = fn(*args, **kw)
    torch.cuda.synchronize()
    loops = [sp for sp in trace.records() if sp.name == "label_loop"]
    assert all(sp.attrs == {"steps": 0, "launches": 1} for sp in loops)
    return out, label_prop.LAUNCHES.value - launches, label_prop.STEPS.value - steps


@pytest.mark.gpu
@pytest.mark.parametrize("conn", [4, 8])
def test_kernel_labels_equal_the_python_loop(conn):
    dev = _card()
    for name, mask in component_cases():
        m = torch.from_numpy(mask).to(dev)
        got, launches, steps = _kernel_steps(ops.label_components, m, conn=conn)
        want, (want_steps,) = _plain_steps(ops.label_components, m, conn=conn)
        cpu = ops.label_components(torch.from_numpy(mask), conn=conn)
        assert got.dtype == torch.int32 and torch.equal(got, want), name
        assert torch.equal(got.cpu(), cpu), name
        assert launches == 1 and steps == want_steps, (name, launches, steps, want_steps)


@pytest.mark.gpu
@pytest.mark.parametrize("conn", [4, 8])
def test_kernel_flood_equals_the_python_loop(conn):
    dev = _card()
    for name, seeds, pre in flood_cases():
        s, p = torch.from_numpy(seeds).to(dev), torch.from_numpy(pre).to(dev)
        got, launches, steps = _kernel_steps(ops._flood, s, p, conn)
        want, (want_steps,) = _plain_steps(ops._flood, s, p, conn)
        cpu = ops._flood(torch.from_numpy(seeds), torch.from_numpy(pre), conn)
        assert torch.equal(got, want) and torch.equal(got.cpu(), cpu), name
        assert launches == 1 and steps == want_steps, (name, launches, steps, want_steps)


@pytest.mark.gpu
@pytest.mark.parametrize("conn", [4, 8])
def test_kernel_watershed_equals_the_python_loops(conn):
    dev = _card()
    for name, mask in watershed_cases():
        m = torch.from_numpy(mask).to(dev)
        got, launches, steps = _kernel_steps(ops.watershed_split, m, 5, conn=conn)
        want, want_steps = _plain_steps(ops.watershed_split, m, 5, conn=conn)
        cpu = ops.watershed_split(torch.from_numpy(mask), 5, conn=conn)
        assert torch.equal(got, want) and torch.equal(got.cpu(), cpu), name
        assert launches == 3 and steps == sum(want_steps), (name, launches, steps, want_steps)


def _mosaic_inputs(dev):
    """A 4096² mosaic of the benchmark's inputs (``perfbench/traffic``),
    taken through Seg3 with the default parameters: the ``area_pre``
    input, and the watershed's (``area_pre``'s output)."""
    from perfbench.traffic import inputs
    from repro_torch.app import pipeline

    pool = inputs.sub_tile_pool(2**31 + 26, 64, 512)
    tile = inputs.mosaic(pool, 2**31 + 26, 0, 0, 8)
    params = dict(pipeline.TABLE1_SPACE.default())
    st = pipeline._t_normalize({"raw": torch.from_numpy(tile).to(dev)})
    st = pipeline._t_background(st, params["B"], params["G"], params["R"])
    st = pipeline._t_rbc(st, params["T1"], params["T2"])
    st = pipeline._t_recon(st, params["G1"], params["RC"])
    area_pre_in = pipeline._t_threshold(st, params["G2"], params["FH"])["mask"]
    watershed_in = pipeline._t_area_pre({"mask": area_pre_in}, params["minS"],
                                        params["maxS"])["mask"]
    return area_pre_in, watershed_in, params


@pytest.mark.gpu
def test_kernel_on_the_mosaic_equals_the_python_loops():
    dev = _card()
    area_pre_in, watershed_in, params = _mosaic_inputs(dev)
    assert area_pre_in.shape == (4096, 4096) and int(area_pre_in.sum()) > 0
    for conn in (4, 8):
        got, launches, steps = _kernel_steps(ops.label_components, area_pre_in, conn=conn)
        want, (want_steps,) = _plain_steps(ops.label_components, area_pre_in, conn=conn)
        assert torch.equal(got, want) and launches == 1 and steps == want_steps
        args = (watershed_in, int(params["minSPL"]))
        got, launches, steps = _kernel_steps(ops.watershed_split, *args, conn=conn)
        want, want_steps = _plain_steps(ops.watershed_split, *args, conn=conn)
        assert torch.equal(got, want) and launches == 3 and steps == sum(want_steps)


@pytest.mark.gpu
def test_a_call_does_not_wait_for_the_card():
    dev = _card()
    mask = torch.from_numpy(spiral(63)).to(dev)
    label_prop.label_components_cuda(mask)
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)  # the stream stays busy for some milliseconds
    label_prop.label_components_cuda(mask)
    assert not torch.cuda.current_stream().query()


@pytest.mark.gpu
def test_two_threads_on_two_streams_give_equal_results():
    dev = _card()
    mask = torch.from_numpy(random_mask(1024, 1024, 21, p=0.6)).to(dev)
    want = label_prop.label_components_cuda(mask, conn=8)
    torch.cuda.synchronize()
    results = [[], []]

    def worker(slot):
        stream = torch.cuda.Stream()
        with torch.cuda.stream(stream):
            results[slot] = [label_prop.label_components_cuda(mask, conn=8) for _ in range(4)]
        stream.synchronize()

    threads = [threading.Thread(target=worker, args=(i,), daemon=True) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    torch.cuda.synchronize()
    assert len(results[0]) == len(results[1]) == 4
    assert all(torch.equal(g, want) for g in results[0] + results[1])


@pytest.mark.gpu
def test_grid_over_occupancy_limit_raises():
    dev = _card()
    mask = torch.from_numpy(random_mask(256, 512, 3)).to(dev)
    limit = label_prop.max_blocks(label_prop.COMPONENT, 8)
    assert label_prop.kernel_tile()[:2] == label_prop.TILE and limit > 0
    with pytest.raises(RuntimeError, match="resident"):
        label_prop._launch(label_prop.COMPONENT, mask, None, 8, grid_blocks=limit + 1)
    want = ops.label_components(mask.cpu(), conn=8).to(dev)
    assert torch.equal(label_prop._launch(label_prop.COMPONENT, mask, None, 8,
                                          grid_blocks=limit), want)
    # a grid of one block walks every tile itself
    assert torch.equal(label_prop._launch(label_prop.COMPONENT, mask, None, 8,
                                          grid_blocks=1), want)
