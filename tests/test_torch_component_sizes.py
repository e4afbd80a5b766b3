"""The component-sizes kernel (``repro_torch.kernels.component_sizes``)
against its plain version in ``repro_torch.app.ops`` (``torch.bincount``),
and that against the JAX package's ``component_sizes`` and ``area_filter``.

The machine with the card has no JAX, so the card tests (marker ``gpu``)
hold the kernel to the plain version on the same labels with
``torch.equal``; the CPU tests hold the plain version to JAX on the same
cases, which closes the chain. The CPU tests also cover the route, the
wrapper's checks, its bounds and the ``component_sizes`` span's counts."""

import threading

import numpy as np
import pytest
import torch

from repro_torch import trace
from repro_torch.app import ops
from repro_torch.kernels import component_sizes as sizes_kernel, label_prop, ops as kops

from test_torch_label_prop import _Plain, _mosaic_inputs, discs, random_mask

INT32_MAX = 2**31 - 1


@pytest.fixture(scope="module")
def jops():
    """The JAX side, imported here so that the card tests run where jax is
    not installed."""
    from repro.app import ops as jax_ops

    return jax_ops


# -- cases ------------------------------------------------------------------


def checkerboard(h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    return (yy + xx) % 2 == 0


def ragged(h, w):
    """Discs of many radii on a ragged image (no side a multiple of 4 or of
    a warp's 128 pixels), with single pixels and a bar between them."""
    m = discs(h, w, [(9, 9), (20, 40), (30, 95), (33, 120)], 1)
    for (cy, cx), r in zip([(9, 9), (20, 40), (30, 95), (33, 120)], (2, 6, 11, 4)):
        m |= discs(h, w, [(cy, cx)], r)
    m[2, 60:110] = True
    m[::7, 3] = True
    return m


def mask_cases():
    """(name, mask): empty, full, checkerboard singletons (one component
    at conn 8), random, ragged sizes, one row and one column."""
    return [
        ("empty 40x52", np.zeros((40, 52), bool)),
        ("full 40x52", np.ones((40, 52), bool)),
        ("checkerboard 33x47", checkerboard(33, 47)),
        ("random 65x33", random_mask(65, 33, 31, p=0.5)),
        ("random 130x257", random_mask(130, 257, 32, p=0.4)),
        ("ragged 37x131", ragged(37, 131)),
        ("row 1x301", random_mask(1, 301, 33, p=0.7)),
        ("column 301x1", random_mask(301, 1, 34, p=0.7)),
    ]


# (lo, hi): a band, singletons alone, everything, hi below lo, lo <= 0
BANDS = [(3, 40), (1, 1), (0, 10**6), (5, 2), (-4, 1)]


def _ids(cases):
    return [c[0] for c in cases]


def _keep(mask, sizes, lo, hi):
    """The plain version's size test: ``mask & lo <= sizes <= hi``."""
    return mask & (sizes >= lo) & (sizes <= hi)


# -- the plain version against JAX (CPU) ------------------------------------


@pytest.mark.parametrize("conn", [4, 8])
@pytest.mark.parametrize("case", mask_cases(), ids=_ids(mask_cases()))
def test_plain_component_sizes_equal_jax(jops, case, conn):
    import jax.numpy as jnp

    _, mask = case
    labels = ops.label_components(torch.from_numpy(mask), conn=conn)
    want = np.asarray(jops.component_sizes(jnp.asarray(labels.numpy())))
    got = ops.component_sizes(labels).numpy()
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert (got[~mask] == 0).all() and (got[mask] > 0).all()


@pytest.mark.parametrize("conn", [4, 8])
@pytest.mark.parametrize("case", mask_cases(), ids=_ids(mask_cases()))
def test_plain_area_filter_equals_jax(jops, case, conn):
    import jax.numpy as jnp

    _, mask = case
    for lo, hi in BANDS:
        want = np.asarray(jops.area_filter(jnp.asarray(mask), lo, hi, conn=conn))
        got = ops.area_filter(torch.from_numpy(mask), lo, hi, conn=conn).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"[{lo}, {hi}]")


def test_checkerboard_is_singletons_at_conn_4_and_one_component_at_conn_8():
    mask = torch.from_numpy(checkerboard(33, 47))
    assert set(ops.component_sizes(ops.label_components(mask, conn=4))[mask].tolist()) == {1}
    assert set(ops.component_sizes(ops.label_components(mask, conn=8))[mask].tolist()) == {
        int(mask.sum())}


# -- the bounds (CPU) -------------------------------------------------------


def test_bounds_round_inwards_and_clamp_to_int32():
    assert sizes_kernel.bounds(0, None) == (0, INT32_MAX)
    assert sizes_kernel.bounds(-5, 3) == (-5, 3)
    assert sizes_kernel.bounds(5, 2) == (5, 2)
    assert sizes_kernel.bounds(2.5, 7.9) == (3, 7)
    assert sizes_kernel.bounds(-2.5, -0.5) == (-2, -1)
    assert sizes_kernel.bounds(2**40, -(2**40)) == (INT32_MAX, -(2**31))
    assert sizes_kernel.bounds(-(2**40), 2**40) == (-(2**31), INT32_MAX)


@pytest.mark.parametrize("lo, hi", BANDS + [(2.5, 7.9), (2**40, 2**41), (-(2**40), -(2**33)),
                                            (-(2**40), 2**40), (0, None), (4, None)])
def test_the_kernels_size_test_with_its_bounds_is_the_plain_one(lo, hi):
    """The kernel's test, ``label >= 0 && lo <= size <= hi`` on the clamped
    int32 bounds, written out in PyTorch: equal to the plain version's on
    every size a component can have. The plain side compares in int64:
    PyTorch wraps a Python int past int32 when it compares it with an int32
    tensor (2**40 reads as 0), which the clamped bounds do not."""
    mask = torch.from_numpy(ragged(37, 131))
    labels = ops.label_components(mask, conn=8)
    sizes = ops.component_sizes(labels)
    lo_i, hi_i = sizes_kernel.bounds(lo, hi)
    kernel = (labels >= 0) & (sizes >= lo_i) & (sizes <= hi_i)
    wide = sizes.to(torch.int64)
    plain = mask & (wide >= lo) if hi is None else _keep(mask, wide, lo, hi)
    assert torch.equal(kernel, plain)


# -- the route and the span (CPU) -------------------------------------------


def _fake_kernels(monkeypatch):
    """Every kernel of the pathology ops faked on their plain versions,
    with the tensors taken for a card's; returns the sizes kernel's calls
    as (mode, bounds, the span open at the call)."""
    calls = []

    def sizes(labels):
        calls.append(("sizes", None, trace.current()))
        with _Plain():
            return ops.component_sizes(labels)

    def size_filter(labels, lo, hi=None):
        calls.append(("filter", (lo, hi), trace.current()))
        with _Plain():
            s = ops.component_sizes(labels)
        lo_i, hi_i = sizes_kernel.bounds(lo, hi)
        return (labels >= 0) & (s >= lo_i) & (s <= hi_i)

    def labelled(m, conn):
        with _Plain():
            return ops.label_components(m, conn=conn)

    def flood(seeds, pre, conn):
        with _Plain():
            return ops._flood(seeds, pre, conn)

    monkeypatch.setattr(label_prop, "label_components_cuda", labelled)
    monkeypatch.setattr(label_prop, "flood_cuda", flood)
    monkeypatch.setattr(sizes_kernel, "component_sizes_cuda", sizes)
    monkeypatch.setattr(sizes_kernel, "size_filter_cuda", size_filter)
    monkeypatch.setattr(kops, "_on_card", lambda t, use_kernel=None: True)
    return calls


def _size_spans(task):
    return [sp for sp in trace.records() if sp.name == "component_sizes"
            and sp.parent == task.id]


@pytest.mark.parametrize("conn", [4, 8])
def test_card_tensors_take_the_kernel_in_one_span_a_call(monkeypatch, conn):
    mask = torch.from_numpy(discs(24, 40, [(12, 13), (12, 27), (3, 36)], 5))
    labels = ops.label_components(mask, conn=conn)
    want = {"sizes": ops.component_sizes(labels),
            "area": ops.area_filter(mask, 10, 60, conn=conn),
            "watershed": ops.watershed_split(mask, 20, conn=conn)}
    calls = _fake_kernels(monkeypatch)
    for name, fn, mode, bounds in [
            ("sizes", lambda: ops.component_sizes(labels), "sizes", None),
            ("area", lambda: ops.area_filter(mask, 10, 60, conn=conn), "filter", (10, 60)),
            ("watershed", lambda: ops.watershed_split(mask, 20, conn=conn), "filter", (20, None))]:
        calls.clear()
        with trace.recording():
            with trace.span("task", "test") as task:
                got = fn()
        assert torch.equal(got, want[name]), name
        (span,) = _size_spans(task)
        assert [(m, b) for m, b, _ in calls] == [(mode, bounds)], name
        assert calls[0][2] is span, name  # the call runs inside the span, outside every label loop
        assert span.attrs == {"launches": 1} and span.layer == "pathology tasks", name


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    mask = torch.from_numpy(discs(24, 40, [(12, 13), (12, 27)], 8))
    before = sizes_kernel.LAUNCHES.value
    for fn, n in [(lambda: ops.area_filter(mask, 10, 1000), 1),
                  (lambda: ops.watershed_split(mask, 5, conn=8), 1),
                  (lambda: ops.component_sizes(ops.label_components(mask)), 1)]:
        with trace.recording():
            with trace.span("task", "test") as task:
                fn()
        spans = _size_spans(task)
        assert len(spans) == n and all(sp.attrs == {"launches": 0} for sp in spans)
    assert sizes_kernel.LAUNCHES.value == before


# -- the wrapper's checks (CPU) ---------------------------------------------


def test_wrapper_refuses_cpu_tensors():
    labels = torch.zeros((8, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        sizes_kernel.component_sizes_cuda(labels)
    with pytest.raises(ValueError, match="CUDA"):
        sizes_kernel.size_filter_cuda(labels, 1, 4)


def test_wrapper_refuses_other_shapes_and_oversized_labels():
    with pytest.raises(ValueError, match="2-D"):
        sizes_kernel.component_sizes_cuda(torch.zeros((2, 8, 8), dtype=torch.int32))
    with pytest.raises(ValueError, match="2-D"):
        sizes_kernel.size_filter_cuda(torch.zeros(64, dtype=torch.int32), 1)
    # past int32's labels and counts, refused before the device is asked
    with pytest.raises(ValueError, match="int32"):
        sizes_kernel.component_sizes_cuda(torch.empty((46341, 46341), dtype=torch.int32,
                                                      device="meta"))
    with pytest.raises(ValueError, match="int32"):
        sizes_kernel.size_filter_cuda(torch.empty((1, 2**31 - 1), dtype=torch.int32,
                                                  device="meta"), 1)


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

    for wrapper in (sizes_kernel.component_sizes_cuda,
                    lambda t: sizes_kernel.size_filter_cuda(t, 1, 9)):
        with pytest.raises(TypeError, match="int32"):
            wrapper(Fake(torch.zeros((8, 8), dtype=torch.int64)))
        with pytest.raises(TypeError, match="int32"):
            wrapper(Fake(torch.zeros((8, 8), dtype=torch.bool)))
        with pytest.raises(ValueError, match="contiguous"):
            wrapper(Fake(torch.zeros((8, 16), dtype=torch.int32)[:, ::2]))
        with pytest.raises(ValueError, match="contiguous"):
            wrapper(Fake(torch.zeros((8, 9), dtype=torch.int32).t()))


# -- the kernel on a card ---------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _plain_sizes(labels):
    """The plain version (``torch.bincount``) on the labels' device."""
    with _Plain():
        return ops.component_sizes(labels)


def _check_both_modes(labels, mask, name):
    """The kernel in both modes against the plain version on ``labels``,
    one launch a call."""
    want = _plain_sizes(labels)
    before = sizes_kernel.LAUNCHES.value
    got = sizes_kernel.component_sizes_cuda(labels)
    assert got.dtype == torch.int32 and torch.equal(got, want), name
    for lo, hi in BANDS + [(0, None), (7, None)]:
        keep = sizes_kernel.size_filter_cuda(labels, lo, hi)
        plain = mask & (want >= lo) if hi is None else _keep(mask, want, lo, hi)
        assert keep.dtype == torch.bool and torch.equal(keep, plain), (name, lo, hi)
    assert sizes_kernel.LAUNCHES.value - before == 1 + len(BANDS) + 2


@pytest.mark.gpu
@pytest.mark.parametrize("conn", [4, 8])
def test_kernel_equals_the_plain_version_in_both_modes(conn):
    dev = _card()
    for name, mask in mask_cases():
        m = torch.from_numpy(mask).to(dev)
        labels = ops.label_components(m, conn=conn)
        _check_both_modes(labels, m, name)
        # the same labels at an offset of one int32: the kernel's scalar loads
        buf = torch.empty(labels.numel() + 1, dtype=torch.int32, device=dev)
        buf[1:] = labels.reshape(-1)
        shifted = buf[1:].view(labels.shape)
        assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
        _check_both_modes(shifted, m, name + " at an offset")


@pytest.mark.gpu
def test_kernel_on_one_whole_component_and_on_all_background():
    """At 4096²: every pixel on one root (every warp's atomic on one word)
    and no pixel labelled (no atomic at all)."""
    dev = _card()
    n = 4096
    full = torch.ones((n, n), dtype=torch.bool, device=dev)
    labels = torch.zeros((n, n), dtype=torch.int32, device=dev)
    assert torch.equal(ops.label_components(full), labels)
    _check_both_modes(labels, full, "one component 4096²")
    assert int(sizes_kernel.component_sizes_cuda(labels)[0, 0]) == n * n
    empty = torch.zeros_like(full)
    background = torch.full((n, n), -1, dtype=torch.int32, device=dev)
    _check_both_modes(background, empty, "background 4096²")
    assert not bool(sizes_kernel.component_sizes_cuda(background).any())


@pytest.mark.gpu
def test_kernel_on_the_mosaic_and_the_filters_end_to_end():
    """A 4096² mosaic of the benchmark's inputs through Seg3: the kernel in
    both modes on the ``area_pre`` labels; ``area_filter`` and
    ``watershed_split`` on the card against the CPU."""
    dev = _card()
    area_pre_in, watershed_in, params = _mosaic_inputs(dev)
    for conn in (4, 8):
        labels = ops.label_components(area_pre_in, conn=conn)
        _check_both_modes(labels, area_pre_in, f"mosaic conn {conn}")
    lo, hi = int(params["minS"]), int(params["maxS"])
    got = ops.area_filter(area_pre_in, lo, hi)
    assert torch.equal(got.cpu(), ops.area_filter(area_pre_in.cpu(), lo, hi))
    for conn in (4, 8):
        got = ops.watershed_split(watershed_in, int(params["minSPL"]), conn=conn)
        want = ops.watershed_split(watershed_in.cpu(), int(params["minSPL"]), conn=conn)
        assert torch.equal(got.cpu(), want), conn


@pytest.mark.gpu
def test_the_card_path_makes_no_host_sync():
    dev = _card()
    mask = torch.from_numpy(random_mask(256, 384, 41, p=0.6)).to(dev)
    labels = ops.label_components(mask)
    want = [ops.area_filter(mask, 3, 40), ops.watershed_split(mask, 5, conn=8),
            ops.component_sizes(labels)]  # built and loaded
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [ops.area_filter(mask, 3, 40), ops.watershed_split(mask, 5, conn=8),
               ops.component_sizes(labels)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)  # the stream stays busy for some milliseconds
    sizes_kernel.size_filter_cuda(labels, 3, 40)
    assert not torch.cuda.current_stream().query()


@pytest.mark.gpu
def test_two_threads_on_two_streams_give_equal_results():
    dev = _card()
    mask = torch.from_numpy(random_mask(1024, 1024, 42, p=0.6)).to(dev)
    labels = ops.label_components(mask)
    want = (sizes_kernel.component_sizes_cuda(labels),
            sizes_kernel.size_filter_cuda(labels, 3, 40))
    torch.cuda.synchronize()
    results = [[], []]

    def worker(slot):
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.default_stream())
        with torch.cuda.stream(stream):
            results[slot] = [(sizes_kernel.component_sizes_cuda(labels),
                              sizes_kernel.size_filter_cuda(labels, 3, 40)) for _ in range(4)]
        stream.synchronize()

    threads = [threading.Thread(target=worker, args=(i,), daemon=True) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    torch.cuda.synchronize()
    assert len(results[0]) == len(results[1]) == 4
    assert all(torch.equal(s, want[0]) and torch.equal(k, want[1])
               for s, k in results[0] + results[1])
