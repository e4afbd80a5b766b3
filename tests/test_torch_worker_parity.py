"""The port's studies on worker processes against the JAX package's, on the
CPU at 32², on the same numpy tiles made from a seed.

- ``run_study`` and ``run_dataset_study`` with ``backend="process"`` and
  ``"socket"`` (spawned workers rebuilding the study through
  ``pathology_rpc_build``, results crossing as store keys) give the Dice
  lists and plan counts of JAX's thread backend, with ``==``;
- ``run_fleet_study`` (two spawned StudyDriver processes over one store
  directory) gives the round records and best point of JAX's in-process
  ``StudyDriver`` over JAX's ``pathology_fleet_build``, with ``==``, and no
  corrupt read.

Also the device rule in the workers (a worker built with ``device=None``
and no CUDA raises, and reports its device in its stats) and the refusal
of ``fork`` where a card is present. Tolerance: none; at 32² every Dice
value and objective is bit-equal to JAX's.
"""

import pytest
import torch

from repro_torch.app import (
    TABLE1_SPACE,
    build_workflow,
    run_dataset_study,
    run_fleet_study,
    run_study,
)
from repro_torch.app.pipeline import _round_detail, pathology_rpc_build, synthetic_tile
from repro_torch.core import halton_sequence
from repro_torch.engine import execute_plan, plan_study
from repro_torch.runtime import ProcessRpcBackend, RemoteTaskError, SocketBackend
from repro_torch.runtime.transport import worker_context
from repro_torch.study import run_fleet_study as study_run_fleet

pytestmark = pytest.mark.filterwarnings("ignore::ResourceWarning")

SIZE = 32
BACKENDS = ["process", "socket"]


@pytest.fixture(scope="module")
def tiles():
    return [synthetic_tile(SIZE, SIZE, seed=s) for s in (1, 2)]


@pytest.fixture(scope="module")
def param_sets():
    sets = TABLE1_SPACE.quantise(halton_sequence(5, TABLE1_SPACE.dim))
    return [TABLE1_SPACE.default()] + list(sets)


@pytest.fixture(scope="module")
def jax_study(tiles, param_sets):
    from repro.app import run_study as j_study

    return j_study(tiles[0], param_sets)


@pytest.fixture(scope="module")
def jax_dataset(tiles, param_sets):
    from repro.app import run_dataset_study as j_dataset

    return j_dataset(tiles, param_sets)


@pytest.mark.parametrize("backend", BACKENDS)
def test_run_study_on_workers_matches_jax(tiles, param_sets, jax_study, backend):
    out = run_study(tiles[0], param_sets, backend=backend, device="cpu")
    assert out["backend"] == backend
    assert out["dice"] == jax_study["dice"]
    for key in ("tasks_total", "planned_tasks_executed", "tasks_executed", "reuse_fraction",
                "peak_bytes", "cache_hits"):
        assert out[key] == jax_study[key], key


@pytest.mark.parametrize("backend", BACKENDS)
def test_run_dataset_study_on_workers_matches_jax(tiles, param_sets, jax_dataset, backend):
    """Two workers each way: Dice equal; the measured counts cover the plan
    exactly, whichever attempt of a bucket won."""
    out = run_dataset_study(tiles, param_sets, backend=backend, device="cpu")
    assert out["backend"] == backend
    assert out["dice"] == jax_dataset["dice"]
    for key in ("tasks_total", "planned_tasks_executed"):
        assert out[key] == jax_dataset[key], key
    assert out["tasks_executed"] + out["cache_hits"] == out["planned_tasks_executed"]


def test_fleet_matches_jax_single_process_driver(tmp_path):
    from repro.app.pipeline import pathology_fleet_build as j_build
    from repro.engine import ClusterSpec as JCluster
    from repro.study import StudyDriver as JDriver

    fleet = run_fleet_study(n_procs=2, store_dir=str(tmp_path / "store"), size=SIZE,
                            n_tiles=2, max_rounds=2, device="cpu")
    b = j_build(size=SIZE, n_tiles=2)
    driver = JDriver(b["workflow"], b["space"], b["inputs"], objective=b["objective"], seed=0,
                     n_boot=16, engine_policy="hybrid", cluster=JCluster(n_workers=1),
                     input_keys=b["input_keys"])
    try:
        single = driver.run(max_rounds=2)
    finally:
        driver.close()
    state = fleet["state"]
    assert state.evaluated == single.evaluated
    assert len(state.rounds) == len(single.rounds) == 2
    for fr, sr in zip(state.rounds, single.rounds):
        assert (fr.kind, fr.param_sets, fr.outputs) == (sr.kind, sr.param_sets, sr.outputs)
        assert fr.analysis == sr.analysis and fr.decision == sr.decision
    assert fleet["best"] == {"params": dict(single.best[0]), "objective": single.best[1]}
    assert fleet["active"] == list(single.active)
    assert fleet["fleet"]["corrupt"] == 0
    assert 0 < fleet["fleet"]["tasks_executed"] < 2 * single.tasks_executed
    # both workers built on the CPU: no CUDA context, the plain versions
    assert len(fleet["fleet"]["worker_pids"]) == 2
    assert fleet["fleet"]["build"] == {"on_cuda": 0, "cuda_context": 0,
                                       "morph_recon_launches": 0, "launched_morph_recon": 0,
                                       "max_memory_allocated": 0}
    assert [_round_detail(r) for r in state.rounds] == fleet["rounds_detail"]


def _one_run_plan(tile):
    return plan_study(build_workflow(*tile.shape[:2]), [TABLE1_SPACE.default()],
                      policy="rmsr", active_paths=1)


def test_worker_build_without_cuda_raises(tiles):
    """``pathology_rpc_build`` resolves its device in the worker: ``None``
    there means the card, and without CUDA the build raises; the worker
    parks the error and fails every lease with it. Nothing falls back to
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the CUDA-less refusal")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pathology_rpc_build([tiles[0]])
    backend = ProcessRpcBackend(pathology_rpc_build, {"images": [tiles[0]]})
    raw = {"raw": torch.from_numpy(tiles[0])}
    try:
        with pytest.raises(RemoteTaskError, match="no CUDA device"):
            execute_plan(_one_run_plan(tiles[0]), raw, backend=backend)
    finally:
        backend.cleanup()
    with pytest.raises(RuntimeError, match="CUDA"):
        run_study(tiles[0], [TABLE1_SPACE.default()], backend="process")


@pytest.mark.parametrize("backend_cls", [ProcessRpcBackend, SocketBackend])
def test_workers_report_their_device(tiles, backend_cls):
    """Each worker ships what its build reports of its device with its
    heartbeats; the backend sums it over the workers."""
    kwargs = {"images": [tiles[0]], "device": "cpu"}
    backend = backend_cls(build=pathology_rpc_build, build_kwargs=kwargs, heartbeat_interval=0.05)
    raw = {"raw": torch.from_numpy(tiles[0])}
    try:
        result = execute_plan(_one_run_plan(tiles[0]), raw, backend=backend)
        assert result.backend == backend.name
        report = backend.stats()["worker"]["build"]
    finally:
        backend.cleanup()
    assert report == {"on_cuda": 0, "cuda_context": 0, "morph_recon_launches": 0,
                      "launched_morph_recon": 0, "max_memory_allocated": 0}


def test_fork_is_refused_where_a_card_is_present(monkeypatch, tmp_path):
    """A forked worker cannot use its parent's CUDA context: with a card
    present, every way of starting workers refuses ``fork`` before it
    starts anything, and ``spawn`` stays allowed."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="spawn"):
        worker_context("fork")
    assert worker_context("spawn").get_start_method() == "spawn"
    with pytest.raises(ValueError, match="spawn"):
        ProcessRpcBackend(mp_context="fork").start(1)
    sock = SocketBackend(mp_context="fork")
    with pytest.raises(ValueError, match="spawn"):
        sock.start(1)
    assert sock.address is None
    sock.cleanup()
    with pytest.raises(ValueError, match="spawn"):
        study_run_fleet(pathology_rpc_build, {}, store_dir=str(tmp_path), mp_context="fork")
    assert not any(tmp_path.iterdir())
