"""A run with its timed path broken underneath reads ``correct`` false:
each fault alters a token or an answer where the program produces it.
The runs skip the harness's look for a card and run the tiny cells on the
CPU; the rest of the run is the benchmark's own."""

import contextlib

import pytest
import torch

from perfbench import harness
from perfbench.tests import cells


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return cells.write(tmp_path_factory.mktemp("checkout"))


def _patched(module, name, make):
    @contextlib.contextmanager
    def patch():
        orig = getattr(module, name)
        setattr(module, name, make(orig))
        try:
            yield
        finally:
            setattr(module, name, orig)
    return patch


def _mask_cut(orig):
    def area_final(state, minSS, maxSS):
        out = orig(state, minSS, maxSS)
        mask = out["mask"].clone()
        mask[: mask.shape[0] // 2, : mask.shape[1] // 2] = False
        return {"mask": mask}
    return area_final


def _dice_off(orig):
    return lambda a, b: orig(a, b) * 0.999


def _faults():
    from repro_torch.app import pipeline

    return {
        "mask_altered": ("tiny.moat", _patched(pipeline, "_t_area_final", _mask_cut)),
        "dice_altered": ("tiny.moat", _patched(pipeline, "dice", _dice_off)),
    }


@pytest.mark.parametrize("fault", ["mask_altered", "dice_altered"])
def test_a_fault_reads_not_correct(root, fault):
    cell, patch = _faults()[fault]
    result = harness.run_cell(root, cell, 2**31 + 303, 0.0, False, device=torch.device("cpu"),
                              patch=patch)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


@pytest.mark.parametrize("cell", sorted(cells.CELLS))
def test_the_same_run_unbroken_reads_correct(root, cell):
    result = harness.run_cell(root, cell, 2**31 + 303, 0.0, False, device=torch.device("cpu"))
    assert result["correct"] is True
