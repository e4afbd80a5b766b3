"""The control, on the card: the reference computed one precision below
the configuration's, put in the program's place, has to read not correct
against the cell's limits, while the program reads correct. At a size a
test run holds: one 1024² tile of the pathology workflow. Further seeds
are read with ``perfbench/readings.py --control`` (PERF.md gives those
readings)."""

import json
import pathlib

import pytest
import torch

from perfbench import harness

ROOT = pathlib.Path(__file__).resolve().parents[2]


def _readings(cell_name, changes, config_changes=None):
    cell, config, mod = harness.find_cell(ROOT, cell_name)
    cell, config = dict(cell, **changes), dict(config, **(config_changes or {}))
    driver = mod.Driver(config, cell, 2**31 + 11, torch.device("cuda", 0))
    driver.setup()
    with driver.patch(None):
        driver.run_item(0)
    torch.cuda.empty_cache()
    return cell["limits"], driver.check(control=True)["numbers"]


def _fails(limits, numbers):
    return any(numbers["control_" + k] > v for k, v in limits.items() if "control_" + k in numbers)


@pytest.mark.gpu
def test_pathology_control_fails():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    limits, numbers = _readings("path4k.moat",
                                {"tiles_per_item": 1, "dataset": {"seed": 2**31 + 11, "items": 1},
                                 "check": {"tiles": 1, "runs_per_tile": 4}}, {"tile": 1024})
    assert all(numbers[k] <= v for k, v in limits.items())
    assert _fails(limits, numbers), json.dumps(numbers)

