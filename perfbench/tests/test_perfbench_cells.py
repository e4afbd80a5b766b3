"""Whole runs of the tiny cells on the CPU: found by name in a folder that
holds only their data files, the result line's keys, and the command's
refusal without a card."""

import json
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from perfbench import harness
from perfbench.tests import cells

ROOT = pathlib.Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return cells.write(tmp_path_factory.mktemp("checkout"), with_metrics=True)


@pytest.mark.parametrize("cell", sorted(cells.CELLS))
def test_a_new_cell_is_found_by_its_files_alone(root, cell):
    result = harness.run_cell(root, cell, 2**31 + 101, 0.2, False, device=CPU)
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) == {"sa_runs_per_s", "peak_device_gib", "setup_s"}
    assert all(m["value"] >= 0 and m["unit"] for m in result["metrics"].values())
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(result["checks"]) == set(cells.CELLS[cell][1]["limits"])
    assert all(set(c) == {"value", "limit"} for c in result["checks"].values())


@pytest.mark.parametrize("cell", sorted(cells.CELLS))
def test_traced_run_reads_the_span_metrics(root, cell):
    result = harness.run_cell(root, cell, 2**31 + 102, 0.2, True, device=CPU)
    assert result["correct"] is True
    assert set(result["metrics"]) == {"planner.tasks_per_run", "dispatch.efficiency",
                                      "tasks.path_s_per_run"}  # no device trace on the CPU
    assert 0 < result["metrics"]["dispatch.efficiency"]["value"] <= 100.0


def test_span_readers_leave_out_the_profiled_item(root, monkeypatch):
    seen = []

    class Spy(harness.Trace):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            seen.append(self)

    monkeypatch.setattr(harness, "Trace", Spy)
    harness.run_cell(root, "tiny.moat", 2**31 + 104, 0.0, True, device=CPU)
    (tr,) = seen
    end = tr.items[-1][1]
    assert len(tr.items) == 1 and tr.profiled[0] >= end
    assert tr.spans and all(s < end for _, _, s, _ in tr.spans)
    assert all(s >= tr.profiled[0] for _, _, s, _ in tr.profiled_spans)
    assert len(tr.profiled_spans) == len(tr.spans)  # the same tasks, one item each


def test_every_seed_runs_the_same_dataset_in_its_own_order(root):
    cell, config, mod = harness.find_cell(root, "tiny.moat")
    a, b, c = (mod.Driver(config, cell, seed, CPU) for seed in (17, 17, 2**31 + 17))
    for d in (a, b, c):
        d.setup()
    assert a.order == b.order and sorted(a.order) == sorted(c.order) == [0, 1]
    assert all((x == y).all() for tiles in zip(a.dataset, c.dataset) for x, y in zip(*tiles))


def test_the_command_refuses_without_a_card(tmp_path):
    """Run from a copy that holds only BENCHMARK.json and perfbench/: no
    card here (and no program there), so it exits non-zero with no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for where in (ROOT, tmp_path):
        out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "path4k.moat",
                              "--seed", str(2**31 + 9), "--seconds", "1", "--trace", "0"],
                             cwd=where, capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert out.stdout.strip() == ""


def test_metric_entries_follow_the_manifest():
    per = {m["name"] for m in harness.metric_entries(ROOT, "path4k.moat", "per_layer")}
    assert "morph_recon_roofline" in per and "device.idle" in per
    assert harness.metric_entries(ROOT, "no.such.cell", "per_layer") == []
    e2e = [m["name"] for m in harness.metric_entries(ROOT, "path4k.halton", "end_to_end")]
    assert e2e == ["sa_runs_per_s", "peak_device_gib", "setup_s"]
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in manifest["workloads"]:
        cell, config, driver = harness.find_cell(ROOT, w["name"])
        assert cell["config"] == w["config"] and hasattr(driver, "Driver")
