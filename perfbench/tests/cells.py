"""Tiny cells for the CPU tests: the pathology workflow on 64² tiles,
written into a folder that holds only data files, as a later change would
add them, with a ``BENCHMARK.json`` that names them."""

from __future__ import annotations

import json
import pathlib
import shutil

PERFBENCH = pathlib.Path(__file__).resolve().parent.parent

_TINY = {"traffic": "moat", "design": "morris", "design_seed": 0, "tiles_per_item": 2,
         "n_workers": 2, "strategy": "hybrid", "dataset": {"seed": 5, "items": 2},
         "check": {"tiles": 2, "runs_per_tile": 2}, "limits": {"dice_gap": 0.0}}

CELLS = {
    "tiny.moat": ({"driver": "pathology_dataset", "tile": 64, "sub_tile": 32},
                  dict(_TINY, config="path_tiny")),
    "tiny.halton": ({"driver": "pathology_dataset", "tile": 64, "sub_tile": 16},
                    dict(_TINY, config="path_tiny16", traffic="halton", design="halton",
                         points=8, skip=20)),
}


def write(root: pathlib.Path, with_metrics: bool = False) -> pathlib.Path:
    """A checkout-like folder with the tiny cells' files only, and a
    ``BENCHMARK.json`` that gives every cell the benchmark's metrics
    (with ``with_metrics``, also a copy of the metric readers)."""
    for name, (config, cell) in CELLS.items():
        for sub, stem, data in (("configs", cell["config"], config),
                                ("workloads", name, cell)):
            path = root / "perfbench" / sub / f"{stem}.json"
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(json.dumps(data))
    manifest = json.loads((PERFBENCH.parent / "BENCHMARK.json").read_text())
    for kind in ("end_to_end", "per_layer"):
        for m in manifest[kind]:
            m.pop("workloads", None)
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    if with_metrics:
        shutil.copytree(PERFBENCH / "metrics", root / "perfbench" / "metrics")
    return root
