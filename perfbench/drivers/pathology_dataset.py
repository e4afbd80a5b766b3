"""Driver of ``repro_torch.app.run_dataset_study``: pathology SA studies
over a dataset of tiles.

An item is one call of the entry: ``tiles_per_item`` tiles streamed
through one plan of the item's parameter sets. A run is one parameter set
on one tile, scored by its Dice against the default set's mask. The
dataset, ``dataset["items"]`` entries of tiles, is made in set-up from
``dataset["seed"]``, the same for every run seed, so that every run does
the same work; the run's seed draws the order in which the window's items
take the entries (cycling where the window outlasts them) and the sample
that the check compares. Spans wrap the workflow's task functions, the
module globals that the entry's workflow is built from.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List

import torch

from perfbench.reference import pathology as ref
from perfbench.traffic import inputs, params

# the workflow's task functions: (module global, span name)
_TASKS = (("_t_normalize", "normalize"), ("_t_background", "background"), ("_t_rbc", "rbc"),
          ("_t_recon", "recon"), ("_t_threshold", "threshold"), ("_t_area_pre", "area_pre"),
          ("_t_watershed", "watershed"), ("_t_area_final", "area_final"))


class Driver:
    task_layer = "path_task"

    def __init__(self, config: Dict[str, Any], cell: Dict[str, Any], seed: int,
                 device: torch.device):
        self.config, self.cell, self.seed, self.device = config, cell, seed, device
        self.n_workers = int(cell["n_workers"])
        self.grid = config["tile"] // config["sub_tile"]
        self.items: List[Dict[str, Any]] = []
        self.tasks_executed = 0

    def _study(self, tiles, sets):
        from repro_torch.app import pipeline

        return pipeline.run_dataset_study(
            tiles, sets, strategy=self.cell["strategy"], n_workers=self.n_workers,
            reference_params=params.default_set(), device=self.device)

    def setup(self) -> None:
        """The dataset's tiles, the order of its entries, and one call of
        the entry on one tile with two runs (loads the kernel, fills the
        allocator's pools at the tile's shape)."""
        data_seed, entries = int(self.cell["dataset"]["seed"]), int(self.cell["dataset"]["items"])
        pool = inputs.sub_tile_pool(data_seed, self.grid * self.grid,
                                    int(self.config["sub_tile"]))
        self.dataset = [[inputs.mosaic(pool, data_seed, j, t, self.grid)
                         for t in range(int(self.cell["tiles_per_item"]))]
                        for j in range(entries)]
        self.order = inputs.order(self.seed, entries)
        self.sets = params.item_sets(self.cell)
        warm = inputs.mosaic(pool, data_seed, entries, 0, self.grid)
        self._study([warm], self.sets[:2])

    # -- the timed path -----------------------------------------------------
    def patch(self, spans) -> contextlib.AbstractContextManager:
        from repro_torch.app import pipeline

        stack = contextlib.ExitStack()
        if spans is not None:
            for attr, name in _TASKS:
                fn = getattr(pipeline, attr)
                stack.callback(setattr, pipeline, attr, fn)
                setattr(pipeline, attr, spans.wrap(name, self.task_layer, fn))
        return stack

    def run_item(self, item: int) -> int:
        entry = self.order[item % len(self.order)]
        tiles = self.dataset[entry]
        out = self._study(tiles, self.sets)
        self.items.append({"entry": entry, "dice": out["dice"]})
        self.tasks_executed += int(out["tasks_executed"])
        return len(self.sets) * len(tiles)

    def counters(self) -> Dict[str, float]:
        return {"tasks_executed": self.tasks_executed}

    # -- the check ----------------------------------------------------------
    def check(self, control: bool = False) -> Dict[str, Any]:
        """Recomputes a sample of the window's runs alone with the plain
        reference: ``check["tiles"]`` (item, tile) pairs and
        ``check["runs_per_tile"]`` runs on each, drawn from the seed.
        ``dice_gap`` is the widest gap between the program's Dice and the
        reference's. With ``control``, also ``control_dice_gap``: the
        reference in bfloat16 against the reference in float32."""
        pairs = [(k, t) for k in range(len(self.items))
                 for t in range(int(self.cell["tiles_per_item"]))]
        numbers = {"dice_gap": 0.0}
        if control:
            numbers["control_dice_gap"] = 0.0
        n = 0
        for k, t in inputs.sample(self.seed, pairs, int(self.cell["check"]["tiles"])):
            rec = self.items[k]
            runs = inputs.sample(self.seed + 1 + k * 97 + t, list(range(len(self.sets))),
                                 int(self.cell["check"]["runs_per_tile"]))
            raw = torch.from_numpy(self.dataset[rec["entry"]][t]).to(self.device)
            sets = [self.sets[r] for r in runs]
            want = ref.run_dice(raw, sets, params.default_set())
            got = [rec["dice"][t][r] for r in runs]
            numbers["dice_gap"] = max([numbers["dice_gap"]] + [abs(g - w) for g, w in zip(got, want)])
            if control:
                low = ref.run_dice(raw, sets, params.default_set(), torch.bfloat16)
                numbers["control_dice_gap"] = max(
                    [numbers["control_dice_gap"]] + [abs(g - w) for g, w in zip(low, want)])
            del raw
            n += len(runs)
        return {"numbers": numbers, "compared": n}
