"""Driver of ``repro_torch.core.sa_serve.run_sa_serve`` on Zyphra's
Zamba2: SA studies over a served LM's prompt and decoding controls.

An item is one ``run_sa_serve`` call: ``prompts_per_item`` prompts, each a
batch of ``batch`` sequences of ``prompt_len`` token ids, under every
combination of prompt, ``rep_penalty`` and ``threshold`` (``top_k``
fixed): prefill, ``gen_len`` greedy decoding steps with the repetition
penalty, and the share of confident tokens. A run is one parameter set.
The model's configuration is the config file's published keys
(``repro_torch.configs.zamba2_7b.from_hf``); its weights are drawn on the
card from the workload file's ``weights_seed``, and the dataset of
``dataset["items"]`` prompt sets (ids uniform over the vocab) from
``dataset["seed"]``, the same for every run seed. The run's seed draws the
order in which the window's items take the entries (cycling where the
window outlasts them) and the sample that the check compares.

A traced run wraps each task of the serve stage (prefill, generate,
score) in a span that ends with a sync of the task's stream, so that a
task's span holds its device work (the program runs ahead of the card
otherwise), and records the port's own spans (``repro_torch.trace``) over
the window and the profiled item.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
from typing import Any, Dict, List

import numpy as np
import torch

from perfbench.reference import zamba2 as ref
from perfbench.traffic import inputs


class Driver:
    task_layer = "serve task"

    def __init__(self, config: Dict[str, Any], cell: Dict[str, Any], seed: int,
                 device: torch.device):
        self.config, self.cell, self.seed, self.device = config, cell, seed, device
        self.n_workers = int(cell["n_workers"])
        self.items: List[Dict[str, Any]] = []
        self.tasks_executed = 0

    def _study(self, prompts, sets, gen_len: int):
        from repro_torch.core.sa_serve import run_sa_serve

        c = self.cell
        return run_sa_serve(self.cfg, self.params, prompts, sets, gen_len=gen_len,
                            max_len=int(c["max_len"]), hbm_budget_bytes=int(c["hbm_budget_bytes"]),
                            policy=c["policy"], n_workers=self.n_workers)

    def setup(self) -> None:
        """The model, the dataset, the order of its entries, and one call of
        the entry on one prompt at the item's shapes (loads the kernels,
        fills the allocator's pools)."""
        try:
            from repro_torch.configs import zamba2_7b
        except ImportError as exc:
            raise SystemExit(f"perfbench: the program has no Zamba2 model to serve ({exc})") from None
        from repro_torch.models import init_params

        # a study's plan is a tree with parent links, a reference cycle that
        # holds the stage's tasks and through them the parameters they serve;
        # an earlier driver's weights in this process (readings.py's seeds)
        # go only at a cyclic collection
        gc.collect()
        c = self.cell
        self.cfg = zamba2_7b.from_hf(self.config)
        gen = torch.Generator(device=self.device).manual_seed(int(c["weights_seed"]))
        self.params = init_params(self.cfg, gen, device=self.device)
        shape = (int(c["batch"]), int(c["prompt_len"]))
        entries, per = int(c["dataset"]["items"]), int(c["prompts_per_item"])
        rng = np.random.default_rng([int(c["dataset"]["seed"]), 5])
        draw = lambda: rng.integers(0, self.cfg.vocab_size, shape).astype(np.int32)  # noqa: E731
        self.dataset = [[draw() for _ in range(per)] for _ in range(entries)]
        self.order = inputs.order(self.seed, entries)
        self.sets = [tuple(sorted({"prompt_id": p, "rep_penalty": float(rp), "top_k": int(c["top_k"]),
                                   "threshold": float(th)}.items()))
                     for p, rp, th in itertools.product(range(per), c["rep_penalty"],
                                                        c["threshold"])]
        warm = [ps for ps in self.sets if dict(ps)["prompt_id"] == 0][:2]
        self._study({0: draw()}, warm, gen_len=2)

    # -- the timed path -----------------------------------------------------
    def patch(self, spans) -> contextlib.AbstractContextManager:
        stack = contextlib.ExitStack()
        if spans is None:
            return stack
        from repro_torch import trace
        from repro_torch.core import sa_serve

        build = sa_serve.build_serve_stage

        def wrapped(*args, **kwargs):
            stage = build(*args, **kwargs)
            return dataclasses.replace(stage, tasks=tuple(
                dataclasses.replace(t, fn=spans.wrap(t.name, self.task_layer, t.fn))
                for t in stage.tasks))

        stack.callback(setattr, sa_serve, "build_serve_stage", build)
        sa_serve.build_serve_stage = wrapped
        stack.enter_context(trace.recording())
        return stack

    def run_item(self, item: int) -> int:
        entry = self.order[item % len(self.order)]
        out = self._study(dict(enumerate(self.dataset[entry])), self.sets,
                          gen_len=int(self.cell["gen_len"]))
        self.items.append({"entry": entry,
                           "ids": {rid: t.cpu() for rid, t in out["ids"].items()},
                           "conf": {rid: t.cpu() for rid, t in out["conf"].items()}})
        self.tasks_executed += int(out["tasks_executed"])
        return len(self.sets)

    def counters(self) -> Dict[str, float]:
        return {"tasks_executed": self.tasks_executed}

    # -- the check ----------------------------------------------------------
    def _scored(self, tokens: torch.Tensor, ids: torch.Tensor, rep_penalty: float,
                precision: str) -> torch.Tensor:
        """The reference's log-probabilities (gen_len, V) of each generated
        position, teacher-forced over the prompt and the program's ids,
        with the program's repetition penalty (each id's log(penalty) times
        its count among the earlier generated ids)."""
        n = ids.shape[0]
        logits = ref.logits(self.config, self.params, tokens, n, precision)
        once = torch.nn.functional.one_hot(ids.to(logits.device), logits.shape[-1]).float()
        seen = once.cumsum(0) - once
        return torch.log_softmax(logits - float(np.log(rep_penalty)) * seen, dim=-1)

    def check(self, control: bool = False) -> Dict[str, Any]:
        """Recomputes ``check["runs"]`` runs of the window, drawn from the
        seed, ``check["sequences"]`` sequences of each, with the plain
        reference in float32. ``conf_gap``: the largest |program's
        confidence − the reference's probability of the program's token|;
        ``logprob_regret``: the largest gap between the reference's
        log-probability of its own best token and of the program's token.
        With ``control``, also ``control_conf_gap`` and
        ``control_logprob_regret``: the reference in float8 e4m3 put in the
        program's place (its probabilities, and its best tokens)."""
        c = self.cell
        pairs = [(k, rid) for k in range(len(self.items)) for rid in range(len(self.sets))]
        names = ["conf_gap", "logprob_regret"]
        numbers = {name: 0.0 for name in names + (["control_" + n for n in names] if control else [])}
        compared = 0
        for k, rid in inputs.sample(self.seed, pairs, int(c["check"]["runs"])):
            rec, ps = self.items[k], dict(self.sets[rid])
            prompt = self.dataset[rec["entry"]][ps["prompt_id"]]
            ids, conf = rec["ids"][rid], rec["conf"][rid]
            rows = inputs.sample(self.seed + 1 + k * 97 + rid, list(range(ids.shape[0])),
                                 int(c["check"]["sequences"]))
            for b in rows:
                tokens = torch.cat([torch.from_numpy(prompt[b]).long(), ids[b, :-1]])
                tokens = tokens.to(self.device)
                tok = ids[b].to(self.device)[:, None]
                want = self._scored(tokens, ids[b], ps["rep_penalty"], "float32")
                best = want.max(-1).values
                got = want.gather(1, tok)[:, 0]
                gap = (conf[b].to(self.device) - got.exp()).abs().max()
                numbers["conf_gap"] = max(numbers["conf_gap"], float(gap))
                numbers["logprob_regret"] = max(numbers["logprob_regret"],
                                                float((best - got).max()))
                if control:
                    low = self._scored(tokens, ids[b], ps["rep_penalty"], "float8_e4m3")
                    gap = (low.gather(1, tok)[:, 0].exp() - got.exp()).abs().max()
                    pick = low.argmax(-1, keepdim=True)
                    regret = (best - want.gather(1, pick)[:, 0]).max()
                    numbers["control_conf_gap"] = max(numbers["control_conf_gap"], float(gap))
                    numbers["control_logprob_regret"] = max(numbers["control_logprob_regret"],
                                                            float(regret))
                compared += ids.shape[1]
        return {"numbers": numbers, "compared": compared}
