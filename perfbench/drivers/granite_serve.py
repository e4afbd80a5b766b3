"""Driver of ``repro_torch.core.sa_serve.run_sa_serve`` on IBM's Granite
4.0-H: the Zamba2 driver's SA studies over a served LM's prompt and
decoding controls (``drivers/zamba2_serve.py``: an item, a run, the traced
spans and the check are the same), on this model and with prompts of
Zipfian ids.

The model's configuration is the config file's published keys
(``repro_torch.configs.granite_4_0_h_small.from_hf``); its weights are
drawn on the card from the workload file's ``weights_seed``. The dataset of
``dataset["items"]`` prompt sets is drawn from ``dataset["seed"]``, the
same for every run seed: each id's rank r is drawn ∝ r^-``zipf_exponent``
over the vocab and the ranks are mapped to ids by a permutation drawn from
the same seed, so that a few ids are frequent, as in text, and the
experts' loads are uneven. The check recomputes the sampled runs with the
plain reference of ``reference/granite_hybrid.py`` and adds to the Zamba2
driver's two largest gaps a mean: ``mean_logprob_regret``, the reference's
log-probability of its own best token less that of the program's token,
over every compared position. A largest gap is set by the one position
where the program's bf16 logits stray furthest, which the sampled rows
hold or miss; the mean reads every position.
"""

from __future__ import annotations

import gc
import itertools
from typing import Any, Dict, List

import numpy as np
import torch

from perfbench.drivers import zamba2_serve
from perfbench.reference import granite_hybrid as ref
from perfbench.traffic import inputs


def zipf_ids(rng: np.random.Generator, vocab: int, exponent: float, perm: np.ndarray,
             shape) -> np.ndarray:
    """int32 ids of ``shape``: ranks drawn ∝ r^-exponent (r = 1..vocab),
    rank r taking id ``perm[r - 1]``."""
    p = np.arange(1, vocab + 1, dtype=np.float64) ** -exponent
    return perm[rng.choice(vocab, size=shape, p=p / p.sum())].astype(np.int32)


class Driver(zamba2_serve.Driver):
    def setup(self) -> None:
        """The model, the dataset, the order of its entries, and one call of
        the entry on one prompt at the item's shapes (loads the kernels,
        fills the allocator's pools)."""
        try:
            from repro_torch.configs import granite_4_0_h_small
        except ImportError as exc:
            raise SystemExit(f"perfbench: the program has no Granite 4.0-H model to serve "
                             f"({exc})") from None
        from repro_torch.models import init_params

        gc.collect()  # an earlier driver's weights in this process (see zamba2_serve)
        c = self.cell
        self.cfg = granite_4_0_h_small.from_hf(self.config)
        gen = torch.Generator(device=self.device).manual_seed(int(c["weights_seed"]))
        self.params = init_params(self.cfg, gen, device=self.device)
        shape = (int(c["batch"]), int(c["prompt_len"]))
        entries, per = int(c["dataset"]["items"]), int(c["prompts_per_item"])
        rng = np.random.default_rng([int(c["dataset"]["seed"]), 5])
        perm = rng.permutation(self.cfg.vocab_size)
        exponent = float(c["dataset"]["zipf_exponent"])
        draw = lambda: zipf_ids(rng, self.cfg.vocab_size, exponent, perm, shape)  # noqa: E731
        self.dataset = [[draw() for _ in range(per)] for _ in range(entries)]
        self.order = inputs.order(self.seed, entries)
        self.sets = [tuple(sorted({"prompt_id": p, "rep_penalty": float(rp), "top_k": int(c["top_k"]),
                                   "threshold": float(th)}.items()))
                     for p, rp, th in itertools.product(range(per), c["rep_penalty"],
                                                        c["threshold"])]
        warm = [ps for ps in self.sets if dict(ps)["prompt_id"] == 0][:2]
        self._study({0: draw()}, warm, gen_len=2)

    def _scored(self, tokens: torch.Tensor, ids: torch.Tensor, rep_penalty: float,
                precision: str) -> torch.Tensor:
        """The reference's log-probabilities (gen_len, V) of each generated
        position, teacher-forced over the prompt and the program's ids,
        with the program's repetition penalty (each id's log(penalty) times
        its count among the earlier generated ids)."""
        logits = ref.logits(self.config, self.params, tokens, ids.shape[0], precision)
        once = torch.nn.functional.one_hot(ids.to(logits.device), logits.shape[-1]).float()
        seen = once.cumsum(0) - once
        scored = torch.log_softmax(logits - float(np.log(rep_penalty)) * seen, dim=-1)
        # the Zamba2 driver's check scores each compared row in float32,
        # then, with the control, in its precision: each position's regret
        # of the program's token, and of the control's best token
        if precision == "float32":
            self._want = scored
            took = ids.to(scored.device)[:, None]
        else:
            took = scored.argmax(-1, keepdim=True)
        regret = self._want.max(-1).values - self._want.gather(1, took)[:, 0]
        self._regrets.setdefault(precision, []).append(regret)
        return scored

    def check(self, control: bool = False) -> Dict[str, Any]:
        """The Zamba2 driver's check (``conf_gap``, ``logprob_regret``),
        and ``mean_logprob_regret``, with ``control_mean_logprob_regret``
        where ``control``."""
        self._regrets: Dict[str, List[torch.Tensor]] = {}
        out = super().check(control)
        for precision, regrets in self._regrets.items():
            name = "mean_logprob_regret" if precision == "float32" else "control_mean_logprob_regret"
            out["numbers"][name] = float(torch.cat(regrets).mean())
        return out
