"""The paper's reuse machinery as an LM-serving feature.

An SA study over a *serving pipeline's* parameters — which prompt, which
decoding controls, which post-hoc acceptance threshold — re-executes the
same pipeline for every parameter set, exactly like the pathology SA. The
pipeline is expressed as a 3-task stage:

    prefill   (prompt_id)            tokens → cache          [expensive]
    generate  (rep_penalty, top_k)   cache  → generated ids  [expensive]
    score     (threshold)            ids    → acceptance     [cheap]

so the reuse trie shares one prefill across every parameter set with the
same prompt (prefix caching, derived rather than hand-built), shares
generation across sets differing only in the threshold, and RMSR's
activePaths bound caps how many caches are live against the device memory
budget.

Everything runs on the parameters' device; prompts (numpy) move there.

Spans (:mod:`repro_torch.trace`, layer ``serve``): ``study`` (``runs``)
around :func:`run_sa_serve`, ``serve.prefill`` (``tokens``, ``batch``),
``serve.generate`` (``steps``) and, inside it, ``serve.decode_step``
(``mamba_layers``, ``shared_blocks``: the recurrent layers and attention
blocks a step runs; ``cache_bytes_copied``: the cache a step copies). No
span waits for the device.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import trace
from repro_torch.configs.base import ModelConfig
from repro_torch.core.params import ParamSet
from repro_torch.core.workflow import StageSpec, TaskSpec, Workflow
from repro_torch.models import decode_step, init_cache, prefill

__all__ = ["build_serve_stage", "run_sa_serve"]


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [tree]


def _cache_bytes(cfg: ModelConfig, batch: int, max_len: int) -> int:
    """Bytes of every leaf of one (nested) cache, sized on the meta device
    (no memory)."""
    cache = init_cache(cfg, batch, max_len, device="meta")
    return sum(t.numel() * t.element_size() for t in _leaves(cache))


def _step_counts(cfg: ModelConfig, cache) -> Dict[str, int]:
    """What one decode step runs and copies: its Mamba2 layers, its
    attention blocks run between them, and the bytes of the cache it copies
    (the cache it is given is not modified): the keys and values, and a
    ``zamba2`` step its states and conv carries too."""
    copied = ["k", "v"]
    if cfg.family == "zamba2":
        mamba, shared, copied = cfg.num_layers, len(cfg.hybrid_layer_ids), copied + ["mamba"]
    elif cfg.family == "hybrid":
        mamba, shared = cfg.num_layers, cfg.num_layers // cfg.attn_every
    else:
        mamba, shared = 0, 0
    return {"mamba_layers": mamba, "shared_blocks": shared, "cache_bytes_copied": sum(
        t.numel() * t.element_size() for k in copied if k in cache for t in _leaves(cache[k]))}


def build_serve_stage(
    cfg: ModelConfig,
    params,
    prompts: Dict[int, np.ndarray],
    *,
    gen_len: int = 8,
    max_len: int = 64,
) -> StageSpec:
    """Build the serve pipeline stage over a given model + prompt library."""
    dev = params["embed"].device

    def t_prefill(state, prompt_id):
        toks = torch.from_numpy(np.asarray(prompts[int(prompt_id)])).to(dev)
        with trace.span("serve.prefill", "serve", tokens=int(toks.numel()),
                        batch=int(toks.shape[0])):
            logits, cache, ln = prefill(cfg, params, {"tokens": toks}, max_len=max_len)
        return {"cache": cache, "len": ln, "last_logits": logits, "tokens": toks}

    def t_generate(state, rep_penalty, top_k):
        cache, ln = state["cache"], state["len"]
        logits = state["last_logits"]
        b = logits.shape[0]
        rows = torch.arange(b, device=dev)
        ones = torch.ones(b, dtype=torch.float32, device=dev)
        log_penalty = torch.log(torch.tensor(rep_penalty, dtype=torch.float32, device=dev))
        out_ids: List[torch.Tensor] = []
        confidences: List[torch.Tensor] = []
        seen = torch.zeros((b, cfg.padded_vocab), dtype=torch.float32, device=dev)
        counts = _step_counts(cfg, cache)
        with trace.span("serve.generate", "serve", steps=gen_len):
            for i in range(gen_len):
                adj = logits - log_penalty * seen
                # the first maximal index, as lax.top_k(adj, top_k)[1][:, 0]
                # takes it; top_k changes no token, in either package
                nxt = torch.argmax(adj, dim=-1)
                probs = torch.softmax(adj, dim=-1)
                confidences.append(probs.gather(1, nxt[:, None])[:, 0])
                seen = seen.index_put((rows, nxt), ones, accumulate=True)
                out_ids.append(nxt)
                with trace.span("serve.decode_step", "serve", **counts):
                    logits, cache = decode_step(cfg, params, {"tokens": nxt[:, None]}, cache,
                                                ln + i)
        return {"ids": torch.stack(out_ids, 1), "conf": torch.stack(confidences, 1)}

    def t_score(state, threshold):
        return {"accept_rate": (state["conf"] > threshold).float().mean(),
                "ids": state["ids"], "conf": state["conf"]}

    any_prompt = next(iter(prompts.values()))
    cache_b = _cache_bytes(cfg, any_prompt.shape[0], max_len)
    return StageSpec(
        name="sa_serve",
        tasks=(
            TaskSpec("prefill", ("prompt_id",), t_prefill,
                     cost=float(any_prompt.shape[1]), output_bytes=cache_b),
            TaskSpec("generate", ("rep_penalty", "top_k"), t_generate,
                     cost=float(gen_len), output_bytes=cache_b // 8),
            TaskSpec("score", ("threshold",), t_score, cost=0.05,
                     output_bytes=64),
        ),
    )


def run_sa_serve(
    cfg: ModelConfig,
    params,
    prompts: Dict[int, np.ndarray],
    param_sets: Sequence[ParamSet],
    *,
    gen_len: int = 8,
    max_len: int = 64,
    hbm_budget_bytes: Optional[int] = None,
    policy: str = "rmsr",
    n_workers: int = 1,
) -> Dict[str, Any]:
    """Execute the SA-serve study through the StudyPlanner engine, on the
    parameters' device.

    The default ``"rmsr"`` policy merges maximally and solves activePaths
    against the memory budget; ``"hybrid"`` additionally buckets for
    multi-worker dispatch. Returns per-run accept rates, each run's
    generated ids (B, gen_len) and their confidences (on the parameters'
    device), plus the reuse/scheduling accounting."""
    from repro_torch.engine import ClusterSpec, MemoryBudget, execute_plan, plan_study

    with trace.span("study", "serve", runs=len(param_sets)):
        stage = build_serve_stage(cfg, params, prompts, gen_len=gen_len, max_len=max_len)
        wf = Workflow(stages=(stage,))
        plan = plan_study(
            wf,
            list(param_sets),
            memory=MemoryBudget(bytes=hbm_budget_bytes),
            cluster=ClusterSpec(n_workers=n_workers),
            policy=policy,
        )
        result = execute_plan(plan, {})
        accept = {rid: float(res["accept_rate"]) for rid, res in result.outputs.items()}
    return {
        "accept_rate": accept,
        "ids": {rid: res["ids"] for rid, res in result.outputs.items()},
        "conf": {rid: res["conf"] for rid, res in result.outputs.items()},
        "tasks_total": plan.tasks_total,
        # measured count (cache hits subtracted) — same semantics as the
        # pathology studies; the plan's analytic count rides alongside
        "tasks_executed": result.tasks_executed,
        "planned_tasks_executed": plan.tasks_executed,
        "reuse_fraction": plan.reuse_fraction,
        "active_paths": plan.active_paths,
        "peak_bytes": plan.peak_bytes,
        "cache_hits": result.cache_hits,
    }
