"""Multi-pod dry-run: run one step of every (architecture × input shape ×
mesh) cell on a fake world and record its memory, FLOPs, bytes and
collectives per rank: the JAX package's ``repro.launch.dryrun``.

Run:  PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A] [--shape S]
          [--mesh single|multi|both] [--out experiments/dryrun_torch.json]

Where JAX forces 512 host devices and lowers and compiles each cell, the
port starts a ``"fake"`` process group of 256 or 512 ranks (collectives
that move nothing), builds the production mesh over it, and runs the
cell's step once as rank 0, on DTensors whose local shards are meta
tensors (shapes and dtypes, no memory, no device). A dispatch mode
(``hlo_analysis.StepTrace``) counts rank 0's local FLOPs, bytes and
collectives. The record has the reference's keys:
  * ``arg_bytes`` / ``out_bytes``: the step's inputs' and outputs' local
    shards on rank 0 (``param_bytes``: the parameters' alone);
  * ``temp_bytes``: the peak of the live bytes of the tensors the step
    makes. This is not XLA's buffer assignment: PyTorch's eager lifetimes,
    autograd's saved tensors included;
  * ``lower_s``: set-up (mesh, meta parameters, layouts); ``compile_s``:
    the traced step.
The port runs every layer (Python loops have no scan to cut), so the terms
need no depth scaling; the SSM scan is stubbed (``ctx.analysis``) and its
closed-form cost (``ssm_scan_costs``) added back, as in the reference. It
touches no device. A record already ``ok`` (or ``skip``) in ``--out`` is
not run again.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import time
import traceback
from typing import Any, Dict

import torch

from repro_torch import tree as tree_mod
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, supports_long_context
from repro_torch.dist.sharding import cache_shardings, distribute, make_ctx, param_shardings
from repro_torch.launch.hlo_analysis import (StepTrace, collective_bytes, model_flops,
                                             roofline_terms, ssm_scan_costs)
from repro_torch.launch.inputs import cache_specs, input_specs, params_specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import make_decode_step, make_prefill_step, make_train_step
from repro_torch.optim import OptConfig, adamw_init

__all__ = ["fake_world", "trace_cell", "run_cell", "main"]


def fake_world(n: int) -> None:
    """A ``"fake"`` process group of ``n`` ranks, this process rank 0
    (the one already running if it has ``n``). Its collectives move no
    data; torch gives it its store."""
    import torch.distributed as dist

    if dist.is_initialized():
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", rank=0, world_size=n)


def _place(tree, shardings):
    # every rank holds the same meta value: each takes its own slice
    return tree_mod.tree_map(lambda x, s: distribute(x, s, src_data_rank=None), tree, shardings)


def _local_bytes(tree) -> int:
    total = 0
    for t in tree_mod.leaves(tree):
        if isinstance(t, torch.Tensor):
            local = t.to_local() if hasattr(t, "to_local") else t
            total += local.numel() * local.element_size()
    return total


def trace_cell(arch: str, shape_name: str, multi_pod: bool, *, cfg=None, mesh=None):
    """One step of the cell on rank 0 of a fake world. Returns (trace, aux):
    aux holds n_chips, the local bytes and the set-up and step seconds."""
    t0 = time.perf_counter()
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    if mesh is None:
        fake_world(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    n_chips = mesh.size()
    ctx = dataclasses.replace(make_ctx(mesh, mode="train" if shape.kind == "train" else "serve"),
                              analysis=True)
    params = params_specs(cfg)
    params = _place(params, param_shardings(params, ctx))
    inputs = input_specs(cfg, shape)
    if shape.kind == "train":
        opt = adamw_init(params)
        mb = int(os.environ.get("REPRO_MICROBATCHES", "1"))
        step, args = make_train_step(cfg, ctx, OptConfig(), microbatches=mb), (params, opt, inputs)
    elif shape.kind == "prefill":
        step, args = make_prefill_step(cfg, ctx, max_len=shape.seq_len), (params, inputs)
    else:  # decode: one token at the cache's last position
        cache = cache_specs(cfg, shape)
        cache = _place(cache, cache_shardings(cfg, shape, ctx)(cache))
        step = make_decode_step(cfg, ctx)
        args = (params, cache, inputs, shape.seq_len - 1)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with StepTrace() as trace:
        out = step(*args)
    step_s = time.perf_counter() - t0
    aux = {"n_chips": n_chips, "param_bytes": _local_bytes(params),
           "arg_bytes": _local_bytes(args), "out_bytes": _local_bytes(out),
           "lower_s": setup_s, "compile_s": step_s, "cfg": cfg, "shape": shape}
    return trace, aux


def run_cell(arch: str, shape_name: str, multi_pod: bool, *, cfg=None,
             mesh=None) -> Dict[str, Any]:
    rec: Dict[str, Any] = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
    }
    cfg = cfg or get_config(arch)
    if shape_name == "long_500k" and not supports_long_context(cfg):
        rec["status"] = "skip(full-attn)"
        return rec
    try:
        trace, aux = trace_cell(arch, shape_name, multi_pod, cfg=cfg, mesh=mesh)
        n_chips, shape = aux["n_chips"], aux["shape"]
        ssm = ssm_scan_costs(cfg, shape)
        cost = {"flops": trace.flops + ssm["flops"] / n_chips,
                "bytes accessed": trace.bytes_accessed + ssm["bytes"] / n_chips}
        coll = collective_bytes(trace.collectives)
        terms = roofline_terms(cost, coll, n_chips)
        terms["analysis"] = "full-depth"
        mf = model_flops(cfg, shape, n_chips)
        hlo_global_flops = terms["hlo_flops_per_chip"] * n_chips
        rec.update(
            status="ok",
            n_chips=n_chips,
            lower_s=round(aux["lower_s"], 1),
            compile_s=round(aux["compile_s"], 1),
            bytes_per_device=int(aux["arg_bytes"] + aux["out_bytes"] + trace.peak_live_bytes),
            arg_bytes=int(aux["arg_bytes"]),
            temp_bytes=int(trace.peak_live_bytes),
            out_bytes=int(aux["out_bytes"]),
            param_bytes=int(aux["param_bytes"]),
            collectives={k: v for k, v in coll.items() if k.startswith("n_") or k == "total"},
            **terms,
            model_flops_global=mf,
            useful_flops_ratio=(mf / hlo_global_flops) if hlo_global_flops else 0.0,
        )
    except Exception as e:  # noqa: BLE001 — record, keep sweeping
        rec["status"] = f"FAIL: {type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None, help="single arch id (default: all)")
    ap.add_argument("--shape", default=None, help="single shape (default: all)")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun_torch.json")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    out_path = pathlib.Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    records = []
    if out_path.exists():
        records = json.loads(out_path.read_text())

    done = {(r["arch"], r["shape"], r["mesh"]) for r in records
            if r.get("status", "").startswith(("ok", "skip"))}
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                key = (arch, shape, "2x16x16" if mp else "16x16")
                if key in done:
                    continue
                print(f"[dryrun] {key} ...", flush=True)
                rec = run_cell(arch, shape, mp)
                print(
                    f"[dryrun] {key} -> {rec['status']}"
                    + (
                        f" compute={rec['compute_s']:.4f}s memory={rec['memory_s']:.4f}s"
                        f" coll={rec['collective_s']:.4f}s dom={rec['dominant']}"
                        f" bytes/dev={rec['bytes_per_device']/1e9:.2f}GB"
                        if rec["status"] == "ok"
                        else ""
                    ),
                    flush=True,
                )
                records = [r for r in records if (r["arch"], r["shape"], r["mesh"]) != key]
                records.append(rec)
                out_path.write_text(json.dumps(records, indent=1))
    n_ok = sum(1 for r in records if r["status"] == "ok")
    n_skip = sum(1 for r in records if r["status"].startswith("skip"))
    n_fail = len(records) - n_ok - n_skip
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skip, {n_fail} fail")


if __name__ == "__main__":
    main()
