"""Training launcher, the JAX package's ``repro.launch.train``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3_1b \
        --seq 4096 --batch 2 --microbatches 2 --steps 4 [--ckpt-dir DIR] \
        [--reduced] [--device cpu] [--mesh none|single|multi]

fp32 master weights (``init_params(..., masters=True)``, seed 0), AdamW,
the deterministic token pipeline (seed 0), and, with ``--ckpt-dir``, a
checkpoint every ``--ckpt-every`` steps and at the end; a run finding a
checkpoint there resumes from the newest, the pipeline's state included.
It runs on the card unless ``--device`` names another device.

``--mesh single`` (16×16 ``data, model``) and ``multi`` (2×16×16 with
``pod``) lay the masters and AdamW state out by ``param_shardings`` on the
production mesh (``launch.mesh.make_production_mesh``) over a ``torchrun``
world of 256 or 512 ranks (``torchrun --nproc-per-node ... -m
repro_torch.launch.train --mesh single``: the process group comes from its
environment); with fewer ranks it raises ``ValueError``, naming the ranks
needed and available, as JAX does with fewer devices. ``--device`` then
picks the mesh's device type (the card: NCCL; ``cpu``: gloo).
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import time
from typing import Any, Dict, List, Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="yi_6b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mesh", default="none", choices=["none", "single", "multi"],
                    help="none: one device; single: the 16x16 mesh (256 ranks); multi: "
                         "2x16x16 (512 ranks), from torchrun's environment")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="torch device; the card (cuda:0) when not given")
    return ap.parse_args(argv)


def setup(args: argparse.Namespace) -> Dict[str, Any]:
    """The run's state before its first step: config, fp32 master params and
    AdamW state (restored from the newest checkpoint under ``--ckpt-dir``
    where there is one), token pipeline, checkpointer, step function, and
    ``start``, the first step to run."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import SHAPES, get_config, reduced_config
    from repro_torch.data import TokenPipeline
    from repro_torch.device import resolve_device
    from repro_torch.dist import make_ctx, param_shardings
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import OptConfig, adamw_init
    from repro_torch.runtime.elastic import reshard_tree

    device = resolve_device(args.device)
    mesh = None
    if args.mesh != "none":
        mesh = make_production_mesh(multi_pod=args.mesh == "multi", device_type=device.type)
    ctx = make_ctx(mesh, mode="train") if mesh is not None else None
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=args.seq, global_batch=args.batch)
    params = init_params(cfg, 0, device, masters=True)
    opt_state = adamw_init(params)
    pipe = TokenPipeline(cfg, shape, seed=0)
    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if ckpt and ckpt.latest_step() is not None:
        (params, opt_state), meta = ckpt.restore((params, opt_state))
        pipe.restore(meta["pipeline"])
        start = pipe.step
        print(f"[train] resumed at step {start}")
    if mesh is not None:
        params, opt_state = reshard_tree((params, opt_state),
                                         param_shardings((params, opt_state), ctx))
    opt_cfg = OptConfig(lr=args.lr, total_steps=args.steps)
    step_fn = make_train_step(cfg, ctx, opt_cfg, microbatches=args.microbatches)
    return dict(cfg=cfg, device=device, params=params, opt_state=opt_state, pipe=pipe,
                ckpt=ckpt, start=start, step_fn=step_fn, ctx=ctx)


def run(state: Dict[str, Any], args: argparse.Namespace) -> List[Dict[str, float]]:
    """Steps ``state["start"]`` to ``--steps``, updating ``state`` in place;
    returns each step's record (step, loss, grad_norm, lr, seconds)."""
    import torch

    pipe, ckpt, device = state["pipe"], state["ckpt"], state["device"]
    records = []
    saved = None
    t0 = time.perf_counter()
    for step in range(state["start"], args.steps):
        t = time.perf_counter()
        batch = {k: torch.from_numpy(v).to(device) for k, v in pipe.batch_at(step).items()}
        state["params"], state["opt_state"], metrics = state["step_fn"](
            state["params"], state["opt_state"], batch)
        pipe.step = step + 1
        rec = {"step": step, **{k: float(v) for k, v in metrics.items()},
               "seconds": time.perf_counter() - t}  # float() waits for the step
        records.append(rec)
        if step == state["start"]:
            # the first step's lazy imports inside torch (torch._dynamo, reached
            # through torch.utils.checkpoint) leave its frames in a reference
            # cycle, which holds the step's old params, moments and gradients
            # until the next cyclic collection: free them now
            gc.collect()
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save_async(step + 1, (state["params"], state["opt_state"]),
                            metadata={"pipeline": pipe.state()})
            saved = step + 1
        if step % 5 == 0 or step + 1 == args.steps:
            print(f"[train] step {step} loss {rec['loss']:.4f} grad_norm {rec['grad_norm']:.4f} "
                  f"lr {rec['lr']:.3g} ({(time.perf_counter() - t0) / (step - state['start'] + 1):.2f}"
                  f"s/step)", flush=True)
    if ckpt:
        if saved != args.steps:  # the last step's own save already holds it
            ckpt.save(args.steps, (state["params"], state["opt_state"]),
                      metadata={"pipeline": pipe.state()})
        ckpt.wait()
    return records


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    run(setup(args), args)


if __name__ == "__main__":
    main()
