"""Serving launcher, the JAX package's ``repro.launch.serve``: batched
prefill and greedy decode, or the reuse-aware SA-serve study:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3_1b --reduced \
        [--batch 2] [--prompt-len 16] [--gen 12] [--sa-reuse] [--device cpu]

Random weights from seed 0 (bf16 matrices, as ``init_params`` gives them
for serving); prompts from numpy seed 0. Runs on the card unless
``--device`` names another device.
"""

from __future__ import annotations

import argparse
import itertools
import time
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="gemma3_1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=12)
    ap.add_argument("--sa-reuse", action="store_true",
                    help="run the reuse-tree SA-serve study instead of plain decode")
    ap.add_argument("--device", default=None,
                    help="torch device; the card (cuda:0) when not given")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.device import resolve_device
    from repro_torch.launch.steps import cast_for_compute, make_prefill_step
    from repro_torch.models import decoder, init_params

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    params = init_params(cfg, 0, device)
    rng = np.random.default_rng(0)

    if args.sa_reuse:
        from repro_torch.core.sa_serve import run_sa_serve

        prompts = {
            pid: rng.integers(0, cfg.vocab_size, (1, args.prompt_len)).astype(np.int32)
            for pid in range(2)
        }
        sets = [
            tuple(sorted({"prompt_id": p, "rep_penalty": rp, "top_k": 8,
                          "threshold": th}.items()))
            for p, rp, th in itertools.product(range(2), (1.0, 1.2), (0.2, 0.4))
        ]
        out = run_sa_serve(cfg, params, prompts, sets, gen_len=args.gen,
                           max_len=args.prompt_len + args.gen + 4)
        print(f"[serve] SA-reuse: {out['tasks_executed']}/{out['tasks_total']} tasks "
              f"({out['reuse_fraction']*100:.0f}% reuse), "
              f"accept rates {list(out['accept_rate'].values())[:4]}")
        return

    max_len = args.prompt_len + args.gen
    toks = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)
    prefill_fn = make_prefill_step(cfg, None, max_len=max_len)
    t0 = time.time()
    with torch.no_grad():
        nxt, cache = prefill_fn(params, {"tokens": torch.from_numpy(toks).to(device)})
        dec = decoder(cfg, cast_for_compute(params), cache)
        outs = [nxt]
        for i in range(args.gen - 1):
            logits = dec.step({"tokens": nxt}, args.prompt_len + i)
            nxt = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
            outs.append(nxt)
    gen = torch.cat(outs, dim=1).cpu()
    dt = time.time() - t0
    print(f"[serve] generated {tuple(gen.shape)} in {dt:.1f}s ({args.batch*args.gen/dt:.1f} tok/s)")
    print(gen.numpy()[:, :10])


if __name__ == "__main__":
    main()
