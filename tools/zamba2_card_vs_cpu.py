"""Where the reduced Zamba2's card-vs-CPU difference in the prefill cache
comes from.

``chip_smoke.py``'s phase 13 holds the card's prefill of the reduced Zamba2
(seed 0, one 16-token prompt, ``max_len`` 20) to the CPU's within 3% in
every cached state. This script runs that prefill in variants that swap one
part of the path at a time and prints, for each, how far its cache and
logits lie from the CPU's own run:

- ``card``: as shipped (the attention and ``ssm_scan`` kernels);
- ``card, attention plain``: the card's attention through the CPU path's
  arithmetic (the JAX model's: q·scale rounded to bf16, P rounded to bf16);
- ``card, ssm_scan plain``: the card's scan through the chunked plain
  version (the JAX package's arithmetic);
- ``card, both plain``: no kernel on the card; what is left is PyTorch's
  own ops on the card (cuBLAS products, conv, norms) against the CPU's;
- ``card, both plain, full bf16 sums``: the same with cuBLAS's reduced
  precision reductions in bf16 products turned off;
- ``cpu, attention as the kernel``: the CPU's attention in the tensor-core
  kernel's arithmetic (``flash_attention_blocked``: q·k in fp32 times the
  scale, P rounded to bf16 per 128-key tile);
- ``cpu, ssm_scan as the kernel``: the CPU's scan through the kernel's
  three passes (``ssm_scan_three_pass``).

Each state is also shown layer by layer (Mamba2 layers, then the shared
attention block's applications), which says where along the depth the
difference starts. Last, the op that seeds it: the ``both plain`` prefill
runs on the card and on the CPU under a recorder of every ATen op, and the
two op sequences are compared output by output; the first op whose output
differs, and the first that differs by more than 1e-3 in norm, are printed
with their place in the model's source.

    python3 tools/zamba2_card_vs_cpu.py    # needs a CUDA card
"""

from __future__ import annotations

import pathlib
import subprocess
import sys
import traceback
from contextlib import ExitStack, contextmanager
from types import SimpleNamespace
from unittest import mock

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.kernels import flash_attention, ref as kref, ssm_scan  # noqa: E402
from repro_torch.models import attention as attention_mod, init_params, prefill  # noqa: E402
from repro_torch.models import ssm as ssm_mod  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402


@contextmanager
def attention_plain():
    """The model's attention takes its CPU branch, whatever the device."""
    with mock.patch.object(attention_mod, "kops", SimpleNamespace(_on_card=lambda t, u: False)):
        yield


@contextmanager
def attention_as_kernel():
    """The model's attention takes the kernel's branch with the kernel's
    plain version in the kernel's place."""
    with mock.patch.object(attention_mod, "kops", SimpleNamespace(_on_card=lambda t, u: True)), \
            mock.patch.object(attention_mod, "flash_attention_cuda", kref.flash_attention_blocked):
        yield


@contextmanager
def scan_with(fn):
    """The Mamba2 blocks' scan through ``fn(x, a, b, c)``."""
    with mock.patch.object(ssm_mod, "kops", SimpleNamespace(ssm_scan=fn)):
        yield


@contextmanager
def full_bf16_sums():
    matmul = torch.backends.cuda.matmul
    old = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        matmul.allow_bf16_reduced_precision_reduction = old


def to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.cpu().double(), b.cpu().double()
    return float((a - b).norm() / b.norm())


def per_layer(name: str, a: torch.Tensor, b: torch.Tensor):
    """Relative difference of each layer: Mamba2 states and conv carries are
    (groups, layers a group, ...), keys and values (applications, ...)."""
    depth = 2 if name.startswith("mamba.") else 1
    a, b = a.reshape(-1, *a.shape[depth:]), b.reshape(-1, *b.shape[depth:])
    return [rel(a[i], b[i]) for i in range(a.shape[0])]


class OpRecorder(TorchDispatchMode):
    """Every ATen op's name, its innermost place in ``repro_torch`` and a
    host copy of its tensor outputs, in the order the ops ran."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        site = next((f"{pathlib.Path(f.filename).name}:{f.lineno} {f.name}"
                     for f in reversed(traceback.extract_stack())
                     if "repro_torch" in f.filename), "?")
        outs = out if isinstance(out, (tuple, list)) else (out,)
        self.ops.append((str(func), site, [o.detach().to("cpu", copy=True) for o in outs
                                           if isinstance(o, torch.Tensor)]))
        return out


def first_moving_ops(cfg, card_params, cpu_params, toks, swaps):
    """Run the prefill under :class:`OpRecorder` on the card and on the
    CPU, with ``swaps`` applied to both, and print the first op whose
    output differs at all and the first whose relative difference in norm
    is over 1e-3, with the op before it."""
    runs = []
    for params in (card_params, cpu_params):
        with ExitStack() as stack:
            for swap in swaps:
                stack.enter_context(swap())
            with OpRecorder() as rec:
                prefill(cfg, params, toks, max_len=20)
        runs.append(rec.ops)
    card, cpu = runs
    print(f"\nthe op that seeds it (card, both plain, against the CPU): {len(card)} ops on the "
          f"card, {len(cpu)} on the CPU")
    found = {}
    for i, ((name, site, outs), (cname, csite, couts)) in enumerate(zip(card, cpu)):
        if name != cname or len(outs) != len(couts):
            print(f"  the op sequences part at op {i}: {name} at {site} on the card, {cname} at "
                  f"{csite} on the CPU")
            break
        for a, b in zip(outs, couts):
            if a.shape != b.shape or not a.is_floating_point() and a.dtype != torch.bool:
                continue
            if torch.equal(a, b):
                continue
            diff = (a.double() - b.double())
            r = float(diff.norm() / max(float(b.double().norm()), 1e-30))
            for key, bar in (("first op to differ", 0.0), ("first op over 1e-3", 1e-3)):
                if key not in found and r > bar:
                    found[key] = i
                    before = card[i - 1] if i else ("-", "-", [])
                    print(f"  {key}: op {i}, {name} at {site}, {tuple(a.shape)} {a.dtype}: "
                          f"max abs diff {float(diff.abs().max())}, relative {r:.4e} "
                          f"(the op before: {before[0]} at {before[1]})")
        if len(found) == 2:
            break
    if not found:
        print("  every op's output equal")


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    cfg = configs.reduced_config(configs.get_config("zamba2_2p7b"))
    cpu_params = init_params(cfg, 0, device="cpu")
    card_params = to_device(cpu_params, "cuda:0")
    rng = np.random.default_rng(1)
    toks = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 16)).astype(np.int32))}
    base_logits, base_cache, _ = prefill(cfg, cpu_params, toks, max_len=20)
    base = flat(base_cache)

    def three_pass(x, a, b, c):
        return kref.ssm_scan_three_pass(x, a, b, c, chunk=64)

    def chunked(x, a, b, c):
        return kref.ssm_scan_chunked(x, a, b, c, None, chunk=64)

    plain_attention, plain_scan = attention_plain, lambda: scan_with(chunked)
    variants = [  # (name, parameters, the swaps)
        ("card", card_params, ()),
        ("card, attention plain", card_params, (plain_attention,)),
        ("card, ssm_scan plain", card_params, (plain_scan,)),
        ("card, both plain", card_params, (plain_attention, plain_scan)),
        ("card, both plain, full bf16 sums", card_params,
         (plain_attention, plain_scan, full_bf16_sums)),
        ("cpu, attention as the kernel", cpu_params, (attention_as_kernel,)),
        ("cpu, ssm_scan as the kernel", cpu_params, (lambda: scan_with(three_pass),)),
    ]
    print(f"reduced {cfg.name}: {cfg.num_layers} Mamba2 layers, d_model {cfg.d_model}, "
          f"attention {cfg.num_heads} heads of {cfg.head_dim} (bf16: the tensor-core kernel), "
          f"one 16-token prompt; differences from the CPU's run (relative, in norm)")
    for name, params, swaps in variants:
        before = (flash_attention.WGMMA_LAUNCHES.value, flash_attention.LAUNCHES.value,
                  ssm_scan.LAUNCHES.value)
        with ExitStack() as stack:
            for swap in swaps:
                stack.enter_context(swap())
            logits, cache, _ = prefill(cfg, params, toks, max_len=20)
        torch.cuda.synchronize()
        after = (flash_attention.WGMMA_LAUNCHES.value, flash_attention.LAUNCHES.value,
                 ssm_scan.LAUNCHES.value)
        got = flat(cache)
        launched = ", ".join(f"{k} {b - a}" for k, a, b in zip(
            ("tensor-core attention", "CUDA-core attention", "ssm_scan"), before, after))
        print(f"\n{name}: launches {launched}; logits max abs diff "
              f"{float((logits.cpu() - base_logits).abs().max())}")
        for k in base:
            layers = " ".join(f"{r:.4%}" for r in per_layer(k, got[k], base[k]))
            print(f"  {k}: {rel(got[k], base[k]):.4%}  by layer: {layers}")
    first_moving_ops(cfg, card_params, cpu_params, toks, (plain_attention, plain_scan))
    return 0


if __name__ == "__main__":
    sys.exit(main())
