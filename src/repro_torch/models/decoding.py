"""The decode steps of a hybrid family whose step runs in place on its cache
(``zamba2``, ``granite_hybrid``): :class:`Decoder`, a generate's steps on
two sets of cache buffers with a CUDA graph of the step on each on the card,
and :func:`decode_step`, one functional step. A family gives its
``init_cache(cfg, batch, max_len, dev)`` and its ``step(cfg, params, tokens,
pos, cache)``, which writes the token's state into ``cache`` in place,
returns the logits fp32 (B, V) and reads no host value (``pos`` is a 0-d
long tensor on the device), so that it can be captured. The caches of both
families keep their attention keys under ``"k"``, (layers, B, max_len,
heads, head_dim)."""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch

__all__ = ["Decoder", "decode_step"]


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [tree]


def _copy_cache(dst, src) -> None:
    for d, s in zip(_leaves(dst), _leaves(src)):
        d.copy_(s)


def _fresh(init_cache: Callable, cfg, cache) -> Dict[str, Any]:
    """A zero cache shaped as ``cache``, on its device."""
    return init_cache(cfg, cache["k"].shape[1], cache["k"].shape[2], cache["k"].device)


class Decoder:
    """The decode steps of one generate from a prompt's ``cache``, which is
    not modified: two sets of cache buffers taken in turn, and on the card a
    CUDA graph of ``step`` on each, captured when the decoder is made: a
    Zamba2-7B step is about 4,400 device operations, which issued one by one
    from Python took 134 ms against the card's 86 (NVIDIA H100). A step
    copies its input (the prompt's cache, then the set written last) into
    the other set and runs there in place. The capture is thread-local, so
    that other workers' threads may launch meanwhile."""

    def __init__(self, cfg, params, cache, init_cache: Callable, step: Callable) -> None:
        dev = cache["k"].device
        self.sets = [_fresh(init_cache, cfg, cache) for _ in (0, 1)]
        self.tokens = torch.zeros((cache["k"].shape[1], 1), dtype=torch.long, device=dev)
        self.pos = torch.zeros((), dtype=torch.long, device=dev)
        self.cfg, self.params, self.cache, self._step = cfg, params, cache, step
        self.last: Optional[int] = None  # the set written last
        self.graphs: list = [None, None]
        self.logits: list = [None, None]
        if dev.type == "cuda":
            self._capture()

    def _capture(self) -> None:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # a first run outside the capture (cuBLAS handles)
            self._step(self.cfg, self.params, self.tokens, self.pos, self.sets[0])
        torch.cuda.current_stream().wait_stream(side)
        pool = None
        for i, buffers in enumerate(self.sets):
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
                self.logits[i] = self._step(self.cfg, self.params, self.tokens, self.pos, buffers)
            self.graphs[i], pool = graph, graph.pool()

    def step(self, batch, cur_len: int) -> torch.Tensor:
        """Logits fp32 (B, V) of the token ``batch["tokens"]`` (B, 1) at ``cur_len``."""
        i = self.last = 1 if self.last == 0 else 0
        _copy_cache(self.sets[i], self.cache)
        self.cache = self.sets[i]  # the next step's input
        self.tokens.copy_(batch["tokens"])
        self.pos.fill_(int(cur_len))
        if self.graphs[i] is None:
            return self._step(self.cfg, self.params, self.tokens, self.pos, self.sets[i])
        self.graphs[i].replay()
        return self.logits[i].clone()  # the caller may keep it


def decode_step(cfg, params, tokens: torch.Tensor, cache, cur_len: int, init_cache: Callable,
                step: Callable):
    """One token (B, 1) at position ``cur_len``, run eagerly; returns
    (logits fp32 (B, V), new cache): a fresh set shaped by ``init_cache``,
    ``cache`` copied into it and ``step`` run there. ``cache`` is not
    modified."""
    out = _fresh(init_cache, cfg, cache)
    _copy_cache(out, cache)
    pos = torch.tensor(int(cur_len), dtype=torch.long, device=out["k"].device)
    return step(cfg, params, tokens, pos, out), out
