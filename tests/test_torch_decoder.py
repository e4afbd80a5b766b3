"""One way to decode a generate: :func:`repro_torch.models.decoder` against
chained :func:`repro_torch.models.decode_step` calls, on the CPU, for every
family's reduced config.

The decoder's steps and the chained functional steps run the same
arithmetic on the same cache values (a ``zamba2`` decoder its two sets of
buffers, the functional step a fresh set a step), so their logits are held
bit-equal, and neither modifies the prompt's cache.
"""

import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.models import decode_step, decoder, init_cache, init_params, prefill
from repro_torch.models import zamba2 as tzamba2

PROMPT, STEPS = 5, 3


def _leaves(tree):
    if isinstance(tree, dict):
        return {f"{k}/{name}".rstrip("/"): leaf for k, v in tree.items()
                for name, leaf in _leaves(v).items()}
    return {"": tree}


def _batch(cfg, length, gen, *, prompt=False):
    """A prompt (vlm's with its patches) or one step's input, of 2 sequences."""
    if cfg.family == "audio":
        return {"frame_embeds": torch.randn(2, length, cfg.d_model, generator=gen)
                .to(torch.bfloat16)}
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, length), generator=gen)}
    if prompt and cfg.family == "vlm":
        batch["patch_embeds"] = torch.randn(2, cfg.num_patches, cfg.d_model,
                                            generator=gen).to(torch.bfloat16)
    return batch


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS + tconfigs.PORT_ARCH_IDS)
def test_decoder_steps_equal_chained_decode_steps(arch):
    """A prefill, then 3 steps through a decoder and 3 chained
    ``decode_step`` calls: bit-equal logits, the prompt's cache unchanged;
    a ``zamba2`` step returns a fresh cache of ``init_cache``'s keys."""
    cfg = tconfigs.reduced_config(tconfigs.get_config(arch))
    params = init_params(cfg, 0, device="cpu")
    gen = torch.Generator().manual_seed(1)
    max_len = cfg.num_patches + PROMPT + STEPS
    with torch.no_grad():
        _, cache, n = prefill(cfg, params, _batch(cfg, PROMPT, gen, prompt=True), max_len=max_len)
        kept = {k: v.clone() for k, v in _leaves(cache).items()}
        steps = [_batch(cfg, 1, gen) for _ in range(STEPS)]
        dec = decoder(cfg, params, cache)
        got = [dec.step(batch, n + i) for i, batch in enumerate(steps)]
        chained, want = cache, []
        for i, batch in enumerate(steps):
            logits, new = decode_step(cfg, params, batch, chained, n + i)
            if cfg.family == "zamba2":
                fresh = init_cache(cfg, 2, max_len, device="cpu")
                assert _leaves(new).keys() == _leaves(fresh).keys()
                assert all(t is not u for t, u in zip(_leaves(new).values(),
                                                      _leaves(chained).values()))
            want.append(logits)
            chained = new
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and torch.equal(g, w)
    assert all(torch.equal(v, kept[k]) for k, v in _leaves(cache).items())
    if cfg.family == "zamba2":
        assert isinstance(dec, tzamba2.Decoder) and dec.last == (STEPS - 1) % 2
