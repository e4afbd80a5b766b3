"""Model operations of a Granite 4.0-H (the published config's keys), for
``granite.serve.mfu``: each weight a token multiplies, two operations each
(the Mamba2 in- and out-projections; attention's q, k, v and o; the router;
the gate, up and down of the top ``num_experts_per_tok`` experts and of the
shared expert; the LM head at the positions whose logits are taken),
attention's 4·D a head for each (query, key) pair it scores, and the scan's
5·N·P a token and head. Norms, the conv, activations, the gates' weighting
and sampling are not counted, nor the experts a token does not take."""


def _sizes(c):
    d = int(c["hidden_size"])
    d_in = int(c["mamba_expand"]) * d
    n, g, p = int(c["mamba_d_state"]), int(c["mamba_n_groups"]), int(c["mamba_d_head"])
    heads, kv = int(c["num_attention_heads"]), int(c["num_key_value_heads"])
    return d, d_in, n, g, p, d_in // p, heads, kv, d // heads


def _counts(c):
    kinds = list(c["layer_types"])
    return kinds.count("mamba"), kinds.count("attention"), len(kinds)


def matmul_weights(c) -> int:
    """Weights one token multiplies in the stack (the LM head apart)."""
    d, d_in, n, g, _, h, heads, kv, hd = _sizes(c)
    nm, na, layers = _counts(c)
    mamba = d * (d_in + d_in + 2 * g * n + h) + d_in * d
    attn = 2 * d * heads * hd + 2 * d * kv * hd
    moe = (d * int(c["num_local_experts"])
           + int(c["num_experts_per_tok"]) * 3 * d * int(c["intermediate_size"])
           + 3 * d * int(c["shared_intermediate_size"]))
    return nm * mamba + na * attn + layers * moe


def _token_flops(c) -> int:
    _, _, n, _, p, h, *_ = _sizes(c)
    return 2 * matmul_weights(c) + _counts(c)[0] * 5 * h * n * p


def _attention(c, queries_keys: int) -> int:
    *_, heads, _, hd = _sizes(c)
    return _counts(c)[1] * 4 * heads * hd * queries_keys


def prefill_flops(c, batch: int, seq: int) -> int:
    """A prefill of ``batch`` sequences of ``seq`` tokens, the logits of
    the last position taken."""
    d = _sizes(c)[0]
    return (batch * seq * _token_flops(c) + 2 * d * int(c["vocab_size"]) * batch
            + _attention(c, batch * seq * (seq + 1) // 2))


def decode_flops(c, batch: int, keys: int) -> int:
    """A decode step of ``batch`` sequences, each query against ``keys``
    cached positions (its own included)."""
    d = _sizes(c)[0]
    return (batch * _token_flops(c) + 2 * d * int(c["vocab_size"]) * batch
            + _attention(c, batch * keys))
