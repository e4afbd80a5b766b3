"""Model operations of a Zamba2 (the published config's keys), for
``serve.mfu``: each weight a token multiplies, two operations each (the
Mamba2 in- and out-projections; at each hybrid use q, k, v, o, gate/up,
down, the adapter's two factors and the use's linear; the LM head at the
positions whose logits are taken), attention's 4·D a head for each
(query, key) pair it scores, and the scan's 5·N·P a token and head. Norms,
the conv, activations and sampling are not counted."""


def _sizes(c):
    d = int(c["hidden_size"])
    d_in = int(c["mamba_expand"]) * d
    n, g, p = int(c["mamba_d_state"]), int(c["mamba_ngroups"]), int(c["mamba_headdim"])
    h = d_in // p
    attn = int(c["num_attention_heads"]) * int(c["attention_head_dim"])
    return d, d_in, n, g, p, h, attn


def matmul_weights(c) -> int:
    """Weights one token multiplies in the stack (the LM head apart)."""
    d, d_in, n, g, _, h, attn = _sizes(c)
    f, r = int(c["ffn_hidden_size"]), int(c["adapter_rank"])
    mamba = d * (d_in + d_in + 2 * g * n + h) + d_in * d
    use = 2 * d * 3 * attn + attn * d + d * 2 * f + f * d + r * (d + 2 * f) + d * d
    return int(c["num_hidden_layers"]) * mamba + len(c["hybrid_layer_ids"]) * use


def _token_flops(c) -> int:
    d, _, n, _, p, h, _ = _sizes(c)
    return 2 * matmul_weights(c) + int(c["num_hidden_layers"]) * 5 * h * n * p


def prefill_flops(c, batch: int, seq: int) -> int:
    """A prefill of ``batch`` sequences of ``seq`` tokens, the logits of
    the last position taken."""
    d, *_ = _sizes(c)
    heads, hd = int(c["num_attention_heads"]), int(c["attention_head_dim"])
    pairs = batch * seq * (seq + 1) // 2
    return (batch * seq * _token_flops(c) + 2 * d * int(c["vocab_size"]) * batch
            + len(c["hybrid_layer_ids"]) * 4 * heads * hd * pairs)


def decode_flops(c, batch: int, keys: int) -> int:
    """A decode step of ``batch`` sequences, each query against ``keys``
    cached positions (its own included)."""
    d, *_ = _sizes(c)
    heads, hd = int(c["num_attention_heads"]), int(c["attention_head_dim"])
    return (batch * _token_flops(c) + 2 * d * int(c["vocab_size"]) * batch
            + len(c["hybrid_layer_ids"]) * 4 * heads * hd * batch * keys)
