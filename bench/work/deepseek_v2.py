"""Operations of DeepSeek-V2 (the published model at the configuration
file's depth) serving requests: each token's own products (MLA's
projections in the plain, unabsorbed form, the leading dense MLP, the
router, 6 routed experts and the shared experts) and its attention over
the keys before it; the output head once a generated token.  Norms,
rope and softmaxes are left out."""

from __future__ import annotations


def token_flops(doc: dict) -> float:
    """Operations of one token's products through every layer, without
    attention over the cache and without the head."""
    d, h = doc["hidden_size"], doc["num_attention_heads"]
    qr, kvr = doc["q_lora_rank"], doc["kv_lora_rank"]
    dn, dr, dv = (doc["qk_nope_head_dim"], doc["qk_rope_head_dim"],
                  doc["v_head_dim"])
    mla = d * qr + qr * h * (dn + dr) + d * (kvr + dr) \
        + kvr * h * (dn + dv) + h * dv * d
    dense = 3 * d * doc["intermediate_size"]
    moe = d * doc["n_routed_experts"] \
        + 3 * d * doc["moe_intermediate_size"] * (
            doc["num_experts_per_tok"] + doc["n_shared_experts"])
    layers = doc["num_hidden_layers"]
    first = doc["first_k_dense_replace"]
    return 2.0 * (layers * mla + first * dense + (layers - first) * moe)


def attention_flops(doc: dict, pairs: int) -> float:
    """Operations of ``pairs`` (query, key) pairs in every layer:
    QK^T over dn + dr and PV over dv, in every head."""
    h = doc["num_attention_heads"]
    width = doc["qk_nope_head_dim"] + doc["qk_rope_head_dim"] \
        + doc["v_head_dim"]
    return 2.0 * doc["num_hidden_layers"] * h * pairs * width


def request_flops(doc: dict, prompt: int, output: int) -> float:
    """Operations of one request: ``prompt`` tokens prefilled and
    ``output`` tokens generated (the first from the prefill, each later
    one a decode step through the ``prompt + output - 1`` tokens before
    it), the head at each generated token."""
    tokens = prompt + output - 1           # tokens run through the layers
    pairs = tokens * (tokens + 1) // 2     # causal, each sees itself
    head = 2.0 * doc["hidden_size"] * doc["vocab_size"] * output
    return tokens * token_flops(doc) + attention_flops(doc, pairs) + head
