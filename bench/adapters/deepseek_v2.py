"""DeepSeek-V2's ``config.json`` keys as the port's ``ModelConfig``."""

from __future__ import annotations


def model_config(doc: dict):
    from repro_torch.configs.base import ModelConfig

    if doc["hidden_act"] != "silu":
        raise ValueError(f"hidden_act {doc['hidden_act']!r}: the port's "
                         f"MoE layers take a gated silu (swiglu)")
    return ModelConfig(
        name=doc["port_arch"], family="moe",
        num_layers=doc["num_hidden_layers"], d_model=doc["hidden_size"],
        vocab_size=doc["vocab_size"],
        num_heads=doc["num_attention_heads"],
        num_kv_heads=doc["num_key_value_heads"],
        head_dim=doc["v_head_dim"], rope_theta=float(doc["rope_theta"]),
        mlp_act="swiglu", tie_embeddings=doc["tie_word_embeddings"],
        num_experts=doc["n_routed_experts"],
        experts_per_token=doc["num_experts_per_tok"],
        num_shared_experts=doc["n_shared_experts"],
        moe_d_ff=doc["moe_intermediate_size"],
        shared_d_ff=doc["n_shared_experts"] * doc["moe_intermediate_size"],
        first_k_dense=doc["first_k_dense_replace"],
        dense_d_ff=doc["intermediate_size"],
        mla=True, q_lora_rank=doc["q_lora_rank"],
        kv_lora_rank=doc["kv_lora_rank"],
        qk_nope_head_dim=doc["qk_nope_head_dim"],
        qk_rope_head_dim=doc["qk_rope_head_dim"],
        v_head_dim=doc["v_head_dim"], dtype=doc["dtype"])
