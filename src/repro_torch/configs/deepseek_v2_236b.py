"""deepseek-v2-236b [moe] [arXiv:2405.04434; hf]:
60L, d_model=5120, 128H MLA (kv_lora=512, q_lora=1536, nope 128 + rope 64,
v 128), 2 shared + 160 routed experts top-6 (expert d_ff=1536), vocab=102400,
first layer dense (d_ff=12288)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe",
    num_layers=60, d_model=5120, num_heads=128, num_kv_heads=128,
    head_dim=128, vocab_size=102400, mlp_act="swiglu",
    mla=True, q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    num_experts=160, experts_per_token=6, num_shared_experts=2,
    moe_d_ff=1536, shared_d_ff=3072,
    first_k_dense=1, dense_d_ff=12288,
)
