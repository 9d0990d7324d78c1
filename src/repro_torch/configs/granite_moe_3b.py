"""granite-moe-3b-a800m [moe]
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]: 32L, d_model=1536,
24H (GQA kv=8), expert d_ff=512, vocab=49155, 40 experts top-8."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    num_layers=32, d_model=1536, num_heads=24, num_kv_heads=8,
    head_dim=64, vocab_size=49155, mlp_act="swiglu",
    num_experts=40, experts_per_token=8, moe_d_ff=512,
    tie_embeddings=True,
)
