"""gemma-7b [dense] [arXiv:2403.08295; hf]: 28L, d_model=3072,
16H (kv=16), head_dim=256, GeGLU d_ff=24576, vocab=256000, tied embeddings."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b", family="dense",
    num_layers=28, d_model=3072, num_heads=16, num_kv_heads=16,
    head_dim=256, d_ff=24576, mlp_act="geglu", vocab_size=256000,
    tie_embeddings=True,
)
