"""zamba2-1.2b [hybrid] [arXiv:2411.15242; hf]: 38 Mamba2
blocks, d_model=2048, shared attention block (32H kv=32, d_ff=8192) applied
every 6 blocks, ssm_state=64, vocab=32000.

Deviations noted in DESIGN.md: zamba2's shared-block input concatenation and
per-application LoRA deltas are simplified to per-application input norms."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    num_layers=38, d_model=2048, vocab_size=32000,
    num_heads=32, num_kv_heads=32, head_dim=64, d_ff=8192,
    mlp_act="gelu",
    ssm_version=2, ssm_state=64, ssm_heads=64, ssm_groups=1,
    attn_every=6,
)
