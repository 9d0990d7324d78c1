"""falcon-mamba-7b [ssm] [arXiv:2410.05355;
unverified]: 64L pure Mamba-1, d_model=4096 (d_inner=8192), ssm_state=16,
vocab=65024.  Attention-free."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    num_layers=64, d_model=4096, vocab_size=65024,
    ssm_version=1, ssm_state=16,
)
