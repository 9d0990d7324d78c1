"""whisper-base [audio]: enc-dec, conv frontend stubbed
[arXiv:2212.04356; unverified].  6L enc + 6L dec, d_model=512, 8H (kv=8),
d_ff=2048, vocab=51865.  The audio conv frontend is a STUB: input_specs()
provides precomputed 1500-frame encoder embeddings (30 s of audio)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="encdec",
    num_layers=6, encoder_layers=6, cross_attention=True,
    d_model=512, num_heads=8, num_kv_heads=8, head_dim=64,
    d_ff=2048, mlp_act="gelu", vocab_size=51865,
    tie_embeddings=True, frontend="audio", frontend_len=1500,
)
