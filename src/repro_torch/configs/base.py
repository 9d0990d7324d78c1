"""Architecture + shape configuration schema."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    vocab_size: int
    # attention
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    # mlp
    d_ff: int = 0
    mlp_act: str = "swiglu"          # swiglu | geglu | gelu | relu2
    # embeddings
    tie_embeddings: bool = False
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    shared_d_ff: int = 0
    first_k_dense: int = 0           # deepseek: leading dense layers
    dense_d_ff: int = 0
    capacity_factor: float = 1.25
    # MLA
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # SSM
    ssm_version: int = 0             # 0: none, 1: mamba1, 2: mamba2
    ssm_state: int = 0
    ssm_d_conv: int = 4
    ssm_expand: int = 2
    ssm_heads: int = 0               # mamba2
    ssm_groups: int = 1              # mamba2 B/C groups
    # hybrid (zamba2): shared attention block applied every k SSM blocks
    attn_every: int = 0
    # enc-dec
    encoder_layers: int = 0
    cross_attention: bool = False
    # modality frontend stub
    frontend: str = "none"           # none | audio | vision
    frontend_len: int = 0
    # numerics
    dtype: str = "bfloat16"

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_dt_rank(self) -> int:
        return max(1, self.d_model // 16)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """long_500k runs only for sub-quadratic (SSM/hybrid) archs."""
        return self.family in ("ssm", "hybrid")

    @property
    def moe_enabled(self) -> bool:
        return self.num_experts > 0


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def reduced(cfg: ModelConfig, layers: int = 2, d_model: int = 64,
            vocab: int = 512) -> ModelConfig:
    """Family-preserving reduced config for CPU smoke tests."""
    scale = d_model / max(cfg.d_model, 1)
    def sc(x, lo=1):
        return max(lo, int(round(x * scale)))
    heads = max(1, min(cfg.num_heads, 4))
    kvh = max(1, min(cfg.num_kv_heads, heads))
    while heads % kvh:
        kvh -= 1
    updates = dict(
        num_layers=layers,
        d_model=d_model,
        vocab_size=vocab,
        num_heads=heads,
        num_kv_heads=kvh,
        head_dim=16 if cfg.head_dim else 0,
        d_ff=4 * d_model if cfg.d_ff else 0,
        moe_d_ff=2 * d_model if cfg.moe_d_ff else 0,
        shared_d_ff=2 * d_model if cfg.shared_d_ff else 0,
        dense_d_ff=4 * d_model if cfg.dense_d_ff else 0,
        num_experts=min(cfg.num_experts, 8),
        experts_per_token=min(cfg.experts_per_token, 2),
        first_k_dense=min(cfg.first_k_dense, 1),
        q_lora_rank=32 if cfg.q_lora_rank else 0,
        kv_lora_rank=16 if cfg.kv_lora_rank else 0,
        qk_nope_head_dim=16 if cfg.qk_nope_head_dim else 0,
        qk_rope_head_dim=8 if cfg.qk_rope_head_dim else 0,
        v_head_dim=16 if cfg.v_head_dim else 0,
        ssm_state=min(cfg.ssm_state, 8) if cfg.ssm_state else 0,
        ssm_heads=min(cfg.ssm_heads, 4) if cfg.ssm_heads else 0,
        ssm_groups=1,
        attn_every=min(cfg.attn_every, 2) if cfg.attn_every else 0,
        encoder_layers=min(cfg.encoder_layers, 2),
        frontend_len=min(cfg.frontend_len, 8) if cfg.frontend_len else 0,
        # generous capacity at smoke scale: no data-dependent expert drops
        capacity_factor=4.0,
        dtype="float32",
    )
    return dataclasses.replace(cfg, **updates)
