"""Extract the per-layer GEMM stream of an (architecture x shape) cell for
the MINISA planner (the framework-side analogue of ACT's graph analysis).

Included: every dense projection, MoE router + per-expert FFN GEMMs, MLA
low-rank projections, attention score/value batched GEMMs (FEATHER+'s
headline dynamic-operand case -- both operands arrive at runtime), and the
LM head.  Excluded (and routed to the paper's Activation instruction):
softmax, norms, rotary, SSM selective scans, embedding gathers.  See
DESIGN.md §Arch-applicability.
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.mapper import Gemm
from repro_torch.core.planner import GemmOp


def _proj(name, m, k, n, count=1, chained=False, act="none", dynamic=False):
    return GemmOp(gemm=Gemm(m=m, k=k, n=n, name=name, count=count),
                  layer=name, chained=chained, activation=act,
                  dynamic=dynamic)


def _attn_gemms(cfg: ModelConfig, tokens: int, batch: int, s_q: int,
                s_kv: int, layers: int, prefix: str = "") -> list[GemmOp]:
    """Projections + batched score/value GEMMs for ``layers`` GQA layers."""
    h, kv, hd, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    ops = [
        _proj(f"{prefix}wq", tokens, d, h * hd, layers),
        _proj(f"{prefix}wk", tokens, d, kv * hd, layers),
        _proj(f"{prefix}wv", tokens, d, kv * hd, layers),
        # scores: per (batch, head) GEMM  [s_q, hd] x [hd, s_kv]; both
        # operands arrive at runtime (FEATHER+'s dynamic-operand case)
        _proj(f"{prefix}qk", s_q, hd, s_kv, layers * batch * h,
              chained=True, act="softmax", dynamic=True),
        # values: [s_q, s_kv] x [s_kv, hd]
        _proj(f"{prefix}pv", s_q, s_kv, hd, layers * batch * h,
              chained=True, dynamic=True),
        _proj(f"{prefix}wo", tokens, h * hd, d, layers, chained=True),
    ]
    return ops


def _mla_gemms(cfg: ModelConfig, tokens: int, batch: int, s_q: int,
               s_kv: int, layers: int) -> list[GemmOp]:
    d, h = cfg.d_model, cfg.num_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return [
        _proj("mla.wq_a", tokens, d, qr, layers),
        _proj("mla.wq_b", tokens, qr, h * (dn + dr), layers, chained=True),
        _proj("mla.wkv_a", tokens, d, kvr + dr, layers),
        _proj("mla.wk_b", tokens, kvr, h * dn, layers, chained=True),
        _proj("mla.wv_b", tokens, kvr, h * dv, layers, chained=True),
        _proj("mla.qk", s_q, dn + dr, s_kv, layers * batch * h,
              chained=True, act="softmax", dynamic=True),
        _proj("mla.pv", s_q, s_kv, dv, layers * batch * h, chained=True,
              dynamic=True),
        _proj("mla.wo", tokens, h * dv, d, layers, chained=True),
    ]


def _mlp_gemms(cfg: ModelConfig, tokens: int, layers: int,
               d_ff: int | None = None, prefix: str = "") -> list[GemmOp]:
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    gated = cfg.mlp_act in ("swiglu", "geglu")
    ops = [_proj(f"{prefix}mlp.up", tokens, d, ff, layers)]
    if gated:
        ops.append(_proj(f"{prefix}mlp.gate", tokens, d, ff, layers))
    ops.append(_proj(f"{prefix}mlp.down", tokens, ff, d, layers,
                     chained=True, act=cfg.mlp_act))
    return ops


def _moe_gemms(cfg: ModelConfig, tokens: int, layers: int) -> list[GemmOp]:
    d, e, k, ff = (cfg.d_model, cfg.num_experts, cfg.experts_per_token,
                   cfg.moe_d_ff)
    per_expert = max(1, tokens * k // e)
    gated = cfg.mlp_act in ("swiglu", "geglu")
    ops = [_proj("moe.router", tokens, d, e, layers)]
    mats = 3 if gated else 2
    ops.append(_proj("moe.expert.up", per_expert, d, ff,
                     layers * e * (mats - 1)))
    ops.append(_proj("moe.expert.down", per_expert, ff, d, layers * e,
                     chained=True, act=cfg.mlp_act))
    if cfg.num_shared_experts:
        sf = cfg.shared_d_ff or ff * cfg.num_shared_experts
        ops += [_proj("moe.shared.up", tokens, d, sf, layers * 2),
                _proj("moe.shared.down", tokens, sf, d, layers,
                      chained=True)]
    return ops


def _ssm_gemms(cfg: ModelConfig, tokens: int, layers: int) -> list[GemmOp]:
    d, di, n = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state
    dt = cfg.ssm_dt_rank
    if cfg.ssm_version == 2:
        g, h = cfg.ssm_groups, cfg.ssm_heads
        width = 2 * di + 2 * g * n + h
        return [
            _proj("ssm2.in", tokens, d, width, layers),
            # selective scan itself: Activation instruction, not a GEMM
            _proj("ssm2.out", tokens, di, d, layers, chained=True,
                  act="silu"),
        ]
    return [
        _proj("ssm.in", tokens, d, 2 * di, layers),
        _proj("ssm.x_proj", tokens, di, dt + 2 * n, layers, chained=True),
        _proj("ssm.dt_proj", tokens, dt, di, layers, chained=True),
        _proj("ssm.out", tokens, di, d, layers, chained=True, act="silu"),
    ]


def gemm_workloads(cfg: ModelConfig, shape: ShapeConfig) -> list[GemmOp]:
    b = shape.global_batch
    if shape.kind == "decode":
        tokens, s_q, s_kv = b, 1, shape.seq_len
    else:
        tokens, s_q, s_kv = shape.tokens, shape.seq_len, shape.seq_len

    ops: list[GemmOp] = []
    L = cfg.num_layers

    if cfg.family == "encdec":
        enc_tokens = b * cfg.frontend_len
        if shape.kind != "decode":
            ops += _attn_gemms(cfg, enc_tokens, b, cfg.frontend_len,
                               cfg.frontend_len, cfg.encoder_layers, "enc.")
            ops += _mlp_gemms(cfg, enc_tokens, cfg.encoder_layers, prefix="enc.")
        ops += _attn_gemms(cfg, tokens, b, s_q, s_kv, L, "dec.")
        ops += _attn_gemms(cfg, tokens, b, s_q, cfg.frontend_len, L, "xattn.")
        ops += _mlp_gemms(cfg, tokens, L, prefix="dec.")
    elif cfg.family == "ssm":
        ops += _ssm_gemms(cfg, tokens, L)
    elif cfg.family == "hybrid":
        n_attn = L // cfg.attn_every
        ops += _ssm_gemms(cfg, tokens, L)
        ops += _attn_gemms(cfg, tokens, b, s_q, s_kv, n_attn, "shared.")
        ops += _mlp_gemms(cfg, tokens, n_attn, prefix="shared.")
    else:
        n_scan = L - cfg.first_k_dense
        if cfg.mla:
            ops += _mla_gemms(cfg, tokens, b, s_q, s_kv, L)
        else:
            ops += _attn_gemms(cfg, tokens, b, s_q, s_kv, L)
        if cfg.moe_enabled:
            ops += _moe_gemms(cfg, tokens, n_scan)
            if cfg.first_k_dense:
                ops += _mlp_gemms(cfg, tokens, cfg.first_k_dense,
                                  d_ff=cfg.dense_d_ff, prefix="dense.")
        else:
            ops += _mlp_gemms(cfg, tokens, L)

    ops.append(_proj("lm_head", tokens, cfg.d_model, cfg.vocab_size, 1,
                     chained=True))
    return ops
