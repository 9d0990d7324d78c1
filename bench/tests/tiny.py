"""Tiny versions of the cells, for the CPU tests: each cell's files with
the configuration cut to a few small layers in fp32 and the traffic to a
few short requests or steps (the same code paths, the plain versions of
the kernels)."""

from __future__ import annotations

import copy

from bench import harness

DECODE = "deepseek-v2-236b.d8.decode_b64_p512_o128"
PREFILL = "deepseek-v2-236b.d8.prefill_p4096"

SIZES = {
    "deepseek_v2": dict(hidden_size=64, num_attention_heads=4,
                        num_key_value_heads=4, q_lora_rank=32,
                        kv_lora_rank=16, qk_nope_head_dim=16,
                        qk_rope_head_dim=8, v_head_dim=16,
                        n_routed_experts=8, num_experts_per_tok=3,
                        moe_intermediate_size=32, intermediate_size=96,
                        vocab_size=256, num_hidden_layers=3,
                        dtype="float32"),
}
#: the traffic's sizes at most (the prompt cut to this length)
TRAFFIC = {"serve": dict(batch=4, prompt=12, output=5)}
#: limits at these sizes: the port's fp32 plain versions against the
#: fp32 reference agree to rounding
LIMITS = {"serve": dict(sample=4, served_gap=1e-3, routing_regret=1e-3,
                        mismatched_drops=0)}


def files(cell: str) -> dict:
    """``harness.cell_files(cell)`` cut to the tiny sizes."""
    f = copy.deepcopy(harness.cell_files(cell))
    f["doc"].update(SIZES[f["doc"]["model_type"]])
    kind = f["traffic"]["kind"]
    f["traffic"].update({k: v if k == "prompt" else min(v, f["traffic"][k])
                         for k, v in TRAFFIC[kind].items()})
    f["limits"].update(LIMITS[kind])
    return f
