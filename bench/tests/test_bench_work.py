"""The work counts against the bound column of ``PERF.md``'s kernel
table (chip_smoke.py's arithmetic at each row's shapes), and the model
counts against a hand count."""

from __future__ import annotations

import json

import pytest

from bench import harness
from bench.work import deepseek_v2, kernels as kw, peaks


def ms(flops, nbytes, rate):
    return peaks.bound_s(flops, nbytes, rate) * 1e3


#: row: (work, rate, the table's bound ms, its digits)
ROWS = {
    # MLA's absorbed decode: q [4, 128, 576], K [4, 49, 576], V [4, 49,
    # 512], lengths 47
    "flash_decode_mla": (kw.flash_decode(4, 128, 576, 512, 4 * 47, elt=2),
                         peaks.BF16_FLOPS, 0.00045, 5),
    # MLA's prefill: [512, 32, 192] causal, v 128 wide
    "flash_attention_mla": (kw.flash_attention(512, 32, 32, 192, 128,
                                               causal=True, elt=2,
                                               lse=False),
                            peaks.BF16_FLOPS, 0.0063, 4),
    # the scan storing its states, [128, 1024, 64, 64], dense inputs
    "mamba_scan_states": (kw.mamba_scan(
        128, 1024, 64, 64, states=True,
        in_bytes=4 * (2 * 128 * 1024 * 64 * 64 + 128 * 1024 * 64
                      + 128 * 64 * 64)), peaks.FP32_FLOPS, 1.343, 3),
    "mamba_scan_bwd": (kw.mamba_scan_bwd(
        128, 1024, 64, 64, da_bytes=4 * 128 * 1024 * 64 * 64,
        dbx_bytes=4 * 128 * 1024 * 64 * 64), peaks.FP32_FLOPS, 2.635, 3),
    # the backward, bf16 [64, 1024, 64] causal
    "flash_attention_bwd": (kw.flash_attention_bwd(64, 1024, 1024, 64, 64,
                                                   causal=True, elt=2),
                            peaks.BF16_FLOPS, 0.0217, 4),
}


@pytest.mark.parametrize("row", sorted(ROWS))
def test_bound_column_of_the_kernel_table(row):
    (flops, nbytes), rate, table, digits = ROWS[row]
    assert round(ms(flops, nbytes, rate), digits) == table


def test_held_bytes_counts_a_broadcast_once():
    # Mamba-2's decay: one scalar a (row, head, step), expanded over P, N
    assert kw.held_bytes((2, 64, 2048, 64, 64), (64 * 2048, 2048, 1, 0, 0),
                         4) == 4 * 2 * 64 * 2048


def test_causal_pairs():
    assert kw.attending_pairs(4, 4, True, 4) == 10
    assert kw.attending_pairs(1, 8, True, 5) == 1
    assert kw.attending_pairs(3, 8, False, 5) == 15


def test_deepseek_request_count_by_hand():
    doc = json.loads((harness.ROOT / "bench/configs/deepseek-v2-236b.d8"
                      ".json").read_text())
    # one token through 8 layers: MLA's products, 1 dense MLP, 7 MoE
    # layers of router + 6 routed + 2 shared experts
    mla = 5120 * 1536 + 1536 * 128 * 192 + 5120 * 576 + 512 * 128 * 256 \
        + 128 * 128 * 5120
    moe = 5120 * 160 + 3 * 5120 * 1536 * 8
    assert deepseek_v2.token_flops(doc) == 2.0 * (8 * mla + 3 * 5120 * 12288
                                                  + 7 * moe)
    # a 2-token prompt and 2 generated: 3 tokens through the layers, 6
    # causal pairs, the head twice
    got = deepseek_v2.request_flops(doc, 2, 2)
    want = 3 * deepseek_v2.token_flops(doc) \
        + 2.0 * 8 * 128 * 6 * 320 + 2 * 2.0 * 5120 * 102400
    assert got == want
