"""Micro-instruction (baseline) control-traffic model (paper §III-D, Tab. I).

The baseline programs FEATHER+ the way FEATHER is programmed: explicit
fine-grained per-cycle configuration of every switch and address generator.
The paper gives asymptotics -- BIRRD control grows O(AW log AW), buffer
addressing O(D x AW) -- but not the RTL word format, so we model the stream
field-by-field and split it into two traffic classes:

STORAGE volume (Fig. 12 bar chart -- what must exist as a program image):
  every cycle's full configuration word:

    word = per-PE micro-ops + BIRRD switches + distribution crossbars
           + per-bank OB addresses + streaming addresses

FETCH volume (what crosses the 9 B/cycle off-chip instruction interface,
which is what causes Tab. I's stalls):
  * switch programs and bank addresses are constant (or counter-generated)
    *within* one NEST invocation, so the instruction buffer replays them;
    they are re-fetched once per invocation (the mapping changes);
  * per-PE enable/select micro-ops are data-position dependent and never
    repeat: a unique stream of ``micro_pe_bits`` * AH * AW bits/cycle.

Calibration: ``micro_pe_bits`` is the single global constant.  With the
default 0.7 bits/PE/cycle the model reproduces Tab. I as:

    paper:  4x4 0%   8x8 0%   4x64 75.3%  16x16 65.2%  8x128 90.4%  16x256 96.9%
    model:  0%       0%       ~60%        ~62%         ~90%         ~97%

(no per-workload fitting; see benchmarks/stall_table.py).  The small-array
zero-stall boundary (<=64 PEs, Fig. 10) falls out exactly: 64 PEs * 0.7 bits
= 5.6 B/cycle < 9 B/cycle interface.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.feather import FeatherConfig, _clog2


@dataclasses.dataclass(frozen=True)
class MicroModel:
    cfg: FeatherConfig

    # -- per-cycle field widths (bits) --------------------------------------
    @property
    def birrd_bits_per_cycle(self) -> int:
        """2 bits per 2x2 switch (pass/swap/add-l/add-r), all stages."""
        return self.cfg.birrd_stages * self.cfg.birrd_switches * 2

    @property
    def xbar_bits_per_cycle(self) -> int:
        """All-to-all distribution crossbars (streaming + stationary):
        a source-select per NEST column."""
        return 2 * self.cfg.aw * _clog2(self.cfg.aw)

    @property
    def ob_addr_bits_per_cycle(self) -> int:
        """Per-bank OB address generation: AW banks x ceil(log2 D_ob)."""
        return self.cfg.aw * _clog2(max(self.cfg.d_ob, 2))

    @property
    def stream_addr_bits_per_cycle(self) -> int:
        """Per-bank streaming addresses (FEATHER's multi-bank interface)."""
        return self.cfg.aw * _clog2(max(self.cfg.d_str, 2))

    @property
    def pe_bits_per_cycle(self) -> float:
        """Unique per-PE control micro-ops (calibrated, see module doc)."""
        return self.cfg.micro_pe_bits * self.cfg.ah * self.cfg.aw

    # -- traffic classes -----------------------------------------------------
    @property
    def storage_bits_per_cycle(self) -> float:
        """Full per-cycle configuration word (program-image size)."""
        return (self.pe_bits_per_cycle + self.birrd_bits_per_cycle
                + self.xbar_bits_per_cycle + self.ob_addr_bits_per_cycle
                + self.stream_addr_bits_per_cycle)

    @property
    def unique_bits_per_cycle(self) -> float:
        """Never-repeating off-chip stream (fetch-side)."""
        return self.pe_bits_per_cycle

    @property
    def program_bits_per_invocation(self) -> float:
        """Re-fetched whenever the NEST mapping changes: switch programs +
        address-counter bases."""
        return (self.birrd_bits_per_cycle + self.xbar_bits_per_cycle
                + self.ob_addr_bits_per_cycle + self.stream_addr_bits_per_cycle)

    # -- per-workload volumes -------------------------------------------------
    def storage_bytes(self, compute_cycles: float) -> float:
        """Total micro-instruction bytes of the program image (Fig. 12)."""
        return self.storage_bits_per_cycle * compute_cycles / 8.0

    def fetch_bytes(self, compute_cycles: float, invocations: int) -> float:
        """Bytes crossing the off-chip instruction interface."""
        return (self.unique_bits_per_cycle * compute_cycles
                + self.program_bits_per_invocation * max(invocations, 1)) / 8.0
