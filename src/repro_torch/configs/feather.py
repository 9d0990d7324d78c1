"""FEATHER+ accelerator configurations (paper Tab. V).

The paper sweeps (AH, AW) in {(4, 4/16/64), (8, 8/32/128), (16, 16/64/256)}.
On-chip data SRAM scales with AH and is partitioned into streaming (40%),
stationary (40%) and output (20%) buffers.  A dedicated instruction buffer
(0.5 / 1 / 2 MB) is fed by a fixed off-chip instruction interface of
9 B/cycle.  Off-chip data bandwidth is AW B/cycle for inputs/weights and
4*AW B/cycle for outputs.  Datapath elements are INT8 (1 byte).
"""

from __future__ import annotations

import dataclasses
import math

MB = 1 << 20

# Per-AH on-chip capacities from Tab. V: (streaming, stationary, output,
# instruction) buffer bytes.  "StrB/StaB" are each 40% of data SRAM, OB 20%.
_CAPACITY_TABLE = {
    4: (int(1.6 * MB), int(1.6 * MB), int(0.8 * MB), int(0.5 * MB)),
    8: (int(6.4 * MB), int(6.4 * MB), int(3.2 * MB), int(1.0 * MB)),
    16: (int(25.6 * MB), int(25.6 * MB), int(12.8 * MB), int(2.0 * MB)),
}

#: The nine array configurations evaluated in the paper (§VI-A).
SWEEP = (
    (4, 4), (4, 16), (4, 64),
    (8, 8), (8, 32), (8, 128),
    (16, 16), (16, 64), (16, 256),
)


def _clog2(x: int) -> int:
    """ceil(log2(x)) for x >= 1."""
    if x <= 1:
        return 0
    return int(math.ceil(math.log2(x)))


@dataclasses.dataclass(frozen=True)
class FeatherConfig:
    """Static description of one FEATHER+ instance."""

    ah: int                      # NEST rows: per-PE dot-product length (VN size cap)
    aw: int                      # NEST columns (independent mapping units)
    str_bytes: int               # streaming buffer capacity
    sta_bytes: int               # stationary buffer capacity
    ob_bytes: int                # output buffer capacity
    instr_bytes: int             # instruction buffer capacity
    elem_bytes: int = 1          # INT8 datapath
    acc_bytes: int = 4           # partial-sum width in OB
    instr_bw: float = 9.0        # off-chip instruction interface, B/cycle
    # Micro-instruction calibration (see core/microinst.py for derivation).
    micro_pe_bits: float = 0.7   # unique per-PE control bits per cycle

    # ---- derived geometry -------------------------------------------------
    @property
    def in_bw(self) -> float:
        """Off-chip input/weight bandwidth, B/cycle."""
        return float(self.aw)

    @property
    def out_bw(self) -> float:
        """Off-chip output bandwidth, B/cycle."""
        return float(4 * self.aw)

    @property
    def d_str(self) -> int:
        """Streaming-buffer depth in rows of AW elements."""
        return self.str_bytes // (self.aw * self.elem_bytes)

    @property
    def d_sta(self) -> int:
        """Stationary-buffer depth in rows of AW elements."""
        return self.sta_bytes // (self.aw * self.elem_bytes)

    @property
    def d_ob(self) -> int:
        """Output-buffer depth per bank (AW banks of acc_bytes words)."""
        return self.ob_bytes // (self.aw * self.acc_bytes)

    @property
    def vn_capacity_str(self) -> int:
        """Max number of VNs resident in the streaming buffer."""
        return (self.d_str // self.ah) * self.aw

    @property
    def vn_capacity_sta(self) -> int:
        return (self.d_sta // self.ah) * self.aw

    @property
    def birrd_stages(self) -> int:
        """BIRRD (Benes-like) stage count: 2*ceil(log2(AW)) - 1."""
        return max(1, 2 * _clog2(self.aw) - 1)

    @property
    def birrd_switches(self) -> int:
        """2x2 switches per stage."""
        return self.aw // 2

    @property
    def pipeline_depth(self) -> int:
        """Cycles from first streamed element to first OB write."""
        return self.ah + self.birrd_stages + 2

    @property
    def peak_macs_per_cycle(self) -> int:
        return self.ah * self.aw

    # ---- ISA field widths (Fig. 3 / Fig. 5) -------------------------------
    # D refers to the stationary/streaming buffer depth in *elements per
    # column* (capacity/AW for 1-byte elements); D/AH is the number of VN
    # slots per column.
    @property
    def d_elems(self) -> int:
        """Per-column buffer depth D in elements (D_sta == D_str in Tab. V)."""
        return self.str_bytes // (self.aw * self.elem_bytes)

    @property
    def vn_slots_per_col(self) -> int:
        return max(1, self.d_elems // self.ah)

    @property
    def vn_slots_total(self) -> int:
        return self.vn_slots_per_col * self.aw

    def bits_set_layout(self) -> int:
        """Set*VNLayout width: OpCode(3) + Order(3) + L0(log2 AW)
        + L1/redL1 (log2(D/AH) each)."""
        return 3 + 3 + _clog2(self.aw) + 2 * _clog2(self.vn_slots_per_col)

    def bits_execute_mapping(self) -> int:
        """ExecuteMapping: OpCode(3) + G_r,G_c (log2 AW each)
        + r0,c0 (log2(D/AH * AW) each) + s_r,s_c (log2(D/AH) each)."""
        return (3 + 2 * _clog2(self.aw)
                + 2 * _clog2(self.vn_slots_total)
                + 2 * _clog2(self.vn_slots_per_col))

    def bits_execute_streaming(self) -> int:
        """ExecuteStreaming: OpCode(3) + df(1) + m0,s_m,T (log2(D/AH) each)
        + VN_SIZE (log2 AH).

        This formula reproduces Tab. V's E.Streaming column exactly for all
        nine configurations.
        """
        return 3 + 1 + 3 * _clog2(self.vn_slots_per_col) + _clog2(self.ah)

    def bits_load_store(self) -> int:
        """Load/Write: OpCode(3) + HBM address + length + target(1)."""
        hbm_bits = 33  # 8 GB addressable off-chip, paper leaves this open
        return 3 + hbm_bits + _clog2(self.d_elems * self.aw) + 1

    def bits_activation(self) -> int:
        """Activation: OpCode(3) + function-select(4) + target(1) + length."""
        return 3 + 4 + 1 + _clog2(self.d_elems * self.aw)


def feather_config(ah: int, aw: int, **overrides) -> FeatherConfig:
    if ah not in _CAPACITY_TABLE:
        # Off-table sizes (scalability studies): scale data SRAM ~ AH^2 like
        # the paper's table does (4->8->16 quadruples capacity).
        base = _CAPACITY_TABLE[16]
        scale = (ah / 16.0) ** 2
        caps = tuple(int(c * scale) for c in base[:3]) + (base[3],)
    else:
        caps = _CAPACITY_TABLE[ah]
    str_b, sta_b, ob_b, ins_b = caps
    return FeatherConfig(
        ah=ah, aw=aw, str_bytes=str_b, sta_bytes=sta_b,
        ob_bytes=ob_b, instr_bytes=ins_b, **overrides)


def sweep_configs() -> list[FeatherConfig]:
    return [feather_config(ah, aw) for ah, aw in SWEEP]
