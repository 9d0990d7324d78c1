"""MINISA instruction set (paper §IV, Tab. II, Fig. 3, Fig. 5).

Eight instructions:

  SetIVNLayout / SetWVNLayout / SetOVNLayout  -- on-chip VN layouts
  ExecuteMapping                              -- stationary-VN placement
  ExecuteStreaming                            -- streaming schedule + dataflow
  Load / Write                                -- off-chip <-> buffer movement
  Activation                                  -- on-buffer activation function

Every instruction declares its encoding once, as a field ``spec``:
``(name, width(cfg), bias)`` triples.  Bitwidths (the instruction-traffic
numbers of Fig. 12 are sums of these), ``encode`` packing and ``decode``
unpacking are all derived from the same spec, so pack/unpack round-trips
never re-derive field widths by hand.
"""

from __future__ import annotations

import dataclasses
import enum
import functools
from typing import Callable, Iterable

from repro_torch.configs.feather import FeatherConfig, _clog2


class Opcode(enum.IntEnum):
    SET_WVN_LAYOUT = 0b000
    SET_IVN_LAYOUT = 0b001
    SET_OVN_LAYOUT = 0b010
    EXECUTE_STREAMING = 0b011
    WRITE = 0b100
    LOAD = 0b101
    ACTIVATION = 0b110
    EXECUTE_MAPPING = 0b111


class Dataflow(enum.IntEnum):
    IOS = 0  # Input-Output stationary: inputs pinned in PEs, weights stream
    WOS = 1  # Weight-Output stationary: weights pinned, inputs stream


class BufferTarget(enum.IntEnum):
    STATIONARY = 0
    STREAMING = 1


# ---------------------------------------------------------------------------
# Field packing helpers
# ---------------------------------------------------------------------------

def _pack(fields: Iterable[tuple[int, int]]) -> int:
    """Pack (value, width) pairs MSB-first into one integer."""
    word = 0
    for value, width in fields:
        if value < 0 or (width < 64 and value >= (1 << width)):
            raise ValueError(f"field value {value} does not fit in {width} bits")
        word = (word << width) | value
    return word


# Fields holding enums: decoded raw ints are cast back through these.
_FIELD_CASTS: dict[str, Callable[[int], object]] = {
    "df": Dataflow,
    "target": BufferTarget,
}


@dataclasses.dataclass(frozen=True)
class Instruction:
    """Base class: subclasses implement spec(cfg) -> [(name, width, bias)].

    ``name`` is the dataclass field holding the value ("opcode" is implicit);
    ``bias`` is subtracted on encode and re-added on decode (the ISA stores
    1-based counts like G_r as value-1).
    """

    opcode: Opcode = dataclasses.field(init=False, default=None, repr=False)

    @classmethod
    def spec(cls, cfg: FeatherConfig) -> list[tuple[str, int, int]]:
        raise NotImplementedError

    def fields(self, cfg: FeatherConfig) -> list[tuple[int, int]]:
        out = []
        for name, width, bias in self.spec(cfg):
            if name == "opcode":
                out.append((int(self.opcode), width))
            else:
                out.append((max(int(getattr(self, name)) - bias, 0), width))
        return out

    def bitwidth(self, cfg: FeatherConfig) -> int:
        # field widths depend only on (class, cfg), never on field values
        return class_bitwidth(type(self), cfg)

    def encode(self, cfg: FeatherConfig) -> int:
        return _pack(self.fields(cfg))

    @classmethod
    def decode(cls, word: int, cfg: FeatherConfig) -> "Instruction":
        """Inverse of encode (exact for in-range field values)."""
        spec = cls.spec(cfg)
        pos = sum(w for _, w, _ in spec)
        kwargs = {}
        for name, width, bias in spec:
            pos -= width
            raw = (word >> pos) & ((1 << width) - 1)
            if name == "opcode":
                if raw != int(cls.opcode):
                    raise ValueError(
                        f"opcode mismatch: got {raw:#b}, "
                        f"expected {int(cls.opcode):#b} ({cls.__name__})")
                continue
            value = raw + bias
            kwargs[name] = _FIELD_CASTS.get(name, int)(value)
        return cls(**kwargs)

    @property
    def is_execute(self) -> bool:
        return False


@functools.lru_cache(maxsize=None)
def class_bitwidth(cls: type, cfg: FeatherConfig) -> int:
    """Encoded width of any instance of ``cls`` under ``cfg``."""
    return sum(w for _, w, _ in cls.spec(cfg))


def decode(word: int, nbits: int, cfg: FeatherConfig) -> Instruction:
    """Decode a packed word of known total width (the opcode occupies the
    top 3 bits; leading zeros make the width part of the wire format)."""
    opcode = Opcode((word >> (nbits - 3)) & 0b111)
    return OPCODE_TO_CLASS[opcode].decode(word, cfg)


# ---------------------------------------------------------------------------
# Layout instructions (Fig. 5).  A layout is (order permutation of the three
# free post-VN ranks) + (level-0 / level-1 partition factors).  The innermost
# reduction-rank factor is pinned at VN size and therefore not encoded.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SetLayoutBase(Instruction):
    order: int = 0        # permutation id in [0, 5] (Tab. III)
    nr_l0: int = 1        # level-0 factor of the non-reduction rank (<= AW)
    nr_l1: int = 1        # level-1 factor of the non-reduction rank
    red_l1: int = 1       # level-1 factor of the reduction rank (K_L1 etc.)

    @classmethod
    def spec(cls, cfg: FeatherConfig) -> list[tuple[str, int, int]]:
        slots = cfg.vn_slots_per_col
        return [
            ("opcode", 3, 0),
            ("order", 3, 0),
            ("nr_l0", _clog2(cfg.aw), 1),
            ("nr_l1", _clog2(slots), 1),
            ("red_l1", _clog2(slots), 1),
        ]

    @property
    def num_vns(self) -> int:
        return self.nr_l0 * self.nr_l1 * self.red_l1


@dataclasses.dataclass(frozen=True)
class SetWVNLayout(SetLayoutBase):
    """Weight VNs: ranks {K_L1, N_L0, N_L1}, K_L0 == VN size."""
    opcode = Opcode.SET_WVN_LAYOUT


@dataclasses.dataclass(frozen=True)
class SetIVNLayout(SetLayoutBase):
    """Input VNs: ranks {J_L1, M_L0, M_L1}, J_L0 == VN size."""
    opcode = Opcode.SET_IVN_LAYOUT


@dataclasses.dataclass(frozen=True)
class SetOVNLayout(SetLayoutBase):
    """Output VNs: ranks {Q_L1, P_L0, P_L1}; also zero-initialises the OB
    tile and, at tile end, commits OB -> streaming/stationary buffer."""
    opcode = Opcode.SET_OVN_LAYOUT


# ---------------------------------------------------------------------------
# Execute instructions (Fig. 3)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ExecuteMapping(Instruction):
    """Place stationary VN(r, c) onto PE(a_h, a_w):

        r = r0 + floor(a_w / G_r)
        c = c0 + s_r * a_h + s_c * (a_w mod G_c)

    (paper Eq. 1).  Out-of-bounds (r, c) are implicitly zero-padded.
    """
    opcode = Opcode.EXECUTE_MAPPING
    r0: int = 0
    c0: int = 0
    g_r: int = 1
    g_c: int = 1
    s_r: int = 0
    s_c: int = 0

    @classmethod
    def spec(cls, cfg: FeatherConfig) -> list[tuple[str, int, int]]:
        slots_col = cfg.vn_slots_per_col
        slots_tot = cfg.vn_slots_total
        return [
            ("opcode", 3, 0),
            ("g_r", _clog2(cfg.aw), 1),
            ("g_c", _clog2(cfg.aw), 1),
            ("r0", _clog2(slots_tot), 0),
            ("c0", _clog2(slots_tot), 0),
            ("s_r", _clog2(slots_col), 0),
            ("s_c", _clog2(slots_col), 0),
        ]

    @property
    def is_execute(self) -> bool:
        return True


@dataclasses.dataclass(frozen=True)
class ExecuteStreaming(Instruction):
    """Stream T VNs into each PE column; VN(m, j) entering column a_w at
    step t in [0, T):

        j = r0 + floor(a_w / G_r)
        m = m0 + s_m * t + floor((a_w mod G_r) / G_c)

    reusing the paired ExecuteMapping's (r0, G_r, G_c).  ``df`` swaps the
    dataflow between IO-S and WO-S; VN_size <= AH.
    """
    opcode = Opcode.EXECUTE_STREAMING
    m0: int = 0
    s_m: int = 1
    t: int = 1            # number of streamed VNs per column
    vn_size: int = 1
    df: Dataflow = Dataflow.WOS

    @classmethod
    def spec(cls, cfg: FeatherConfig) -> list[tuple[str, int, int]]:
        w = _clog2(cfg.vn_slots_per_col)
        return [
            ("opcode", 3, 0),
            ("df", 1, 0),
            ("m0", w, 0),
            ("s_m", w, 1),
            ("t", w, 1),
            ("vn_size", _clog2(cfg.ah), 1),
        ]

    @property
    def is_execute(self) -> bool:
        return True


# ---------------------------------------------------------------------------
# Memory movement + activation
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MemAccess(Instruction):
    """Shared encoding of off-chip <-> buffer movement (Load and Write have
    identical field layouts; only the opcode differs)."""
    hbm_addr: int = 0
    length: int = 0          # elements
    target: BufferTarget = BufferTarget.STREAMING

    @classmethod
    def spec(cls, cfg: FeatherConfig) -> list[tuple[str, int, int]]:
        return [
            ("opcode", 3, 0),
            ("hbm_addr", 33, 0),
            ("length", _clog2(cfg.d_elems * cfg.aw) + 1, 0),
            ("target", 1, 0),
        ]


@dataclasses.dataclass(frozen=True)
class Load(MemAccess):
    opcode = Opcode.LOAD


@dataclasses.dataclass(frozen=True)
class Write(MemAccess):
    opcode = Opcode.WRITE


@dataclasses.dataclass(frozen=True)
class Activation(Instruction):
    """On-buffer activation (relu/gelu/silu/softmax-lut/none)."""
    opcode = Opcode.ACTIVATION
    function: int = 0
    length: int = 0
    target: BufferTarget = BufferTarget.STREAMING

    @classmethod
    def spec(cls, cfg: FeatherConfig) -> list[tuple[str, int, int]]:
        return [
            ("opcode", 3, 0),
            ("function", 4, 0),
            ("target", 1, 0),
            ("length", _clog2(cfg.d_elems * cfg.aw) + 1, 0),
        ]


ACTIVATION_FUNCS = {"none": 0, "relu": 1, "gelu": 2, "silu": 3,
                    "softmax": 4, "rmsnorm": 5, "layernorm": 6, "geglu": 7,
                    "swiglu": 8}

OPCODE_TO_CLASS: dict[Opcode, type[Instruction]] = {
    Opcode.SET_WVN_LAYOUT: SetWVNLayout,
    Opcode.SET_IVN_LAYOUT: SetIVNLayout,
    Opcode.SET_OVN_LAYOUT: SetOVNLayout,
    Opcode.EXECUTE_MAPPING: ExecuteMapping,
    Opcode.EXECUTE_STREAMING: ExecuteStreaming,
    Opcode.LOAD: Load,
    Opcode.WRITE: Write,
    Opcode.ACTIVATION: Activation,
}


# ---------------------------------------------------------------------------
# Trace-level accounting
# ---------------------------------------------------------------------------

def trace_bits(trace: Iterable[Instruction], cfg: FeatherConfig) -> int:
    return sum(inst.bitwidth(cfg) for inst in trace)


def trace_bytes(trace: Iterable[Instruction], cfg: FeatherConfig) -> float:
    return trace_bits(trace, cfg) / 8.0


def trace_summary(trace: Iterable[Instruction], cfg: FeatherConfig) -> dict:
    counts: dict[str, int] = {}
    bits = 0
    for inst in trace:
        name = type(inst).__name__
        counts[name] = counts.get(name, 0) + 1
        bits += inst.bitwidth(cfg)
    return {"counts": counts, "bits": bits, "bytes": bits / 8.0,
            "n_instructions": sum(counts.values())}
