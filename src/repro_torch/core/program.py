"""Tiled Program IR: the single lowered artifact shared by simulation,
byte accounting and functional execution.

A :class:`Program` is an ordered sequence of :class:`Tile`\\ s.  Each tile
carries its MINISA instructions (Load* / ExecuteMapping / ExecuteStreaming /
Activation / Write TraceOps with simulator side-band metadata), knows its
operand-residency mode, and exposes a :class:`repro_torch.core.perf.TileCost`.
One lowering produces everything downstream:

    Gemm + MappingChoice --lower()--> Program
        --> backends.CudaBackend         (compiled: tiling -> nest_gemm)
        --> perf.simulate(tile_costs())  (5-engine analytical model)
        --> minisa_bytes()               (byte accounting == trace_bits of
                                          the flattened instruction stream)

so what we *count* is by construction what we *execute* -- there is no
separate closed-form instruction/byte model.

Scale-out: :func:`shard_program` partitions a Program across a
``dist.ArrayMesh`` of FEATHER+ arrays (M/N output splits, or K with a
reduction epilogue) into a :class:`ShardedProgram` whose per-array
sub-Programs keep all of the above exact per array.

Fusion: :func:`fuse_segment` turns a ``chain()``-ed segment into a
:class:`FusedSegment` -- the launch geometry for ONE compiled kernel
covering the whole chain, with every interior activation resident
on-chip (the kernel-level analog of the §IV-G commit) and the traffic
accounting elided to match.

Tiling & residency
------------------
The loop nest is n-outer, m-mid, k-inner in the mapper's search
orientation (IO-S transposes the GEMM).  Each operand is lowered in one of
three residency modes, decided against the real buffer capacities:

  full    the whole operand fits: one Load up front, VN indices are global
  panel   (stationary only) one k-panel per n-tile fits: incremental Loads
          per k-tile, reused across the m loop; VN rows global, cols local
  tiled   per-tile Loads every visit; VN indices tile-local

Execute instructions address whatever the Loads put in the buffer, so the
index bases differ per mode; the ExecuteStreaming TraceOp meta carries the
tile's global offsets/bounds for the simulator (j_off / m_off / c_off /
r_hi / c_hi / m_hi), which is side-band only -- hardware derives the same
from the Load base registers.

Inner-loop compression: the EM/ES block of a tile is stored as a compact
:class:`ExecBlock` descriptor (instruction *counts* and bitwidths are
exact; the instruction objects themselves materialise lazily via
``trace_ops()``), so lowering a multi-million-invocation GEMM stays O(tiles)
while the flattened stream remains well-defined and byte-identical.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Iterator

from repro_torch.configs.feather import FeatherConfig
from repro_torch.core import isa, layout as layoutlib, perf
from repro_torch.core.microinst import MicroModel


@dataclasses.dataclass
class TraceOp:
    """An instruction plus simulation side-band metadata.

    The ISA encodes only what hardware needs (Fig. 3/5); the simulator
    additionally needs to know *which* host tensor a Load refers to, the
    bound VNLayout object and where a tile sits in the global problem.
    ``meta`` keys used:

      Load:            tensor (str), operand ('I'|'W'), layout (VNLayout),
                       slice ((r0, r1, c0, c1) host coords | None = whole),
                       vn_row0 / col0 (placement offset in the layout's VN
                       array), reset (bool), extents ((red, free) validity
                       region)
      Set*VNLayout:    layout (VNLayout)
      SetOVNLayout:    m_extent, n_extent (full accumulator shape)
      ExecuteStreaming: j_off, m_off, c_off, r_hi, c_hi, m_hi (tile bounds)
      Write:           tensor (str), transpose (bool), slice ((m0, m1, n0,
                       n1) in search orientation), final (bool), commit_to
                       (None | 'streaming' | 'stationary'), layout (commit
                       re-bind layout)
      Activation:      fn (callable) applied to the drained output slice,
                       name (act registry key -- lets the machine apply a
                       device-side twin without leaving the accelerator)
    """
    inst: isa.Instruction
    meta: dict[str, Any] = dataclasses.field(default_factory=dict)


# ---------------------------------------------------------------------------
# Execute block (compressed EM/ES inner loop of one tile)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ExecBlock:
    """The (ExecuteMapping, ExecuteStreaming*) lattice of one tile.

    Shared by every tile of the same extent class; instruction counts and
    per-instruction bitwidths are exact, materialisation is lazy.
    """
    kg_ext: int          # reduction groups covered by this tile
    nb_ext: int          # n-blocks covered by this tile
    m_ext: int           # streamed free-rank extent
    vn: int
    n_kg: int
    n_nb: int
    g_r: int
    g_c: int
    s_r: int
    s_c: int
    t_max: int           # ES T-field bound (paper §IV-G sub-tiling)
    df: isa.Dataflow

    @property
    def dup(self) -> int:
        return max(1, self.g_r // self.g_c)

    @property
    def t_steps(self) -> int:
        return math.ceil(self.m_ext / self.dup)

    @property
    def n_invocations(self) -> int:
        return (math.ceil(self.kg_ext / max(self.n_kg, 1))
                * math.ceil(self.nb_ext / max(self.n_nb, 1)))

    @property
    def es_per_invocation(self) -> int:
        return math.ceil(self.t_steps / max(self.t_max, 1))

    @property
    def n_es(self) -> int:
        return self.n_invocations * self.es_per_invocation

    def bits(self, cfg: FeatherConfig) -> int:
        return (self.n_invocations * cfg.bits_execute_mapping()
                + self.n_es * cfg.bits_execute_streaming())

    def compute_cycles(self, cfg: FeatherConfig) -> float:
        """Per-invocation: stream T VNs x vn cycles each; the stationary
        (re)load of vn VNs x vn elements is double-buffered and exposed
        only when longer than the streaming phase; plus drain."""
        stream = self.t_steps * self.vn
        sta_load = self.vn * self.vn
        drain = self.vn + cfg.birrd_stages + 2
        return self.n_invocations * (max(stream, sta_load) + drain)

    def trace_ops(self, sta_row_base: int, sta_col_base: int,
                  str_m_base: int, es_meta: dict) -> Iterator[TraceOp]:
        """Materialise the EM/ES stream with this tile's index bases."""
        dup = self.dup
        m_span = dup * max(self.t_max, 1)
        for kg0 in range(0, self.kg_ext, self.n_kg):
            em = isa.ExecuteMapping(
                r0=sta_row_base + kg0, c0=sta_col_base,
                g_r=self.g_r, g_c=self.g_c, s_r=self.s_r, s_c=self.s_c)
            for nb0 in range(0, self.nb_ext, self.n_nb):
                if nb0:
                    em = dataclasses.replace(
                        em, c0=sta_col_base + nb0 * self.vn)
                yield TraceOp(em, {})
                for mc in range(0, self.m_ext, m_span):
                    t = min(self.t_max,
                            math.ceil((self.m_ext - mc) / dup))
                    yield TraceOp(
                        isa.ExecuteStreaming(
                            m0=str_m_base + mc, s_m=dup, t=t,
                            vn_size=self.vn, df=self.df),
                        es_meta)


# ---------------------------------------------------------------------------
# Tile
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Tile:
    """One schedulable unit: its loads, its execute block, its drains."""
    im: int
    i_n: int
    ik: int
    m0: int                      # element offsets (search orientation)
    n0: int
    k0: int
    m_ext: int
    n_ext: int
    k_ext: int
    loads: tuple[TraceOp, ...]
    exec_block: ExecBlock
    drains: tuple[TraceOp, ...]  # [Activation,] Write at the last k tile
    sta_row_base: int
    sta_col_base: int
    str_row_base: int
    str_m_base: int
    last_k: bool

    @property
    def macs(self) -> int:
        return self.m_ext * self.k_ext * self.n_ext

    def es_meta(self) -> dict:
        return {
            "j_off": self.str_row_base - self.sta_row_base,
            "m_off": self.m0 - self.str_m_base,
            "c_off": self.n0 - self.sta_col_base,
            "r_hi": self.sta_row_base + self.exec_block.kg_ext,
            "c_hi": self.sta_col_base + self.n_ext,
            "m_hi": self.str_m_base + self.m_ext,
        }

    def trace_ops(self) -> Iterator[TraceOp]:
        yield from self.loads
        yield from self.exec_block.trace_ops(
            self.sta_row_base, self.sta_col_base, self.str_m_base,
            self.es_meta())
        yield from self.drains

    def bits(self, cfg: FeatherConfig) -> int:
        fixed = sum(op.inst.bitwidth(cfg)
                    for op in self.loads + self.drains)
        return fixed + self.exec_block.bits(cfg)


# ---------------------------------------------------------------------------
# Program
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Program:
    """Lowered tiled program for one GEMM layer."""
    gemm: Any                     # mapper.Gemm (kept duck-typed: m/k/n)
    choice: Any                   # mapper.MappingChoice
    cfg: FeatherConfig
    prologue: tuple[TraceOp, ...]   # SetIVNLayout? SetWVNLayout SetOVNLayout
    tiles: list[Tile]
    n_m: int
    n_n: int
    n_k: int
    residency: dict[str, str]     # {'stationary': mode, 'streaming': mode}
    input_role: str               # 'streaming' (WO-S) | 'stationary' (IO-S)
    out_name: str = "O"
    activation: Callable | None = None
    act_name: str = "none"
    input_elided: bool = False
    #: per-Program memo of trace-derived aggregates (tile-cost streams,
    #: instruction bits): ``perf.simulate`` and the MINISA byte accounting
    #: consume the same stream several times per Program (minisa vs micro
    #: control, mapper scoring, runtime perf_stats), so regenerating it
    #: each call is pure waste.  Keyed by the derivation arguments; never
    #: part of equality/pickling semantics.
    _memo: dict = dataclasses.field(default_factory=dict, repr=False,
                                    compare=False)

    def __getstate__(self):
        # the memo is derivable state: keep pickles (ProgramCache disk
        # persistence) lean and deterministic
        state = self.__dict__.copy()
        state["_memo"] = {}
        return state

    # -- structure -----------------------------------------------------------
    @property
    def n_tiles(self) -> int:
        return len(self.tiles)

    @property
    def total_invocations(self) -> int:
        return sum(t.exec_block.n_invocations for t in self.tiles)

    @property
    def macs(self) -> int:
        return sum(t.macs for t in self.tiles)

    def trace_ops(self) -> Iterator[TraceOp]:
        yield from self.prologue
        for tile in self.tiles:
            yield from tile.trace_ops()

    def instructions(self) -> Iterator[isa.Instruction]:
        for op in self.trace_ops():
            yield op.inst

    # -- byte accounting (exact: equals trace_bits of the flat stream) -------
    def minisa_bits(self) -> int:
        hit = self._memo.get("minisa_bits")
        if hit is not None:
            return hit
        cfg = self.cfg
        bits = sum(op.inst.bitwidth(cfg) for op in self.prologue)
        block_bits: dict[int, int] = {}
        for tile in self.tiles:
            key = id(tile.exec_block)
            if key not in block_bits:
                block_bits[key] = tile.exec_block.bits(cfg)
            bits += block_bits[key] + _fixed_bits(tile, cfg)
        self._memo["minisa_bits"] = bits
        return bits

    def minisa_bytes(self) -> float:
        return self.minisa_bits() / 8.0

    def summary(self) -> dict:
        return isa.trace_summary(self.instructions(), self.cfg)

    # -- timing --------------------------------------------------------------
    @property
    def compute_cycles(self) -> float:
        cycles: dict[int, float] = {}
        total = 0.0
        for tile in self.tiles:
            key = id(tile.exec_block)
            if key not in cycles:
                cycles[key] = tile.exec_block.compute_cycles(self.cfg)
            total += cycles[key]
        return total

    # -- micro-instruction baseline (counterfactual control scheme) ----------
    def micro_storage_bytes(self) -> float:
        return MicroModel(self.cfg).storage_bytes(self.compute_cycles)

    def micro_fetch_bytes(self) -> float:
        return MicroModel(self.cfg).fetch_bytes(
            self.compute_cycles, self.total_invocations)

    # -- perf-model tile stream (THE tile stream, not a re-derivation) -------
    def tile_costs(self, control: str = "minisa",
                   max_tiles: int = 4096, *,
                   elide_input_loads: bool = False,
                   elide_weight_loads: bool = False,
                   on_chip_store: bool = False) -> list[perf.TileCost]:
        """control in {'minisa', 'micro'} selects the fetch stream.

        A Write whose meta marks an on-chip commit (``commit_to``, paper
        §IV-G) never crosses HBM: it is costed as OB->operand-buffer
        commit cycles (out2stream) instead of store bytes, so the data
        traffic the model charges is the traffic the chain actually
        ships.  ``elide_input_loads`` / ``on_chip_store`` extend the same
        accounting to fused-segment execution, where *every* interior
        activation stays in VMEM: input-operand Loads (the consumer side
        of the chain) and all output Writes (the producer side) are kept
        on-chip.  ``elide_weight_loads`` drops the weight-operand Loads
        instead -- the streamed fused launch replaces the Program's
        residency-derived weight traffic with its own K-tile schedule
        (``FusedSegment.layer_tile_costs`` folds those bytes back in).

        Streams longer than ``max_tiles`` are run-length merged (k
        consecutive tiles -> one cost with summed fields); the engine
        recurrence is linear over uniform runs, so merging preserves the
        makespan to within one tile's skew.

        Results are memoised per (control, max_tiles, flags) -- see
        ``_memo``.
        """
        memo_key = ("tile_costs", control, max_tiles, elide_input_loads,
                    elide_weight_loads, on_chip_store)
        hit = self._memo.get(memo_key)
        if hit is not None:
            return hit
        cfg = self.cfg
        micro = MicroModel(cfg) if control == "micro" else None
        elem = cfg.elem_bytes
        prologue_bits = sum(op.inst.bitwidth(cfg) for op in self.prologue)
        block_cache: dict[int, tuple[int, float, int]] = {}
        out: list[perf.TileCost] = []
        for i, tile in enumerate(self.tiles):
            key = id(tile.exec_block)
            if key not in block_cache:
                blk = tile.exec_block
                block_cache[key] = (blk.bits(cfg), blk.compute_cycles(cfg),
                                    blk.n_invocations)
            blk_bits, blk_cycles, blk_inv = block_cache[key]
            fixed_bits = _fixed_bits(tile, cfg)
            if control == "micro":
                fetch = micro.fetch_bytes(blk_cycles, blk_inv)
            else:
                fetch = (blk_bits + fixed_bits
                         + (prologue_bits if i == 0 else 0)) / 8.0
            load_bytes = sum(
                op.inst.length for op in tile.loads
                if not ((elide_input_loads
                         and op.meta.get("operand") == "I")
                        or (elide_weight_loads
                            and op.meta.get("operand") == "W"))) * elem
            store = 0
            commit_elems = 0
            for op in tile.drains:
                if not isinstance(op.inst, isa.Write):
                    continue
                if on_chip_store or op.meta.get("commit_to") is not None:
                    commit_elems += op.inst.length
                else:
                    store += op.inst.length
            o2s = (tile.m_ext * tile.n_ext) / cfg.aw if tile.last_k else 0.0
            o2s += commit_elems / cfg.aw
            out.append(perf.TileCost(
                fetch_bytes=fetch, load_bytes=load_bytes,
                compute_cycles=blk_cycles, out2stream_cycles=o2s,
                store_bytes=float(store * elem), macs=float(tile.macs)))
        if len(out) <= max_tiles:
            self._memo[memo_key] = out
            return out
        merged: list[perf.TileCost] = []
        base, rem = divmod(len(out), max_tiles)
        idx = 0
        for gi in range(max_tiles):
            k = base + (1 if gi < rem else 0)
            run = out[idx:idx + k]
            idx += k
            merged.append(perf.TileCost(
                fetch_bytes=sum(t.fetch_bytes for t in run),
                load_bytes=sum(t.load_bytes for t in run),
                compute_cycles=sum(t.compute_cycles for t in run),
                out2stream_cycles=sum(t.out2stream_cycles for t in run),
                store_bytes=sum(t.store_bytes for t in run),
                macs=sum(t.macs for t in run)))
        self._memo[memo_key] = merged
        return merged


def _fixed_bits(tile: Tile, cfg: FeatherConfig) -> int:
    """Bits of a tile's non-execute instructions (class-constant widths)."""
    bits = len(tile.loads) * isa.class_bitwidth(isa.Load, cfg)
    for op in tile.drains:
        bits += isa.class_bitwidth(type(op.inst), cfg)
    return bits


# ---------------------------------------------------------------------------
# Lowering
# ---------------------------------------------------------------------------

FULL, PANEL, TILED = "full", "panel", "tiled"

#: Activations that normalise over a full output row and therefore cannot
#: be applied to a partial-row (n-tiled) drain.
ROW_WISE_ACTIVATIONS = frozenset({"softmax", "rmsnorm", "layernorm"})


def _oriented(gemm, choice) -> tuple[int, int, int, bool]:
    wos = choice.df == isa.Dataflow.WOS
    ms, ks, ns = ((gemm.m, gemm.k, gemm.n) if wos
                  else (gemm.n, gemm.k, gemm.m))
    return ms, ks, ns, wos


def snap_tiling(gemm, choice, cfg) -> tuple[int, int, int] | None:
    """Clip tile extents to the problem and snap k_t to a VN multiple
    (global VN-row indexing of resident operands needs aligned k tiles).
    Returns (m_t, k_t, n_t) or None if degenerate."""
    ms, ks, ns, _ = _oriented(gemm, choice)
    vn = choice.vn
    if vn < 1 or vn > cfg.ah:
        return None
    m_t = min(choice.m_t, ms)
    k_t = min(choice.k_t, ks)
    n_t = min(choice.n_t, ns)
    if min(m_t, k_t, n_t) < 1:
        return None
    if k_t < ks:
        k_t = max(vn, (k_t // vn) * vn)
    return m_t, k_t, n_t


def lower(gemm, choice, cfg: FeatherConfig, *,
          activation: Callable | None = None, act_name: str = "none",
          out_name: str = "O", commit_to: str | None = None,
          commit_layout=None, elide_input: bool = False) -> Program:
    """Lower a (Gemm, MappingChoice) to a tiled Program.

    ``elide_input`` drops the input operand's SetIVNLayout + Load(s)
    (paper §IV-G chained layers: the producer's committing Write already
    placed the data); only legal when the input operand is fully resident
    -- callers should check ``input_elidable`` first.
    """
    ms, ks, ns, wos = _oriented(gemm, choice)
    vn = choice.vn
    aw, elem = cfg.aw, cfg.elem_bytes
    snapped = snap_tiling(gemm, choice, cfg)
    if snapped is None:
        raise ValueError(f"infeasible mapping choice {choice} for {gemm}")
    m_t, k_t, n_t = snapped
    n_m = math.ceil(ms / m_t)
    n_n = math.ceil(ns / n_t)
    n_k = math.ceil(ks / k_t)
    if activation is not None and act_name in ROW_WISE_ACTIVATIONS \
            and n_n > 1:
        # drains apply the activation per output tile; a row-wise function
        # over a partial row would be silently wrong
        raise ValueError(
            f"row-wise activation {act_name!r} needs full output rows per "
            f"tile (n_n == 1), got n_n={n_n} for {gemm}")
    kg_total = math.ceil(ks / vn)

    # residency (real buffer-capacity bounds)
    str_mode = FULL if ms * ks * elem <= cfg.str_bytes else TILED
    if ks * ns * elem <= cfg.sta_bytes:
        sta_mode = FULL
    elif ks * n_t * elem <= cfg.sta_bytes:
        sta_mode = PANEL
    else:
        sta_mode = TILED

    sta_name, str_name = ("W", "I") if wos else ("I", "W")
    input_role = "streaming" if wos else "stationary"
    df = isa.Dataflow.WOS if wos else isa.Dataflow.IOS

    # full-region layouts (prologue Set*VNLayout payloads; Loads re-bind
    # region/tile layouts as data arrives)
    lay_sta = layoutlib.layout_for(kg_total, ns, vn, aw, order=choice.order_w)
    lay_str = layoutlib.layout_for(kg_total, ms, vn, aw, order=choice.order_i)
    lay_out = layoutlib.layout_for(math.ceil(ns / vn), ms, vn, aw,
                                   order=choice.order_o)

    def _lay_op(operand_tensor: str, lay) -> TraceOp:
        return TraceOp(lay.to_instruction(operand_tensor), {"layout": lay})

    prologue: list[TraceOp] = []
    if not elide_input:
        prologue.append(_lay_op("I", lay_str if wos else lay_sta))
    prologue.append(_lay_op("W", lay_sta if wos else lay_str))
    prologue.append(TraceOp(
        isa.SetOVNLayout(order=choice.order_o, nr_l0=min(ms, aw),
                         nr_l1=math.ceil(ms / min(ms, aw)),
                         red_l1=math.ceil(ns / vn)),
        {"layout": lay_out, "m_extent": ms, "n_extent": ns}))

    # host-coordinate slices: the stationary tensor has (red, free) =
    # (k, n-search); the streaming one (free, red) = (m-search, k) -- which
    # host axes those are depends on the dataflow.
    def sta_slice(k0, k1, f0, f1):
        return (k0, k1, f0, f1) if wos else (f0, f1, k0, k1)

    def str_slice(f0, f1, k0, k1):
        return (f0, f1, k0, k1) if wos else (k0, k1, f0, f1)

    g_r = aw // max(choice.n_kg, 1)
    g_c = max(choice.n_nb, 1)
    s_r, s_c = (g_c, 1) if choice.strided else (1, vn)
    t_max = max(cfg.vn_slots_per_col, 1)

    load_bits_target = (isa.BufferTarget.STATIONARY,
                        isa.BufferTarget.STREAMING)
    blocks: dict[tuple, ExecBlock] = {}
    lay_cache: dict[tuple, layoutlib.VNLayout] = {}

    def _lay(rows: int, cols: int, order: int) -> layoutlib.VNLayout:
        key = (rows, cols, order)
        if key not in lay_cache:
            lay_cache[key] = layoutlib.layout_for(rows, cols, vn, aw,
                                                  order=order)
        return lay_cache[key]

    tiles: list[Tile] = []
    hbm_sta, hbm_str = 0, ks * ns  # nominal HBM base addresses

    for i_n in range(n_n):
        n0 = i_n * n_t
        n_ext = min(n_t, ns - n0)
        for im in range(n_m):
            m0 = im * m_t
            m_ext = min(m_t, ms - m0)
            for ik in range(n_k):
                k0 = ik * k_t
                k_ext = min(k_t, ks - k0)
                kg_ext = math.ceil(k_ext / vn)
                nb_ext = math.ceil(n_ext / vn)
                kg0 = k0 // vn
                first = i_n == 0 and im == 0 and ik == 0
                loads: list[TraceOp] = []

                # stationary loads (under IO-S the stationary operand IS
                # the layer input, so elision skips this load instead)
                if sta_mode == FULL:
                    if first and not (elide_input and sta_name == "I"):
                        loads.append(TraceOp(
                            isa.Load(hbm_addr=hbm_sta, length=ks * ns,
                                     target=load_bits_target[0]),
                            {"tensor": sta_name, "operand": sta_name,
                             "layout": lay_sta, "slice": None,
                             "vn_row0": 0, "col0": 0, "reset": True,
                             "extents": (kg_total, ns)}))
                    sta_row_base, sta_col_base = kg0, n0
                elif sta_mode == PANEL:
                    if im == 0:
                        panel_lay = _lay(kg_total, n_ext, choice.order_w)
                        loads.append(TraceOp(
                            isa.Load(hbm_addr=hbm_sta + k0 * ns + n0,
                                     length=k_ext * n_ext,
                                     target=load_bits_target[0]),
                            {"tensor": sta_name, "operand": sta_name,
                             "layout": panel_lay,
                             "slice": sta_slice(k0, k0 + k_ext,
                                                n0, n0 + n_ext),
                             "vn_row0": kg0, "col0": 0, "reset": ik == 0,
                             "extents": (kg_total, n_ext)}))
                    sta_row_base, sta_col_base = kg0, 0
                else:
                    tile_lay = _lay(kg_ext, n_ext, choice.order_w)
                    loads.append(TraceOp(
                        isa.Load(hbm_addr=hbm_sta + k0 * ns + n0,
                                 length=k_ext * n_ext,
                                 target=load_bits_target[0]),
                        {"tensor": sta_name, "operand": sta_name,
                         "layout": tile_lay,
                         "slice": sta_slice(k0, k0 + k_ext, n0, n0 + n_ext),
                         "vn_row0": 0, "col0": 0, "reset": True,
                         "extents": (kg_ext, n_ext)}))
                    sta_row_base, sta_col_base = 0, 0

                # streaming loads
                if str_mode == FULL:
                    if first and not (elide_input and str_name == "I"):
                        loads.append(TraceOp(
                            isa.Load(hbm_addr=hbm_str, length=ms * ks,
                                     target=load_bits_target[1]),
                            {"tensor": str_name, "operand": str_name,
                             "layout": lay_str, "slice": None,
                             "vn_row0": 0, "col0": 0, "reset": True,
                             "extents": (kg_total, ms)}))
                    str_row_base, str_m_base = kg0, m0
                else:
                    tile_lay = _lay(kg_ext, m_ext, choice.order_i)
                    loads.append(TraceOp(
                        isa.Load(hbm_addr=hbm_str + m0 * ks + k0,
                                 length=m_ext * k_ext,
                                 target=load_bits_target[1]),
                        {"tensor": str_name, "operand": str_name,
                         "layout": tile_lay,
                         "slice": str_slice(m0, m0 + m_ext, k0, k0 + k_ext),
                         "vn_row0": 0, "col0": 0, "reset": True,
                         "extents": (kg_ext, m_ext)}))
                    str_row_base, str_m_base = 0, 0

                bkey = (kg_ext, nb_ext, m_ext)
                if bkey not in blocks:
                    blocks[bkey] = ExecBlock(
                        kg_ext=kg_ext, nb_ext=nb_ext, m_ext=m_ext, vn=vn,
                        n_kg=choice.n_kg, n_nb=choice.n_nb, g_r=g_r,
                        g_c=g_c, s_r=s_r, s_c=s_c, t_max=t_max, df=df)

                last_k = ik == n_k - 1
                drains: list[TraceOp] = []
                if last_k:
                    if activation is not None:
                        drains.append(TraceOp(
                            isa.Activation(
                                function=isa.ACTIVATION_FUNCS.get(
                                    act_name, 0),
                                length=m_ext * n_ext,
                                target=isa.BufferTarget.STREAMING),
                            {"fn": activation, "name": act_name}))
                    final = (i_n == n_n - 1 and im == n_m - 1)
                    wmeta: dict[str, Any] = {
                        "tensor": out_name, "transpose": not wos,
                        "slice": (m0, m0 + m_ext, n0, n0 + n_ext),
                        "final": final}
                    if final and commit_to is not None:
                        wmeta["commit_to"] = commit_to
                        wmeta["layout"] = commit_layout
                    drains.append(TraceOp(
                        isa.Write(hbm_addr=0, length=m_ext * n_ext,
                                  target=isa.BufferTarget.STREAMING),
                        wmeta))

                tiles.append(Tile(
                    im=im, i_n=i_n, ik=ik, m0=m0, n0=n0, k0=k0,
                    m_ext=m_ext, n_ext=n_ext, k_ext=k_ext,
                    loads=tuple(loads), exec_block=blocks[bkey],
                    drains=tuple(drains),
                    sta_row_base=sta_row_base, sta_col_base=sta_col_base,
                    str_row_base=str_row_base, str_m_base=str_m_base,
                    last_k=last_k))

    return Program(
        gemm=gemm, choice=choice, cfg=cfg, prologue=tuple(prologue),
        tiles=tiles, n_m=n_m, n_n=n_n, n_k=n_k,
        residency={"stationary": sta_mode, "streaming": str_mode},
        input_role=input_role, out_name=out_name,
        activation=activation, act_name=act_name,
        input_elided=elide_input)


# ---------------------------------------------------------------------------
# Program-to-Program transforms (paper §IV-G chained-layer elision)
# ---------------------------------------------------------------------------

def input_elidable(program: Program) -> bool:
    """A consumer may skip its input Load/SetIVNLayout only when the input
    operand is fully resident (one Load covers it -- exactly what the
    producer's on-chip commit replaces)."""
    return program.residency[program.input_role] == FULL


def elide_input(program: Program) -> Program:
    """Chained-consumer transform: re-lower without the input operand's
    SetIVNLayout + Load.  Returns ``program`` unchanged when not legal."""
    if program.input_elided or not input_elidable(program):
        return program
    return lower(program.gemm, program.choice, program.cfg,
                 activation=program.activation, act_name=program.act_name,
                 out_name=program.out_name, elide_input=True)


def with_commit(program: Program, commit_to: str, commit_layout) -> Program:
    """Chained-producer transform: the final Write commits the output
    on-chip into the consumer's operand buffer instead of going off-chip."""
    return lower(program.gemm, program.choice, program.cfg,
                 activation=program.activation, act_name=program.act_name,
                 out_name=program.out_name, commit_to=commit_to,
                 commit_layout=commit_layout,
                 elide_input=program.input_elided)


def chain(programs: list[Program], lower_fn: Callable = None
          ) -> list[Program]:
    """Wire a layer chain: producer i commits on-chip and consumer i+1
    elides its input Load + SetIVNLayout, whenever the VN sizes match and
    the consumer's input is fully resident; incompatible neighbours fall
    back to an off-chip round trip (no elision).

    Un-elided consumers have their input Loads retargeted to the producer's
    named output (the machine resolves tensor names against its committed
    outputs), so the fallback also executes correctly.  Input Programs are
    never mutated; rewired layers are fresh objects.

    ``lower_fn`` (signature of :func:`lower`) lets callers inject a
    memoising lowering -- the runtime's ProgramCache passes its own so a
    rebuilt chain reuses Program objects (and their compiled artifacts)."""
    if lower_fn is None:
        lower_fn = lower
    out: list[Program] = []
    for i, prog in enumerate(programs):
        nxt = programs[i + 1] if i + 1 < len(programs) else None
        elide = False
        retarget: str | None = None
        if i > 0:
            prev = programs[i - 1]
            if prev.choice.vn == prog.choice.vn and input_elidable(prog):
                elide = True
            else:
                retarget = prev.out_name
        commit_to = commit_lay = None
        if nxt is not None and nxt.choice.vn == prog.choice.vn \
                and input_elidable(nxt):
            vn = prog.choice.vn
            commit_lay = layoutlib.layout_for(
                math.ceil(prog.gemm.n / vn), prog.gemm.m, vn, prog.cfg.aw,
                order=prog.choice.order_o)
            commit_to = ("streaming"
                         if nxt.choice.df == isa.Dataflow.WOS
                         else "stationary")
        cur = prog
        if elide or commit_to is not None:
            # single re-lower carrying both roles; retargeting (below) must
            # come last so a re-lower cannot undo it
            cur = lower_fn(prog.gemm, prog.choice, prog.cfg,
                           activation=prog.activation,
                           act_name=prog.act_name, out_name=prog.out_name,
                           commit_to=commit_to, commit_layout=commit_lay,
                           elide_input=elide)
        if retarget is not None:
            cur = _retarget_input(cur, retarget)
        out.append(cur)
    return out


# ---------------------------------------------------------------------------
# M-polymorphic buckets (cross-request batched decode)
# ---------------------------------------------------------------------------

#: Padded host-M bucket ladder for cross-request batching: the serving
#: scheduler stacks B requests' decode rows along M and executes the
#: stack at the smallest bucket >= B, so every (segment, bucket) pair
#: compiles exactly once regardless of how the batch composition drifts
#: as requests admit and retire.
M_BUCKET_LADDER: tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64, 128)


def m_bucket(rows: int,
             ladder: tuple[int, ...] = M_BUCKET_LADDER) -> int:
    """Smallest ladder bucket >= ``rows`` (doubling past the ladder end,
    so an oversized batch still gets a power-of-two pad)."""
    if rows < 1:
        raise ValueError(f"need at least one row, got {rows}")
    for b in ladder:
        if b >= rows:
            return b
    b = ladder[-1]
    while b < rows:
        b *= 2
    return b


def bucketed_gemm(gemm, bucket: int):
    """The same GEMM with ``bucket`` stacked request blocks along host-M.

    K/N (and therefore the weight operand and its residency) are
    untouched; callers re-lower with the *original* MappingChoice, whose
    K tiling ``snap_tiling`` preserves, so every stacked row sees the
    same reduction order as the per-request Program -- the batched path
    stays on the sequential path's numeric trajectory."""
    if bucket < 1:
        raise ValueError(f"bucket must be >= 1, got {bucket}")
    name = f"{gemm.name}@mx{bucket}" if gemm.name else gemm.name
    return dataclasses.replace(gemm, m=bucket * gemm.m, name=name)


# ---------------------------------------------------------------------------
# Fused segments (chained-layer elision compiled to ONE kernel launch)
# ---------------------------------------------------------------------------

#: Elementwise activations the fused kernel applies at a layer's final-K
#: store.  Mirrors ``kernels.nest_gemm.ACT_FNS`` (asserted in tests); kept
#: as names here so the core IR stays JAX-free.
FUSED_ELEMENTWISE_ACTS = frozenset({"relu", "gelu", "silu"})

#: The GEMM stream carries no gate operand, so the runtime's ACTIVATIONS
#: registry maps the gated activations to their ungated halves; the fused
#: kernel follows the identical convention.
FUSED_ACT_ALIASES = {"swiglu": "silu", "geglu": "gelu"}

#: Bytes per element of the dtypes the fused kernel streams.  The budget
#: below is in BYTES, so bf16/int8 segments genuinely fit twice/four
#: times the fp32 working set instead of being sized as if fp32.
DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1}

#: Default VMEM working-set budget for one fused segment, in BYTES
#: (double-buffered operand windows + the fp32 activation/accumulator
#: scratch).  16 MB == one TPU core's VMEM; segments over budget fall
#: back to per-layer launches rather than silently thrash.
FUSED_VMEM_BUDGET = 16 << 20

#: HBM->VMEM weight-pipeline depth: 2 == double buffering (the grid
#: pipeline fetches K-tile j+1 while K-tile j is in compute).
FUSED_STREAM_DEPTH = 2


def _streamed_footprint_bytes(bm: int, bk0: int, layer_dims, bks, *,
                              operand_dtype: str = "float32",
                              depth: int = FUSED_STREAM_DEPTH) -> int:
    """VMEM high-water of the streamed fused launch, in bytes.

    Operand windows (the segment input's (bm, bk0) block, each weight's
    (bk_l, n_l) K-tile, the (bm, n_out) output block) are held ``depth``
    deep by the pipeline; the resident activation slab and the
    accumulator are fp32 VMEM scratch sized by the widest interior layer.
    """
    db = DTYPE_BYTES[operand_dtype]
    kps = [-(-k // bk) * bk for (k, _), bk in zip(layer_dims, bks)]
    k_slab = max(kps[1:], default=1)
    n_max = max(n for _, n in layer_dims)
    n_out = layer_dims[-1][1]
    windows = (depth * bm * bk0
               + sum(depth * bk * n for bk, (_, n) in zip(bks, layer_dims))
               + depth * bm * n_out)
    scratch = 4 * bm * (k_slab + n_max)
    return db * windows + scratch


def fusion_illegal_reason(programs: list["Program"], *,
                          vmem_budget: int = FUSED_VMEM_BUDGET,
                          adapts: tuple[bool, ...] | None = None,
                          operand_dtype: str = "float32") -> str | None:
    """Why this chain cannot execute as one fused kernel (None == legal).

    Legal segments are ``wired`` chains: layer i's host output [m, n_i]
    is exactly layer i+1's host input [m, k_{i+1}] -- unless the caller
    marks the boundary in ``adapts`` (``adapts[i]`` True means layer i's
    input is the deterministic flatten/cycle/reshape ``adapt`` glue of
    layer i-1's output, which the kernel applies as an in-VMEM index
    permutation on the resident slab; that requires the whole activation
    resident, enforced geometrically by ``fuse_segment``).  Activations
    must be applicable inside the kernel: elementwise
    (``FUSED_ELEMENTWISE_ACTS``) anywhere; row-wise ones only when the
    layer's accumulator holds full host rows (WO-S -- the same condition
    under which the lowering admits them in-Program).  Sharded segments
    fall back: on-chip residency is per-array state and does not cross
    the mesh boundary (``fuse_sharded_segment`` fuses *within* each
    array instead).

    ``operand_dtype`` sizes the budget check in bytes: the minimal
    streamed footprint (one activation row, unit K tiles -- or the full
    resident activation when ``adapts`` forces it) must fit
    ``vmem_budget``.
    """
    if len(programs) < 2:
        return "segment has fewer than 2 layers"
    if operand_dtype not in DTYPE_BYTES:
        return f"operand dtype {operand_dtype!r} has no byte width"
    if adapts is None:
        adapts = (False,) * len(programs)
    if len(adapts) != len(programs):
        return (f"adapts length {len(adapts)} != segment length "
                f"{len(programs)}")
    if adapts[0]:
        return "layer 0 cannot adapt from a producer outside the segment"
    for i, prog in enumerate(programs):
        if isinstance(prog, (ShardedProgram, ShardedFusedSegment)):
            return f"layer {i} is mesh-sharded"
        if i > 0 and not adapts[i]:
            prev = programs[i - 1].gemm
            g = prog.gemm
            if (prev.m, prev.n) != (g.m, g.k):
                return (f"layer {i - 1} output {(prev.m, prev.n)} != "
                        f"layer {i} input {(g.m, g.k)}")
        act = FUSED_ACT_ALIASES.get(prog.act_name, prog.act_name)
        if prog.activation is not None and act == "none":
            return (f"layer {i} carries an anonymous activation callable "
                    f"the kernel cannot reproduce by name")
        if act != "none" and act not in FUSED_ELEMENTWISE_ACTS:
            if act not in ROW_WISE_ACTIVATIONS:
                return f"layer {i} activation {act!r} is not fusable"
            if prog.choice.df != isa.Dataflow.WOS:
                return (f"layer {i} row-wise activation {act!r} needs the "
                        f"host-row accumulator orientation (WO-S)")
    # necessary condition: even the minimal streamed geometry (unit K
    # tiles; one resident row, or every row when an adapt permutation
    # needs the whole activation resident) must fit the byte budget.
    # fuse_segment() additionally fits the real bm / bk schedule.
    dims = [(p.gemm.k, p.gemm.n) for p in programs]
    min_rows = max(p.gemm.m for p in programs) if any(adapts) else 1
    need = _streamed_footprint_bytes(min_rows, 1, dims,
                                     (1,) * len(programs),
                                     operand_dtype=operand_dtype)
    if need > vmem_budget:
        return (f"minimal streamed working set {need} bytes "
                f"({operand_dtype}) exceeds the fused VMEM budget "
                f"{vmem_budget}")
    return None


def fusable(programs: list["Program"], *,
            vmem_budget: int = FUSED_VMEM_BUDGET,
            adapts: tuple[bool, ...] | None = None,
            operand_dtype: str = "float32") -> bool:
    return fusion_illegal_reason(programs, vmem_budget=vmem_budget,
                                 adapts=adapts,
                                 operand_dtype=operand_dtype) is None


@dataclasses.dataclass
class FusedSegment:
    """A chained segment compiled as ONE kernel launch (paper §IV-G at
    kernel granularity).

    The per-layer Programs stay the source of truth for instruction
    accounting and the fallback path; the segment adds the *fused launch
    geometry*: every layer's tiling snapped to one common host-M tile
    (``bm`` rows of the chained activation stay resident in VMEM scratch
    across all layers) and a per-layer host-K tile (``layer_bks``) that
    streams each layer's weight HBM->VMEM in ``buffer_depth``-deep
    (double-buffered) K-tiles against the resident activation -- so the
    VMEM footprint is bounded by the largest layer's windows, not the
    sum of all weights.

    ``adapts[l]`` True marks layer l's input as the flatten/cycle/reshape
    ``adapt`` glue of layer l-1's output, executed inside the kernel as a
    static index permutation on the resident slab (whole activation
    resident: ``m_steps == 1`` whenever any adapt is present), which is
    what lets attention (qk/pv) and MLP fuse into ONE launch per
    transformer block.

    Data-traffic accounting (:meth:`tile_costs`) keeps every interior
    boundary on-chip -- interior Writes are costed as OB-commit cycles
    and interior input Loads vanish, while weight Loads are restated to
    the streamed K-tile schedule (re-fetched once per M step) -- so
    ``perf.simulate`` over the fused stream charges exactly the HBM
    bytes the fused kernel ships.
    """
    programs: list[Program]
    bm: int                       # common host-M tile (resident rows)
    layer_bks: tuple[int, ...]    # per-layer host-K weight-streaming tile
    acts: tuple[str | None, ...]  # per-layer in-kernel activation name
    adapts: tuple[bool, ...] = None       # in-kernel adapt boundaries
    buffer_depth: int = FUSED_STREAM_DEPTH    # K-tile pipeline depth
    vmem_budget: int = FUSED_VMEM_BUDGET      # bytes the geometry fit
    operand_dtype: str = "float32"            # streamed operand dtype

    def __post_init__(self):
        if self.adapts is None:
            self.adapts = (False,) * len(self.programs)

    @property
    def n_layers(self) -> int:
        return len(self.programs)

    @property
    def cfg(self) -> FeatherConfig:
        return self.programs[0].cfg

    @property
    def out_name(self) -> str:
        return self.programs[-1].out_name

    @property
    def m(self) -> int:
        return self.programs[0].gemm.m

    @property
    def k_in(self) -> int:
        return self.programs[0].gemm.k

    @property
    def widths(self) -> tuple[int, ...]:
        """Per-layer output widths (interior ones live in VMEM scratch)."""
        return tuple(p.gemm.n for p in self.programs)

    @property
    def macs(self) -> int:
        return sum(p.macs for p in self.programs)

    # -- streamed launch geometry --------------------------------------------
    @property
    def m_steps(self) -> int:
        """Host-M grid steps of the launch.  The weight K-tile stream
        restarts per M step (each step re-streams every layer's weight),
        and any in-kernel adapt permutation requires exactly one."""
        return -(-self.m // self.bm)

    @property
    def padded_ks(self) -> tuple[int, ...]:
        """Per-layer K extents padded to the K-tile schedule (the zero
        pad rows are inert: padded weight rows are zero)."""
        return tuple(-(-p.gemm.k // bk) * bk
                     for p, bk in zip(self.programs, self.layer_bks))

    def vmem_highwater_bytes(self) -> int:
        """Peak VMEM bytes the streamed launch holds: double-buffered
        operand windows (input block, one K-tile per weight, output
        block) plus the fp32 slab/accumulator scratch -- bounded by the
        largest layer's windows, NOT the sum of all weights."""
        dims = [(p.gemm.k, p.gemm.n) for p in self.programs]
        return _streamed_footprint_bytes(
            self.bm, min(self.layer_bks[0], self.programs[0].gemm.k),
            dims, self.layer_bks, operand_dtype=self.operand_dtype,
            depth=self.buffer_depth)

    def resident_vmem_bytes(self) -> int:
        """What the same segment would hold with every weight fully
        VMEM-resident (the pre-streaming discipline): the sum over
        layers, the footprint streaming replaces."""
        db = DTYPE_BYTES[self.operand_dtype]
        weights = sum(p.gemm.k * p.gemm.n for p in self.programs)
        slabs = self.bm * (self.k_in + sum(self.widths))
        return db * weights + 4 * slabs

    def max_layer_working_set_bytes(self) -> int:
        """The largest single layer's working set (its full weight plus
        its bm-row input/output slabs) -- the bound the streamed
        footprint is held to."""
        db = DTYPE_BYTES[self.operand_dtype]
        return max(db * (g.k * g.n) + 4 * self.bm * (g.k + g.n)
                   for g in (p.gemm for p in self.programs))

    # -- instruction accounting (the chained stream is unchanged) ------------
    def minisa_bits(self) -> int:
        return sum(p.minisa_bits() for p in self.programs)

    def minisa_bytes(self) -> float:
        return self.minisa_bits() / 8.0

    # -- data-traffic accounting ---------------------------------------------
    def layer_tile_costs(self, layer: int, control: str = "minisa",
                         max_tiles: int = 4096) -> list:
        """Layer ``layer``'s tile stream under streamed fused execution:
        interior stores stay on-chip, non-first layers read their input
        from the resident activation (no HBM Load), and the Program's
        residency-derived weight Loads are restated to the bytes the
        streamed kernel actually ships -- the padded weight fetched once
        per M step of the launch, spread evenly over the layer's tiles."""
        costs = self.programs[layer].tile_costs(
            control, max_tiles,
            elide_input_loads=layer > 0,
            elide_weight_loads=True,
            on_chip_store=layer < self.n_layers - 1)
        g = self.programs[layer].gemm
        kp = self.padded_ks[layer]
        shipped = float(self.cfg.elem_bytes * self.m_steps * kp * g.n)
        per_tile = shipped / max(len(costs), 1)
        return [dataclasses.replace(t, load_bytes=t.load_bytes + per_tile)
                for t in costs]

    def tile_costs(self, control: str = "minisa",
                   max_tiles: int = 4096) -> list:
        out = []
        for layer in range(self.n_layers):
            out.extend(self.layer_tile_costs(layer, control, max_tiles))
        return out

    def hbm_bytes(self) -> float:
        """Off-chip data bytes of the fused *machine-model* tile stream
        (loads + stores after interior elision)."""
        return sum(t.load_bytes + t.store_bytes for t in self.tile_costs())

    # -- kernel-launch traffic (what the compiled backend actually ships) ----
    def kernel_hbm_bytes(self) -> float:
        """Bytes the ONE fused launch moves across HBM: the segment
        input, every layer's weight K-tile stream (the padded weight,
        re-fetched once per M step -- the streaming discipline trades
        weight re-streams for bounded VMEM), the final output -- nothing
        else."""
        elem = self.cfg.elem_bytes
        m = self.m
        return elem * (m * self.k_in
                       + self.m_steps * sum(
                           kp * p.gemm.n
                           for kp, p in zip(self.padded_ks, self.programs))
                       + m * self.programs[-1].gemm.n)

    def per_layer_kernel_hbm_bytes(self) -> float:
        """Bytes L separate per-layer launches move: each launch reads
        its input from HBM and writes its output back, so every interior
        activation round-trips."""
        elem = self.cfg.elem_bytes
        m = self.m
        return elem * sum(m * p.gemm.k + p.gemm.k * p.gemm.n
                          + m * p.gemm.n for p in self.programs)

    def elided_hbm_bytes(self) -> float:
        """Intermediate traffic fusion keeps on-chip: one Write + one
        (re-)Load of every interior activation."""
        return self.per_layer_kernel_hbm_bytes() - self.kernel_hbm_bytes()

    def describe(self) -> dict:
        return {
            "n_layers": self.n_layers,
            "m": self.m,
            "widths": (self.k_in,) + self.widths,
            "bm": self.bm,
            "layer_bks": self.layer_bks,
            "acts": self.acts,
            "adapts": self.adapts,
            "m_steps": self.m_steps,
            "buffer_depth": self.buffer_depth,
            "operand_dtype": self.operand_dtype,
            "vmem_highwater_bytes": self.vmem_highwater_bytes(),
            "vmem_resident_bytes": self.resident_vmem_bytes(),
            "max_layer_working_set_bytes":
                self.max_layer_working_set_bytes(),
            "hbm_bytes_fused": self.kernel_hbm_bytes(),
            "hbm_bytes_per_layer": self.per_layer_kernel_hbm_bytes(),
            "hbm_bytes_elided": self.elided_hbm_bytes(),
        }


def fuse_segment(programs: list["Program"], *,
                 vmem_budget: int = FUSED_VMEM_BUDGET,
                 adapts: tuple[bool, ...] | None = None,
                 operand_dtype: str = "float32",
                 bm: int | None = None,
                 layer_bks: tuple[int, ...] | None = None
                 ) -> FusedSegment | None:
    """Build the streamed fused launch geometry for a chained segment,
    or None when the segment must fall back to per-layer execution.

    With ``bm``/``layer_bks`` given, the geometry comes from a *joint
    choice* (``mapper.SegmentChoice`` -- the fusion-aware segment
    search, or a measured autotune winner) instead of the per-layer
    snapping heuristic below: the requested tiles are clamped to the
    problem, the adapt residency rule is still enforced, and the
    candidate is rejected (None) if its streamed footprint exceeds
    ``vmem_budget``.

    Otherwise (the greedy-then-snap default): each layer's host-K tile
    (snapped from its own mapping, then capped so the double-buffered
    K-tile windows of ALL layers together stay under the largest single
    weight) becomes its HBM->VMEM streaming granularity.  The host-M
    tile covers the whole activation in one grid step whenever the
    streamed footprint allows (no weight re-streams) -- and MUST when
    ``adapts`` marks an in-kernel permutation boundary (the
    flatten/cycle/reshape glue needs every row resident); otherwise bm
    falls back to the tightest snapped tile and halves until the
    footprint fits ``vmem_budget`` (bytes, sized for ``operand_dtype``).
    """
    if fusion_illegal_reason(programs, vmem_budget=vmem_budget,
                             adapts=adapts,
                             operand_dtype=operand_dtype) is not None:
        return None
    n_layers = len(programs)
    if adapts is None:
        adapts = (False,) * n_layers
    m = programs[0].gemm.m
    m_max = max(p.gemm.m for p in programs)

    if bm is not None or layer_bks is not None:
        # joint-choice geometry: clamp, enforce residency, fit-or-reject
        if layer_bks is None or len(layer_bks) != n_layers:
            return None
        bks = [max(1, min(int(bk), p.gemm.k))
               for bk, p in zip(layer_bks, programs)]
        rows = m_max if any(adapts) else max(1, min(int(bm or m), m))
        dims = [(p.gemm.k, p.gemm.n) for p in programs]
        if _streamed_footprint_bytes(
                rows, bks[0], dims, bks,
                operand_dtype=operand_dtype) > vmem_budget:
            return None
        acts = tuple(
            None if p.act_name == "none"
            else FUSED_ACT_ALIASES.get(p.act_name, p.act_name)
            for p in programs)
        return FusedSegment(
            programs=list(programs), bm=rows, layer_bks=tuple(bks),
            acts=acts, adapts=tuple(adapts),
            buffer_depth=FUSED_STREAM_DEPTH, vmem_budget=vmem_budget,
            operand_dtype=operand_dtype)

    bm_snap = m_max
    bks = []
    for prog in programs:
        snapped = snap_tiling(prog.gemm, prog.choice, prog.cfg)
        if snapped is None:       # lower() would have raised already
            return None
        m_t, k_t, n_t = snapped
        wos = prog.choice.df == isa.Dataflow.WOS
        bm_snap = min(bm_snap, m_t if wos else n_t)
        bks.append(max(1, min(k_t, prog.gemm.k)))
    # cap the K tiles so the depth-deep K-tile windows of all layers sum
    # to no more than the largest single weight: the streamed footprint
    # is bounded by the biggest layer, not the per-layer sum
    depth = FUSED_STREAM_DEPTH
    w_max = max(p.gemm.k * p.gemm.n for p in programs)
    bks = [max(1, min(bk, max(1, w_max // (depth * n_layers * p.gemm.n))))
           for bk, p in zip(bks, programs)]
    dims = [(p.gemm.k, p.gemm.n) for p in programs]

    def fits(rows: int) -> bool:
        return _streamed_footprint_bytes(
            rows, bks[0], dims, bks,
            operand_dtype=operand_dtype) <= vmem_budget

    if any(adapts):
        bm = m_max            # the permutation needs the whole activation
        if not fits(bm):
            return None
    elif fits(m):
        bm = m                # whole M resident: weights stream exactly once
    else:
        bm = max(1, min(bm_snap, m))
        while bm > 1 and not fits(bm):
            bm //= 2
        if not fits(bm):
            return None       # not even one streamed row fits
    acts = tuple(
        None if p.act_name == "none"
        else FUSED_ACT_ALIASES.get(p.act_name, p.act_name)
        for p in programs)
    return FusedSegment(
        programs=list(programs), bm=max(1, bm),
        layer_bks=tuple(bks), acts=acts, adapts=tuple(adapts),
        buffer_depth=depth, vmem_budget=vmem_budget,
        operand_dtype=operand_dtype)


# ---------------------------------------------------------------------------
# Multi-array sharding (Program -> ShardedProgram over an ArrayMesh)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Shard:
    """One array's slice of a sharded GEMM, with its own lowered Program.

    Slice bounds are host-orientation element ranges of the *unsharded*
    problem: the shard computes ``O[m0:m1, n0:n1]`` (a partial sum over
    ``k0:k1`` when the split axis is K) from ``I[m0:m1, k0:k1]`` and
    ``W[k0:k1, n0:n1]``.
    """
    array: int                   # logical array index on the mesh
    program: Program
    m0: int
    m1: int
    n0: int
    n1: int
    k0: int
    k1: int

    def slice_tensors(self, tensors: dict | None) -> dict:
        """This shard's view of the host operand dict ('I' / 'W')."""
        out = dict(tensors) if tensors else {}
        if "I" in out:
            out["I"] = out["I"][self.m0:self.m1, self.k0:self.k1]
        if "W" in out:
            out["W"] = out["W"][self.k0:self.k1, self.n0:self.n1]
        return out


@dataclasses.dataclass
class ShardedProgram:
    """A Program split across the arrays of an ``dist.ArrayMesh``.

    The tile space is partitioned along one host GEMM rank: M or N
    shards compute disjoint output slices with the other operand
    replicated; a K split computes per-array partial sums that a
    reduction epilogue combines (``reduce``).  Activations that are not
    shard-local (any activation under a K split; row-wise ones under an
    N split, which breaks output rows) are hoisted out of the per-shard
    Programs into ``epilogue_act``, applied to the assembled output.

    Per-array accounting is exact: each shard's Program carries its own
    MINISA instruction stream, so ``per_array_minisa_bytes`` /
    ``tile_costs`` feed ``perf.simulate`` per array and sum to (within
    tiling overhead) the unsharded totals.
    """
    base: Program                # the unsharded lowering (reference/meta)
    mesh: Any                    # dist.ArrayMesh
    axis: str                    # 'm' | 'n' | 'k' (host orientation)
    shards: tuple[Shard, ...]
    epilogue_act: Callable | None = None
    epilogue_act_name: str = "none"

    @property
    def cfg(self) -> FeatherConfig:
        return self.base.cfg

    @property
    def out_name(self) -> str:
        return self.base.out_name

    @property
    def reduce(self) -> bool:
        return self.axis == "k"

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def n_arrays(self) -> int:
        return self.mesh.n_arrays

    @property
    def uniform(self) -> bool:
        """All shards cover equal extents (shard_map-able without host
        raggedness)."""
        spans = {(s.m1 - s.m0, s.n1 - s.n0, s.k1 - s.k0)
                 for s in self.shards}
        return len(spans) == 1

    def per_array_minisa_bytes(self) -> list[float]:
        """Instruction bytes per logical array (idle arrays report 0)."""
        out = [0.0] * self.n_arrays
        for s in self.shards:
            out[s.array] += s.program.minisa_bytes()
        return out

    def minisa_bytes(self) -> float:
        return sum(self.per_array_minisa_bytes())

    def per_array_tile_costs(self, control: str = "minisa",
                             max_tiles: int = 4096) -> list[list]:
        """One ``perf.TileCost`` stream per logical array."""
        out: list[list] = [[] for _ in range(self.n_arrays)]
        for s in self.shards:
            out[s.array].extend(s.program.tile_costs(control, max_tiles))
        return out

    @property
    def macs(self) -> int:
        return sum(s.program.macs for s in self.shards)

    def summary(self) -> dict:
        bytes_per = self.per_array_minisa_bytes()
        return {
            "axis": self.axis, "n_arrays": self.n_arrays,
            "n_shards": self.n_shards, "reduce": self.reduce,
            "minisa_bytes": sum(bytes_per),
            "minisa_bytes_per_array": bytes_per,
            "byte_imbalance": perf.load_imbalance(bytes_per),
        }


def _shard_ranges(dim: int, n: int) -> list[tuple[int, int]]:
    """Ceil-div contiguous split of [0, dim) into <= n non-empty ranges."""
    chunk = -(-dim // n)
    out = []
    for i in range(n):
        lo = i * chunk
        hi = min(lo + chunk, dim)
        if lo >= hi:
            break
        out.append((lo, hi))
    return out


def shard_program(program: Program, mesh, axis: str | None = None,
                  lower_fn: Callable = None) -> ShardedProgram:
    """Partition a lowered Program across ``mesh``'s arrays.

    ``axis`` forces the split rank; by default the ``dist.sharding``
    GEMM-rank policy picks it (N-first tensor parallelism, then M, then
    K-with-reduction).  Each shard re-lowers the same MappingChoice on
    its sub-extents -- ``snap_tiling`` clips, so every feasible choice
    stays feasible -- through ``lower_fn`` (defaults to :func:`lower`;
    the runtime passes its memoising ``ProgramCache.lower``).

    Chained Programs (elided input / on-chip commit) cannot be sharded:
    their operand flow is per-array machine state, and the mesh boundary
    is exactly where that state does not reach.
    """
    if lower_fn is None:
        lower_fn = lower
    if program.input_elided:
        raise ValueError("cannot shard a chained Program with an elided "
                         "input; shard the un-chained lowering instead")
    if any(op.meta.get("commit_to") is not None
           for tile in program.tiles for op in tile.drains):
        raise ValueError("cannot shard a Program whose final Write commits "
                         "on-chip; shard the un-chained lowering instead")
    g = program.gemm
    if axis is None:
        # the dist.sharding policy over host-orientation tile counts
        # (under IO-S the search m-rank tiles host N and vice versa)
        from repro_torch.dist import sharding as shardinglib
        wos = program.choice.df == isa.Dataflow.WOS
        tiles = {"m": program.n_m if wos else program.n_n,
                 "n": program.n_n if wos else program.n_m,
                 "k": program.n_k}
        axis = shardinglib.gemm_shard_axis(g.m, g.k, g.n, mesh.n_arrays,
                                           tiles=tiles)
    if axis not in ("m", "n", "k"):
        raise ValueError(f"shard axis must be 'm'|'n'|'k', got {axis!r}")

    if mesh.n_arrays == 1:
        return ShardedProgram(
            base=program, mesh=mesh, axis=axis,
            shards=(Shard(array=0, program=program, m0=0, m1=g.m,
                          n0=0, n1=g.n, k0=0, k1=g.k),))

    # Activations that are not shard-local move to the epilogue: any
    # activation under a K split (partial sums are pre-activation), and
    # row-wise ones whenever a shard would hold partial accumulator rows
    # (rows are host-N under WO-S, so only a WO-S M split keeps them
    # intact per shard).
    wos = program.choice.df == isa.Dataflow.WOS
    hoist = program.activation is not None and (
        axis == "k"
        or (program.act_name in ROW_WISE_ACTIVATIONS
            and not (wos and axis == "m")))
    act = None if hoist else program.activation
    act_name = "none" if hoist else program.act_name

    dim = {"m": g.m, "n": g.n, "k": g.k}[axis]
    shards = []
    for i, (lo, hi) in enumerate(_shard_ranges(dim, mesh.n_arrays)):
        m0, m1 = (lo, hi) if axis == "m" else (0, g.m)
        n0, n1 = (lo, hi) if axis == "n" else (0, g.n)
        k0, k1 = (lo, hi) if axis == "k" else (0, g.k)
        sub = dataclasses.replace(
            g, m=m1 - m0, k=k1 - k0, n=n1 - n0,
            name=f"{g.name or 'gemm'}@{axis}{i}")
        shards.append(Shard(
            array=i,
            program=lower_fn(sub, program.choice, program.cfg,
                             activation=act, act_name=act_name,
                             out_name=program.out_name),
            m0=m0, m1=m1, n0=n0, n1=n1, k0=k0, k1=k1))
    return ShardedProgram(
        base=program, mesh=mesh, axis=axis, shards=tuple(shards),
        epilogue_act=program.activation if hoist else None,
        epilogue_act_name=program.act_name if hoist else "none")


@dataclasses.dataclass
class ShardedFusedSegment:
    """A chained segment fused WITHIN each array of an M-sharded stream.

    When every step of a wired run is sharded along host-M with aligned
    row ranges, each array owns a contiguous row slice of the *whole*
    chain: no interior activation ever crosses the mesh boundary, so the
    per-array sub-chains fuse into one streamed launch each.  The
    segment then costs ``n_arrays`` launches instead of
    ``n_arrays * n_layers`` -- the mesh only forbids fusing *across*
    arrays, never within one.
    """
    steps: list[ShardedProgram]                 # per-layer sharded lowerings
    mesh: Any                                   # dist.ArrayMesh
    array_segments: tuple[FusedSegment, ...]    # one fused chain per array
    row_ranges: tuple[tuple[int, int], ...]     # host rows [m0, m1) per array

    @property
    def cfg(self) -> FeatherConfig:
        return self.steps[0].cfg

    @property
    def out_name(self) -> str:
        return self.steps[-1].out_name

    @property
    def n_layers(self) -> int:
        return len(self.steps)

    @property
    def n_arrays(self) -> int:
        return len(self.array_segments)

    @property
    def m(self) -> int:
        return self.steps[0].base.gemm.m

    @property
    def n_out(self) -> int:
        return self.steps[-1].base.gemm.n

    @property
    def acts(self) -> tuple:
        return self.array_segments[0].acts

    def vmem_highwater_bytes(self) -> int:
        """Worst per-array streamed footprint (arrays run concurrently)."""
        return max(seg.vmem_highwater_bytes()
                   for seg in self.array_segments)

    def layer_tile_costs(self, layer: int, control: str = "minisa",
                         max_tiles: int = 4096) -> list:
        """Layer ``layer``'s tile stream across every array's fused
        sub-chain (per-array streams concatenated; arrays run in
        parallel, but the byte totals are what accounting sums)."""
        out = []
        for seg in self.array_segments:
            out.extend(seg.layer_tile_costs(layer, control, max_tiles))
        return out

    def describe(self) -> dict:
        return {
            "n_layers": self.n_layers, "n_arrays": self.n_arrays,
            "m": self.m, "row_ranges": list(self.row_ranges),
            "vmem_highwater_bytes": self.vmem_highwater_bytes(),
            "per_array": [seg.describe() for seg in self.array_segments],
        }


def fuse_sharded_segment(steps: list[ShardedProgram], *,
                         vmem_budget: int = FUSED_VMEM_BUDGET,
                         operand_dtype: str = "float32"
                         ) -> ShardedFusedSegment | None:
    """Fuse a run of M-sharded steps within each array, or None.

    Legal only when every step is split along host-M on the same mesh
    with identical row ranges (so array ``a``'s shard chain is a closed
    sub-problem) and each array's per-shard Program chain is itself
    fusable.  Adapt boundaries never qualify: the flatten/cycle
    permutation mixes rows globally, which is exactly the cross-array
    dataflow the mesh forbids.
    """
    if len(steps) < 2:
        return None
    if not all(isinstance(s, ShardedProgram) for s in steps):
        return None
    mesh = steps[0].mesh
    if any(s.mesh is not mesh or s.axis != "m" for s in steps):
        return None
    if any(s.epilogue_act is not None for s in steps):
        return None
    ranges = tuple((sh.m0, sh.m1) for sh in steps[0].shards)
    for s in steps[1:]:
        if tuple((sh.m0, sh.m1) for sh in s.shards) != ranges:
            return None
    array_segments = []
    for a in range(len(ranges)):
        chain = [s.shards[a].program for s in steps]
        seg = fuse_segment(chain, vmem_budget=vmem_budget,
                           operand_dtype=operand_dtype)
        if seg is None:
            return None
        array_segments.append(seg)
    return ShardedFusedSegment(
        steps=list(steps), mesh=mesh,
        array_segments=tuple(array_segments), row_ranges=ranges)


def _retarget_input(program: Program, source_name: str) -> Program:
    """Copy of ``program`` whose input Loads read ``source_name`` (the
    producer's committed output) instead of the host 'I' tensor.  The
    input Program -- possibly shared or memoized -- is left untouched."""
    new_tiles = []
    for tile in program.tiles:
        loads = tuple(
            TraceOp(op.inst, {**op.meta, "tensor": source_name})
            if op.meta.get("tensor") == "I" else op
            for op in tile.loads)
        if any(a is not b for a, b in zip(loads, tile.loads)):
            tile = dataclasses.replace(tile, loads=loads)
        new_tiles.append(tile)
    # fresh memo: the rewired copy must not share trace-derived caches
    # with (or leak them into) the source Program
    return dataclasses.replace(program, tiles=new_tiles, _memo={})
