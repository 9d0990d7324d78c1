"""FEATHER+ Mapper: analytical (mapping, layout) co-search (paper §V, Tab. VII).

Pipeline (paper Fig. 8/9):

  workload -> VNs -> tiles -> VN groups -> combined VN groups -> column
  duplication -> feasible layouts -> lowered Program -> simulated latency

Search knobs (Tab. VII):
  dataflow      WO-S / IO-S (IO-S == transposed WO-S; §V-B "from the
                mapper's perspective")
  VN size       vn <= AH (balanced divisors of K considered; §VI-D)
  tiling        (M_t, K_t, N_t) bounded by buffer capacities
  grouping      n_kg x n_nb concurrent combined VN groups per invocation
  duplication   d copies of each group across columns (T shrinks by d)
  layout        Tab. III order per operand + level-0 factors
  patterns      block/strided stationary c-strides, interleaved/consecutive
                streaming (consecutive degenerates to interleaved when d>1,
                see ExecuteStreaming's m-offset form)

Mapping-first, layout-second: candidates are ranked with a closed-form
lower bound, the shortlist is *lowered to a tiled Program* and scored with
the discrete-event model over the Program's actual tile stream, and for the
best mappings we search a feasible layout (single-bank streaming-row
legality + OB bank legality + capacity).  The winning Program is the one
artifact every consumer (machine, perf, byte accounting) shares.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable

import numpy as np

from repro_torch.configs.feather import FeatherConfig
from repro_torch.core import isa, layout as layoutlib, perf
from repro_torch.core import program as programlib


# ---------------------------------------------------------------------------
# Workloads
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Gemm:
    """O[M, N] = I[M, K] @ W[K, N]  (extended-einsum ranks of Fig. 1)."""
    m: int
    k: int
    n: int
    name: str = ""
    count: int = 1       # repeated layers with identical shape

    @property
    def macs(self) -> int:
        return self.m * self.k * self.n

    @property
    def data_bytes(self) -> int:
        return self.m * self.k + self.k * self.n + self.m * self.n


# ---------------------------------------------------------------------------
# Mapping choice
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MappingChoice:
    df: isa.Dataflow
    vn: int                  # VN size (<= AH)
    m_t: int                 # tile extents in the *search* orientation
    k_t: int
    n_t: int
    n_kg: int                # concurrent reduction groups per invocation
    n_nb: int                # concurrent n-blocks per invocation
    dup: int                 # column duplication factor
    order_w: int = 0         # Tab. III layout orders
    order_i: int = 0
    order_o: int = 0
    strided: bool = False    # stationary c-stride pattern (Tab. VII)

    @property
    def concurrent(self) -> int:
        return self.n_kg * self.n_nb * self.dup


@dataclasses.dataclass(frozen=True)
class Tiling:
    """Tile/invocation counts of a feasible choice.

    Used for candidate *pruning* (the closed-form prescore) and layout
    legality only -- all reported cycle/byte numbers come from the lowered
    Program's actual tile stream, never from these counts.
    """
    ms: int
    ks: int
    ns: int
    m_t: int
    k_t: int
    n_t: int
    n_m: int
    n_n: int
    n_k: int
    t_steps: int
    invocations_per_tile: int
    cycles_per_invocation: float

    @property
    def n_tiles(self) -> int:
        return self.n_m * self.n_n * self.n_k

    @property
    def m_eff(self) -> int:
        return min(self.m_t, self.ms)

    @property
    def n_eff(self) -> int:
        return min(self.n_t, self.ns)


def tiling(gemm: Gemm, choice: MappingChoice,
           cfg: FeatherConfig) -> Tiling | None:
    """Feasibility (capacity + shape) and tile counts; None if infeasible."""
    ah, aw = cfg.ah, cfg.aw
    vn = choice.vn
    if vn > ah or vn < 1:
        return None
    ms, ks, ns, _ = programlib._oriented(gemm, choice)
    snapped = programlib.snap_tiling(gemm, choice, cfg)
    if snapped is None:
        return None
    m_t, k_t, n_t = snapped
    if choice.concurrent > aw:
        return None
    # capacity feasibility (bytes; elem_bytes == 1)
    if m_t * k_t > cfg.str_bytes:
        return None
    if k_t * n_t > cfg.sta_bytes:
        return None
    if m_t * n_t * cfg.acc_bytes > cfg.ob_bytes:
        return None

    n_m = math.ceil(ms / m_t)
    n_n = math.ceil(ns / n_t)
    n_k = math.ceil(ks / k_t)
    kg_tiles = math.ceil(k_t / vn)
    nb_tiles = math.ceil(n_t / vn)
    invocations = (math.ceil(kg_tiles / max(choice.n_kg, 1))
                   * math.ceil(nb_tiles / max(choice.n_nb, 1)))
    t_steps = math.ceil(m_t / choice.dup)
    stream_cycles = t_steps * vn
    sta_load = vn * vn
    drain = vn + cfg.birrd_stages + 2
    cycles_per_invocation = max(stream_cycles, sta_load) + drain
    return Tiling(ms=ms, ks=ks, ns=ns, m_t=m_t, k_t=k_t, n_t=n_t,
                  n_m=n_m, n_n=n_n, n_k=n_k, t_steps=t_steps,
                  invocations_per_tile=invocations,
                  cycles_per_invocation=cycles_per_invocation)


# ---------------------------------------------------------------------------
# Candidate enumeration (with Tab. VII pruning heuristics)
# ---------------------------------------------------------------------------

def _pow2_tiles(lo: int, hi: int) -> list[int]:
    out = []
    v = lo
    while v < hi:
        out.append(v)
        v *= 2
    out.append(hi)
    return sorted(set(out))


def _vn_candidates(k: int, ah: int) -> list[int]:
    """Balanced VN sizes: AH plus sizes that avoid zero-pad waste.

    For K <= AH the exact K is best; for K > AH the balanced size
    ceil(K / ceil(K / AH)) removes the ragged last VN (e.g. K=40, AH=16
    gives vn=14 over 3 tiles, or vn=10 over 4 exact tiles).
    """
    cands = {min(ah, k)}
    if k > ah:
        base_tiles = math.ceil(k / ah)
        for tiles in (base_tiles, base_tiles + 1):
            cands.add(math.ceil(k / tiles))
    return sorted(c for c in cands if 1 <= c <= ah)


def _divisors_pow2ish(n: int) -> list[int]:
    """Divisors of n (exact column coverage is required by Eq. 1)."""
    return [d for d in range(1, n + 1) if n % d == 0]


#: Structural memo for candidate enumeration.  The candidate set depends
#: only on the GEMM extents and the config (never on ``name``/``count``),
#: and the batched-decode M-bucket ladder re-enumerates the same shapes
#: once per bucket -- so equal problems share one materialised tuple.
_ENUM_CACHE: dict[tuple, tuple[MappingChoice, ...]] = {}
_ENUM_CACHE_MAX = 256


def enumerate_choices(gemm: Gemm, cfg: FeatherConfig,
                      max_candidates: int = 512) -> Iterable[MappingChoice]:
    key = (gemm.m, gemm.k, gemm.n, cfg, max_candidates)
    hit = _ENUM_CACHE.get(key)
    if hit is None:
        hit = tuple(_enumerate_choices(gemm, cfg, max_candidates))
        if len(_ENUM_CACHE) >= _ENUM_CACHE_MAX:
            _ENUM_CACHE.pop(next(iter(_ENUM_CACHE)))
        _ENUM_CACHE[key] = hit
    return hit


def _enumerate_choices(gemm: Gemm, cfg: FeatherConfig,
                       max_candidates: int = 512) -> Iterable[MappingChoice]:
    ah, aw = cfg.ah, cfg.aw
    for df in (isa.Dataflow.WOS, isa.Dataflow.IOS):
        ms, ks, ns = ((gemm.n, gemm.k, gemm.m) if df == isa.Dataflow.IOS
                      else (gemm.m, gemm.k, gemm.n))
        # Heuristic from §III-C: IO-S when M > N, WO-S otherwise; we still
        # search both but the pruning keeps the promising one cheap.
        for vn in _vn_candidates(ks, ah):
            # tiling: prefer the largest tiles that fit (fewer reloads)
            k_opts = _pow2_tiles(min(vn, ks), min(ks, cfg.sta_bytes))
            k_opts = [k for k in k_opts[-3:]]
            for k_t in k_opts:
                max_nt = max(1, cfg.sta_bytes // max(k_t, 1))
                n_opts = _pow2_tiles(min(vn, ns), min(ns, max_nt))
                for n_t in n_opts[-3:]:
                    max_mt = max(1, min(cfg.str_bytes // max(k_t, 1),
                                        cfg.ob_bytes // (max(n_t, 1)
                                                         * cfg.acc_bytes),
                                        cfg.vn_slots_per_col))
                    m_opts = _pow2_tiles(1, min(ms, max_mt))
                    for m_t in m_opts[-3:]:
                        kg = math.ceil(min(k_t, ks) / vn)
                        nb = math.ceil(min(n_t, ns) / vn)
                        # Group-formation knobs.  Eq. 1's index arithmetic
                        # forces exact column coverage: G_r = AW/n_kg,
                        # G_c = n_nb and the duplication factor is
                        # structurally d = G_r / G_c, so (n_kg, n_nb) must
                        # divide the column space exactly and d is derived.
                        for n_kg in _divisors_pow2ish(aw):
                            if n_kg > 2 * kg:
                                continue  # >half the columns masked: skip
                            g_r = aw // n_kg
                            for n_nb in _divisors_pow2ish(g_r):
                                if n_nb > 2 * nb:
                                    continue
                                dup = g_r // n_nb
                                yield MappingChoice(
                                    df=df, vn=vn, m_t=m_t, k_t=k_t,
                                    n_t=n_t, n_kg=n_kg, n_nb=n_nb,
                                    dup=dup)


# ---------------------------------------------------------------------------
# Layout feasibility (step 6)
# ---------------------------------------------------------------------------

def _layouts_for(gemm: Gemm, choice: MappingChoice, dims: Tiling,
                 cfg: FeatherConfig) -> tuple[layoutlib.VNLayout,
                                              layoutlib.VNLayout,
                                              layoutlib.VNLayout] | None:
    """Derive (stationary, streaming, output) layouts realising the mapping
    without bank conflicts.

    FEATHER+'s all-to-all distribution makes the *stationary* side conflict-
    free by construction (any resident VN can reach any column, §III-B), so
    the binding constraints are:

      streaming: the single-bank buffer serves one row (AW elements) per
        cycle; at stream step t, element e, every column reads element e of
        I_VN(m[t,a_w], j[a_w]) -- all of those must live in one buffer row
        (multicast handles duplicates).  Satisfied by placing I_VNs with the
        reduction rank innermost across columns (order with nr_L0 outermost,
        red_L1 innermost) when n_kg*dup <= AW ... we *verify* by direct
        address simulation below instead of trusting the construction.

      output: the AW OB banks absorb one psum per bank per cycle; BIRRD can
        permute, so legality is "<= AW distinct banks per drain cycle",
        guaranteed when the O_VN layout's level-0 free factor >= concurrent
        n-block width.  Also verified directly.
    """
    vn = choice.vn
    kg = math.ceil(min(dims.k_t, gemm.k) / vn)
    m_eff = dims.m_eff
    n_eff = dims.n_eff

    # candidate orders, most-promising first
    stream_orders = [0b100, 0b010, 0b000, 0b001, 0b011, 0b101]
    for o_i in stream_orders:
        lay_i = layoutlib.layout_for(kg, m_eff, vn, cfg.aw, order=o_i,
                                     nr_l0=min(cfg.aw, m_eff))
        if _stream_feasible(lay_i, choice, dims, cfg):
            break
    else:
        return None
    lay_w = layoutlib.layout_for(kg, n_eff, vn, cfg.aw, order=choice.order_w)
    lay_o = layoutlib.layout_for(math.ceil(n_eff / vn), m_eff, vn, cfg.aw,
                                 order=choice.order_o)
    if lay_w.rows_needed > cfg.d_sta or lay_i.rows_needed > cfg.d_str:
        return None
    return lay_w, lay_i, lay_o


def _stream_feasible(lay_i: layoutlib.VNLayout, choice: MappingChoice,
                     dims: Tiling, cfg: FeatherConfig,
                     probe_steps: int = 4) -> bool:
    """Single-bank streaming legality by direct address simulation."""
    aw = cfg.aw
    g_r = max(1, (aw // max(choice.n_kg, 1)))
    g_c = max(1, choice.n_nb)
    a_w = np.arange(aw)
    j = a_w // g_r
    for t in range(min(probe_steps, dims.t_steps)):
        m = choice.dup * t + (a_w % g_r) // g_c
        valid = (m < dims.m_eff) & (j < lay_i.red_l1)
        if not valid.any():
            continue
        rows, _ = lay_i.address(np.where(valid, j, 0), np.where(valid, m, 0))
        rows = rows[valid]
        # all concurrent reads within one row -> single-bank OK (the vn
        # elements advance row-by-row in lockstep for every column)
        if np.unique(rows).size > 1:
            return False
    return True


# ---------------------------------------------------------------------------
# Top-level search
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Plan:
    gemm: Gemm
    cfg: FeatherConfig
    choice: MappingChoice
    program: programlib.Program
    layouts: tuple       # (W, I, O) VNLayouts
    perf_minisa: perf.PerfResult
    perf_micro: perf.PerfResult

    @property
    def speedup(self) -> float:
        return self.perf_micro.cycles / max(self.perf_minisa.cycles, 1e-9)

    def execute(self, tensors: dict, backend="cuda", mesh=None,
                shard_axis: str | None = None, **backend_kwargs) -> dict:
        """Run the winning Program on an execution backend.

        ``backend`` is a registry name ('cuda' compiles the Program's
        tiling to one hand-written ``nest_gemm`` launch) or a ``backends.Backend``
        instance for stateful multi-layer runs.  Returns the named output
        tensors ({self.program.out_name: ...}).

        ``mesh`` (a ``dist.ArrayMesh`` with ``n_arrays > 1``) executes
        the Program sharded across the mesh's arrays instead
        (``program.shard_program``; ``shard_axis`` overrides the axis
        policy).
        """
        from repro_torch import backends as backendlib
        be = backendlib.get_backend(backend, self.cfg, **backend_kwargs)
        if mesh is not None and mesh.n_arrays > 1:
            sharded = programlib.shard_program(self.program, mesh,
                                               axis=shard_axis)
            return be.run_sharded(sharded, tensors)
        return be.run_program(self.program, tensors)

    def summary(self) -> dict:
        p = self.program
        minisa_bytes = p.minisa_bytes()
        micro_bytes = p.micro_storage_bytes()
        return {
            "workload": self.gemm.name or f"{self.gemm.m}x{self.gemm.k}x{self.gemm.n}",
            "array": f"{self.cfg.ah}x{self.cfg.aw}",
            "df": self.choice.df.name,
            "vn": self.choice.vn,
            "tile": (p.n_m, p.n_n, p.n_k),
            "cycles_minisa": self.perf_minisa.cycles,
            "cycles_micro": self.perf_micro.cycles,
            "speedup": self.speedup,
            "util_minisa": self.perf_minisa.utilization,
            "stall_micro": self.perf_micro.stall_ifetch_frac,
            "stall_minisa": self.perf_minisa.stall_ifetch_frac,
            "instr_bytes_minisa": minisa_bytes,
            "instr_bytes_micro": micro_bytes,
            "instr_reduction": micro_bytes / max(minisa_bytes, 1e-9),
            "data_bytes": self.gemm.data_bytes,
        }


def _prescore(gemm: Gemm, dims: Tiling, cfg: FeatherConfig) -> float:
    """Closed-form lower-bound latency for candidate *ranking* only (the
    discrete-event pass over real Program tiles runs on the shortlist)."""
    compute = dims.n_tiles * dims.invocations_per_tile \
        * dims.cycles_per_invocation
    i_bytes = dims.ms * dims.ks * cfg.elem_bytes
    w_bytes = dims.ks * dims.ns * cfg.elem_bytes
    loads = (i_bytes * (1 if i_bytes <= cfg.str_bytes else dims.n_n)
             + w_bytes * (1 if dims.ks * dims.n_t <= cfg.sta_bytes
                          else dims.n_m))
    store = dims.ms * dims.ns * cfg.elem_bytes
    instr = dims.n_tiles * dims.invocations_per_tile * (
        cfg.bits_execute_mapping() + cfg.bits_execute_streaming()
        * math.ceil(dims.t_steps / max(cfg.vn_slots_per_col, 1))) / 8.0
    return max(compute, loads / cfg.in_bw, store / cfg.out_bw,
               instr / cfg.instr_bw)


def _prescore_batch(gemm: Gemm, cfg: FeatherConfig,
                    choices: list[MappingChoice]
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Vectorised twin of ``tiling()`` feasibility + ``_prescore()`` over
    ALL enumerated candidates at once (one numpy pass instead of a
    per-candidate Python loop).  Returns ``(scores, feasible)``; the
    formulas replicate the scalar pair exactly, so the shortlist ranking
    is bit-identical to the loop it replaces (asserted in tests)."""
    ah, aw = cfg.ah, cfg.aw
    wos = np.fromiter((c.df == isa.Dataflow.WOS for c in choices),
                      dtype=bool, count=len(choices))
    as_i64 = lambda attr: np.fromiter(  # noqa: E731
        (getattr(c, attr) for c in choices), dtype=np.int64,
        count=len(choices))
    vn = as_i64("vn")
    m_t, k_t, n_t = as_i64("m_t"), as_i64("k_t"), as_i64("n_t")
    n_kg, n_nb, dup = as_i64("n_kg"), as_i64("n_nb"), as_i64("dup")

    ms = np.where(wos, gemm.m, gemm.n)
    ks = np.full_like(vn, gemm.k)
    ns = np.where(wos, gemm.n, gemm.m)

    feas = (vn >= 1) & (vn <= ah)
    vn_s = np.maximum(vn, 1)                  # div-safe; masked by feas
    # snap_tiling: clip to the problem, snap k_t to a VN multiple
    m_t = np.minimum(m_t, ms)
    k_t = np.minimum(k_t, ks)
    n_t = np.minimum(n_t, ns)
    feas &= (m_t >= 1) & (k_t >= 1) & (n_t >= 1)
    k_t = np.where(k_t < ks, np.maximum(vn_s, (k_t // vn_s) * vn_s), k_t)
    # capacity + shape feasibility (tiling())
    feas &= n_kg * n_nb * dup <= aw
    feas &= m_t * k_t <= cfg.str_bytes
    feas &= k_t * n_t <= cfg.sta_bytes
    feas &= m_t * n_t * cfg.acc_bytes <= cfg.ob_bytes

    m_ts = np.maximum(m_t, 1)
    k_ts = np.maximum(k_t, 1)
    n_ts = np.maximum(n_t, 1)
    n_m = -(-ms // m_ts)
    n_n = -(-ns // n_ts)
    n_k = -(-ks // k_ts)
    n_tiles = n_m * n_n * n_k
    kg_tiles = -(-k_t // vn_s)
    nb_tiles = -(-n_t // vn_s)
    invocations = ((-(-kg_tiles // np.maximum(n_kg, 1)))
                   * (-(-nb_tiles // np.maximum(n_nb, 1))))
    t_steps = -(-m_t // np.maximum(dup, 1))
    cycles_per_inv = (np.maximum(t_steps * vn, vn * vn)
                      + vn + cfg.birrd_stages + 2)

    compute = (n_tiles * invocations * cycles_per_inv).astype(np.float64)
    elem = cfg.elem_bytes
    i_bytes = ms * ks * elem
    w_bytes = ks * ns * elem
    loads = (i_bytes * np.where(i_bytes <= cfg.str_bytes, 1, n_n)
             + w_bytes * np.where(ks * n_t <= cfg.sta_bytes, 1, n_m))
    store = ms * ns * elem
    es_per_inv = -(-t_steps // max(cfg.vn_slots_per_col, 1))
    instr = n_tiles * invocations * (
        cfg.bits_execute_mapping()
        + cfg.bits_execute_streaming() * es_per_inv) / 8.0
    score = np.maximum.reduce([
        compute, loads / cfg.in_bw, store / cfg.out_bw,
        instr / cfg.instr_bw])
    return score, feas


def search(gemm: Gemm, cfg: FeatherConfig, top_k: int = 8,
           shortlist: int = 10,
           fixed_input_vn: int | None = None,
           fixed_input_order: int | None = None,
           vectorized: bool = True) -> Plan:
    """Mapping-first, layout-second co-search returning the best Plan.

    ``fixed_input_vn`` / ``fixed_input_order`` implement the paper's
    *layout-constrained* mode (artifact item 6, §V step 7's inter-layer
    compatibility): when layer i's output layout is already committed,
    layer i+1 may only consider mappings whose input VN size matches and
    whose input layout order equals the committed one.

    ``vectorized`` prescores ALL enumerated candidates in one numpy batch
    (``_prescore_batch``) and materialises ``Tiling`` objects only for
    the shortlist; ``False`` keeps the per-candidate Python loop (same
    ranking -- retained as the reference and for the before/after
    benchmark in ``benchmarks/run.py``).
    """
    pool: list[MappingChoice] = []
    seen = set()
    for choice in enumerate_choices(gemm, cfg):
        if fixed_input_vn is not None and choice.vn != fixed_input_vn:
            continue
        if fixed_input_order is not None:
            choice = dataclasses.replace(choice,
                                         order_i=fixed_input_order)
        key = dataclasses.astuple(choice)
        if key in seen:
            continue
        seen.add(key)
        pool.append(choice)

    candidates: list[tuple[float, MappingChoice, Tiling]] = []
    if vectorized and pool:
        scores, feas = _prescore_batch(gemm, cfg, pool)
        order = np.flatnonzero(feas)
        order = order[np.argsort(scores[order], kind="stable")]
        for i in order[:shortlist]:
            dims = tiling(gemm, pool[i], cfg)   # exact, shortlist-only
            if dims is not None:                # always true: same maths
                candidates.append((float(scores[i]), pool[i], dims))
    else:
        for choice in pool:
            dims = tiling(gemm, choice, cfg)
            if dims is None:
                continue
            candidates.append((_prescore(gemm, dims, cfg), choice, dims))
        candidates.sort(key=lambda x: x[0])
    if not candidates:
        raise ValueError(f"no feasible mapping for {gemm} on "
                         f"{cfg.ah}x{cfg.aw}")
    # shortlist: lower to real Programs and score the actual tile streams.
    # Lowering is O(tiles), so huge candidate programs draw down a shared
    # tile budget -- at least 4 candidates are always fully lowered.
    scored = []
    tile_budget = 60_000
    for _, choice, dims in candidates[:shortlist]:
        if len(scored) >= 4 and tile_budget <= 0:
            break
        tile_budget -= dims.n_tiles
        prog = programlib.lower(gemm, choice, cfg)
        res = perf.simulate(prog.tile_costs("minisa"), cfg)
        scored.append((res.cycles, choice, dims, prog, res))
    scored.sort(key=lambda x: x[0])
    # layout-second: walk the best mappings until one has a feasible layout
    chosen = None
    for cycles, choice, dims, prog, res in scored[:max(top_k, 1)]:
        layouts = _layouts_for(gemm, choice, dims, cfg)
        if layouts is not None:
            chosen = (choice, dims, prog, res, layouts)
            break
    if chosen is None:
        # fall back: best mapping with default layouts (always functional;
        # perf model unchanged -- conflicts would cost cycles on silicon)
        cycles, choice, dims, prog, res = scored[0]
        vn = choice.vn
        kg = math.ceil(min(choice.k_t, gemm.k) / vn)
        lay_w = layoutlib.layout_for(kg, dims.n_eff, vn, cfg.aw)
        lay_i = layoutlib.layout_for(kg, dims.m_eff, vn, cfg.aw)
        lay_o = layoutlib.layout_for(math.ceil(dims.n_eff / vn),
                                     dims.m_eff, vn, cfg.aw)
        chosen = (choice, dims, prog, res, (lay_w, lay_i, lay_o))
    choice, dims, prog, res_minisa, layouts = chosen
    res_micro = perf.simulate(prog.tile_costs("micro"), cfg)
    return Plan(gemm=gemm, cfg=cfg, choice=choice, program=prog,
                layouts=layouts, perf_minisa=res_minisa,
                perf_micro=res_micro)


# ---------------------------------------------------------------------------
# Joint segment search: Pareto frontier over the fused-launch geometry
# ---------------------------------------------------------------------------

# Fixed cost per streamed weight window: the DMA descriptor issue plus
# the double-buffer swap at every K-step boundary.  Transfer *bytes* are
# K-tile-invariant (each weight byte streams once per M pass), so
# without this term the cycle model could not see that 220 one-column
# windows cost more than 2 full-K windows and the frontier would
# collapse onto minimum-VMEM unit tiles.
STREAM_SETUP_CYCLES = 64


@dataclasses.dataclass(frozen=True)
class SegmentChoice:
    """One joint fused-launch geometry for a chained segment: the shared
    host-M tile (resident activation rows) plus every layer's host-K
    weight-streaming tile -- exactly the PR 7 streamed search space that
    per-GEMM search + post-hoc snapping explored only one point of."""
    bm: int
    layer_bks: tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class SegmentPoint:
    """A Pareto point of the joint search, priced on three axes: the
    MINISA HBM traffic the ONE fused launch ships, the analytic
    discrete-event cycles of the fused tile stream, and the streamed
    VMEM high-water (``program._streamed_footprint_bytes``)."""
    choice: SegmentChoice
    traffic_bytes: float
    cycles: float
    vmem_bytes: int

    @property
    def metrics(self) -> tuple[float, float, int]:
        return (self.traffic_bytes, self.cycles, self.vmem_bytes)


def _dominates(a: tuple, b: tuple) -> bool:
    """a Pareto-dominates b: no worse on every axis, better on one."""
    return (all(x <= y for x, y in zip(a, b))
            and any(x < y for x, y in zip(a, b)))


def pareto_frontier(points: list[SegmentPoint]) -> list[SegmentPoint]:
    """Non-dominated subset (first-seen wins among metric ties),
    cycles-ascending so ``points[:k]`` is the analytic top-k."""
    front: list[SegmentPoint] = []
    seen_metrics: set[tuple] = set()
    for p in points:
        if p.metrics in seen_metrics:
            continue
        if any(_dominates(q.metrics, p.metrics) for q in points):
            continue
        seen_metrics.add(p.metrics)
        front.append(p)
    return sorted(front, key=lambda p: (p.cycles, p.traffic_bytes,
                                        p.vmem_bytes))


@dataclasses.dataclass
class SegmentFrontier:
    """The joint search result: every surviving geometry, not a single
    winner -- the measured autotune pass (``runtime.autotune``) picks
    among these against real launch wall clock."""
    points: list[SegmentPoint]           # non-dominated, cycles-ascending
    n_enumerated: int                    # joint candidates generated
    n_feasible: int                      # ... that fit the VMEM budget
    vmem_budget: int
    operand_dtype: str

    def top(self, k: int) -> list[SegmentPoint]:
        return self.points[:max(1, k)]

    def summary(self) -> dict:
        return {"n_points": len(self.points),
                "n_enumerated": self.n_enumerated,
                "n_feasible": self.n_feasible,
                "vmem_budget": self.vmem_budget,
                "operand_dtype": self.operand_dtype,
                "best_cycles": self.points[0].cycles
                if self.points else None}


def _restated_tiles(segment, base_costs) -> list:
    """The fused tile stream for one candidate geometry: the
    geometry-independent per-layer costs (interior loads/stores elided)
    plus each layer's weight bytes restated to the candidate's streamed
    K-tile schedule -- ``FusedSegment.layer_tile_costs`` factored so the
    expensive Program walk happens once per segment, not per point."""
    cfg = segment.cfg
    tiles = []
    for layer, costs in enumerate(base_costs):
        kp = segment.padded_ks[layer]
        g = segment.programs[layer].gemm
        shipped = float(cfg.elem_bytes * segment.m_steps * kp * g.n)
        per_tile = shipped / max(len(costs), 1)
        tiles.extend(dataclasses.replace(t, load_bytes=t.load_bytes
                                         + per_tile)
                     for t in costs)
    return tiles


def _bk_vectors(programs, adapts, vmem_budget, operand_dtype) -> list:
    """Candidate per-layer K-tile vectors: halving pressure levels from
    full-K streaming down to unit tiles, plus each layer's own snapped
    ``k_t`` and the greedy capped vector (so the post-hoc-snap geometry
    is always IN the joint space and can never be lost to it)."""
    ks = [p.gemm.k for p in programs]
    vecs: list[tuple[int, ...]] = []
    for j in range(0, 9):
        vec = tuple(max(1, -(-k // (1 << j))) for k in ks)
        if vec not in vecs:
            vecs.append(vec)
        if all(v == 1 for v in vec):
            break
    snapped = []
    for p in programs:
        st = programlib.snap_tiling(p.gemm, p.choice, p.cfg)
        snapped.append(max(1, min(st[1], p.gemm.k)) if st else 1)
    if tuple(snapped) not in vecs:
        vecs.append(tuple(snapped))
    greedy = programlib.fuse_segment(
        list(programs), vmem_budget=vmem_budget, adapts=adapts,
        operand_dtype=operand_dtype)
    if greedy is not None and greedy.layer_bks not in vecs:
        vecs.append(greedy.layer_bks)
    return vecs


def search_segment(programs, *,
                   vmem_budget: int = programlib.FUSED_VMEM_BUDGET,
                   adapts: tuple[bool, ...] | None = None,
                   operand_dtype: str = "float32",
                   max_tiles: int = 4096) -> SegmentFrontier | None:
    """Map a whole chained segment at once (ROADMAP item 3).

    Enumerates joint candidates over (shared ``bm``) x (per-layer
    ``bk_l``) priced by ``program._streamed_footprint_bytes`` -- the
    dtype-aware streamed VMEM budget -- and keeps the Pareto frontier
    over {MINISA traffic bytes, analytic cycles, VMEM high-water}
    instead of a single winner.  Returns None when the segment is not
    fusion-legal (the per-layer fallback path applies).

    The per-layer Programs stay the lowering source of truth: a
    ``SegmentChoice`` only re-geometries the fused launch, so every
    frontier point shares the Programs' instruction accounting and
    numerics (same accumulation shapes, different K-tile walk).
    """
    programs = list(programs)
    if adapts is None:
        adapts = (False,) * len(programs)
    template = programlib.fuse_segment(
        programs, vmem_budget=vmem_budget, adapts=adapts,
        operand_dtype=operand_dtype)
    if template is None:
        return None
    cfg = template.cfg
    n_layers = template.n_layers
    base_costs = [
        programs[layer].tile_costs(
            "minisa", max_tiles,
            elide_input_loads=layer > 0,
            elide_weight_loads=True,
            on_chip_store=layer < n_layers - 1)
        for layer in range(n_layers)]

    m = programs[0].gemm.m
    if any(adapts):
        # the in-kernel slab permutation needs every row resident
        bm_opts = [max(p.gemm.m for p in programs)]
    else:
        bm_opts = sorted({m, template.bm,
                          *_pow2_tiles(1, m)}, reverse=True)[:8]
    bk_vecs = _bk_vectors(programs, adapts, vmem_budget, operand_dtype)

    points: list[SegmentPoint] = []
    n_enumerated = 0
    for bm in bm_opts:
        for bks in bk_vecs:
            n_enumerated += 1
            seg = dataclasses.replace(template, bm=bm, layer_bks=bks)
            vmem = seg.vmem_highwater_bytes()
            if vmem > vmem_budget:
                continue
            k_steps = seg.m_steps * sum(
                -(-p.gemm.k // max(1, bk))
                for p, bk in zip(programs, bks))
            cycles = (perf.simulate(_restated_tiles(seg, base_costs),
                                    cfg).cycles
                      + STREAM_SETUP_CYCLES * k_steps)
            points.append(SegmentPoint(
                choice=SegmentChoice(bm=bm, layer_bks=bks),
                traffic_bytes=seg.kernel_hbm_bytes(),
                cycles=cycles, vmem_bytes=vmem))
    if not points:
        return None
    return SegmentFrontier(points=pareto_frontier(points),
                           n_enumerated=n_enumerated,
                           n_feasible=len(points),
                           vmem_budget=vmem_budget,
                           operand_dtype=operand_dtype)
