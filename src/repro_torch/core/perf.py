"""Analytical performance model: the paper's "cycle-accurate analytical
model with a 5-engine asynchronous execution simulator" (paper §VI-A,
appendix).

Engines (inferred from Fig. 13's breakdown components):

  IFETCH      -- off-chip instruction interface, cfg.instr_bw B/cycle
  LOAD        -- off-chip input/weight loads, cfg.in_bw B/cycle
  COMPUTE     -- the NEST array (streaming + drain cycles per invocation)
  OUT2STREAM  -- OB -> streaming/stationary buffer commit (AW elems/cycle)
  STORE       -- off-chip output stores, cfg.out_bw B/cycle

Tiles execute in order.  Instruction fetch and operand loads for tile i+1
overlap with compute of tile i (double buffering); a tile's compute cannot
start until its instructions and operands have arrived, which is exactly how
instruction-fetch stalls emerge at scale (Tab. I).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.obs.trace import trace


@dataclasses.dataclass(frozen=True)
class TileCost:
    """Everything the engines need to know about one schedulable unit."""
    fetch_bytes: float = 0.0        # instruction bytes for this tile
    load_bytes: float = 0.0         # fresh off-chip operand bytes
    compute_cycles: float = 0.0     # NEST busy cycles
    out2stream_cycles: float = 0.0  # OB commit cycles (on-chip)
    store_bytes: float = 0.0        # off-chip output bytes
    macs: float = 0.0               # useful MACs (utilization numerator)


@dataclasses.dataclass(frozen=True)
class PerfResult:
    cycles: float
    macs: float
    peak_macs_per_cycle: float
    busy: dict[str, float]          # per-engine busy cycles
    stall_ifetch_frac: float        # fraction of total cycles attributable
                                    # to waiting on instruction fetch
    cycles_no_fetch: float

    @property
    def utilization(self) -> float:
        if self.cycles <= 0:
            return 0.0
        return self.macs / (self.peak_macs_per_cycle * self.cycles)

    def breakdown(self) -> dict[str, float]:
        out = dict(self.busy)
        out["total"] = self.cycles
        out["ifetch_stall"] = self.stall_ifetch_frac * self.cycles
        return out

    def publish_metrics(self, registry=None, **labels) -> None:
        """Publish the modelled cycle/stall figures into a metrics
        registry (default: the shared ``obs.metrics`` one) -- the
        paper's Tab. I fetch-stall fraction becomes the
        ``perf_stall_ifetch_frac`` gauge, labelled by the caller (e.g.
        ``control="minisa"``)."""
        from repro_torch.obs import metrics as obs_metrics
        reg = registry if registry is not None else obs_metrics.REGISTRY
        reg.gauge("perf_cycles",
                  "modelled makespan cycles (5-engine model)").set(
                      self.cycles, **labels)
        reg.gauge("perf_stall_ifetch_frac",
                  "fraction of cycles stalled on instruction fetch "
                  "(Tab. I)").set(self.stall_ifetch_frac, **labels)
        reg.gauge("perf_utilization").set(self.utilization, **labels)
        for engine, cycles in self.busy.items():
            reg.gauge("perf_engine_busy_cycles",
                      "per-engine busy cycles").set(
                          cycles, engine=engine, **labels)


def _simulate(tiles: Sequence[TileCost], instr_bw: float, in_bw: float,
              out_bw: float, out2stream: bool = True) -> tuple[float, dict]:
    """Event-driven pass over the tile sequence; returns (makespan, busy)."""
    t_fetch = 0.0      # when the fetch engine becomes free
    t_load = 0.0
    t_compute = 0.0
    t_commit = 0.0
    t_store = 0.0
    busy = {"ifetch": 0.0, "load": 0.0, "compute": 0.0,
            "out2stream": 0.0, "store": 0.0}
    for tile in tiles:
        fetch_time = tile.fetch_bytes / instr_bw if instr_bw > 0 else 0.0
        load_time = tile.load_bytes / in_bw if in_bw > 0 else 0.0
        # fetch + load proceed independently and may prefetch ahead
        t_fetch = t_fetch + fetch_time
        t_load = t_load + load_time
        busy["ifetch"] += fetch_time
        busy["load"] += load_time
        start = max(t_compute, t_fetch, t_load)
        t_compute = start + tile.compute_cycles
        busy["compute"] += tile.compute_cycles
        if out2stream and tile.out2stream_cycles:
            t_commit = max(t_commit, t_compute) + tile.out2stream_cycles
            busy["out2stream"] += tile.out2stream_cycles
        if tile.store_bytes:
            store_time = tile.store_bytes / out_bw if out_bw > 0 else 0.0
            t_store = max(t_store, max(t_commit, t_compute)) + store_time
            busy["store"] += store_time
    makespan = max(t_compute, t_commit, t_store, t_fetch, t_load)
    return makespan, busy


def hbm_traffic(tiles: Sequence[TileCost]) -> dict[str, float]:
    """Off-chip byte totals of a tile stream (the quantities fused-segment
    execution elides: a chained commit moves store bytes into out2stream
    cycles, an elided input Load vanishes -- see Program.tile_costs)."""
    return {
        "load_bytes": sum(t.load_bytes for t in tiles),
        "store_bytes": sum(t.store_bytes for t in tiles),
        "fetch_bytes": sum(t.fetch_bytes for t in tiles),
        "data_bytes": sum(t.load_bytes + t.store_bytes for t in tiles),
    }


def simulate(tiles: Sequence[TileCost], cfg) -> PerfResult:
    """cfg: FeatherConfig."""
    with trace.span("perf.simulate", n_tiles=len(tiles)):
        return _simulate_result(tiles, cfg)


def _simulate_result(tiles: Sequence[TileCost], cfg) -> PerfResult:
    total, busy = _simulate(tiles, cfg.instr_bw, cfg.in_bw, cfg.out_bw)
    # Counterfactual run with free instruction delivery isolates the
    # fetch-stall share (the paper's "explicit stall of fetching
    # instructions", Tab. I).
    no_fetch, _ = _simulate(tiles, float("inf"), cfg.in_bw, cfg.out_bw)
    macs = sum(t.macs for t in tiles)
    stall = 0.0 if total <= 0 else max(0.0, (total - no_fetch) / total)
    return PerfResult(cycles=total, macs=macs,
                      peak_macs_per_cycle=cfg.peak_macs_per_cycle,
                      busy=busy, stall_ifetch_frac=stall,
                      cycles_no_fetch=no_fetch)


# ---------------------------------------------------------------------------
# Multi-array (mesh) view: one engine simulation per array
# ---------------------------------------------------------------------------

def load_imbalance(per_array_values) -> float:
    """Max-over-mean across the arrays that did any work (1.0 = perfectly
    balanced or idle) -- the one imbalance definition every mesh report
    shares."""
    active = [v for v in per_array_values if v > 0]
    if not active:
        return 1.0
    return max(active) / (sum(active) / len(active))


@dataclasses.dataclass(frozen=True)
class MeshPerfResult:
    """Per-array PerfResults of a ShardedProgram, arrays run in parallel.

    Makespan is the slowest array (plus the reduction epilogue for
    K-partitioned shards); traffic and MACs sum; ``load_imbalance`` is
    max-over-mean busy cycles across the arrays that did any work.
    """
    per_array: tuple[PerfResult, ...]
    reduce_cycles: float = 0.0      # K-split epilogue (psum over arrays)

    @property
    def cycles(self) -> float:
        busiest = max((r.cycles for r in self.per_array), default=0.0)
        return busiest + self.reduce_cycles

    @property
    def macs(self) -> float:
        return sum(r.macs for r in self.per_array)

    @property
    def stall_ifetch_frac(self) -> float:
        total = sum(r.cycles for r in self.per_array)
        if total <= 0:
            return 0.0
        return sum(r.stall_ifetch_frac * r.cycles
                   for r in self.per_array) / total

    @property
    def load_imbalance(self) -> float:
        return load_imbalance([r.cycles for r in self.per_array])

    @property
    def utilization(self) -> float:
        if self.cycles <= 0 or not self.per_array:
            return 0.0
        peak = self.per_array[0].peak_macs_per_cycle * len(self.per_array)
        return self.macs / (peak * self.cycles)


def simulate_sharded(sharded, cfg, control: str = "minisa"
                     ) -> MeshPerfResult:
    """Run the 5-engine model independently per array of a
    :class:`~repro_torch.core.program.ShardedProgram` (each array has its own
    fetch/load/compute/store engines; they share nothing but the host).

    The K-split reduction epilogue is modelled as one pass over the
    output at the commit rate (AW elements/cycle) per combining array --
    the same cost shape as out2stream.
    """
    results = [simulate(costs, cfg)
               for costs in sharded.per_array_tile_costs(control)]
    reduce_cycles = 0.0
    if sharded.reduce and sharded.n_shards > 1:
        g = sharded.base.gemm
        reduce_cycles = (sharded.n_shards - 1) * (g.m * g.n) / cfg.aw
    return MeshPerfResult(per_array=tuple(results),
                          reduce_cycles=reduce_cycles)
