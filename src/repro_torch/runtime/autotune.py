"""Measured autotuning of the fused-segment Pareto frontier.

The joint segment search (``mapper.search_segment``, memoised in the
ProgramCache frontier tier) prices geometries analytically; this pass
closes the loop against measured hardware: compile the top-k frontier
points through the compiled backend and score them with the ``obs``
telemetry spine -- the backend's per-launch spans end in a device
synchronise while tracing is on and carry the streamed high-water, and
``obs.export.span_breakdown`` turns them into kernel-vs-host fractions
-- with no second timing path.

The measured winner persists in the ProgramCache tuned tier under a key
carrying the tuning state (backend kind, device type, max_block): a
winner measured with the plain versions on the CPU is never returned
for the kernels on the card.  ``autotune_segment`` on a warm cache is
one dict lookup, and ``ModelExecutable`` segment builds consume the
winner's geometry directly.

Usage::

    from repro_torch.runtime import autotune
    report = autotune.autotune_segment(chained_programs, backend,
                                       cache=cache, adapts=adapts)
    seg = fuse_segment(chained_programs, adapts=adapts,
                       bm=report.winner.bm,
                       layer_bks=report.winner.layer_bks)
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import perf
from repro_torch.core import program as programlib
from repro_torch.obs import export as obs_export
from repro_torch.obs.trace import trace
from repro_torch.runtime.cache import ProgramCache, default_cache, segment_key


@dataclasses.dataclass(frozen=True)
class TunedGeometry:
    """A measured frontier winner: the joint geometry plus the evidence.

    Value-only (ints/floats/tuples), so it pickles into the ProgramCache
    tuned tier and survives process restarts."""
    bm: int
    layer_bks: tuple[int, ...]
    measured_s: float            # median fused-launch span
    kernel_frac: float           # launch share of the measured window
    analytic_cycles: float       # the frontier point's modelled cycles
    traffic_bytes: float         # ... and modelled MINISA HBM bytes
    vmem_bytes: int              # streamed on-chip high-water
    n_points_measured: int       # frontier points actually compiled+run


@dataclasses.dataclass
class AutotuneReport:
    winner: TunedGeometry
    trials: list[dict]           # one row per measured frontier point
    cached: bool                 # True == served from the tuned tier

    def summary(self) -> dict:
        w = self.winner
        return {"bm": w.bm, "layer_bks": list(w.layer_bks),
                "measured_us": w.measured_s * 1e6,
                "kernel_frac": w.kernel_frac,
                "vmem_bytes": w.vmem_bytes,
                "n_points_measured": w.n_points_measured,
                "cached": self.cached}


def tuning_state(backend) -> tuple:
    """The measurement state a tuned winner is valid for: the backend
    kind, the device type its launches ran on ("cpu" times the plain
    versions, "cuda" the kernels) and its ``max_block``."""
    return (backend.name, backend.device.type, int(backend.max_block))


def _segment_tensors(programs, seed: int = 0) -> dict:
    """Deterministic operand set for measurement runs."""
    rng = np.random.default_rng(seed)
    g0 = programs[0].gemm
    t = {"I": rng.standard_normal((g0.m, g0.k)).astype(np.float32)}
    for i, p in enumerate(programs):
        g = p.gemm
        t[f"W{i}"] = (rng.standard_normal((g.k, g.n)).astype(np.float32)
                      / np.sqrt(g.k))
    return t


def _measure_launches(backend, seg, tensors, iters: int) -> dict | None:
    """Run the fused segment ``iters`` times and read the result off the
    telemetry spine: the backend's ``launch`` spans end in a device
    synchronise while tracing is on and carry the streamed high-water;
    ``span_breakdown`` gives the kernel-vs-host split of the measured
    window."""
    backend.run_segment(seg, tensors)        # compile + first-launch warm-up
    was_enabled = trace.enabled
    events_before = len(trace.events())
    trace.enable()
    try:
        with trace.span("autotune.trial", bm=seg.bm,
                        layer_bks=tuple(seg.layer_bks)):
            for _ in range(iters):
                backend.run_segment(seg, tensors)
    finally:
        if not was_enabled:
            trace.disable()
    events = trace.events()[events_before:]
    launches = [ev for ev in events if ev.name == "launch"]
    if not launches:
        return None
    durs = sorted(ev.dur_s for ev in launches)
    breakdown = obs_export.span_breakdown("autotune.trial", {"launch"},
                                          events)
    return {"median_s": durs[len(durs) // 2],
            "total_s": sum(durs),
            "n_launches": len(launches),
            "kernel_frac": breakdown["child_frac"],
            "vmem_highwater_bytes": max(
                ev.attrs.get("vmem_highwater_bytes", 0)
                for ev in launches)}


def autotune_segment(programs, backend, *,
                     cache: ProgramCache | None = None,
                     adapts: tuple[bool, ...] | None = None,
                     vmem_budget: int | None = None,
                     operand_dtype: str = "float32",
                     top_k: int = 4, iters: int = 3,
                     seed: int = 0) -> AutotuneReport | None:
    """Measure the top-k frontier points of a chained segment and
    persist the winner.

    Returns None when the segment is not fusion-legal (nothing to
    tune).  On a warm cache (the tuned tier already holds a winner for
    this structure under this backend's tuning state) the report comes
    back ``cached=True`` with zero searches, compiles or launches.
    """
    cache = cache if cache is not None else default_cache()
    programs = list(programs)
    if adapts is None:
        adapts = (False,) * len(programs)
    state = tuning_state(backend)
    key = segment_key(programs, adapts=adapts, vmem_budget=vmem_budget,
                      operand_dtype=operand_dtype, tuning=state)
    hit = cache.lookup_tuned(key)
    if hit is not None:
        return AutotuneReport(winner=hit, trials=[], cached=True)

    front = cache.frontier(programs, adapts=adapts,
                           vmem_budget=vmem_budget,
                           operand_dtype=operand_dtype)
    if front is None or not front.points:
        return None
    budget = (vmem_budget if vmem_budget is not None
              else programlib.FUSED_VMEM_BUDGET)

    # the greedy-then-snap default always joins the measured pool (even
    # when analytic pruning dominated it off the frontier), so the
    # persisted winner can never lose to the untuned geometry under the
    # same measurement conditions
    geometries: list[tuple[int, tuple[int, ...], object]] = [
        (p.choice.bm, p.choice.layer_bks, p) for p in front.top(top_k)]
    greedy = programlib.fuse_segment(
        programs, adapts=adapts, vmem_budget=budget,
        operand_dtype=operand_dtype)
    if greedy is not None and all(
            (greedy.bm, greedy.layer_bks) != (bm, bks)
            for bm, bks, _ in geometries):
        geometries.append((greedy.bm, greedy.layer_bks, None))

    # operands on the backend's device once, outside every launch span
    tensors = {name: backend.to_device(arr) for name, arr
               in _segment_tensors(programs, seed=seed).items()}
    trials: list[dict] = []
    best = None
    for bm, bks, point in geometries:
        seg = programlib.fuse_segment(
            programs, adapts=adapts, operand_dtype=operand_dtype,
            vmem_budget=budget, bm=bm, layer_bks=bks)
        if seg is None:       # budget race: frontier said fit, refused
            continue
        measured = _measure_launches(backend, seg, tensors, iters)
        if measured is None:
            continue
        if point is not None:
            cycles, traffic = point.cycles, point.traffic_bytes
            vmem = point.vmem_bytes
        else:                 # greedy baseline: price it the same way
            cycles = perf.simulate(seg.tile_costs("minisa"),
                                   seg.cfg).cycles
            traffic = seg.kernel_hbm_bytes()
            vmem = seg.vmem_highwater_bytes()
        trial = {"bm": seg.bm, "layer_bks": list(seg.layer_bks),
                 "analytic_cycles": cycles, "traffic_bytes": traffic,
                 "vmem_bytes": vmem, **measured}
        trials.append(trial)
        if best is None or measured["median_s"] < best[0]["median_s"]:
            best = (measured, trial, seg)
    if best is None:
        return None
    measured, trial, seg = best
    winner = TunedGeometry(
        bm=seg.bm, layer_bks=tuple(seg.layer_bks),
        measured_s=measured["median_s"],
        kernel_frac=measured["kernel_frac"],
        analytic_cycles=trial["analytic_cycles"],
        traffic_bytes=trial["traffic_bytes"],
        vmem_bytes=trial["vmem_bytes"],
        n_points_measured=len(trials))
    cache.store_tuned(key, winner)
    if cache.path:
        cache.save()
    return AutotuneReport(winner=winner, trials=trials, cached=False)
