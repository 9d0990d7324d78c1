"""Model-graph -> MINISA planner (the paper's ACT-ecosystem integration,
§V-A, adapted to this framework's model zoo).

The paper plugs the FEATHER+ mapper into ACT's graph-level analysis: ACT
finds layout-flexible regions, the mapper does layout-constrained search per
layer, and consecutive layers elide SetOVNLayout(i)/SetIVNLayout(i+1).

Here the "graph" is the per-layer GEMM stream of one of our assigned
architectures (see configs/<arch>.py:gemm_workloads).  The planner:

  1. runs the mapper per distinct GEMM shape (shapes repeat across layers,
     so plans are memoised -- the framework-level analogue of layout
     regions),
  2. applies the inter-layer elision as a Program-to-Program transform:
     a chained layer's Program drops its SetIVNLayout + input Load
     (``program.elide_input``), and the byte delta is measured on the
     transformed instruction stream rather than discounted by formula,
  3. aggregates instruction traffic, stall fractions, speedup, utilization
     per architecture x shape cell -- all byte counts taken from the
     lowered Programs' actual tile streams.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

from repro_torch.configs.feather import FeatherConfig
from repro_torch.core import mapper as mapperlib
from repro_torch.core import perf as perflib
from repro_torch.core import program as programlib
from repro_torch.core.mapper import Gemm


def as_gemm(op_shape) -> Gemm:
    """Normalise a workload shape to the GEMM the spine maps: ``Gemm``
    passes through, anything with ``to_gemm`` (``core.conv.Conv2D``)
    lowers via im2col (paper Fig. 1's "conv. -> MatMul")."""
    if hasattr(op_shape, "to_gemm"):
        return op_shape.to_gemm()
    return op_shape


@dataclasses.dataclass(frozen=True)
class GemmOp:
    """One GEMM (or im2col-able Conv2D) in the model graph."""
    gemm: Any               # mapper.Gemm | core.conv.Conv2D
    layer: str = ""
    chained: bool = False   # consumes the previous op's output on-chip
    activation: str = "none"
    dynamic: bool = False   # both operands arrive at runtime (attention
                            # score/value GEMMs): the "weight" is request
                            # state, not part of the cached weight set


@dataclasses.dataclass
class ArchPlan:
    arch: str
    shape: str
    cfg: FeatherConfig
    ops: list[GemmOp]
    plans: dict[tuple, mapperlib.Plan]

    # aggregates
    total_macs: float = 0.0
    cycles_minisa: float = 0.0
    cycles_micro: float = 0.0
    minisa_bytes: float = 0.0
    micro_bytes: float = 0.0
    data_bytes: float = 0.0
    elided_bytes: float = 0.0

    # multi-array serving (mesh-aware planning)
    n_arrays: int = 1
    per_array_bytes: list = dataclasses.field(default_factory=list)
    per_array_cycles: list = dataclasses.field(default_factory=list)

    @property
    def load_imbalance(self) -> float:
        return perflib.load_imbalance(self.per_array_cycles)

    @property
    def speedup(self) -> float:
        return self.cycles_micro / max(self.cycles_minisa, 1e-9)

    @property
    def instr_reduction(self) -> float:
        return self.micro_bytes / max(self.minisa_bytes, 1e-9)

    @property
    def utilization(self) -> float:
        peak = self.cfg.peak_macs_per_cycle
        return self.total_macs / max(peak * self.cycles_minisa, 1e-9)

    @property
    def instr_to_data_minisa(self) -> float:
        return self.minisa_bytes / max(self.data_bytes, 1e-9)

    @property
    def instr_to_data_micro(self) -> float:
        return self.micro_bytes / max(self.data_bytes, 1e-9)

    def summary(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape,
            "array": f"{self.cfg.ah}x{self.cfg.aw}",
            "n_gemms": sum(getattr(op.gemm, "count", 1) for op in self.ops),
            "n_unique": len(self.plans),
            "macs": self.total_macs,
            "cycles_minisa": self.cycles_minisa,
            "cycles_micro": self.cycles_micro,
            "speedup": self.speedup,
            "utilization": self.utilization,
            "instr_bytes_minisa": self.minisa_bytes,
            "instr_bytes_micro": self.micro_bytes,
            "instr_reduction": self.instr_reduction,
            "instr_to_data_minisa": self.instr_to_data_minisa,
            "instr_to_data_micro": self.instr_to_data_micro,
            "elided_bytes": self.elided_bytes,
            "n_arrays": self.n_arrays,
            "load_imbalance": self.load_imbalance,
        }


def cross_check(arch_plan: ArchPlan,
                backends: Sequence[str] = ("interpreter", "cuda"),
                max_macs: float = 2e8, seed: int = 0,
                **backend_kwargs) -> dict[tuple, dict]:
    """Execute the planned Programs on the selected backends against the
    einsum oracle (the correctness spine behind the analytic numbers).

    Every unique GEMM plan whose functional execution fits ``max_macs`` is
    run; huge layers (decode GEMMs reach billions of MACs) are skipped --
    their *mappings* are identical shape classes to the checked ones.
    Returns {(m, k, n): {backend: max_abs_err}} and raises on divergence.
    ``backend_kwargs`` reach every backend (``device="cpu"`` for the
    plain versions).
    """
    import numpy as np

    from repro_torch import backends as backendlib

    rng = np.random.default_rng(seed)
    out: dict[tuple, dict] = {}
    for key, plan in arch_plan.plans.items():
        g = plan.gemm
        if g.macs > max_macs:
            continue
        tensors = {
            "I": rng.standard_normal((g.m, g.k)).astype(np.float32),
            "W": rng.standard_normal((g.k, g.n)).astype(np.float32),
        }
        out[key] = backendlib.cross_check(plan.program, tensors,
                                          backends=tuple(backends),
                                          **backend_kwargs)
    return out


def plan_model(arch: str, shape: str, ops: Sequence[GemmOp],
               cfg: FeatherConfig, cache=None, mesh=None) -> ArchPlan:
    """Plan a cell's GEMM stream.

    Mapper searches are memoised through a
    :class:`repro_torch.runtime.cache.ProgramCache` (the process default unless
    ``cache`` is given), so the planner, the benchmarks and the runtime
    executables share one search/lowering memoisation; ``ArchPlan.plans``
    remains this cell's view of the distinct shapes it used.

    ``mesh`` (a ``dist.ArrayMesh``) plans the cell for multi-array
    serving: every Program is sharded across the mesh, per-GEMM cycles
    are the slowest array's (arrays run in parallel), instruction bytes
    sum over arrays, and the per-array aggregates / load imbalance land
    in the ArchPlan.  Inter-layer elision is per-array machine state and
    does not cross the mesh boundary, so chained ops stop eliding."""
    from repro_torch.runtime.cache import default_cache
    cache = cache if cache is not None else default_cache()
    plans: dict[tuple, mapperlib.Plan] = {}
    elided_cache: dict[tuple, float] = {}
    mesh_cache: dict[tuple, tuple] = {}
    n_arrays = mesh.n_arrays if mesh is not None else 1
    out = ArchPlan(arch=arch, shape=shape, cfg=cfg, ops=list(ops),
                   plans=plans, n_arrays=n_arrays,
                   per_array_bytes=[0.0] * n_arrays,
                   per_array_cycles=[0.0] * n_arrays)
    for op in ops:
        g = as_gemm(op.gemm)
        key = (g.m, g.k, g.n)
        if key not in plans:
            plans[key] = cache.plan(g, cfg)
        plan = plans[key]
        prog = plan.program
        count = getattr(g, "count", 1)
        out.total_macs += g.macs * count
        if n_arrays > 1:
            if key not in mesh_cache:
                sharded = cache.sharded(prog, mesh)
                mesh_cache[key] = (
                    sharded,
                    perflib.simulate_sharded(sharded, cfg, "minisa"),
                    perflib.simulate_sharded(sharded, cfg, "micro"))
            sharded, mesh_minisa, mesh_micro = mesh_cache[key]
            out.cycles_minisa += mesh_minisa.cycles * count
            out.cycles_micro += mesh_micro.cycles * count
            bytes_per = sharded.per_array_minisa_bytes()
            for i, (b, r) in enumerate(zip(bytes_per,
                                           mesh_minisa.per_array)):
                out.per_array_bytes[i] += b * count
                out.per_array_cycles[i] += r.cycles * count
            out.minisa_bytes += sum(bytes_per) * count
        else:
            out.cycles_minisa += plan.perf_minisa.cycles * count
            out.cycles_micro += plan.perf_micro.cycles * count
            minisa_b = prog.minisa_bytes()
            if op.chained:
                if key not in elided_cache:
                    chained_prog = programlib.elide_input(prog)
                    elided_cache[key] = chained_prog.minisa_bytes()
                chained_b = elided_cache[key]
                out.elided_bytes += max(0.0, minisa_b - chained_b) * count
                minisa_b = chained_b
            out.minisa_bytes += minisa_b * count
        out.micro_bytes += prog.micro_storage_bytes() * count
        out.data_bytes += g.data_bytes * count
    return out
