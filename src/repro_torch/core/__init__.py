"""MINISA core: the paper's contribution as a composable library.

Public surface:

  configs.feather.FeatherConfig / feather_config / SWEEP
  core.isa          -- the 8 MINISA instructions + bitwidths
  core.layout       -- Set*VNLayout semantics and address generation
  core.microinst    -- micro-instruction baseline traffic model
  core.perf         -- 5-engine analytical performance model
  core.mapper       -- mapping/layout co-search (paper §V)
  core.program      -- tiled Program IR (the single lowered artifact)
  core.workloads    -- Tab. IV GEMM suite
  core.planner      -- LM model graph -> per-layer MINISA plans

The CUDA execution backend lives in ``repro_torch.backends``; the model
runtime (ProgramCache / ModelExecutable / Scheduler) lives in
``repro_torch.runtime``.  The functional machine (``core.machine``,
``core.vn``, ``core.mapping``) is not ported yet.
"""

from repro_torch.core.mapper import Gemm, MappingChoice, Plan, search  # noqa: F401
from repro_torch.core.program import Program, Tile, lower  # noqa: F401
