"""MINISA core: the paper's contribution as a composable library.

Public surface:

  configs.feather.FeatherConfig / feather_config / SWEEP
  core.isa          -- the 8 MINISA instructions + bitwidths
  core.layout       -- Set*VNLayout semantics and address generation
  core.vn           -- Virtual Neuron views of operands
  core.mapping      -- ExecuteMapping/ExecuteStreaming index semantics (Eq. 1)
  core.machine      -- MINISA instruction semantics (FEATHER+ state in
                       PyTorch tensors on a device)
  core.microinst    -- micro-instruction baseline traffic model
  core.perf         -- 5-engine analytical performance model
  core.mapper       -- mapping/layout co-search (paper §V)
  core.program      -- tiled Program IR (the single lowered artifact)
  core.workloads    -- Tab. IV GEMM suite
  core.planner      -- LM model graph -> per-layer MINISA plans

Execution backends (interpreter / cuda) live in ``repro_torch.backends``;
the model runtime (ProgramCache / ModelExecutable / Scheduler) lives in
``repro_torch.runtime``.
"""

from repro_torch.core.mapper import Gemm, MappingChoice, Plan, search  # noqa: F401
from repro_torch.core.program import Program, Tile, lower  # noqa: F401
from repro_torch.core.machine import (FeatherMachine, TraceOp,  # noqa: F401
                                      run_program, run_trace)
