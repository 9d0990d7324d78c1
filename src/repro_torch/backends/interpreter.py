"""InterpreterBackend: the FEATHER+ functional machine behind the Backend
interface.

This is the orchestration loop over ``core/machine.FeatherMachine``: walk
a Program's TraceOp stream, ``step`` each instruction through the
machine, ``flush`` the batched Execute invocations at the end.  The
machine itself (``core/machine.py``) only implements instruction
semantics and architecture state, in tensors on the backend's device.

The backend keeps one machine across ``run_program`` calls, so chained
Programs (paper §IV-G on-chip commit + input elision) execute as the
architecture does: layer i's committing Write places data in the operand
buffer and layer i+1's elided input reads it from there.

It launches no hand-written kernel (``n_launches`` stays 0): it is the
port's own oracle, the trajectory the compiled ``cuda`` backend is held
to (``backends.cross_check``).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Iterable

import torch

from repro_torch.backends.base import Backend
from repro_torch.core import program as programlib
from repro_torch.core.machine import FeatherMachine
from repro_torch.obs.trace import trace

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.configs.feather import FeatherConfig
    from repro_torch.core.program import Program, TraceOp


class InterpreterBackend(Backend):
    """Tile-by-tile interpretation of the MINISA instruction stream, on
    ``device`` (``"cuda"`` by default; ``"cpu"`` for the tests)."""

    name = "interpreter"

    def __init__(self, cfg: "FeatherConfig", *, device="cuda",
                 max_depth: int | None = None):
        super().__init__(cfg, device)
        self.max_depth = max_depth
        self.machine = FeatherMachine(cfg, device=self.device,
                                      max_depth=max_depth)

    def _make_shard_backend(self) -> "InterpreterBackend":
        return InterpreterBackend(self.cfg, device=self.device,
                                  max_depth=self.max_depth)

    def run_trace(self, ops: Iterable["TraceOp"], tensors=None
                  ) -> dict[str, torch.Tensor]:
        """Drive the machine over a flat TraceOp stream."""
        m = self.machine
        with trace.span("interpret.trace"):
            for op in ops:
                m.step(op, tensors)
            m.flush()
        self.outputs = m.outputs
        return m.outputs

    def run_program(self, program: "Program", tensors=None
                    ) -> dict[str, torch.Tensor]:
        if isinstance(program, programlib.ShardedProgram):
            return self.run_sharded(program, tensors)
        return self.run_trace(program.trace_ops(), tensors)

    def reset(self) -> None:
        super().reset()
        self.machine.reset()
