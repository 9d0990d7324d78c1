"""Execution-backend interface: how a lowered Program becomes numbers.

A :class:`Backend` consumes the tiled Program IR (``core/program.py``) and
produces the named output tensors.  One implementation ships so far:

  cuda   ``backends.cuda_backend.CudaBackend`` -- compiles the Program's
         tiling to one hand-written ``nest_gemm`` launch per layer (the
         plain PyTorch versions with ``device="cpu"``)

Backends are stateful across ``run_program`` calls within one instance:
chained Programs (paper §IV-G) resolve their elided/retargeted inputs
against the backend's committed outputs, exactly like the machine's
on-chip commit.  ``reset()`` clears that state.

Outputs are torch tensors on the backend's ``device``; inputs may be
tensors or numpy arrays (:meth:`Backend.to_device` moves them).  The
multi-array (sharded) path is not ported yet.
"""

from __future__ import annotations

import abc
from typing import TYPE_CHECKING

import numpy as np
import torch

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.configs.feather import FeatherConfig
    from repro_torch.core.program import Program


class Backend(abc.ABC):
    """Common interface over Program executors."""

    #: registry key; subclasses override
    name: str = "abstract"

    def __init__(self, cfg: "FeatherConfig", device="cpu"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.outputs: dict[str, torch.Tensor] = {}
        #: kernel launches performed
        self.n_launches = 0

    def to_device(self, arr) -> torch.Tensor:
        """``arr`` (tensor or array) as a float32 tensor on ``device``."""
        if isinstance(arr, torch.Tensor):
            return arr.to(device=self.device, dtype=torch.float32)
        return torch.from_numpy(
            np.ascontiguousarray(arr, dtype=np.float32)).to(self.device)

    @abc.abstractmethod
    def run_program(self, program: "Program", tensors=None
                    ) -> dict[str, torch.Tensor]:
        """Execute one lowered Program; returns all named outputs so far.

        Chained layer sequences (``program.chain``) are executed with one
        ``run_program`` call per layer on the same backend instance,
        passing each layer's own tensors (the default lowering names every
        layer's weight Load 'W', so a single shared dict would silently
        reuse layer 0's weights)."""

    @abc.abstractmethod
    def run_segment(self, segment, tensors=None) -> dict[str, torch.Tensor]:
        """Execute a :class:`~repro_torch.core.program.FusedSegment` as
        one launch.  ``tensors`` carries the segment input as ``'I'`` and
        layer l's weight as ``'W{l}'``."""

    @abc.abstractmethod
    def run_batched_attention(self, programs, q, kT, v,
                              lengths=None) -> torch.Tensor:
        """Advance a whole decode batch through one attention segment.

        ``programs`` is the (score, value) Program pair of a dynamic
        attention segment; ``q`` is [B, m, d] stacked per-request
        carriers, ``kT`` [B, d, skv] / ``v`` [B, skv, d_o] the
        per-request gathered KV operands, ``lengths`` the per-request
        true KV lengths.  Returns the stacked [B, m, d_o] context."""

    def run_batched_attention_proj(self, programs, q, kT, v, wo, *,
                                   m_out: int, k_out: int,
                                   lengths=None) -> torch.Tensor:
        """Block-fused decode attention: the attention pair PLUS the
        adapt-cycled output projection ``wo`` for every request.

        This implementation replays :meth:`run_batched_attention` and
        applies the runtime ``adapt`` + GEMM per request -- the oracle for
        the compiled override, which folds the projection into the same
        launch as the attention.  Returns [B, m_out, n_out]."""
        from repro_torch.runtime.executable import adapt
        ctx = self.run_batched_attention(programs, q, kT, v,
                                         lengths=lengths)
        wo = self.to_device(wo)
        return torch.stack([adapt(ctx[r], m_out, k_out) @ wo
                            for r in range(ctx.shape[0])])

    def reset(self) -> None:
        self.outputs = {}

    def __repr__(self) -> str:  # pragma: no cover
        return (f"{type(self).__name__}(ah={self.cfg.ah}, "
                f"aw={self.cfg.aw}, device={self.device})")
