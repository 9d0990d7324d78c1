"""Execution-backend interface: how a lowered Program becomes numbers.

A :class:`Backend` consumes the tiled Program IR (``core/program.py``) and
produces the named output tensors.  Two implementations ship:

  interpreter  ``backends.interpreter.InterpreterBackend`` -- drives the
               FEATHER+ functional machine tile by tile (the semantics of
               every MINISA instruction, ``core/machine.py``)
  cuda         ``backends.cuda_backend.CudaBackend`` -- compiles the
               Program's tiling to one hand-written ``nest_gemm`` launch
               per layer (the plain PyTorch versions with
               ``device="cpu"``)

Backends are stateful across ``run_program`` calls within one instance:
chained Programs (paper §IV-G) resolve their elided/retargeted inputs
against the backend's committed outputs, exactly like the machine's
on-chip commit.  ``reset()`` clears that state.

Outputs are torch tensors on the backend's ``device``; inputs may be
tensors or numpy arrays (:meth:`Backend.to_device` moves them).  A
backend on ``device="cuda"`` (every subclass's default) raises without a
GPU.

Multi-array execution: ``run_program`` also accepts a
:class:`~repro_torch.core.program.ShardedProgram` (dispatching to
:meth:`run_sharded`).  This implementation keeps one sub-backend per
logical array -- each array is its own machine with its own buffers and
committed state, on this backend's device -- runs every shard on its
array's executor, one after another, and assembles the output
(disjoint slices along the split rank, or a sum of K-partitioned
partial products) before applying any hoisted epilogue activation.
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
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"{type(self).__name__}(device='cuda') needs a CUDA device; "
                f"pass device='cpu' to run on the CPU")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        if self.device.type == "cuda" and self.device.index is None:
            # an explicit index, so resident tensors compare equal to it
            # and ``to_device`` never copies them
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.outputs: dict[str, torch.Tensor] = {}
        #: kernel launches performed (only compiled backends bump this;
        #: the interpreter replays instructions, it does not launch)
        self.n_launches = 0
        # one executor per logical array, created on first sharded run
        self._shard_subs: dict[int, "Backend"] = {}

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
        reuse layer 0's weights).

        A :class:`~repro_torch.core.program.ShardedProgram` argument
        dispatches to :meth:`run_sharded`."""

    def run_segment(self, segment, tensors=None) -> dict[str, torch.Tensor]:
        """Execute a :class:`~repro_torch.core.program.FusedSegment`.

        ``tensors`` carries the segment input as ``'I'`` and layer l's
        weight as ``'W{l}'``.  This implementation replays the chained
        per-layer Programs on this backend (the chain semantics --
        on-chip commit, elided/retargeted inputs -- come from the
        Programs themselves), applying the runtime ``adapt`` shape glue
        at the segment's interior adapt boundaries; the CUDA backend
        overrides it with one ``fused_chain`` launch.  A
        :class:`~repro_torch.core.program.ShardedFusedSegment` dispatches
        to the per-array path."""
        from repro_torch.core.program import ShardedFusedSegment
        if isinstance(segment, ShardedFusedSegment):
            return self._run_sharded_segment(segment, tensors)
        from repro_torch.runtime.executable import adapt
        tensors = tensors or {}
        adapts = getattr(segment, "adapts", None) \
            or (False,) * len(segment.programs)
        for layer, prog in enumerate(segment.programs):
            t = {"W": tensors[f"W{layer}"]}
            if layer == 0:
                if "I" in tensors:
                    t["I"] = tensors["I"]
            elif adapts[layer]:
                prev = self.outputs[segment.programs[layer - 1].out_name]
                g = prog.gemm
                t["I"] = adapt(prev, g.m, g.k)
            elif any(op.meta.get("operand") == "I"
                     and op.meta.get("tensor") == "I"
                     for tile in prog.tiles for op in tile.loads):
                # unchained sub-programs (per-array shard chains) still
                # load the host 'I': feed the previous layer's output
                t["I"] = self.outputs[segment.programs[layer - 1].out_name]
            self.run_program(prog, t)
        return self.outputs

    def _run_sharded_segment(self, segment, tensors=None
                             ) -> dict[str, torch.Tensor]:
        """Per-array fused execution of an M-sharded chained segment:
        each array runs its row slice of the WHOLE chain on its own
        sub-backend (fused on backends that support it), so the segment
        costs n_arrays launches instead of n_arrays * n_layers."""
        tensors = tensors or {}
        out = torch.zeros((segment.m, segment.n_out), dtype=torch.float32,
                          device=self.device)
        for a, (fseg, (m0, m1)) in enumerate(
                zip(segment.array_segments, segment.row_ranges)):
            sub = self._shard_backend(a)
            before = sub.n_launches
            t = {k: v for k, v in tensors.items() if k != "I"}
            if "I" in tensors:
                t["I"] = tensors["I"][m0:m1]
            res = sub.run_segment(fseg, t)
            out[m0:m1] = res[fseg.out_name][:m1 - m0]
            self.n_launches += sub.n_launches - before
        self.outputs[segment.out_name] = out
        return self.outputs

    def run_batched_attention(self, programs, q, kT, v,
                              lengths=None) -> torch.Tensor:
        """Advance a whole decode batch through one attention segment.

        ``programs`` is the (score, value) Program pair of a dynamic
        attention segment; ``q`` is [B, m, d] stacked per-request
        carriers, ``kT`` [B, d, skv] / ``v`` [B, skv, d_o] the
        per-request gathered KV operands, ``lengths`` the per-request
        true KV lengths.  Returns the stacked [B, m, d_o] context.

        This implementation replays the chained Program pair once per
        request -- the sequential oracle the batched kernel must match.
        The Programs' in-stream softmax spans the full ``skv`` width, so
        it only accepts full-width lengths; the CUDA backend's override
        (one ``flash_decode`` launch) handles ragged batches."""
        qk, pv = programs
        skv = kT.shape[2]
        if lengths is not None:
            lens = torch.as_tensor(lengths).reshape(-1).tolist()
            if any(int(x) != skv for x in lens):
                raise ValueError(
                    f"{type(self).__name__}.run_batched_attention replays "
                    f"full-width Programs; ragged lengths {lens} need the "
                    f"cuda backend")
        outs = []
        for r in range(q.shape[0]):
            self.run_program(qk, {"I": q[r], "W": kT[r]})
            outs.append(self.run_program(pv, {"W": v[r]})[pv.out_name])
        return torch.stack([self.to_device(o) for o in outs])

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

    # -- multi-array execution ----------------------------------------------
    def _make_shard_backend(self) -> "Backend":
        """A fresh executor for one logical array, on this backend's
        device (subclasses thread their other construction kwargs
        through)."""
        return type(self)(self.cfg, device=self.device)

    def _shard_backend(self, array: int) -> "Backend":
        be = self._shard_subs.get(array)
        if be is None:
            be = self._make_shard_backend()
            self._shard_subs[array] = be
        return be

    def _shard_tensors(self, sharded, shard, tensors) -> dict:
        """The operand dict one shard runs on (its slices of 'I' and
        'W'; the CUDA backend makes them contiguous)."""
        return shard.slice_tensors(tensors)

    def run_sharded(self, sharded, tensors=None
                    ) -> dict[str, torch.Tensor]:
        """Execute every shard on its array's executor and assemble.

        M/N shards write disjoint output slices; K shards produce
        partial sums added in shard order from zeros -- the functional
        twin of the mesh all-reduce.  The hoisted epilogue activation
        (see ``program.shard_program``) runs on the assembled output.
        Launches stay on the sub-backends' counts, as in the JAX
        package (``n_launches`` of this backend does not move)."""
        g = sharded.base.gemm
        acc = torch.zeros((g.m, g.n), dtype=torch.float32,
                          device=self.device)
        for shard in sharded.shards:
            sub = self._shard_backend(shard.array)
            out = sub.run_program(shard.program,
                                  self._shard_tensors(sharded, shard,
                                                      tensors)
                                  )[sharded.out_name]
            if sharded.reduce:
                acc += out
            else:
                acc[shard.m0:shard.m1, shard.n0:shard.n1] = out
        if sharded.epilogue_act is not None:
            acc = sharded.epilogue_act(acc)
        self.outputs[sharded.out_name] = acc
        return self.outputs

    def reset(self) -> None:
        self.outputs = {}
        for sub in self._shard_subs.values():
            sub.reset()

    def __repr__(self) -> str:  # pragma: no cover
        return (f"{type(self).__name__}(ah={self.cfg.ah}, "
                f"aw={self.cfg.aw}, device={self.device})")
