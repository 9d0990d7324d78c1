"""CudaBackend: compile a lowered Program to one hand-written CUDA launch.

The counterpart of the JAX package's ``PallasBackend``
(``repro/backends/pallas_backend.py``): the Program is compiled once and
the whole tile lattice runs as a single kernel launch per layer --

  Program tiling (M_t, K_t, N_t)  ->  (bm, bk, bn) and grid, derived
                                      exactly as the Pallas backend does
                                      (``compile_program``)
  SetOVNLayout / IO-S dataflow    ->  ``out_block_t``: the kernel stores
                                      the (N, M) transposed output
  elementwise Activation drain    ->  fused into the kernel's store
                                      (``kernels.ref.ACT_FNS``); row-wise
                                      activations are applied here on the
                                      assembled output, in the
                                      accumulator orientation
  fused segment                   ->  one ``fused_chain`` launch
  sharded Program (ArrayMesh)     ->  one ``nest_gemm`` launch per shard,
                                      each on its array's sub-backend; on
                                      ranks of a process group, one a
                                      rank and an all-gather
  M-sharded fused segment         ->  one ``fused_chain`` launch per array
  batched decode attention        ->  one ``flash_decode`` launch
  ... with the Wo projection      ->  one ``flash_decode_proj`` launch

Tensors live on ``device``: ``"cuda"`` (the default) launches the
kernels and raises when there is no GPU; ``"cpu"`` runs every kernel's
plain PyTorch version instead, the counterpart of Pallas interpret mode.
Chained Programs resolve their elided/retargeted inputs against the
backend's previous outputs, mirroring the machine's on-chip commit.
"""

from __future__ import annotations

import dataclasses
import math
import weakref
from typing import TYPE_CHECKING, Any

import numpy as np
import torch

from repro_torch.backends.base import Backend
from repro_torch.core import isa
from repro_torch.core import program as programlib
from repro_torch.dist import ranks as dist_ranks
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.ref import ACT_FNS, FUSED_ACT_FNS
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.trace import trace

#: every kernel launch site increments this (labelled by kernel), so the
#: scheduler's per-instance ``n_launches`` diffs and the process-wide
#: scrape agree on what actually launched
_LAUNCHES = obs_metrics.counter(
    "backend_launches_total", "kernel launches by kernel")

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.configs.feather import FeatherConfig
    from repro_torch.core.program import Program


@dataclasses.dataclass(frozen=True)
class CompiledProgram:
    """Compilation artifact: everything needed to launch the kernel."""
    wos: bool                    # WO-S (host-oriented) vs IO-S (transposed)
    bm: int                      # host-coordinate kernel block sizes
    bk: int
    bn: int
    grid: tuple[int, int, int]   # (m blocks, n blocks, k blocks), padded
    out_block_t: bool            # transposed (N, M) output store
    fused_act: str | None        # activation fused into the kernel
    host_act: Any                # activation applied post-assembly
    input_name: str | None       # Load tensor name of the input operand
    weight_name: str             # Load tensor name of the weight operand
    out_name: str
    commit: bool                 # final Write commits on-chip (chaining)
    residency: dict[str, str]

    def describe(self) -> dict:
        return {
            "dataflow": "WOS" if self.wos else "IOS",
            "blocks": (self.bm, self.bk, self.bn),
            "grid": self.grid,
            "out_block_t": self.out_block_t,
            "fused_act": self.fused_act,
            "residency": dict(self.residency),
        }


@dataclasses.dataclass(frozen=True)
class CompiledSegment:
    """Fused-segment artifact: ONE kernel launch for a chained segment.

    Mirrors the :class:`~repro_torch.core.program.FusedSegment` geometry
    with the backend's ``max_block`` clamp applied; ``dims`` are the
    per-layer TRUE host (M, K, N) extents, ``adapts`` the in-kernel
    shape-glue boundaries.
    """
    bm: int                         # resident-activation rows per block
    layer_bks: tuple[int, ...]      # per-layer weight K tile
    acts: tuple[str | None, ...]    # per-layer in-kernel activation
    dims: tuple[tuple[int, int, int], ...]
    adapts: tuple[bool, ...]
    out_name: str

    @property
    def n_layers(self) -> int:
        return len(self.dims)

    def describe(self) -> dict:
        return {
            "n_layers": self.n_layers,
            "bm": self.bm,
            "layer_bks": self.layer_bks,
            "acts": self.acts,
            "dims": self.dims,
            "adapts": self.adapts,
        }


def compile_segment(segment, *, max_block: int = 2048) -> CompiledSegment:
    """Clamp the FusedSegment launch geometry to the backend's working-set
    bound.  One call == one fused compile (vs one per layer unfused).

    Adapt-crossing segments keep their bm unclamped: the in-kernel slab
    permutation needs every activation row resident in one M block.
    """
    for act in segment.acts:
        if act is not None and act not in FUSED_ACT_FNS:
            raise ValueError(f"activation {act!r} has no fused kernel")
    adapts = tuple(segment.adapts)
    bm = segment.bm if any(adapts) else max(1, min(segment.bm, max_block))
    return CompiledSegment(
        bm=bm,
        layer_bks=tuple(max(1, min(bk, max_block))
                        for bk in segment.layer_bks),
        acts=tuple(segment.acts),
        dims=tuple((p.gemm.m, p.gemm.k, p.gemm.n)
                   for p in segment.programs),
        adapts=adapts,
        out_name=segment.out_name)


def _load_names(program: "Program") -> tuple[str | None, str]:
    """Tensor names the Program's Loads bind to ('I' may be retargeted to a
    producer's committed output, or absent entirely when elided)."""
    input_name, weight_name = None, "W"
    for tile in program.tiles:
        for op in tile.loads:
            if op.meta.get("operand") == "I":
                input_name = op.meta["tensor"]
            elif op.meta.get("operand") == "W":
                weight_name = op.meta["tensor"]
    return input_name, weight_name


def compile_program(program: "Program", *,
                    max_block: int = 2048) -> CompiledProgram:
    """Derive the kernel launch geometry from the Program's tiling."""
    cfg = program.cfg
    snapped = programlib.snap_tiling(program.gemm, program.choice, cfg)
    if snapped is None:  # lower() would have raised already
        raise ValueError(f"infeasible program {program.choice}")
    m_t, k_t, n_t = snapped
    wos = program.choice.df == isa.Dataflow.WOS
    # search orientation -> host orientation: under IO-S the search m-rank
    # tiles host N and the search n-rank tiles host M
    if wos:
        bm_t, bk_t, bn_t = m_t, k_t, n_t
    else:
        bm_t, bk_t, bn_t = n_t, k_t, m_t

    def _block(tile_ext: int, dim: int, mode: str) -> int:
        b = min(tile_ext, dim)
        if mode == programlib.TILED:
            b = min(b, max_block)
        return max(1, min(b, max_block * 2))

    g = program.gemm
    sta_mode = program.residency["stationary"]
    str_mode = program.residency["streaming"]
    # host-M is streamed under WO-S, stationary under IO-S (and vice versa
    # for host-N); K follows the tighter of the two operands
    bm = _block(bm_t, g.m, str_mode if wos else sta_mode)
    bn = _block(bn_t, g.n, sta_mode if wos else str_mode)
    bk = _block(bk_t, g.k,
                programlib.TILED if (sta_mode == programlib.TILED
                                     or str_mode == programlib.TILED)
                else programlib.FULL)
    grid = (math.ceil(g.m / bm), math.ceil(g.n / bn), math.ceil(g.k / bk))

    fused = None
    host_act = None
    if program.activation is not None:
        if program.act_name in ACT_FNS:
            fused = program.act_name
        else:
            host_act = program.activation

    input_name, weight_name = _load_names(program)
    commit = any(op.meta.get("commit_to") is not None
                 for tile in program.tiles for op in tile.drains)
    return CompiledProgram(
        wos=wos, bm=bm, bk=bk, bn=bn, grid=grid,
        out_block_t=not wos, fused_act=fused, host_act=host_act,
        input_name=input_name, weight_name=weight_name,
        out_name=program.out_name, commit=commit,
        residency=dict(program.residency))


class CudaBackend(Backend):
    """Compiled execution: one hand-written kernel launch per Program."""

    name = "cuda"

    def __init__(self, cfg: "FeatherConfig", *, device="cuda",
                 max_block: int = 2048, compile_cache=None):
        super().__init__(cfg, device)
        self.max_block = max_block
        self._committed: torch.Tensor | None = None
        # id(program) alone would go stale once a Program is collected and
        # its id reused; keeping the Program alongside pins the id and lets
        # us verify the hit.  Bounded so a long-lived backend cannot leak.
        self._cache: dict[int, tuple["Program", CompiledProgram]] = {}
        self._fused_cache: dict[int, tuple[Any, CompiledSegment]] = {}
        self._cache_limit = 128
        # Optional shared artifact store (runtime.cache.ProgramCache):
        # keyed *structurally*, so fresh-but-equivalent Program objects
        # reuse compiled artifacts instead of recompiling.  n_compiles
        # counts the real compile_program invocations of this instance.
        self.compile_cache = compile_cache
        self.n_compiles = 0
        # contiguous copies of the column slices an N split cuts from a
        # weight: id(source) -> (weak reference, version, mesh,
        # {bounds: copy})
        self._slices: dict[int, tuple] = {}
        #: slice copies made (a resident weight's: once per shard)
        self.n_slice_copies = 0

    def compile(self, program: "Program") -> CompiledProgram:
        key = id(program)
        hit = self._cache.get(key)
        if hit is not None and hit[0] is program:
            return hit[1]
        comp = None
        if self.compile_cache is not None:
            comp = self.compile_cache.lookup_compiled(program,
                                                      self.max_block)
        if comp is None:
            with trace.span("backend.compile", out=program.out_name):
                comp = compile_program(program, max_block=self.max_block)
            self.n_compiles += 1
            if self.compile_cache is not None:
                self.compile_cache.store_compiled(program, self.max_block,
                                                  comp)
        if len(self._cache) >= self._cache_limit:
            self._cache.pop(next(iter(self._cache)))
        self._cache[key] = (program, comp)
        return comp

    def compile_fused(self, segment) -> CompiledSegment:
        """Fused-tier compile: one artifact per segment (structural key
        via the shared ProgramCache when attached)."""
        key = id(segment)
        hit = self._fused_cache.get(key)
        if hit is not None and hit[0] is segment:
            return hit[1]
        comp = None
        if self.compile_cache is not None:
            comp = self.compile_cache.lookup_fused(segment, self.max_block)
        if comp is None:
            with trace.span("backend.compile_fused",
                            n_layers=len(segment.programs)):
                comp = compile_segment(segment, max_block=self.max_block)
            self.n_compiles += 1
            if self.compile_cache is not None:
                self.compile_cache.store_fused(segment, self.max_block,
                                               comp)
        if len(self._fused_cache) >= self._cache_limit:
            self._fused_cache.pop(next(iter(self._fused_cache)))
        self._fused_cache[key] = (segment, comp)
        return comp

    def _sync(self) -> None:
        """Wait for the device (only when a traced span times a launch)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run_segment(self, segment, tensors=None):
        """ONE ``fused_chain`` launch for the whole chained segment: the
        interior activations stay in the kernel's block; only the segment
        input, the weights and the final output cross device memory.  A
        :class:`~repro_torch.core.program.ShardedFusedSegment` runs one
        such launch per array (``Backend._run_sharded_segment``)."""
        if isinstance(segment, programlib.ShardedFusedSegment):
            return self._run_sharded_segment(segment, tensors)
        comp = self.compile_fused(segment)
        self.n_launches += 1
        _LAUNCHES.inc(1, kernel="fused_chain")
        tensors = tensors or {}
        x = self._resolve("I", tensors, False)
        ws = [self._resolve(f"W{layer}", tensors, False)
              for layer in range(comp.n_layers)]
        with trace.span("launch", kernel="fused_chain",
                        n_layers=comp.n_layers, bm=comp.bm,
                        out=comp.out_name) as sp:
            out = kernel_ops.fused_chain(
                x, ws, bm=comp.bm, bks=comp.layer_bks, acts=comp.acts,
                adapts=comp.adapts, dims=comp.dims)
            if sp:
                self._sync()
                sp.set(n_launches=self.n_launches,
                       vmem_highwater_bytes=segment.vmem_highwater_bytes())
        self.outputs[comp.out_name] = out
        return self.outputs

    def run_batched_attention(self, programs, q, kT, v, lengths=None):
        """ONE ``flash_decode`` launch for the whole decode batch: every
        request's score+context GEMM pair, each row masked to its own
        true KV length.  Replaces 2*B per-request launches with one."""
        self.n_launches += 1
        _LAUNCHES.inc(1, kernel="flash_decode")
        k = self.to_device(kT).transpose(1, 2).contiguous()
        if lengths is not None:
            lengths = torch.as_tensor(np.asarray(lengths, np.int32))
        with trace.span("launch", kernel="flash_decode",
                        batch=int(q.shape[0])) as sp:
            out = kernel_ops.flash_decode(self.to_device(q), k,
                                          self.to_device(v), lengths)
            if sp:
                self._sync()
                sp.set(n_launches=self.n_launches)
        return out

    def run_batched_attention_proj(self, programs, q, kT, v, wo, *,
                                   m_out, k_out, lengths=None):
        """ONE ``flash_decode_proj`` launch: batched ragged attention
        with the adapt head-merge and the output projection in the same
        kernel.  Replaces the attention launch plus B per-request Wo
        launches."""
        self.n_launches += 1
        _LAUNCHES.inc(1, kernel="flash_decode_proj")
        k = self.to_device(kT).transpose(1, 2).contiguous()
        if lengths is not None:
            lengths = torch.as_tensor(np.asarray(lengths, np.int32))
        with trace.span("launch", kernel="flash_decode_proj",
                        batch=int(q.shape[0])) as sp:
            out = kernel_ops.flash_decode_proj(
                self.to_device(q), k, self.to_device(v), self.to_device(wo),
                lengths, m_out=m_out, k_out=k_out)
            if sp:
                self._sync()
                sp.set(n_launches=self.n_launches)
        return out

    def _resolve(self, name: str | None, tensors, elided: bool
                 ) -> torch.Tensor:
        if name is None:
            if not elided or self._committed is None:
                raise KeyError("Program has no input Load and no committed "
                               "producer output to elide from")
            return self._committed
        src = tensors.get(name) if tensors else None
        if src is None:
            src = self.outputs.get(name)
        if src is None:
            raise KeyError(f"Load refers to unknown tensor {name!r}")
        return self.to_device(src)

    def run_program(self, program: "Program", tensors=None
                    ) -> dict[str, torch.Tensor]:
        if isinstance(program, programlib.ShardedProgram):
            return self.run_sharded(program, tensors)
        comp = self.compile(program)
        self.n_launches += 1
        _LAUNCHES.inc(1, kernel="nest_gemm")
        x = self._resolve(comp.input_name, tensors, program.input_elided)
        w = self._resolve(comp.weight_name, tensors, False)
        with trace.span("launch", kernel="nest_gemm", grid=comp.grid,
                        out=comp.out_name) as sp:
            out = self._nest_gemm(comp, x, w)
            if sp:
                self._sync()
                sp.set(n_launches=self.n_launches)
        out = self._host_view(comp, out)
        self.outputs[comp.out_name] = out
        if comp.commit:
            self._committed = out
        return self.outputs

    @staticmethod
    def _nest_gemm(comp: CompiledProgram, x, w) -> torch.Tensor:
        return kernel_ops.nest_gemm(x, w, bk=comp.bk,
                                    out_block_t=comp.out_block_t,
                                    act=comp.fused_act)

    @staticmethod
    def _host_view(comp: CompiledProgram, out) -> torch.Tensor:
        """The kernel's output as the final Write presents it: under
        IO-S the kernel stored the (search-oriented) accumulator, whose
        transpose is the host-facing view; row-wise activations apply in
        the accumulator orientation."""
        if comp.host_act is not None:
            out = comp.host_act(out)
        return out.T.contiguous() if comp.out_block_t else out

    # -- multi-array execution ----------------------------------------------
    def _make_shard_backend(self) -> "CudaBackend":
        return CudaBackend(self.cfg, device=self.device,
                           max_block=self.max_block,
                           compile_cache=self.compile_cache)

    def run_sharded(self, sharded, tensors=None
                    ) -> dict[str, torch.Tensor]:
        """One ``nest_gemm`` launch a rank over the array mesh: the twin
        of the JAX package's ``shard_map`` launch.

        When ranks of a process group back the arrays
        (``ArrayMesh.device_mesh()``), rank ``a`` launches shard ``a``
        alone -- the very launch the sequential path makes for it: its
        Program's own geometry on its own slices (``shard_map`` needs one
        shape on every device and pads the split rank; ranks do not, and
        a padded K would sum in another order) -- and the output is
        assembled on every rank: M/N slices by an all-gather of pieces
        padded to the uniform per-array extent, then cropped; K partials
        by an all-gather summed in array order from zeros, as the
        sequential path sums them (a reduction's order is the
        transport's).  So every rank holds the same output, bit-equal to
        :meth:`Backend.run_sharded`'s.  The hoisted epilogue activation
        then runs on it.  Ranks past a degraded mesh's arrays launch
        nothing and receive the output from rank 0.  Without a mesh of
        ranks, or with one shard, the shards run one after another."""
        dm = sharded.mesh.device_mesh()
        if dm is None or sharded.n_shards < 2:
            return super().run_sharded(sharded, tensors)
        g = sharded.base.gemm
        n, axis = sharded.mesh.n_arrays, sharded.axis
        coord = dm.get_coordinate()
        with trace.span("launch", kernel="nest_gemm_shard_map", n_arrays=n,
                        axis=axis, out=sharded.out_name) as sp:
            if coord is not None:
                out = self._shard_launch(sharded, coord[0], tensors,
                                         dm.get_group())
            else:   # outside a degraded mesh: rank 0's output comes below
                out = torch.empty((g.m, g.n), dtype=torch.float32,
                                  device=self.device)
            if n < dist_ranks.world_size():
                out = dist_ranks.broadcast(out, src=0)
            if sp:
                sp.set(n_launches=self.n_launches)
        if sharded.epilogue_act is not None:
            out = sharded.epilogue_act(out)
        self.outputs[sharded.out_name] = out
        return self.outputs

    def _shard_launch(self, sharded, a: int, tensors, group
                      ) -> torch.Tensor:
        """Array ``a``'s launch and the gather: the assembled [m, n]
        output before the epilogue."""
        g = sharded.base.gemm
        n, axis = sharded.mesh.n_arrays, sharded.axis
        chunk = -(-{"m": g.m, "n": g.n, "k": g.k}[axis] // n)
        piece = torch.zeros({"m": (chunk, g.n), "n": (g.m, chunk),
                             "k": (g.m, g.n)}[axis],
                            dtype=torch.float32, device=self.device)
        if a < sharded.n_shards:   # a rank past a narrow GEMM's shards
            shard = sharded.shards[a]
            comp = self.compile(shard.program)
            t = self._shard_tensors(sharded, shard, tensors)
            self.n_launches += 1
            _LAUNCHES.inc(1, kernel="nest_gemm_shard_map")
            o = self._host_view(comp, self._nest_gemm(
                comp, self._resolve(comp.input_name, t, False),
                self._resolve(comp.weight_name, t, False)))
            piece[:o.shape[0], :o.shape[1]] = o
        parts = dist_ranks.all_gather(piece, group)
        if axis == "k":
            out = torch.zeros((g.m, g.n), dtype=torch.float32,
                              device=self.device)
            for p in parts:
                out += p
            return out
        return torch.cat(parts, dim=0 if axis == "m" else 1)[:g.m, :g.n]

    def _shard_tensors(self, sharded, shard, tensors) -> dict:
        """A shard's operands: its 'I' slice as ``Shard.slice_tensors``
        cuts it (the kernel wrapper copies a K split's column slice per
        call), its 'W' slice through :meth:`_weight_slice`."""
        out = shard.slice_tensors(tensors)
        if "W" in out:
            w = tensors["W"]
            if not isinstance(w, torch.Tensor):
                w = torch.from_numpy(np.ascontiguousarray(w, np.float32))
            out["W"] = self._weight_slice(w, sharded.mesh, shard)
        return out

    def _weight_slice(self, w: torch.Tensor, mesh, shard) -> torch.Tensor:
        """``w[k0:k1, n0:n1]``, contiguous float32 on this device.  A
        contiguous slice of a float32 weight on this device is a view;
        any other slice (an N split's columns, or a slice of a weight on
        the host, which moves only the slice) is copied once per source
        tensor and mesh, and kept while the source lives unmodified on
        that mesh: the entry holds the source by a weak reference (a KV
        operand, made per call, is copied per call, and its entry goes at
        the next miss), checks its identity and version counter (an
        in-place update of a weight copies it again), and is made anew
        when the source is first cut for another mesh (a failover's
        re-lowering drops the old mesh's copies)."""
        view = w[shard.k0:shard.k1, shard.n0:shard.n1]
        if (view.device == self.device and view.dtype == torch.float32
                and view.is_contiguous()):
            return view
        key = id(w)
        entry = self._slices.get(key)
        if (entry is None or entry[0]() is not w or entry[1] != w._version
                or entry[2] != mesh):
            for dead in [k for k, e in self._slices.items() if e[0]() is None]:
                del self._slices[dead]
            entry = (weakref.ref(w), w._version, mesh, {})
            self._slices[key] = entry
        bounds = (shard.k0, shard.k1, shard.n0, shard.n1)
        copy = entry[3].get(bounds)
        if copy is None:
            copy = entry[3][bounds] = torch.empty(
                view.shape, dtype=torch.float32,
                device=self.device).copy_(view)
            self.n_slice_copies += 1
        return copy

    def held_slices(self) -> dict[tuple, torch.Tensor]:
        """The weight-slice copies held for sources still alive, by
        ``(id(source), (k0, k1, n0, n1))``."""
        return {(key, bounds): copy for key, e in self._slices.items()
                if e[0]() is not None for bounds, copy in e[3].items()}

    def reset(self) -> None:
        super().reset()
        self._committed = None
        self._cache = {}
        self._fused_cache = {}
