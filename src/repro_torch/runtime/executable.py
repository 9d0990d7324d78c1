"""ModelExecutable: a whole model's GEMM stream, lowered once, runnable.

``core/planner.py`` *plans* an (architecture x shape) cell analytically;
this module makes the same cell *run*: the cell's ``GemmOp`` stream
(``core/model_gemms.gemm_workloads``) is lowered once -- through the shared
:class:`~repro_torch.runtime.cache.ProgramCache` -- into a chained sequence of
Programs, and executed end-to-end with real numerics on any ``Backend``,
cross-checked step by step against an einsum oracle of the identical
stream.

Stream semantics
----------------
Each ``GemmOp`` becomes one :class:`Step` (repeated layers execute one
representative instance; ``reps`` carries the multiplicity into the
traffic accounting, exactly like the planner's analytic aggregates).  A
step's input operand comes from one of three sources:

  wired   the op is ``chained`` and the producer's output shape equals
          the consumer's input shape: the pair joins one
          ``program.chain`` segment (paper §IV-G on-chip commit + input
          elision / named-output retarget) -- no host round trip.
  adapt   the op is ``chained`` but the shapes differ (the model's
          head-split/reshape between projections and attention): the
          producer's *numbers* still feed the consumer, through the
          deterministic host glue :func:`adapt` that the oracle replays.
  fresh   not chained: a seeded host tensor.

Weight operands are host tensors per step -- except ops flagged
``dynamic`` (the attention score/value GEMMs, FEATHER+'s headline
runtime-layout case), whose "weights" (K^T / V) are runtime tensors
supplied per request by the serving scheduler, not part of the cached
weight set.

Fused segments: consecutive ``wired`` steps form a :class:`Segment`;
when the whole chain is fusion-legal (``program.fuse_segment``) the
segment carries a ``FusedSegment`` and ``run(fused=True)`` executes it
as ONE backend kernel launch -- interior activations never leave the
chip, the serving scheduler's decode fast path runs on this, and
``fusion_stats`` reports the elided HBM traffic.

Activations run inside the Program (Activation drain, fused by the
CUDA backend where elementwise) whenever that is semantics-preserving:
elementwise always; row-wise (softmax/norms) only under WO-S with full
output rows per tile.  Anything else is applied between Programs, which
also breaks the chain there (the oracle mirrors both paths).

Tensors are torch tensors on the backend's device: each run moves
its tensor dict there once (resident weights pass through), and the
carriers it returns stay there.

Multi-array serving: with a ``dist.ArrayMesh`` (``mesh=``), every
step's Program is sharded across the mesh (``ProgramCache.sharded``) and
executed via the backends' sharded path.  On-chip chaining is per-array
machine state and does not cross the mesh boundary, so sharded streams
feed each wired step its producer's output explicitly.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.core import isa, perf
from repro_torch.core import program as programlib
from repro_torch.core.planner import GemmOp, as_gemm
from repro_torch.kernels.ref import FUSED_ACT_FNS
from repro_torch.obs.trace import trace
from repro_torch.runtime.cache import ProgramCache, default_cache


# ---------------------------------------------------------------------------
# Activation registry (numeric twins of the ISA's Activation functions)
# ---------------------------------------------------------------------------

def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))


def _act(fn):
    return lambda x: fn(_as_tensor(x))


#: act_name -> callable on tensors (arrays are taken too).  The
#: elementwise entries match the kernels' fused ``kernels.ref.ACT_FNS``
#: numerics (gelu is the tanh approximation); the gated activations
#: (swiglu/geglu) are approximated by their ungated halves -- the GEMM
#: stream carries no gate operand (DESIGN.md arch-applicability).
ACTIVATIONS: dict[str, Callable | None] = {
    "none": None,
    "relu": _act(FUSED_ACT_FNS["relu"]),
    "gelu": _act(FUSED_ACT_FNS["gelu"]),
    "silu": _act(FUSED_ACT_FNS["silu"]),
    "swiglu": _act(FUSED_ACT_FNS["silu"]),
    "geglu": _act(FUSED_ACT_FNS["gelu"]),
    "softmax": _act(FUSED_ACT_FNS["softmax"]),
    "rmsnorm": _act(FUSED_ACT_FNS["rmsnorm"]),
    "layernorm": _act(FUSED_ACT_FNS["layernorm"]),
}


def adapt(x, m: int, k: int) -> torch.Tensor:
    """Deterministic host glue between shape-incompatible chained layers
    (the reshape/head-split the GEMM-stream abstraction elides): flatten,
    cycle-extend, reshape to the consumer's [m, k].  Stays on ``x``'s
    device."""
    flat = _as_tensor(x).reshape(-1)
    need = m * k
    if flat.numel() == 0:
        return torch.zeros((m, k), dtype=torch.float32, device=flat.device)
    if flat.numel() < need:
        flat = flat.repeat(-(-need // flat.numel()))
    return flat[:need].reshape(m, k).contiguous()


def tensors_from_numpy(env: dict, device) -> dict[str, torch.Tensor]:
    """A tensor dict (numpy arrays, e.g. the JAX package's
    ``make_tensors``) as float32 tensors on ``device``."""
    return {name: torch.from_numpy(np.ascontiguousarray(
                arr, dtype=np.float32)).to(device)
            for name, arr in env.items()}


#: normals drawn per chunk by ``make_tensors`` (bounds the float64 buffer
#: at full width, where lm_head alone is 786M elements)
_DRAW_CHUNK = 1 << 24


def _draw(rng: np.random.Generator, shape, scale_rows: bool) -> np.ndarray:
    """``rng.standard_normal(shape).astype(np.float32)`` (divided by
    sqrt(rows) for weights), drawn in chunks: a Generator's normal stream
    does not depend on how the draws are split, so the values are
    bit-equal to one draw."""
    n = int(np.prod(shape))
    out = np.empty(n, np.float32)
    for i in range(0, n, _DRAW_CHUNK):
        chunk = rng.standard_normal(min(_DRAW_CHUNK, n - i)).astype(
            np.float32)
        if scale_rows:
            chunk /= np.sqrt(shape[0])
        out[i:i + chunk.size] = chunk
    return out.reshape(shape)


def _skip(rng: np.random.Generator, shape) -> None:
    """Advance ``rng`` past the normals of a tensor that is not wanted."""
    n = int(np.prod(shape))
    for i in range(0, n, _DRAW_CHUNK):
        rng.standard_normal(min(_DRAW_CHUNK, n - i))


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Step:
    """One executable GEMM of the stream (one representative instance)."""
    index: int
    op: GemmOp
    program: programlib.Program     # executed (possibly chain-rewired)
    input_mode: str                 # 'wired' | 'adapt' | 'fresh'
    host_act: Callable | None       # applied host-side after the Program
    reps: int                       # multiplicity for traffic accounting
    sharded: programlib.ShardedProgram | None = None   # multi-array form

    @property
    def weight_name(self) -> str:
        return f"W{self.index}"

    @property
    def input_name(self) -> str:
        return f"I{self.index}"


@dataclasses.dataclass
class Segment:
    """A maximal chained run of steps, possibly spanning adapt breaks.

    ``fused`` carries the one-kernel-launch geometry when the whole
    segment is fusion-legal (``program.fuse_segment``): ``wired`` chains
    with kernel-applicable activations, joined across interior ``adapt``
    (head split/merge) boundaries -- the streamed megakernel lowers the
    shape glue to an in-kernel slab permutation, so a whole transformer
    block runs as one launch.  On a mesh, ``fused`` may instead be a
    :class:`~repro_torch.core.program.ShardedFusedSegment` (fused WITHIN each
    array when the run is M-sharded with aligned rows -- the mesh only
    forbids fusing *across* arrays).  Everything else falls back to the
    per-Program path automatically.
    """
    indices: list[int]                            # step indices, in order
    fused: programlib.FusedSegment | None = None

    @property
    def n_steps(self) -> int:
        return len(self.indices)


@dataclasses.dataclass
class BatchSegment:
    """One segment of the M-polymorphic batched-decode plan.

    kind 'static':    weight-stationary segment re-lowered at the M
                      bucket (same MappingChoice, so the K accumulation
                      order matches the per-request path); every active
                      request's rows stack along M and advance in ONE
                      launch (``fused`` when fusion-legal, else the
                      bucketed chained per-layer Programs).
    kind 'attention': the dynamic score+context pair; per-request KV
                      rides in as stacked operands and the backend's
                      ``run_batched_attention`` advances the whole batch
                      in one launch (flash_decode on the CUDA backend).
    kind 'perreq':    anything the bucketed lowering cannot express --
                      sequential per-request replay, bit-identical to
                      the unbatched path.
    """
    kind: str                          # 'static' | 'attention' | 'perreq'
    indices: list[int]                 # step indices of the segment
    programs: list                     # bucketed Programs / (score, ctx)
    fused: programlib.FusedSegment | None = None
    host_act: Callable | None = None   # last step's host-side activation
    m_rows: int = 1                    # per-request rows through the seg


@dataclasses.dataclass
class BatchPlan:
    """Batched-decode execution plan for one M bucket."""
    bucket: int
    segments: list[BatchSegment]

    @property
    def launches_per_tick(self) -> int | None:
        """Backend launches one tick costs, or None if a per-request
        fallback segment makes it batch-size-dependent."""
        total = 0
        for seg in self.segments:
            if seg.kind == "perreq":
                return None
            if seg.kind == "static" and seg.fused is None:
                total += len(seg.programs)
            else:
                total += 1
        return total


@dataclasses.dataclass
class RunResult:
    outputs: list[torch.Tensor]     # per-step outputs (post host_act);
                                    # interior steps of a fused segment
                                    # stay on-chip and report None
    final: torch.Tensor
    checked: bool = False
    fused_segments: int = 0         # segments executed as one kernel


#: Reduced shapes sized for functional end-to-end execution (the SHAPES
#: cells target analytic planning; running decode_32k numerically is not
#: the point of a CPU correctness spine).
TINY_SHAPES = {
    "prefill_tiny": ShapeConfig("prefill_tiny", seq_len=16, global_batch=2,
                                kind="prefill"),
    "decode_tiny": ShapeConfig("decode_tiny", seq_len=16, global_batch=1,
                               kind="decode"),
}


class ModelExecutable:
    """A cell's GEMM stream compiled (through the shared cache) into
    chained Programs, executable on any backend against the oracle."""

    def __init__(self, ops: list[GemmOp], cfg, *,
                 cache: ProgramCache | None = None, name: str = "model",
                 mesh=None):
        self.cfg = cfg
        self.cache = cache if cache is not None else default_cache()
        self.name = name
        # normalise Conv2D (or any to_gemm-able) ops: the whole stream
        # machinery (tensor specs, wiring, oracle) speaks GEMM shapes
        self.ops = [dataclasses.replace(op, gemm=as_gemm(op.gemm))
                    if hasattr(op.gemm, "to_gemm") else op
                    for op in ops]
        self.tokens: int | None = None   # set by for_cell
        # multi-array serving: a dist.ArrayMesh shards every step across
        # the arrays (None / 1 array == the single-array pipeline)
        self.mesh = mesh if mesh is not None and mesh.n_arrays > 1 else None
        self.segments: list[Segment] = []
        with trace.span("executable.build", model=name,
                        n_ops=len(self.ops)):
            self.steps = self._build()
        self._perf_cache: dict[int, tuple] = {}
        self._fusion_stats: dict | None = None
        self._batch_plans: dict[int, BatchPlan] = {}

    def remesh(self, mesh) -> None:
        """Rebuild the stream onto a different ArrayMesh in place --
        the degraded-mesh failover path.  Cache keys carry the mesh
        shape, so this is a cache-miss re-lower through ``shard_program``
        (plans and lowered Programs all hit), not new machinery; perf
        and batch-plan caches reset because per-array accounting
        changed.  ``mesh=None`` (or one array) falls back to the
        unsharded single-array pipeline."""
        self.mesh = mesh if mesh is not None and mesh.n_arrays > 1 else None
        self.segments = []
        with trace.span("executable.remesh", model=self.name,
                        n_arrays=self.n_arrays):
            self.steps = self._build()
        self._perf_cache = {}
        self._fusion_stats = None
        self._batch_plans = {}

    # -- construction --------------------------------------------------------
    @classmethod
    def for_cell(cls, arch: str, shape: str | ShapeConfig, cfg, *,
                 cache: ProgramCache | None = None,
                 reduce_model: bool = True, layers: int = 2,
                 d_model: int = 64, vocab: int = 256,
                 mesh=None) -> "ModelExecutable":
        """Build the executable for an (architecture x shape) cell.

        ``reduce_model`` shrinks the architecture family-preservingly
        (``configs.base.reduced``) so the stream executes functionally on
        CPU; ``shape`` accepts the planning SHAPES, the TINY_SHAPES
        serving cells, or an explicit ShapeConfig."""
        from repro_torch.configs.base import reduced
        from repro_torch.configs.registry import get_config
        from repro_torch.core.model_gemms import gemm_workloads

        mcfg = get_config(arch)
        if reduce_model:
            mcfg = reduced(mcfg, layers=layers, d_model=d_model, vocab=vocab)
        if isinstance(shape, ShapeConfig):
            scfg = shape
        else:
            scfg = {**SHAPES, **TINY_SHAPES}[shape]
        ex = cls(gemm_workloads(mcfg, scfg), cfg, cache=cache,
                 name=f"{arch}/{scfg.name}", mesh=mesh)
        ex.tokens = (scfg.global_batch if scfg.kind == "decode"
                     else scfg.tokens)
        return ex

    def _build(self) -> list[Step]:
        cache = self.cache
        base: list[tuple[GemmOp, Any, programlib.Program,
                         Callable | None]] = []
        for i, op in enumerate(self.ops):
            plan = cache.plan(op.gemm, self.cfg)
            act_name = op.activation or "none"
            fn = ACTIVATIONS.get(act_name)
            in_program = fn is not None and (
                act_name not in programlib.ROW_WISE_ACTIVATIONS
                or (plan.choice.df == isa.Dataflow.WOS
                    and plan.program.n_n == 1))
            prog = cache.lower(
                plan.gemm, plan.choice, self.cfg,
                activation=fn if in_program else None,
                act_name=act_name if in_program else "none",
                out_name=f"O{i}")
            base.append((op, plan, prog,
                         None if in_program else fn))

        steps: list[Step] = []
        segment: list[tuple] = []
        modes: list[str] = []

        def flush():
            if not segment:
                return
            progs = [e[2] for e in segment]
            # on-chip commit / input elision is per-array machine state;
            # a mesh-sharded stream keeps every layer's host round trip
            # ('wired' steps feed the producer's output back as 'I')
            if len(progs) > 1 and self.mesh is None:
                # chain each maximal wired sub-run; interior adapt
                # boundaries keep their host-shaped input Program (the
                # fused kernel lowers the shape glue to an in-kernel
                # slab permutation; the per-step fallback adapts
                # host-side)
                chained: list = []
                start = 0
                for i in range(1, len(progs) + 1):
                    if i == len(progs) or modes[i] != "wired":
                        sub = progs[start:i]
                        chained.extend(
                            programlib.chain(sub, lower_fn=cache.lower)
                            if len(sub) > 1 else sub)
                        start = i
                progs = chained
            first = len(steps)
            shardeds = []
            for (op, _, _, host_act), prog, mode in zip(segment, progs,
                                                        modes):
                sharded = (self.cache.sharded(prog, self.mesh)
                           if self.mesh is not None else None)
                shardeds.append(sharded)
                steps.append(Step(index=len(steps), op=op, program=prog,
                                  input_mode=mode, host_act=host_act,
                                  reps=max(1, getattr(op.gemm, "count", 1)),
                                  sharded=sharded))
            fused = None
            if len(progs) > 1:
                if self.mesh is None:
                    # interior adapt boundaries fuse as in-kernel
                    # permutations; the FIRST step's adapt (if any) is
                    # applied host-side to the segment input
                    adapts = (False,) + tuple(
                        m == "adapt" for m in modes[1:])
                    fused = self._fuse_with_tuned(progs, adapts)
                elif all(s is not None for s in shardeds):
                    # fuse WITHIN each array: legal when the whole run
                    # is M-sharded with aligned rows (mesh segments
                    # contain only wired sub-runs by construction)
                    fused = programlib.fuse_sharded_segment(shardeds)
            self.segments.append(
                Segment(indices=list(range(first, len(steps))),
                        fused=fused))
            segment.clear()
            modes.clear()

        prev: tuple[GemmOp, Callable | None] | None = None
        for entry in base:
            op, _, _, host_act = entry
            g = op.gemm
            wired = (prev is not None and op.chained
                     and prev[1] is None       # host act breaks the chain
                     and (prev[0].gemm.m, prev[0].gemm.n) == (g.m, g.k))
            # a chained shape break (head split/merge) no longer flushes:
            # the segment continues across the adapt boundary and the
            # fused kernel swallows the reshape (single-array streams
            # only -- per-array residency stops at the mesh boundary)
            adaptable = (not wired and prev is not None and op.chained
                         and prev[1] is None and self.mesh is None)
            if not (wired or adaptable):
                flush()
            segment.append(entry)
            modes.append("wired" if wired
                         else "adapt" if (op.chained and prev is not None)
                         else "fresh")
            prev = (op, host_act)
        flush()
        return steps

    def _fuse_with_tuned(self, progs,
                         adapts: tuple[bool, ...] | None = None):
        """Fused launch geometry for a chained run, preferring a
        measured autotune winner (the ProgramCache tuned tier --
        ``runtime.autotune``) over the greedy-then-snap default: a
        serving process sharing a warmed cache consumes the tuned
        geometry at build time, with zero searches and zero re-tuning."""
        fused = programlib.fuse_segment(progs, adapts=adapts)
        if fused is None:
            return None
        tg = self.cache.tuned_geometry(progs, adapts=adapts)
        if tg is not None:
            tuned = programlib.fuse_segment(
                progs, adapts=adapts, bm=tg.bm, layer_bks=tg.layer_bks)
            if tuned is not None:
                return tuned
        return fused

    # -- tensor environment ---------------------------------------------------
    def tensor_specs(self) -> dict[str, tuple[tuple[int, int], str]]:
        """name -> (shape, kind); kind in {'weight', 'dynamic', 'input'}.
        ``dynamic`` marks runtime-supplied operands (attention K^T / V)."""
        specs: dict[str, tuple[tuple[int, int], str]] = {}
        for s in self.steps:
            g = s.op.gemm
            specs[s.weight_name] = ((g.k, g.n),
                                    "dynamic" if s.op.dynamic else "weight")
            if s.input_mode == "fresh":
                specs[s.input_name] = ((g.m, g.k), "input")
        return specs

    def make_tensors(self, seed: int = 0,
                     kinds: tuple[str, ...] = ("weight", "dynamic", "input")
                     ) -> dict[str, np.ndarray]:
        """Seeded host tensors; weights scaled 1/sqrt(k) so chained layer
        magnitudes stay O(1) across the stream.  Bit-equal to the JAX
        package's draw: the specs are drawn in the same order from the
        same ``default_rng(seed)``, and the draw stops after the last
        spec of a requested kind (an identical prefix of the stream)."""
        rng = np.random.default_rng(seed)
        specs = list(self.tensor_specs().items())
        last = max((i for i, (_, (_, kind)) in enumerate(specs)
                    if kind in kinds), default=-1)
        out: dict[str, np.ndarray] = {}
        for name, (shape, kind) in specs[:last + 1]:
            if kind in kinds:
                out[name] = _draw(rng, shape, kind != "input")
            else:
                _skip(rng, shape)
        return out

    def inputs_from(self, x) -> dict[str, torch.Tensor]:
        """Fresh-input tensors derived from a carrier array (the serving
        scheduler feeds each decode step from the previous step's
        output)."""
        return {s.input_name: adapt(x, s.op.gemm.m, s.op.gemm.k)
                for s in self.steps if s.input_mode == "fresh"}

    # -- execution ------------------------------------------------------------
    def make_backend(self, backend, device="cuda"):
        """A backend for this stream: a registry name (built on
        ``device``; the compiled backend shares this executable's
        ProgramCache) or a live ``Backend`` instance, passed through."""
        from repro_torch import backends as backendlib
        if not isinstance(backend, str):
            return backend
        kwargs = {"device": device}
        if backend == "cuda":
            kwargs["compile_cache"] = self.cache
        return backendlib.get_backend(backend, self.cfg, **kwargs)

    def _env(self, be, tensors, seed: int) -> dict[str, torch.Tensor]:
        """``tensors`` completed from the seeded draw, on ``be``'s
        device (resident weights pass through without a copy)."""
        env = dict(tensors) if tensors else {}
        missing = {kind for name, (_, kind) in self.tensor_specs().items()
                   if name not in env}
        if missing:
            for name, arr in self.make_tensors(seed, tuple(missing)).items():
                env.setdefault(name, arr)
        return {name: be.to_device(arr) for name, arr in env.items()}

    def run(self, backend="cuda", *, tensors=None, seed: int = 0,
            check: bool = False, rtol: float = 2e-3,
            atol: float = 2e-3, fused: bool = False,
            device="cuda") -> RunResult:
        """Execute the stream end-to-end.

        ``backend`` is a registry name (built on ``device``) or a live
        ``Backend`` instance (the scheduler reuses one across requests).
        ``tensors`` supplies any subset of :meth:`tensor_specs`; missing
        entries are seeded.  ``check=True`` asserts every step against
        the einsum-oracle replay of the identical stream (on the CPU).

        ``fused=True`` executes every fusion-legal segment as ONE backend
        kernel launch (``Backend.run_segment``): interior activations stay
        on-chip, so interior steps report ``None`` in ``outputs``; the
        oracle check still verifies every fused segment's final output
        against the step-by-step einsum replay.  Segments without a fused
        form take the per-Program path unchanged."""
        be = self.make_backend(backend, device)
        env = self._env(be, tensors, seed)
        # the oracle replays on the CPU, outside every kernel
        cpu = {name: t.cpu() for name, t in env.items()} if check else {}

        prev: torch.Tensor | None = None
        ref_prev: torch.Tensor | None = None
        outputs: list[torch.Tensor | None] = [None] * len(self.steps)
        n_fused = 0

        def seg_input(first: Step, carrier, env):
            g = first.op.gemm
            if first.input_mode == "fresh":
                return env[first.input_name]
            if first.input_mode == "adapt":
                return adapt(carrier, g.m, g.k)
            return carrier

        def assert_close(out, ref, k, msg):
            np.testing.assert_allclose(
                out.cpu().numpy(), ref.numpy(), rtol=rtol,
                atol=atol + rtol * k, err_msg=msg)

        for seg in self.segments:
            steps = [self.steps[i] for i in seg.indices]
            if fused and seg.fused is not None:
                first, last = steps[0], steps[-1]
                t = {"I": seg_input(first, prev, env)}
                for j, s in enumerate(steps):
                    t[f"W{j}"] = env[s.weight_name]
                with trace.span("segment", kind="fused",
                                n_steps=len(steps),
                                first=steps[0].index):
                    out = be.run_segment(seg.fused, t)[seg.fused.out_name]
                if last.host_act is not None:
                    out = last.host_act(out)
                if check:
                    ref = seg_input(first, ref_prev, cpu)
                    for j, s in enumerate(steps):
                        if j > 0 and s.input_mode == "adapt":
                            ref = adapt(ref, s.op.gemm.m, s.op.gemm.k)
                        ref = ref @ cpu[s.weight_name]
                        if s.program.activation is not None:
                            ref = s.program.activation(ref)
                        if s.host_act is not None:
                            ref = s.host_act(ref)
                    k_max = max(s.op.gemm.k for s in steps)
                    assert_close(out, ref, k_max,
                                 f"fused segment at steps {seg.indices} "
                                 f"diverged from the stream oracle")
                    ref_prev = ref
                outputs[last.index] = out
                prev = out
                n_fused += 1
                continue
            for s in steps:
                g = s.op.gemm
                w = env[s.weight_name]
                t: dict[str, torch.Tensor] = {"W": w}
                if s.input_mode == "fresh":
                    t["I"] = env[s.input_name]
                elif s.input_mode == "adapt":
                    t["I"] = adapt(prev, g.m, g.k)
                elif s.input_mode == "wired" and s.sharded is not None:
                    # sharded streams do not chain on-chip: the producer's
                    # output crosses the array boundary explicitly
                    t["I"] = prev
                with trace.span("segment", kind="per_step", step=s.index):
                    out = be.run_program(
                        s.sharded if s.sharded is not None else s.program,
                        t)[s.program.out_name]
                if s.host_act is not None:
                    out = s.host_act(out)
                if check:
                    if s.input_mode == "fresh":
                        ref_x = cpu[s.input_name]
                    elif s.input_mode == "adapt":
                        ref_x = adapt(ref_prev, g.m, g.k)
                    else:
                        ref_x = ref_prev
                    ref = ref_x @ cpu[s.weight_name]
                    if s.program.activation is not None:
                        ref = s.program.activation(ref)
                    if s.host_act is not None:
                        ref = s.host_act(ref)
                    assert_close(out, ref, g.k,
                                 f"step {s.index} ({g.name or g}) diverged "
                                 f"from the stream oracle")
                    ref_prev = ref
                outputs[s.index] = out
                prev = out
        return RunResult(outputs=outputs, final=prev, checked=check,
                         fused_segments=n_fused)

    # -- cross-request batched execution (M-polymorphic segments) -------------
    def batch_plan(self, n_requests: int) -> BatchPlan:
        """The M-polymorphic plan serving ``n_requests`` stacked rows.

        Bucketed to :func:`program.m_bucket` so thousands of batch
        compositions share a handful of compiled artifacts; plans are
        memoised per bucket and their Programs flow through the shared
        ProgramCache like every other lowering."""
        if self.mesh is not None:
            raise ValueError("batched decode requires a single-array "
                             "stream; mesh-sharded streams schedule "
                             "per-request")
        bucket = programlib.m_bucket(n_requests)
        plan = self._batch_plans.get(bucket)
        if plan is None:
            with trace.span("executable.batch_plan", bucket=bucket,
                            n_requests=n_requests):
                plan = self._build_batch_plan(bucket)
            self._batch_plans[bucket] = plan
        return plan

    def _build_batch_plan(self, bucket: int) -> BatchPlan:
        """Re-lower every static segment at m = bucket * m_rows.

        Each bucketed GEMM reuses the base step's *own* MappingChoice
        (``snap_tiling`` clips the M tile; K tiling is untouched), so the
        per-row accumulation order matches the per-request path -- the
        batched numbers stay on the sequential trajectory.  In-program
        activation legality survives the re-lowering: elementwise acts
        are M-independent and row-wise acts were only in-program under
        WO-S with full output rows, which bucketing preserves."""
        cache = self.cache
        segs: list[BatchSegment] = []
        runs: list[list[int]] = []
        for seg in self.segments:
            # Stacked-batch flattening cannot cross an interior adapt
            # boundary (the flatten/cycle glue would mix requests' rows)
            # or a dynamic<->static transition, so fused segments that
            # span them re-split here into batchable sub-runs -- the
            # pre-streaming segment granularity.
            run: list[int] = []
            for i in seg.indices:
                s = self.steps[i]
                if run and (s.input_mode == "adapt"
                            or s.op.dynamic != self.steps[run[-1]].op.dynamic):
                    runs.append(run)
                    run = []
                run.append(i)
            if run:
                runs.append(run)
        for idx in runs:
            steps = [self.steps[i] for i in idx]
            m_rows = steps[0].op.gemm.m
            if any(s.op.dynamic for s in steps):
                if (len(steps) == 2 and all(s.op.dynamic for s in steps)
                        and steps[0].program.act_name == "softmax"
                        and steps[0].host_act is None
                        and steps[1].input_mode == "wired"
                        and steps[1].program.act_name == "none"):
                    segs.append(BatchSegment(
                        kind="attention", indices=idx,
                        programs=[steps[0].program, steps[1].program],
                        host_act=steps[-1].host_act, m_rows=m_rows))
                else:
                    segs.append(BatchSegment(kind="perreq", indices=idx,
                                             programs=[]))
                continue
            try:
                progs = []
                for s in steps:
                    bg = programlib.bucketed_gemm(s.op.gemm, bucket)
                    progs.append(cache.lower(
                        bg, s.program.choice, self.cfg,
                        activation=s.program.activation,
                        act_name=s.program.act_name,
                        out_name=s.program.out_name))
                fused = None
                if len(progs) > 1:
                    progs = programlib.chain(progs, lower_fn=cache.lower)
                    fused = self._fuse_with_tuned(progs)
            except ValueError:
                segs.append(BatchSegment(kind="perreq", indices=idx,
                                         programs=[]))
                continue
            segs.append(BatchSegment(kind="static", indices=idx,
                                     programs=list(progs), fused=fused,
                                     host_act=steps[-1].host_act,
                                     m_rows=m_rows))
        return BatchPlan(bucket=bucket, segments=segs)

    def run_batch(self, backend, envs: list[dict], *, lengths=None,
                  fused: bool = True, device="cuda") -> list[torch.Tensor]:
        """Advance EVERY request one step with one launch per segment.

        ``envs`` carries one tensor dict per request (static weights are
        identical across requests by construction; dynamic KV operands
        and fresh inputs are per-request).  ``lengths`` are the
        per-request true KV widths for the attention segment.  Returns
        the per-request final carriers, each bit-comparable (modulo the
        stabilised-recurrence regime) to a sequential :meth:`run`.
        """
        be = self.make_backend(backend, device)
        envs = [{name: be.to_device(arr) for name, arr in env.items()}
                for env in envs]
        n = len(envs)
        plan = self.batch_plan(n)
        prevs: list[torch.Tensor | None] = [None] * n
        for bseg in plan.segments:
            steps = [self.steps[i] for i in bseg.indices]
            first = steps[0]
            g = first.op.gemm
            if bseg.kind == "perreq":
                with trace.span("batch_segment", kind="perreq",
                                n_steps=len(steps), batch=n):
                    for r in range(n):
                        prevs[r] = self._run_steps_perreq(
                            be, steps, envs[r], prevs[r])
                continue
            xs = []
            for r in range(n):
                if first.input_mode == "fresh":
                    xs.append(envs[r][first.input_name])
                elif first.input_mode == "adapt":
                    xs.append(adapt(prevs[r], g.m, g.k))
                else:          # 'wired' never starts a segment
                    xs.append(prevs[r])
            if bseg.kind == "attention":
                kT = torch.stack([envs[r][steps[0].weight_name]
                                  for r in range(n)])
                v = torch.stack([envs[r][steps[1].weight_name]
                                 for r in range(n)])
                with trace.span("batch_segment", kind="attention",
                                batch=n):
                    out = be.run_batched_attention(
                        tuple(bseg.programs), torch.stack(xs), kT, v,
                        lengths)
                outs = [out[r] for r in range(n)]
                if bseg.host_act is not None:
                    outs = [bseg.host_act(o) for o in outs]
                prevs = outs
                continue
            # static: stack along M, zero-pad to the bucket, one launch
            m_rows = bseg.m_rows
            X = torch.cat(xs, dim=0)
            if n < plan.bucket:
                X = torch.cat(
                    [X, X.new_zeros(((plan.bucket - n) * m_rows,
                                     X.shape[1]))], dim=0)
            if fused and bseg.fused is not None:
                t = {"I": X}
                for j, s in enumerate(steps):
                    t[f"W{j}"] = envs[0][s.weight_name]
                with trace.span("batch_segment", kind="static_fused",
                                n_steps=len(steps), batch=n,
                                bucket=plan.bucket):
                    out = be.run_segment(bseg.fused, t)[bseg.fused.out_name]
            else:
                with trace.span("batch_segment", kind="static",
                                n_steps=len(steps), batch=n,
                                bucket=plan.bucket):
                    out = X
                    for j, (s, prog) in enumerate(zip(steps,
                                                      bseg.programs)):
                        t = {"W": envs[0][s.weight_name]}
                        if j == 0:
                            t["I"] = X
                        out = be.run_program(prog, t)[prog.out_name]
            out = out[:n * m_rows]
            if bseg.host_act is not None:
                out = bseg.host_act(out)
            prevs = [out[r * m_rows:(r + 1) * m_rows] for r in range(n)]
        return prevs

    def _run_steps_perreq(self, be, steps, env, prev):
        """Sequential replay of one segment for one request (the batched
        plan's fallback; numerics identical to :meth:`run`'s per-Program
        path)."""
        for s in steps:
            g = s.op.gemm
            t: dict[str, torch.Tensor] = {"W": env[s.weight_name]}
            if s.input_mode == "fresh":
                t["I"] = env[s.input_name]
            elif s.input_mode == "adapt":
                t["I"] = adapt(prev, g.m, g.k)
            out = be.run_program(s.program, t)[s.program.out_name]
            if s.host_act is not None:
                out = s.host_act(out)
            prev = out
        return prev

    # -- accounting (the same tile streams perf.simulate consumes) ------------
    @property
    def n_arrays(self) -> int:
        return self.mesh.n_arrays if self.mesh is not None else 1

    def perf_stats(self) -> dict[str, float]:
        """Aggregate MINISA vs micro traffic + stall fractions over the
        stream, ``reps``-weighted; simulated once per unique Program.

        On a mesh, per-GEMM cycles are the slowest array's (arrays run
        in parallel), instruction bytes sum over arrays, and the
        per-array breakdowns plus ``load_imbalance`` join the dict."""
        n_arrays = self.n_arrays
        tot = {"minisa_bytes": 0.0, "micro_bytes": 0.0,
               "cycles_minisa": 0.0, "cycles_micro": 0.0,
               "stall_cycles_minisa": 0.0, "stall_cycles_micro": 0.0,
               "macs": 0.0, "n_gemms": 0.0}
        per_bytes = [0.0] * n_arrays
        per_cycles = [0.0] * n_arrays
        for s in self.steps:
            key = id(s.sharded if s.sharded is not None else s.program)
            if key not in self._perf_cache:
                if s.sharded is not None:
                    pm = perf.simulate_sharded(s.sharded, self.cfg,
                                               "minisa")
                    pu = perf.simulate_sharded(s.sharded, self.cfg,
                                               "micro")
                    mb = s.sharded.minisa_bytes()
                    arr_b = s.sharded.per_array_minisa_bytes()
                    arr_c = [r.cycles for r in pm.per_array]
                else:
                    pm = perf.simulate(s.program.tile_costs("minisa"),
                                       self.cfg)
                    pu = perf.simulate(s.program.tile_costs("micro"),
                                       self.cfg)
                    mb = s.program.minisa_bytes()
                    arr_b = [mb]
                    arr_c = [pm.cycles]
                self._perf_cache[key] = (
                    pm, pu, mb, s.program.micro_storage_bytes(),
                    arr_b, arr_c)
            pm, pu, mb, ub, arr_b, arr_c = self._perf_cache[key]
            r = s.reps
            tot["minisa_bytes"] += mb * r
            tot["micro_bytes"] += ub * r
            tot["cycles_minisa"] += pm.cycles * r
            tot["cycles_micro"] += pu.cycles * r
            tot["stall_cycles_minisa"] += pm.stall_ifetch_frac * pm.cycles * r
            tot["stall_cycles_micro"] += pu.stall_ifetch_frac * pu.cycles * r
            tot["macs"] += s.op.gemm.macs * r
            tot["n_gemms"] += r
            for i in range(min(len(arr_b), n_arrays)):
                per_bytes[i] += arr_b[i] * r
                per_cycles[i] += arr_c[i] * r
        tot["stall_minisa"] = (tot["stall_cycles_minisa"]
                               / max(tot["cycles_minisa"], 1e-9))
        tot["stall_micro"] = (tot["stall_cycles_micro"]
                              / max(tot["cycles_micro"], 1e-9))
        tot["instr_reduction"] = (tot["micro_bytes"]
                                  / max(tot["minisa_bytes"], 1e-9))
        tot["n_arrays"] = n_arrays
        tot["per_array_minisa_bytes"] = per_bytes
        tot["per_array_cycles_minisa"] = per_cycles
        tot["load_imbalance"] = perf.load_imbalance(per_cycles)
        return tot

    def fusion_stats(self) -> dict:
        """Modelled traffic and cycles of the stream under per-layer vs
        fused execution, ``reps``-weighted.

        Two layers of accounting, matching the two execution realities:
        ``cycles_*`` come from the machine-model tile streams (interior
        elision applied for fused segments -- ``FusedSegment.tile_costs``),
        while ``hbm_bytes_*`` are *kernel-launch* traffic: per-layer
        launches round-trip every interior activation through HBM, the
        fused launch ships only the segment input, the weights and the
        final output.  ``hbm_bytes_elided`` is exactly the difference --
        what the fused kernels keep on-chip.

        Depends only on the (immutable) step/segment structure, so the
        result is computed once and cached."""
        if self._fusion_stats is not None:
            return dict(self._fusion_stats)
        out = {"n_segments": len(self.segments),
               "n_fused_segments": 0, "n_fused_steps": 0,
               "hbm_bytes_per_layer": 0.0, "hbm_bytes_fused": 0.0,
               "cycles_per_layer": 0.0, "cycles_fused": 0.0}
        elem = self.cfg.elem_bytes
        for seg in self.segments:
            steps = [self.steps[i] for i in seg.indices]
            if seg.fused is not None:
                out["n_fused_segments"] += 1
                out["n_fused_steps"] += len(steps)
            for pos, s in enumerate(steps):
                g = s.op.gemm
                plain = s.program.tile_costs("minisa")
                r = s.reps
                res = perf.simulate(plain, self.cfg)
                launch = elem * (g.m * g.k + g.k * g.n + g.m * g.n)
                out["hbm_bytes_per_layer"] += r * launch
                out["cycles_per_layer"] += r * res.cycles
                if seg.fused is not None:
                    fused_costs = seg.fused.layer_tile_costs(pos)
                    fres = perf.simulate(fused_costs, self.cfg)
                    if isinstance(seg.fused, programlib.FusedSegment):
                        # weights ship K-padded, once per M step of the
                        # streamed launch (kernel_hbm_bytes semantics)
                        fused_launch = elem * (seg.fused.m_steps
                                               * seg.fused.padded_ks[pos]
                                               * g.n)
                    else:
                        fused_launch = elem * (g.k * g.n)
                    if pos == 0:
                        fused_launch += elem * g.m * g.k    # segment input
                    if pos == len(steps) - 1:
                        fused_launch += elem * g.m * g.n    # final output
                    out["hbm_bytes_fused"] += r * fused_launch
                    out["cycles_fused"] += r * fres.cycles
                else:
                    out["hbm_bytes_fused"] += r * launch
                    out["cycles_fused"] += r * res.cycles
        out["hbm_bytes_elided"] = (out["hbm_bytes_per_layer"]
                                   - out["hbm_bytes_fused"])
        self._fusion_stats = out
        return dict(out)

    def describe(self) -> dict:
        return {
            "name": self.name,
            "n_steps": len(self.steps),
            "n_segments": len(self.segments),
            "n_fused_segments": sum(1 for s in self.segments
                                    if s.fused is not None),
            "n_gemms": int(sum(s.reps for s in self.steps)),
            "n_dynamic": sum(1 for s in self.steps if s.op.dynamic),
            "n_wired": sum(1 for s in self.steps
                           if s.input_mode == "wired"),
            "n_elided": sum(1 for s in self.steps
                            if s.program.input_elided),
            "n_arrays": self.n_arrays,
            "n_sharded": sum(1 for s in self.steps
                             if s.sharded is not None),
        }
