"""ProgramCache: one memoisation for the whole compile pipeline.

The expensive path from a GEMM shape to something executable is

    mapper.search (candidate enumeration + shortlist lowering + layout)
      -> program.lower (the winning Program, possibly re-lowered for
         activation / chaining variants)
        -> backend compile (CompiledProgram launch geometry for CUDA)

Before this module every consumer memoised its own slice of that pipeline
(the planner's per-``plan_model`` ``plans`` dict, ``benchmarks.common``'s
``lru_cache`` sweep, the compiled backend's per-instance ``id()`` cache).  The
:class:`ProgramCache` replaces those with one three-tier cache:

  plans      (m, k, n, FeatherConfig, search kwargs)      -> mapper.Plan
  lowered    (shape, MappingChoice, cfg, lowering kwargs) -> Program
  compiled   ("cuda", structural program key, max_block)  -> CompiledProgram
  sharded    (structural program key, mesh shape, axis)   -> ShardedProgram
  fused      (per-layer compiled keys, segment geometry)  -> CompiledSegment
  frontier   (structural segment key)                     -> SegmentFrontier
  tuned      (structural segment key + tuning state)      -> TunedGeometry

``plan`` also accepts a ``core.conv.Conv2D`` (anything with ``to_gemm``):
the im2col GEMM shape is the search problem, so convs share the same
memoisation as the GEMM stream.

Keys are *structural*: two equal-by-value ``Gemm``/``FeatherConfig``
instances hit the same entry regardless of object identity, and the
compiled tier keys on what ``compile_program`` actually reads (shape,
choice, cfg, activation, operand tensor names, commit flag) so a rebuilt
chain of fresh Program objects still reuses its artifacts.  Hit/miss/byte
stats are tracked per tier, and the plan tier optionally persists to disk
(``save``/``load``) so a warmed cache survives process restarts.

``core/planner.plan_model``, ``benchmarks/common.sweep_plans``, the
runtime's :class:`~repro_torch.runtime.executable.ModelExecutable` and the
``CudaBackend`` (via its ``compile_cache`` hook) all share the process
default returned by :func:`default_cache`.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import pickle
import tempfile
from typing import TYPE_CHECKING, Any, Callable

from repro_torch.core import mapper as mapperlib
from repro_torch.core import program as programlib
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.trace import trace

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.backends.cuda_backend import CompiledProgram
    from repro_torch.configs.feather import FeatherConfig
    from repro_torch.core.mapper import Gemm, Plan, SegmentFrontier
    from repro_torch.core.program import Program

#: Disk-payload version: bumped whenever the pickled layout changes.
#: Version 2 added the per-tier ``schema`` dict and the persisted tuned
#: tier; version 3 moved every entry under ``tiers`` as an individually
#: pickled ``(blob, sha256)`` pair, so load verifies each entry's
#: content checksum and a corrupt entry quarantines (counting a miss)
#: instead of poisoning -- or crashing -- the next process.
_PERSIST_VERSION = 3

#: Per-tier entry schemas inside the payload; a tier whose schema
#: doesn't match is rejected wholesale (same guard, finer grain: a
#: future plan-layout change won't discard still-valid tuned winners).
_TIER_SCHEMAS = {"plans": 2, "tuned": 2}

#: The backend this package compiles for.  It leads every compiled key
#: and is written into the disk payload, so a cache file persisted by the
#: JAX package (whose entries pickle *its* classes) is refused on load,
#: never unpickled.
BACKEND = "cuda"


def _entry_digest(blob: bytes) -> str:
    """Content checksum persisted next to each pickled entry."""
    return hashlib.sha256(blob).hexdigest()


@dataclasses.dataclass
class CacheStats:
    """Per-tier hit/miss accounting (misses == real pipeline work done)."""
    plan_hits: int = 0
    plan_misses: int = 0          # == mapper searches performed
    lowered_hits: int = 0
    lowered_misses: int = 0       # == program.lower calls performed
    compile_hits: int = 0
    compile_misses: int = 0       # == backend compile_program calls
    sharded_hits: int = 0
    sharded_misses: int = 0       # == shard_program partitionings
    fused_hits: int = 0
    fused_misses: int = 0         # == fused-segment compiles
    frontier_hits: int = 0
    frontier_misses: int = 0      # == joint segment searches performed
    tuned_hits: int = 0
    tuned_misses: int = 0         # == tuned-geometry lookups that missed
    disk_rejected: int = 0        # stale persisted payloads refused
    disk_corrupt: int = 0         # checksum-failed entries quarantined
    evictions: int = 0
    disk_evictions: int = 0       # plans trimmed from the persisted tier
    disk_bytes: int = 0           # size of the persisted file, last save
    loaded_from_disk: int = 0

    @property
    def searches(self) -> int:
        return self.plan_misses

    @property
    def compiles(self) -> int:
        return self.compile_misses

    @property
    def hits(self) -> int:
        return (self.plan_hits + self.lowered_hits + self.compile_hits
                + self.sharded_hits + self.fused_hits
                + self.frontier_hits + self.tuned_hits)

    @property
    def misses(self) -> int:
        return (self.plan_misses + self.lowered_misses
                + self.compile_misses + self.sharded_misses
                + self.fused_misses + self.frontier_misses)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def snapshot(self) -> "CacheStats":
        return dataclasses.replace(self)

    def delta(self, since: "CacheStats") -> dict[str, int]:
        return {f.name: getattr(self, f.name) - getattr(since, f.name)
                for f in dataclasses.fields(self)}

    def summary(self) -> dict:
        return {
            "hits": self.hits, "misses": self.misses,
            "hit_rate": self.hit_rate,
            "searches": self.searches, "lowerings": self.lowered_misses,
            "compiles": self.compiles, "shardings": self.sharded_misses,
            "fused_compiles": self.fused_misses,
            "fused_hits": self.fused_hits,
            "frontier_searches": self.frontier_misses,
            "frontier_hits": self.frontier_hits,
            "tuned_hits": self.tuned_hits,
            "tuned_misses": self.tuned_misses,
            "disk_rejected": self.disk_rejected,
            "disk_corrupt": self.disk_corrupt,
            "evictions": self.evictions,
            "disk_evictions": self.disk_evictions,
            "disk_bytes": self.disk_bytes,
            "loaded_from_disk": self.loaded_from_disk,
        }


def _act_token(activation: Callable | None, act_name: str) -> Any:
    """Hashable identity of an activation binding.

    Registry activations (``runtime.executable.ACTIVATIONS``) are
    module-level callables, so ``id`` is stable for the process lifetime;
    keying on the id (not just the name) keeps two same-named programs
    bound to *different* callables from colliding."""
    if activation is None:
        return None
    return (act_name, id(activation))


def compiled_key(program: "Program", max_block: int) -> tuple:
    """Structural key covering everything ``compile_program`` reads."""
    from repro_torch.backends.cuda_backend import _load_names
    g = program.gemm
    input_name, weight_name = _load_names(program)
    commit = any(op.meta.get("commit_to") is not None
                 for tile in program.tiles for op in tile.drains)
    return (BACKEND, g.m, g.k, g.n, program.choice, program.cfg,
            program.out_name,
            _act_token(program.activation, program.act_name),
            input_name, weight_name, commit, program.input_elided,
            max_block)


def fused_key(segment, max_block: int) -> tuple:
    """Structural key of a fused segment: the per-layer compiled keys
    plus the full streamed launch geometry -- a rebuilt executable's
    fresh FusedSegment objects hit the same artifact, while a changed
    K-tile schedule, adapt layout, buffer depth or VMEM budget can never
    serve a stale compiled kernel."""
    return (tuple(compiled_key(p, max_block) for p in segment.programs),
            segment.bm, segment.layer_bks, segment.acts,
            tuple(segment.adapts), segment.buffer_depth,
            segment.vmem_budget, segment.operand_dtype, max_block)


def segment_key(programs, *, adapts=None,
                vmem_budget: int | None = None,
                operand_dtype: str = "float32",
                tuning: tuple = ()) -> tuple:
    """Structural key of a chained segment *before* any launch geometry
    exists: per-layer (shape, MappingChoice, activation name), the
    config, the adapt boundaries and the streamed budget -- what the
    joint search (frontier tier) and the measured winner (tuned tier)
    are both functions of.

    ``tuning`` carries the measurement state a tuned winner is only
    valid for (``runtime.autotune.tuning_state``: backend kind, device
    type, max_block): a winner measured with the plain versions on the
    CPU never answers a lookup made for the kernels on the card.  Unlike
    ``compiled_key`` this key holds no ``id()``-based activation token
    (activation *names* suffice -- geometry does not depend on the
    callable), so tuned entries pickle cleanly and stay valid across
    processes.
    """
    if adapts is None:
        adapts = (False,) * len(programs)
    if vmem_budget is None:
        vmem_budget = programlib.FUSED_VMEM_BUDGET
    layers = tuple((p.gemm.m, p.gemm.k, p.gemm.n, p.choice, p.act_name)
                   for p in programs)
    return (layers, programs[0].cfg, tuple(adapts), int(vmem_budget),
            operand_dtype, programlib.FUSED_STREAM_DEPTH, tuple(tuning))


class ProgramCache:
    """Memoises mapper search -> Program lowering -> backend compile.

    ``path`` enables on-disk persistence of the plan tier: an existing
    file is loaded at construction and :meth:`save` writes the current
    plans back (lowered/compiled tiers hold callables and are rebuilt,
    cheaply, from the cached plans).  ``max_plans`` bounds the plan tier
    with insertion-order eviction -- the variant and artifact tiers get
    proportional bounds -- so a long-lived process cannot grow
    unboundedly.
    """

    def __init__(self, path: str | os.PathLike | None = None,
                 max_plans: int = 128):
        self._plans: dict[tuple, "Plan"] = {}
        self._lowered: dict[tuple, "Program"] = {}
        self._compiled: dict[tuple, "CompiledProgram"] = {}
        self._sharded: dict[tuple, Any] = {}
        self._fused: dict[tuple, Any] = {}
        self._frontiers: dict[tuple, Any] = {}
        self._tuned: dict[tuple, Any] = {}
        # struct part of a tuned key -> its full key (latest stored
        # winner wins), so segment builds can consume tuned geometry
        # without knowing which tuning state produced it
        self._tuned_by_struct: dict[tuple, tuple] = {}
        self.stats = CacheStats()
        self.max_plans = max_plans
        # variant/artifact tiers are bounded too (several lowering
        # variants and compiled artifacts may hang off one plan)
        self.max_lowered = 8 * max_plans
        self.max_compiled = 16 * max_plans
        self.max_sharded = 8 * max_plans
        self.max_fused = 8 * max_plans
        self.max_frontiers = 4 * max_plans
        self.max_tuned = 4 * max_plans
        self.path = os.fspath(path) if path is not None else None
        if self.path and os.path.exists(self.path):
            self.load(self.path)

    def _evict_over(self, table: dict, bound: int) -> None:
        while len(table) >= bound:
            table.pop(next(iter(table)))
            self.stats.evictions += 1

    # -- tier 1: mapper search ------------------------------------------------
    @staticmethod
    def plan_key(gemm: "Gemm", cfg: "FeatherConfig",
                 **search_kwargs) -> tuple:
        """Shape + config + search-mode key.  ``name``/``count`` are
        display/aggregation metadata and deliberately excluded: equal
        shapes share one mapping-search problem."""
        return (gemm.m, gemm.k, gemm.n, cfg,
                tuple(sorted(search_kwargs.items())))

    def plan(self, gemm: "Gemm", cfg: "FeatherConfig",
             **search_kwargs) -> "Plan":
        if hasattr(gemm, "to_gemm"):       # Conv2D (or any im2col-able op)
            gemm = gemm.to_gemm()
        key = self.plan_key(gemm, cfg, **search_kwargs)
        hit = self._plans.get(key)
        if hit is not None:
            self.stats.plan_hits += 1
            # LRU touch
            self._plans[key] = self._plans.pop(key)
            return hit
        self.stats.plan_misses += 1
        with trace.span("cache.search", m=gemm.m, k=gemm.k, n=gemm.n):
            plan = mapperlib.search(gemm, cfg, **search_kwargs)
        self._evict_over(self._plans, self.max_plans)
        self._plans[key] = plan
        return plan

    # -- tier 2: lowering variants (activation / chaining rewires) ------------
    def lower(self, gemm, choice, cfg: "FeatherConfig", *,
              activation: Callable | None = None, act_name: str = "none",
              out_name: str = "O", commit_to: str | None = None,
              commit_layout=None, elide_input: bool = False) -> "Program":
        """Memoising drop-in for ``program.lower`` (``chain``'s
        ``lower_fn``): a rebuilt executable reuses Program objects, which
        in turn keeps the compiled tier and the backends' ``id`` caches
        warm."""
        key = (gemm.m, gemm.k, gemm.n, choice, cfg,
               _act_token(activation, act_name), act_name, out_name,
               commit_to, commit_layout, elide_input)
        hit = self._lowered.get(key)
        if hit is not None:
            self.stats.lowered_hits += 1
            self._lowered[key] = self._lowered.pop(key)   # LRU touch
            return hit
        self.stats.lowered_misses += 1
        with trace.span("cache.lower", m=gemm.m, k=gemm.k, n=gemm.n,
                        out=out_name):
            prog = programlib.lower(gemm, choice, cfg,
                                    activation=activation,
                                    act_name=act_name, out_name=out_name,
                                    commit_to=commit_to,
                                    commit_layout=commit_layout,
                                    elide_input=elide_input)
        self._evict_over(self._lowered, self.max_lowered)
        self._lowered[key] = prog
        return prog

    # -- tier 4: mesh partitionings (ShardedProgram per mesh shape) -----------
    def sharded(self, program: "Program", mesh, axis: str | None = None):
        """Memoising drop-in for ``program.shard_program``: the mesh
        shape joins the structural key, so the same Program served on
        2- and 4-array meshes holds two entries, and every shard's
        sub-Program lowering flows through :meth:`lower` (shared with
        the unsharded variants)."""
        g = program.gemm
        key = (g.m, g.k, g.n, program.choice, program.cfg,
               program.out_name,
               _act_token(program.activation, program.act_name),
               program.input_elided, mesh.shape, mesh.axis_name, axis)
        hit = self._sharded.get(key)
        if hit is not None:
            self.stats.sharded_hits += 1
            self._sharded[key] = self._sharded.pop(key)   # LRU touch
            return hit
        self.stats.sharded_misses += 1
        with trace.span("cache.shard", mesh=mesh.shape, axis=axis):
            sharded = programlib.shard_program(program, mesh, axis=axis,
                                               lower_fn=self.lower)
        self._evict_over(self._sharded, self.max_sharded)
        self._sharded[key] = sharded
        return sharded

    # -- tier 3: backend compile artifacts (CudaBackend hook) -----------------
    def lookup_compiled(self, program: "Program",
                        max_block: int) -> "CompiledProgram | None":
        key = compiled_key(program, max_block)
        comp = self._compiled.get(key)
        if comp is not None:
            self.stats.compile_hits += 1
            self._compiled[key] = self._compiled.pop(key)   # LRU touch
        return comp

    def store_compiled(self, program: "Program", max_block: int,
                       comp: "CompiledProgram") -> None:
        self.stats.compile_misses += 1
        self._evict_over(self._compiled, self.max_compiled)
        self._compiled[compiled_key(program, max_block)] = comp

    # -- tier 5: fused-segment artifacts (one compile per chained segment) ----
    def lookup_fused(self, segment, max_block: int):
        key = fused_key(segment, max_block)
        comp = self._fused.get(key)
        if comp is not None:
            self.stats.fused_hits += 1
            self._fused[key] = self._fused.pop(key)   # LRU touch
        return comp

    def store_fused(self, segment, max_block: int, comp) -> None:
        self.stats.fused_misses += 1
        self._evict_over(self._fused, self.max_fused)
        self._fused[fused_key(segment, max_block)] = comp

    # -- tier 6: joint-search frontiers (one per segment structure) -----------
    def frontier(self, programs, *, adapts=None,
                 vmem_budget: int | None = None,
                 operand_dtype: str = "float32"):
        """Memoising drop-in for ``mapper.search_segment``: the Pareto
        frontier of joint (bm, per-layer bk) geometries for a chained
        segment, keyed structurally so rebuilt executables and repeat
        autotune calls never re-run the joint search.  Returns None for
        fusion-illegal segments (not cached -- the legality check is
        cheap and the result can change with ``adapts``)."""
        key = segment_key(programs, adapts=adapts,
                          vmem_budget=vmem_budget,
                          operand_dtype=operand_dtype)
        hit = self._frontiers.get(key)
        if hit is not None:
            self.stats.frontier_hits += 1
            self._frontiers[key] = self._frontiers.pop(key)   # LRU touch
            return hit
        self.stats.frontier_misses += 1
        with trace.span("cache.frontier", n_layers=len(programs)):
            front = mapperlib.search_segment(
                list(programs), adapts=adapts,
                vmem_budget=(vmem_budget if vmem_budget is not None
                             else programlib.FUSED_VMEM_BUDGET),
                operand_dtype=operand_dtype)
        if front is not None:
            self._evict_over(self._frontiers, self.max_frontiers)
            self._frontiers[key] = front
        return front

    # -- tier 7: measured autotune winners (persisted across processes) -------
    def lookup_tuned(self, key: tuple):
        """Exact-match lookup: ``key`` comes from :func:`segment_key`
        *with* the tuning state the caller measures under."""
        tg = self._tuned.get(key)
        if tg is not None:
            self.stats.tuned_hits += 1
            self._tuned[key] = self._tuned.pop(key)   # LRU touch
        else:
            self.stats.tuned_misses += 1
        return tg

    def store_tuned(self, key: tuple, tuned) -> None:
        self._evict_over(self._tuned, self.max_tuned)
        self._tuned[key] = tuned
        self._tuned_by_struct[key[:-1]] = key

    def tuned_geometry(self, programs, *, adapts=None,
                       vmem_budget: int | None = None,
                       operand_dtype: str = "float32",
                       tuning: tuple | None = None):
        """The measured winner for a segment structure, or None.

        With ``tuning`` given the lookup is exact; without, the most
        recently stored winner for the structure is returned (segment
        *builds* consume tuned geometry without knowing which backend
        state tuned it -- the geometry is valid under any, only the
        measured time was state-specific)."""
        if tuning is not None:
            return self.lookup_tuned(segment_key(
                programs, adapts=adapts, vmem_budget=vmem_budget,
                operand_dtype=operand_dtype, tuning=tuning))
        struct = segment_key(programs, adapts=adapts,
                             vmem_budget=vmem_budget,
                             operand_dtype=operand_dtype)[:-1]
        full = self._tuned_by_struct.get(struct)
        if full is None:
            self.stats.tuned_misses += 1
            return None
        return self.lookup_tuned(full)

    # -- stats / persistence --------------------------------------------------
    def __len__(self) -> int:
        return (len(self._plans) + len(self._lowered)
                + len(self._compiled) + len(self._sharded)
                + len(self._fused) + len(self._frontiers)
                + len(self._tuned))

    def size_bytes(self) -> int:
        """Pickled payload size of the plan tier (computed on demand --
        the byte figure for the ``bytes`` stat, not a live counter)."""
        total = 0
        for plan in self._plans.values():
            try:
                total += len(pickle.dumps(plan,
                                          protocol=pickle.HIGHEST_PROTOCOL))
            except Exception:  # pragma: no cover - unpicklable plan
                total += int(plan.program.minisa_bytes())
        return total

    def publish_metrics(self, registry=None) -> None:
        """Sync the per-tier hit/miss/eviction stats and the disk-tier
        figures (``disk_bytes``, ``disk_evictions``) into the metrics
        registry (default: the shared ``obs.metrics`` one) as labelled
        gauges -- the unified scrape surface over every ad-hoc stats
        dict."""
        reg = registry if registry is not None else obs_metrics.REGISTRY
        s = self.stats
        tiers = {"plan": (s.plan_hits, s.plan_misses, self._plans),
                 "lowered": (s.lowered_hits, s.lowered_misses,
                             self._lowered),
                 "compile": (s.compile_hits, s.compile_misses,
                             self._compiled),
                 "sharded": (s.sharded_hits, s.sharded_misses,
                             self._sharded),
                 "fused": (s.fused_hits, s.fused_misses, self._fused),
                 "frontier": (s.frontier_hits, s.frontier_misses,
                              self._frontiers),
                 "tuned": (s.tuned_hits, s.tuned_misses, self._tuned)}
        for tier, (hits, misses, table) in tiers.items():
            reg.gauge("cache_hits",
                      "ProgramCache hits per tier").set(hits, tier=tier)
            reg.gauge("cache_misses",
                      "ProgramCache misses (real pipeline work) per "
                      "tier").set(misses, tier=tier)
            reg.gauge("cache_entries",
                      "live ProgramCache entries per tier").set(
                          len(table), tier=tier)
        reg.gauge("cache_hit_rate").set(s.hit_rate)
        reg.gauge("cache_evictions").set(s.evictions)
        reg.gauge("cache_disk_evictions",
                  "plans trimmed from the persisted tier").set(
                      s.disk_evictions)
        reg.gauge("cache_disk_bytes",
                  "size of the persisted plan file, last save").set(
                      s.disk_bytes)
        reg.gauge("cache_disk_corrupt",
                  "checksum-failed disk entries quarantined").set(
                      s.disk_corrupt)
        reg.gauge("cache_loaded_from_disk").set(s.loaded_from_disk)

    def summary(self) -> dict:
        return {
            "entries": {"plans": len(self._plans),
                        "lowered": len(self._lowered),
                        "compiled": len(self._compiled),
                        "sharded": len(self._sharded),
                        "fused": len(self._fused),
                        "frontiers": len(self._frontiers),
                        "tuned": len(self._tuned)},
            "bytes": self.size_bytes(),
            **self.stats.summary(),
        }

    def save(self, path: str | os.PathLike | None = None) -> str:
        """Persist the plan tier and the measured tuned winners (both
        hold only value objects, so they pickle cleanly; variant/compiled
        tiers hold callables and launch geometry and are re-derived).

        Each entry is pickled on its own and stored as a
        ``(blob, sha256)`` pair under ``tiers`` so :meth:`load` can
        verify entries independently -- one flipped byte quarantines one
        entry, not the whole cache.  The write is atomic and durable:
        a unique temp file in the destination directory (concurrent
        saves never collide), fsync'ed, then ``os.replace``'d into
        place, so a crash mid-save can never leave a torn file at
        ``path``.

        The documented ``max_plans`` LRU bound holds on disk too: only
        the most-recently-used ``max_plans`` entries persist (dict order
        IS recency order -- hits re-insert), trimmed entries count as
        ``disk_evictions``, and the written file's size is stat'ed into
        ``disk_bytes``."""
        path = os.fspath(path or self.path)
        if not path:
            raise ValueError("no persistence path configured")
        items = list(self._plans.items())
        trimmed = max(0, len(items) - self.max_plans)
        self.stats.disk_evictions += trimmed
        tuned = list(self._tuned.items())[-self.max_tuned:]
        tiers = {}
        for tier, entries in (("plans", items[trimmed:]),
                              ("tuned", tuned)):
            packed = []
            for key, value in entries:
                blob = pickle.dumps((key, value),
                                    protocol=pickle.HIGHEST_PROTOCOL)
                packed.append((blob, _entry_digest(blob)))
            tiers[tier] = packed
        payload = {"version": _PERSIST_VERSION,
                   "backend": BACKEND,
                   "schema": dict(_TIER_SCHEMAS),
                   "tiers": tiers}
        dirname = os.path.dirname(path) or "."
        fd, tmp = tempfile.mkstemp(dir=dirname,
                                   prefix=os.path.basename(path) + ".",
                                   suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self.stats.disk_bytes = os.path.getsize(path)
        return path

    # -- corruption quarantine ------------------------------------------------
    def quarantine_dir(self, path: str) -> str:
        return path + ".quarantine"

    def _quarantine(self, path: str, name: str, data: bytes) -> None:
        """Move corrupt bytes aside (never raising -- quarantine is a
        best-effort forensic aid on the serving path)."""
        self.stats.disk_corrupt += 1
        try:
            qdir = self.quarantine_dir(path)
            os.makedirs(qdir, exist_ok=True)
            with open(os.path.join(qdir, name), "wb") as f:
                f.write(data)
        except OSError:  # pragma: no cover - quarantine dir unwritable
            pass

    def load(self, path: str | os.PathLike) -> int:
        """Merge a persisted payload.

        Two distinct failure modes, deliberately handled differently:

        * **stale layout** -- a well-formed payload whose version or
          per-tier schema doesn't match raises ``ValueError`` (and
          counts ``disk_rejected``): the caller configured an
          incompatible file and should know.
        * **corruption** -- an unreadable/truncated file, or an entry
          whose sha256 doesn't match its blob, never raises: the file
          or entry moves to the ``<path>.quarantine`` sidecar, counts
          ``disk_corrupt``, and the entry is simply a miss (re-derived
          by the next search) -- torn disks must not crash a serve.
        """
        path = os.fspath(path)
        with open(path, "rb") as f:
            raw = f.read()
        try:
            payload = pickle.loads(raw)
            if not isinstance(payload, dict) or "version" not in payload:
                raise pickle.UnpicklingError("malformed cache payload")
        except (EOFError, KeyError, IndexError, ImportError,
                AttributeError, TypeError, pickle.PickleError):
            # truncated/garbled file: quarantine, never crash a serve
            self._quarantine(path, "payload.bin", raw)
            return 0
        if payload.get("version") != _PERSIST_VERSION:
            self.stats.disk_rejected += 1
            raise ValueError(
                f"cache file version {payload.get('version')!r} != "
                f"{_PERSIST_VERSION}")
        if payload.get("backend") != BACKEND:
            self.stats.disk_rejected += 1
            raise ValueError(
                f"cache file backend {payload.get('backend')!r} != "
                f"{BACKEND!r}")
        schema = payload.get("schema", {})
        for tier, want in _TIER_SCHEMAS.items():
            if schema.get(tier, want) != want:
                self.stats.disk_rejected += 1
                raise ValueError(
                    f"cache tier {tier!r} schema {schema.get(tier)!r} "
                    f"!= {want}")
        loaded = 0
        tiers = payload.get("tiers", {})
        for tier in ("plans", "tuned"):
            for i, entry in enumerate(tiers.get(tier, [])):
                try:
                    blob, digest = entry
                    if _entry_digest(blob) != digest:
                        raise ValueError("checksum mismatch")
                    key, value = pickle.loads(blob)
                except Exception:
                    blob = entry[0] if (isinstance(entry, (tuple, list))
                                        and entry) else b""
                    self._quarantine(path, f"{tier}-{i}.bin", bytes(blob))
                    continue
                if tier == "plans":
                    if key not in self._plans:
                        self._evict_over(self._plans, self.max_plans)
                        loaded += 1
                    self._plans[key] = value
                else:
                    if key not in self._tuned:
                        loaded += 1
                    self.store_tuned(key, value)
        self.stats.loaded_from_disk += loaded
        return loaded


_DEFAULT: ProgramCache | None = None


def default_cache() -> ProgramCache:
    """Process-wide shared cache (planner, benchmarks and runtime all
    memoise through this unless handed an explicit instance)."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = ProgramCache()
    return _DEFAULT


def reset_default_cache() -> None:
    global _DEFAULT
    _DEFAULT = None
