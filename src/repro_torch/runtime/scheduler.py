"""Continuous-batching request scheduler over compiled model executables.

The paper's end-to-end speedups (§V) come from amortising instruction
fetch across layers *and requests*; this scheduler is that serving loop.
One prefill and one decode :class:`~repro_torch.runtime.executable.ModelExecutable`
-- compiled once through the shared ProgramCache -- serve every request:

  * **weight residency**: the static weight tensors are generated once
    per scheduler and shared by all requests (only *dynamic* operands --
    the attention K^T/V, FEATHER+'s runtime-layout case -- are
    per-request state);
  * **KV residency**: each request's dynamic tensors live in a paged
    :class:`KVPool` arena for the request's lifetime; every step's
    output is committed back into them (a deterministic bounded update
    standing in for the model's KV append), and the next step's fresh
    inputs derive from the previous output, so the decode loop is a real
    numeric recurrence.  Pages are evicted back to the pool when a
    request retires; admission stalls (never deadlocks) when the pool is
    exhausted;
  * **one backend instance** executes everything, so its compile cache
    stays warm across requests -- a second request performs zero mapper
    searches and zero backend compiles (the cache stats in the report
    prove it).  The static weights are moved to the backend's device
    once; per step only the small per-request operands go there and
    only the carrier comes back: the recurrence feedback, the KV commits
    and the checksums stay in numpy, so checksums are bit-comparable
    with the JAX package's.

Scheduling is split prefill/decode continuous batching: every tick first
advances the WHOLE decode batch -- with ``batch_decode`` the batch
stacks along M and moves through the decode stream's M-polymorphic
segments in ONE backend launch per segment
(``ModelExecutable.run_batch``), flash-decode included -- then retires
finished requests mid-batch, and only then spends the per-tick
``token_budget`` on prefill work: continuing admitted requests' prompt
chunks and admitting new requests into free slots.  Long prompts are
chunked (``prompt_tokens`` per request), so one long prompt can never
stall the decode batch.

Per-request accounting reuses the exact tile streams ``perf.simulate``
consumes (via ``ModelExecutable.perf_stats``): MINISA vs micro-instruction
traffic bytes, modelled cycles and instruction-fetch stall fractions,
plus wall-clock latency and time-to-first-token.  With mesh-sharded
executables the report additionally carries per-array traffic/cycles and
the load-imbalance factor, and seeded runs are bit-reproducible across
backends *and batch compositions* (quantised recurrence feedback; see
``_stabilize``).
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import time

import numpy as np

from repro_torch.core import perf
from repro_torch.dist import ranks as dist_ranks
from repro_torch.faults.inject import (CircuitBreaker, FaultError, FaultInjector,
                                 PoisonedOutputError, check_finite)
from repro_torch.faults.plan import FaultPlan
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.trace import trace
from repro_torch.runtime.executable import ModelExecutable, tensors_from_numpy

#: The serving recurrence feeds backend outputs back into request state
#: (KV commits, the next step's input carrier).  Quantising that feedback
#: to this many decimals makes a seeded run *bit*-reproducible across
#: backends and packages -- and across batch compositions: fp32
#: kernel-order differences between the CUDA kernels, their plain CPU
#: versions, the JAX package's backends and the M-stacked batched
#: launches (~1e-6 at serving extents) vanish under the quantum, so
#: every path walks the identical state trajectory.
_STATE_DECIMALS = 3


def _stabilize(x: np.ndarray) -> np.ndarray:
    return np.round(np.asarray(x, np.float32), _STATE_DECIMALS)


def _host(t) -> np.ndarray:
    """A step's final carrier, brought back from the device."""
    return t.detach().cpu().numpy()


def _carry_inputs(executable: ModelExecutable, carry: np.ndarray) -> dict:
    """``executable.inputs_from(_stabilize(carry))``, stabilising only the
    prefix the fresh inputs read: ``adapt`` takes the first m * k
    elements (cycled when the carry is shorter) and ``_stabilize`` is
    elementwise, so the result is bit-identical -- at full width the
    carry is a 256000-wide vocabulary row and the inputs read 3072."""
    need = max((s.op.gemm.m * s.op.gemm.k for s in executable.steps
                if s.input_mode == "fresh"), default=0)
    return executable.inputs_from(
        _stabilize(np.asarray(carry, np.float32).ravel()[:need]))


def _pct(vals: list[float], q: float) -> float:
    return float(np.percentile(np.asarray(vals, np.float64), q)) \
        if vals else 0.0


@dataclasses.dataclass
class Request:
    rid: int
    decode_steps: int
    seed: int = 0
    #: prompt length in tokens; prompts longer than one prefill pass are
    #: chunked (None == exactly one pass, the pre-chunking behaviour)
    prompt_tokens: int | None = None
    t_submit: float = 0.0
    #: wall-clock budget from submission; an overdue request retires as
    #: ``timed_out`` instead of wedging the tick loop (None == no limit)
    deadline_s: float | None = None


@dataclasses.dataclass
class RequestReport:
    rid: int
    prefill_tokens: int
    decode_tokens: int
    wall_s: float
    minisa_bytes: float
    micro_bytes: float
    cycles_minisa: float
    cycles_micro: float
    stall_minisa: float
    stall_micro: float
    #: sha1 over the request's final quantised KV state + carrier --
    #: equal across backends / re-runs / batch compositions for equal
    #: seeds (determinism regression surface)
    state_checksum: str = ""
    #: submit -> first decode token out (prefill queueing + chunking)
    ttft_s: float = 0.0
    #: terminal state: "ok" | "timed_out" (deadline hit) | "failed"
    #: (retry budget exhausted under persistent faults)
    status: str = "ok"
    #: fault-retried steps this request absorbed (0 on a clean run)
    retries: int = 0

    @property
    def tokens(self) -> int:
        return self.prefill_tokens + self.decode_tokens

    @property
    def instr_reduction(self) -> float:
        return self.micro_bytes / max(self.minisa_bytes, 1e-9)

    def summary(self) -> dict:
        return {
            "rid": self.rid, "tokens": self.tokens,
            "prefill_tokens": self.prefill_tokens,
            "decode_tokens": self.decode_tokens,
            "wall_s": self.wall_s,
            "ttft_s": self.ttft_s,
            "minisa_bytes": self.minisa_bytes,
            "micro_bytes": self.micro_bytes,
            "instr_reduction": self.instr_reduction,
            "stall_minisa": self.stall_minisa,
            "stall_micro": self.stall_micro,
            "state_checksum": self.state_checksum,
            "status": self.status,
            "retries": self.retries,
        }


@dataclasses.dataclass
class SchedulerReport:
    backend: str
    requests: list[RequestReport]
    wall_s: float
    ticks: int
    max_concurrent: int
    cache: dict
    # multi-array serving (all zeros / ones on a single array)
    n_arrays: int = 1
    per_array_minisa_bytes: list = dataclasses.field(default_factory=list)
    per_array_cycles: list = dataclasses.field(default_factory=list)
    # batched decode fast path (fused-segment kernels)
    decode_fused: bool = False
    decode_fused_segments: int = 0    # fused launches per decode step
    decode_segments: int = 0          # total decode segments per step
    decode_hbm_elided_bytes: float = 0.0   # modelled per decode step
    # cross-request batched decode (M-polymorphic segments)
    batch_decode: bool = False
    decode_wall_s: float = 0.0        # wall time inside decode ticks
    prefill_wall_s: float = 0.0       # wall time inside prefill/admission
    decode_steps_total: int = 0       # request-steps decoded
    decode_ticks: int = 0             # ticks that ran a decode phase
    decode_launches: int = 0          # backend kernel launches in decode
    kv: dict = dataclasses.field(default_factory=dict)   # KVPool stats
    #: fault/recovery accounting ({} on a run with resilience off):
    #: injected/recovered/skipped per kind, unrecovered, retries,
    #: timed_out/failed request counts, breaker state, mesh degradations
    resilience: dict = dataclasses.field(default_factory=dict)

    @property
    def total_tokens(self) -> int:
        return sum(r.tokens for r in self.requests)

    @property
    def tokens_per_sec(self) -> float:
        return self.total_tokens / max(self.wall_s, 1e-9)

    @property
    def decode_tokens_per_sec(self) -> float:
        """Decode-phase throughput, separated from prefill/TTFT."""
        toks = sum(r.decode_tokens for r in self.requests)
        return toks / max(self.decode_wall_s, 1e-9)

    @property
    def launches_per_decode_tick(self) -> float:
        return self.decode_launches / max(self.decode_ticks, 1)

    @property
    def load_imbalance(self) -> float:
        return perf.load_imbalance(self.per_array_cycles)

    def summary(self) -> dict:
        walls = [r.wall_s for r in self.requests]
        ttfts = [r.ttft_s for r in self.requests]
        return {
            "backend": self.backend,
            "n_requests": len(self.requests),
            "total_tokens": self.total_tokens,
            "tokens_per_sec": self.tokens_per_sec,
            "decode_tokens_per_sec": self.decode_tokens_per_sec,
            "wall_s": self.wall_s,
            "decode_wall_s": self.decode_wall_s,
            "prefill_wall_s": self.prefill_wall_s,
            "ticks": self.ticks,
            "max_concurrent": self.max_concurrent,
            "batch_decode": self.batch_decode,
            "decode_ticks": self.decode_ticks,
            "decode_steps_total": self.decode_steps_total,
            "decode_launches": self.decode_launches,
            "launches_per_decode_tick": self.launches_per_decode_tick,
            "latency_p50_s": _pct(walls, 50),
            "latency_p95_s": _pct(walls, 95),
            "latency_p99_s": _pct(walls, 99),
            "ttft_p50_s": _pct(ttfts, 50),
            "ttft_p95_s": _pct(ttfts, 95),
            "ttft_p99_s": _pct(ttfts, 99),
            "n_arrays": self.n_arrays,
            "per_array_minisa_bytes": list(self.per_array_minisa_bytes),
            "per_array_cycles": list(self.per_array_cycles),
            "load_imbalance": self.load_imbalance,
            "decode_fused": self.decode_fused,
            "decode_fused_segments": self.decode_fused_segments,
            "decode_segments": self.decode_segments,
            "decode_hbm_elided_bytes": self.decode_hbm_elided_bytes,
            "kv": dict(self.kv),
            "resilience": dict(self.resilience),
            "requests_ok": sum(1 for r in self.requests
                               if r.status == "ok"),
            "requests_timed_out": sum(1 for r in self.requests
                                      if r.status == "timed_out"),
            "requests_failed": sum(1 for r in self.requests
                                   if r.status == "failed"),
            "retries_total": sum(r.retries for r in self.requests),
            "cache_hit_rate": self.cache.get("hit_rate", 0.0),
            "cache_searches": self.cache.get("searches", 0),
            "cache_compiles": self.cache.get("compiles", 0),
            "minisa_bytes_per_request": float(np.mean(
                [r.minisa_bytes for r in self.requests])) if self.requests
            else 0.0,
            "micro_bytes_per_request": float(np.mean(
                [r.micro_bytes for r in self.requests])) if self.requests
            else 0.0,
            "stall_minisa": float(np.mean(
                [r.stall_minisa for r in self.requests])) if self.requests
            else 0.0,
            "stall_micro": float(np.mean(
                [r.stall_micro for r in self.requests])) if self.requests
            else 0.0,
        }

    def to_dict(self) -> dict:
        """The full serialisable report: the summary, every per-request
        report, the complete cache stats (disk tier included) and the
        KVPool stats -- the shape the benchmark JSON and the CI
        artifacts carry."""
        return {
            **self.summary(),
            "requests": [r.summary() for r in self.requests],
            "cache": dict(self.cache),
            "kv": dict(self.kv),
        }

    def timeline(self, events=None) -> list[dict]:
        """Join tracer span events to requests: one entry per request,
        carrying its ``("request", rid)`` swimlane (submit instant,
        prefill chunks, per-tick decode spans, first-token / retire
        markers) in time order.  ``events`` defaults to the shared
        tracer's buffer; empty swimlanes (tracing off) yield empty
        span lists."""
        if events is None:
            events = trace.events()
        by_rid: dict[int, list] = {r.rid: [] for r in self.requests}
        for ev in events:
            if ev.track[0] == "request" and ev.track[1] in by_rid:
                by_rid[ev.track[1]].append(ev)
        out = []
        for r in self.requests:
            evs = sorted(by_rid[r.rid], key=lambda e: (e.t0_s, e.seq))
            out.append({
                "rid": r.rid,
                "ttft_s": r.ttft_s,
                "wall_s": r.wall_s,
                "state_checksum": r.state_checksum,
                "spans": [{
                    "name": ev.name, "t0_s": ev.t0_s, "dur_s": ev.dur_s,
                    "instant": ev.instant, **ev.attrs} for ev in evs],
            })
        return out

    def publish_metrics(self, registry=None) -> None:
        """Push the serving totals into the metrics registry (default:
        the shared ``obs.metrics`` one): MINISA vs micro instruction
        bytes and token counters, the scalar summary as gauges, and the
        KVPool + cache stats -- one scrape surface over every ad-hoc
        stats dict."""
        reg = registry if registry is not None else obs_metrics.REGISTRY
        reg.counter("minisa_bytes_total",
                    "MINISA instruction bytes served").inc(
                        sum(r.minisa_bytes for r in self.requests),
                        backend=self.backend)
        reg.counter("micro_bytes_total",
                    "micro-instruction control bytes (baseline)").inc(
                        sum(r.micro_bytes for r in self.requests),
                        backend=self.backend)
        reg.counter("tokens_total", "tokens served").inc(
            self.total_tokens, backend=self.backend)
        reg.counter("requests_total", "requests retired").inc(
            len(self.requests), backend=self.backend)
        timed_out = sum(1 for r in self.requests
                        if r.status == "timed_out")
        if timed_out:
            reg.counter("requests_timed_out_total",
                        "requests retired past their deadline").inc(
                            timed_out, backend=self.backend)
        retries = sum(r.retries for r in self.requests)
        if retries:
            reg.counter("retries_total",
                        "fault-retried request steps").inc(
                            retries, backend=self.backend)
        summary = self.summary()
        reg.set_many({k: v for k, v in summary.items()
                      if k not in ("kv", "resilience")}, prefix="sched_")
        reg.set_many(self.kv, prefix="kv_")


# ---------------------------------------------------------------------------
# Paged per-request KV state
# ---------------------------------------------------------------------------

def _kv_specs(executable: ModelExecutable) -> dict[str, tuple]:
    """name -> (shape, time_axis, time_extent, width) for every dynamic
    tensor.  The time-like axis is the *longer* one -- the same rule the
    commit recurrence has always used."""
    specs = {}
    for name, (shape, kind) in executable.tensor_specs().items():
        if kind != "dynamic":
            continue
        rows, cols = shape
        if cols > rows:
            specs[name] = (shape, 1, cols, rows)
        else:
            specs[name] = (shape, 0, rows, cols)
    return specs


class KVPool:
    """Fixed arena of KV pages shared by all in-flight requests.

    One page holds ``page_size`` time slots of EVERY dynamic tensor (one
    arena per tensor, indexed by the same page table), so a request's
    whole KV state allocates and evicts as one page list.  ``allocate``
    returns None when the pool is exhausted -- the scheduler turns that
    into an admission stall, never an OOM.
    """

    def __init__(self, specs: dict[str, tuple], page_size: int,
                 n_pages: int):
        self.specs = specs
        self.page_size = max(1, page_size)
        self.n_pages = max(1, n_pages)
        self.arenas = {
            name: np.zeros((self.n_pages * self.page_size, width),
                           np.float32)
            for name, (_, _, _, width) in specs.items()}
        self._free = list(range(self.n_pages - 1, -1, -1))
        self._allocated: set[int] = set()
        self.allocated_pages = 0
        self.high_water_pages = 0
        self.evicted_pages = 0
        self.admit_stalls = 0
        self.double_releases = 0
        self.reserved_pages = 0       # held out by a fault spike, now

    @property
    def time_extent(self) -> int:
        """Slots one request needs: the longest dynamic time axis."""
        return max((t for _, _, t, _ in self.specs.values()), default=1)

    @property
    def pages_per_request(self) -> int:
        return -(-self.time_extent // self.page_size)

    def allocate(self) -> list[int] | None:
        need = self.pages_per_request
        if len(self._free) < need:
            return None
        pages = [self._free.pop() for _ in range(need)]
        self._allocated.update(pages)
        self.allocated_pages += need
        self.high_water_pages = max(self.high_water_pages,
                                    self.allocated_pages)
        return pages

    def release(self, pages: list[int]) -> None:
        """Idempotent: only pages this pool currently has allocated go
        back to the free list.  A double release (or a stale page id)
        counts ``double_releases`` and is otherwise a no-op -- a page
        can never re-enter ``_free`` twice and be handed to two live
        requests."""
        live = [p for p in pages if p in self._allocated]
        self.double_releases += len(pages) - len(live)
        self._allocated.difference_update(live)
        self._free.extend(live)
        self.allocated_pages -= len(live)
        self.evicted_pages += len(live)

    def reserve(self, n: int = 0) -> list[int]:
        """Hold pages out of the free list (a fault-injected pressure
        spike): ``n <= 0`` grabs every free page.  Reserved pages are
        neither free nor allocated until :meth:`unreserve` returns
        them."""
        take = len(self._free) if n <= 0 else min(n, len(self._free))
        held = [self._free.pop() for _ in range(take)]
        self.reserved_pages += len(held)
        return held

    def unreserve(self, held: list[int]) -> None:
        self._free.extend(held)
        self.reserved_pages -= len(held)

    def stats(self) -> dict:
        return {
            "n_pages": self.n_pages,
            "page_size": self.page_size,
            "pages_per_request": self.pages_per_request,
            "allocated_pages": self.allocated_pages,
            "high_water_pages": self.high_water_pages,
            "evicted_pages": self.evicted_pages,
            "admit_stalls": self.admit_stalls,
            "double_releases": self.double_releases,
            "reserved_pages": self.reserved_pages,
        }


class PagedKV:
    """One request's KV state, resident in pool pages.

    ``seed``/``commit``/``gather`` reproduce the flat-dict recurrence
    bit-exactly: ``gather`` reconstructs the original-shaped float32
    tensors, so state checksums are independent of the paging layout.
    """

    def __init__(self, pool: KVPool, pages: list[int]):
        self.pool = pool
        self.pages = pages

    def _slot(self, j: int) -> int:
        ps = self.pool.page_size
        return self.pages[j // ps] * ps + j % ps

    def _slots(self, t_ext: int) -> np.ndarray:
        """Arena rows of time slots 0..t_ext-1, in order (one gather
        index instead of a Python loop over slots)."""
        ps = self.pool.page_size
        j = np.arange(t_ext)
        return np.asarray(self.pages, np.int64)[j // ps] * ps + j % ps

    def seed(self, dynamics: dict[str, np.ndarray]) -> None:
        for name, (shape, tax, t_ext, _) in self.pool.specs.items():
            arr = np.asarray(dynamics[name], np.float32)
            self.pool.arenas[name][self._slots(t_ext)] = \
                arr[:t_ext] if tax == 0 else arr[:, :t_ext].T

    def commit(self, out: np.ndarray, pos: int) -> None:
        """Deterministic bounded KV append: fold the step output into
        one time slot of each dynamic operand (same fold as the
        pre-paging ``_commit_kv``, same quantisation)."""
        # np.resize reads only the first ``width`` elements (cycled when
        # shorter) and the fold is elementwise: fold just that prefix
        width_max = max((w for *_, w in self.pool.specs.values()),
                        default=0)
        flat = np.asarray(out, np.float32).ravel()[:width_max]
        vec = _stabilize(np.tanh(flat))
        if vec.size == 0:
            return
        for name, (_, _, t_ext, width) in self.pool.specs.items():
            arena = self.pool.arenas[name]
            arena[self._slot(pos % t_ext), :] = np.resize(vec, width)

    def gather(self) -> dict[str, np.ndarray]:
        out = {}
        for name, (shape, tax, t_ext, _) in self.pool.specs.items():
            rows = self.pool.arenas[name][self._slots(t_ext)] \
                if t_ext else np.zeros(shape, np.float32)
            out[name] = np.ascontiguousarray(rows if tax == 0 else rows.T)
        return out

    def release(self) -> None:
        if self.pages:
            self.pool.release(self.pages)
            self.pages = []


@dataclasses.dataclass
class _Active:
    req: Request
    kv: PagedKV
    carry: np.ndarray | None            # previous step's output
    t_start: float
    prefill_chunks: int = 1             # total prompt chunks
    chunks_done: int = 0
    decoded: int = 0
    t_first: float = 0.0                # first decode token wall time
    # fault-tolerance state (all inert on a clean run)
    retries: int = 0                    # fault-retried steps, total
    consec_faults: int = 0              # consecutive, reset on success
    backoff_until: int = 0              # first tick allowed to run again
    pending_faults: list = dataclasses.field(default_factory=list)
    status: str = "ok"

    @property
    def prefill_done(self) -> bool:
        return self.chunks_done >= self.prefill_chunks

    @property
    def dynamics(self) -> dict[str, np.ndarray]:
        """Flat view of the paged KV state (compat / checksums)."""
        return self.kv.gather()


def _commit_kv(dynamics: dict[str, np.ndarray], out: np.ndarray,
               pos: int) -> None:
    """Flat-dict twin of :meth:`PagedKV.commit` (kept for direct use on
    unpaged dynamics dicts)."""
    vec = _stabilize(np.tanh(np.asarray(out, np.float32).ravel()))
    if vec.size == 0:
        return
    for arr in dynamics.values():
        if arr.shape[1] > arr.shape[0]:
            arr[:, pos % arr.shape[1]] = np.resize(vec, arr.shape[0])
        else:
            arr[pos % arr.shape[0], :] = np.resize(vec, arr.shape[1])


def _state_checksum(dynamics: dict[str, np.ndarray],
                    carry: np.ndarray) -> str:
    h = hashlib.sha1()
    for name in sorted(dynamics):
        h.update(name.encode())
        h.update(np.ascontiguousarray(dynamics[name]).tobytes())
    h.update(_stabilize(carry).tobytes())
    return h.hexdigest()


class Scheduler:
    """Split prefill/decode continuous-batching loop over executables.

    Seeding is fully explicit: every request's tensors derive from
    ``(self.seed, request seed)`` only -- never from admission order or
    leftover generator state -- and all recurrence feedback is quantised
    (``_stabilize``), so a run with the same submissions is
    bit-reproducible run-to-run, across backends *and across batch
    compositions* (``RequestReport.state_checksum`` is the regression
    surface).

    ``batch_decode`` (default: on for the CUDA backend on a
    single-array stream) advances the whole active batch through the
    decode stream's M-polymorphic segments with ONE backend launch per
    segment per tick; ``token_budget`` caps prefill tokens per tick so
    prompt work never starves the decode batch, and ``prompt_tokens``
    at submit chunks long prompts across ticks.

    When the executables carry an ``ArrayMesh``, every Program executes
    sharded (per-request; batching auto-disables) and the report adds
    per-array instruction traffic, modelled cycles and the
    load-imbalance factor -- the multi-array serving simulator view.
    On ranks of a process group (``dist.ranks``) the Scheduler runs on
    every rank, from the same seeds, in step: the CUDA backend splits
    each sharded launch across the ranks, everything else runs on each,
    and rank 0 alone decides which requests are past their deadlines.
    """

    def __init__(self, prefill: ModelExecutable, decode: ModelExecutable,
                 *, backend: str = "cuda", device="cuda",
                 max_concurrent: int = 4,
                 weight_seed: int = 0, seed: int = 0,
                 weights: tuple[dict, dict] | None = None,
                 use_fused: bool | None = None,
                 batch_decode: bool | None = None,
                 token_budget: int | None = None,
                 kv_page_size: int = 4, kv_pages: int | None = None,
                 faults: "FaultPlan | FaultInjector | None" = None,
                 finite_check: bool | None = None,
                 max_retries: int = 4,
                 backoff_base: int = 1, backoff_cap: int = 8,
                 breaker_threshold: int = 4, breaker_cooldown: int = 4):
        if prefill.cfg != decode.cfg:
            raise ValueError("prefill/decode executables must share one "
                             "FeatherConfig")
        if prefill.cache is not decode.cache:
            raise ValueError("prefill/decode executables must share one "
                             "ProgramCache")
        if prefill.n_arrays != decode.n_arrays:
            raise ValueError("prefill/decode executables must share one "
                             "ArrayMesh shape")
        self.prefill = prefill
        self.decode = decode
        self.backend_name = backend
        self.backend = prefill.make_backend(backend, device)
        self.max_concurrent = max_concurrent
        self.seed = seed
        # -- fault tolerance: entirely inert (no wrapper, no checks, no
        # extra branches on the hot path) unless a fault plan / injector
        # or an explicit finite_check opts in
        if isinstance(faults, FaultPlan):
            faults = FaultInjector(faults)
        self.injector: FaultInjector | None = faults
        self.finite_check = (finite_check if finite_check is not None
                             else faults is not None)
        self.resilient = self.injector is not None or self.finite_check
        self.max_retries = max(1, max_retries)
        self.backoff_base = max(1, backoff_base)
        self.backoff_cap = max(self.backoff_base, backoff_cap)
        self.breaker = (CircuitBreaker(breaker_threshold, breaker_cooldown)
                        if self.resilient else None)
        if self.injector is not None:
            self.backend = self.injector.wrap(self.backend)
        self._kv_spikes: list[tuple[int, list[int]]] = []
        self._mesh_degraded = 0
        # Fused-segment fast path: chained segments execute as ONE kernel
        # launch (prefill and decode).  Defaults on for the compiled
        # backend, where per-launch overhead dominates.
        self.use_fused = (use_fused if use_fused is not None
                          else backend == "cuda")
        # Cross-request batched decode: stack every active request along
        # M and advance the batch with one launch per segment per tick.
        # Mesh-sharded streams schedule per-request (on-chip residency is
        # per-array state), so batching auto-disables there.
        if batch_decode is None:
            batch_decode = backend == "cuda" and decode.mesh is None
        elif batch_decode and decode.mesh is not None:
            raise ValueError("batch_decode requires a single-array "
                             "decode stream (got an ArrayMesh)")
        self.batch_decode = batch_decode
        #: prefill tokens one tick may spend (None == unbounded); decode
        #: always runs first, so prompts never stall the decode batch
        self.token_budget = token_budget
        # paged per-request KV state: sized so max_concurrent requests
        # fit by default; smaller pools admission-stall, never OOM
        specs = _kv_specs(decode)
        t_ext = max((t for _, _, t, _ in specs.values()), default=1)
        per_req = -(-t_ext // max(1, kv_page_size))
        if kv_pages is None:
            kv_pages = per_req * max_concurrent
        if kv_pages < per_req:
            raise ValueError(
                f"kv_pages={kv_pages} cannot hold even one request "
                f"({per_req} pages of {kv_page_size} slots needed)")
        self.kv_pool = KVPool(specs, kv_page_size, kv_pages)
        # weight residency: one static weight set serves every request,
        # moved to the backend's device once -- or the (prefill, decode)
        # sets of another Scheduler of the same model (``weights``), so
        # a flat and a mesh server on one device share them
        dev = self.backend.device
        if weights is None:
            weights = tuple(
                tensors_from_numpy(ex.make_tensors(weight_seed,
                                                   kinds=("weight",)), dev)
                for ex in (prefill, decode))
        for ex, w in zip((prefill, decode), weights):
            names = {n for n, (_, kind) in ex.tensor_specs().items()
                     if kind == "weight"}
            if set(w) != names:
                raise ValueError(f"weights of {ex.name} must be exactly "
                                 f"its weight tensors {sorted(names)}")
        self.prefill_weights, self.decode_weights = weights
        self._pending: collections.deque[Request] = collections.deque()
        self._next_rid = 0
        # serving state shared between the loop, snapshot() and resumed
        # run() calls: in-flight work, retired reports (this process +
        # restored from a snapshot), and the monotone tick clock
        self._active: list[_Active] = []
        self._done: list[RequestReport] = []
        self._restored: list[RequestReport] = []
        self._ticks = 0

    def submit(self, decode_steps: int, seed: int | None = None,
               prompt_tokens: int | None = None,
               deadline_s: float | None = None) -> Request:
        """Queue a request.  The default per-request seed derives from
        the scheduler seed and the rid alone, so a submission sequence
        reproduces exactly regardless of wall-clock or interleaving.
        ``prompt_tokens`` longer than one prefill pass are chunked
        across ticks under the token budget; ``deadline_s`` bounds the
        request's wall clock from submission (overdue -> ``timed_out``)."""
        if seed is None:
            seed = self.seed * 1_000_003 + self._next_rid
        req = Request(rid=self._next_rid, decode_steps=decode_steps,
                      seed=seed, prompt_tokens=prompt_tokens,
                      t_submit=time.perf_counter(), deadline_s=deadline_s)
        self._next_rid += 1
        self._pending.append(req)
        trace.instant("submit", ("request", req.rid),
                      decode_steps=decode_steps,
                      prompt_tokens=prompt_tokens)
        return req

    # -- one request's phases -------------------------------------------------
    def _chunks_for(self, req: Request) -> int:
        chunk = max(1, self.prefill.tokens or 1)
        prompt = req.prompt_tokens if req.prompt_tokens else chunk
        return max(1, -(-prompt // chunk))

    def _admit(self, req: Request) -> _Active | None:
        """Allocate KV pages and run the first prompt chunk; None when
        the pool cannot hold another request (admission stall).  A fault
        on the first chunk (resilient runs only) backs the request off
        in place -- it is admitted, pages held, chunk 0 retried on a
        later tick."""
        pages = self.kv_pool.allocate()
        if pages is None:
            return None
        trace.instant("admit", ("request", req.rid), pages=len(pages))
        # request wall time runs from submission (queueing included)
        a = _Active(req=req, kv=PagedKV(self.kv_pool, pages), carry=None,
                    t_start=req.t_submit or time.perf_counter(),
                    prefill_chunks=self._chunks_for(req))
        try:
            self._prefill_chunk(a)
        except FaultError as e:
            self._on_fault(a, e)
        return a

    def _prefill_chunk(self, a: _Active) -> None:
        """One prompt chunk through the prefill stream (fused fast path
        under ``use_fused``), committed into the request's KV at the
        chunk position.  Chunk 0 seeds the KV from the request seed;
        later chunks carry the stabilised output forward, so chunking is
        itself a deterministic recurrence."""
        c = a.chunks_done
        env = dict(self.prefill_weights)
        if c == 0:
            env.update(self.prefill.make_tensors(
                a.req.seed, kinds=("dynamic", "input")))
        else:
            env.update(self.prefill.make_tensors(
                a.req.seed + 7_919 * c, kinds=("dynamic",)))
            env.update(_carry_inputs(self.prefill, a.carry))
        with trace.span("prefill_chunk", ("request", a.req.rid),
                        chunk=c, of=a.prefill_chunks):
            final = _host(self.prefill.run(self.backend, tensors=env,
                                           fused=self.use_fused).final)
        if self.finite_check and not check_finite(final):
            # nothing committed yet: the chunk replays identically
            raise PoisonedOutputError(
                f"non-finite prefill output (rid {a.req.rid} chunk {c})")
        if c == 0:
            a.kv.seed(self.decode.make_tensors(a.req.seed,
                                               kinds=("dynamic",)))
        a.carry = final
        a.kv.commit(final, c)       # prompt chunk feeds the KV
        a.chunks_done += 1

    def _decode_env(self, a: _Active) -> dict:
        env = dict(self.decode_weights)
        env.update(a.kv.gather())
        # quantised carrier: every path feeds identical step inputs
        env.update(_carry_inputs(self.decode, a.carry))
        return env

    def _after_decode(self, a: _Active, final: np.ndarray) -> None:
        if self.resilient:
            self._note_success(a)
        a.decoded += 1
        a.carry = final
        if a.t_first == 0.0:
            a.t_first = time.perf_counter()
            trace.instant("first_token", ("request", a.req.rid),
                          ttft_s=a.t_first - (a.req.t_submit
                                              or a.t_start))
        # decode commits continue the prompt chunks' positions
        a.kv.commit(final, a.prefill_chunks - 1 + a.decoded)

    def _decode_step(self, a: _Active) -> None:
        with trace.span("decode_step", ("request", a.req.rid),
                        step=a.decoded):
            final = _host(self.decode.run(self.backend,
                                          tensors=self._decode_env(a),
                                          fused=self.use_fused).final)
        if self.finite_check and not check_finite(final):
            # carry/KV untouched: the retry replays from identical state
            raise PoisonedOutputError(
                f"non-finite decode output (rid {a.req.rid} "
                f"step {a.decoded})")
        self._after_decode(a, final)

    def _decode_batch(self, batch: list[_Active]) -> None:
        """One tick of the whole decode batch: every request's row
        stacked along M, one backend launch per M-polymorphic segment
        (``ModelExecutable.run_batch``).  Under tracing, the collective
        launch window is recorded onto every participating request's
        swimlane (one measurement, several lanes).  With the finite
        guard on, each request's row is checked before its commit:
        poisoned rows fault (and retry), clean rows commit -- one bad
        launch cannot wedge the whole batch."""
        t0 = time.perf_counter() if trace.enabled else 0.0
        finals = [_host(f) for f in self.decode.run_batch(
            self.backend, [self._decode_env(a) for a in batch],
            fused=self.use_fused)]
        if trace.enabled:
            t1 = time.perf_counter()
            for a in batch:
                trace.record("decode_step", ("request", a.req.rid),
                             t0, t1, step=a.decoded, batched=True,
                             batch=len(batch))
        for a, final in zip(batch, finals):
            if self.finite_check and not check_finite(final):
                self._on_fault(a, PoisonedOutputError(
                    f"non-finite batched decode output "
                    f"(rid {a.req.rid} step {a.decoded})"))
            else:
                self._after_decode(a, final)

    def _report(self, a: _Active, pre: dict, dec: dict) -> RequestReport:
        n = a.decoded
        c = a.chunks_done
        return RequestReport(
            rid=a.req.rid,
            prefill_tokens=c * (self.prefill.tokens or 0),
            decode_tokens=n * (self.decode.tokens or 1),
            wall_s=time.perf_counter() - a.t_start,
            minisa_bytes=c * pre["minisa_bytes"] + n * dec["minisa_bytes"],
            micro_bytes=c * pre["micro_bytes"] + n * dec["micro_bytes"],
            cycles_minisa=(c * pre["cycles_minisa"]
                           + n * dec["cycles_minisa"]),
            cycles_micro=(c * pre["cycles_micro"]
                          + n * dec["cycles_micro"]),
            stall_minisa=(c * pre["stall_cycles_minisa"]
                          + n * dec["stall_cycles_minisa"])
            / max(c * pre["cycles_minisa"] + n * dec["cycles_minisa"],
                  1e-9),
            stall_micro=(c * pre["stall_cycles_micro"]
                         + n * dec["stall_cycles_micro"])
            / max(c * pre["cycles_micro"] + n * dec["cycles_micro"], 1e-9),
            state_checksum=_state_checksum(a.kv.gather(), a.carry),
            ttft_s=(a.t_first - a.req.t_submit
                    if a.t_first and a.req.t_submit else 0.0),
            status=a.status,
            retries=a.retries,
        )

    # -- fault tolerance ------------------------------------------------------
    def _on_fault(self, a: _Active, err: FaultError) -> None:
        """One failed step: nothing was committed (carry and KV are
        untouched), so the retry replays from bit-identical state.
        Capped exponential backoff in ticks; the breaker counts the
        failure; past ``max_retries`` consecutive faults the request
        retires as ``failed`` instead of wedging the loop."""
        tick = self._ticks
        kind = ("launch_nan" if isinstance(err, PoisonedOutputError)
                else "launch_transient")
        a.retries += 1
        a.consec_faults += 1
        a.pending_faults.append(kind)
        delay = min(self.backoff_cap,
                    self.backoff_base * (1 << (a.consec_faults - 1)))
        a.backoff_until = tick + delay
        if self.breaker is not None:
            self.breaker.record_failure(tick)
        trace.instant("fault_retry", ("request", a.req.rid), kind=kind,
                      retry=a.retries, backoff_ticks=delay, tick=tick)
        if a.consec_faults > self.max_retries:
            a.status = "failed"

    def _note_success(self, a: _Active) -> None:
        """A step committed: the request's pending faults are recovered
        (counted against the injector's ledger), its backoff resets, and
        the breaker sees the success."""
        if a.pending_faults:
            if self.injector is not None:
                for kind in a.pending_faults:
                    self.injector.mark_recovered(kind, rid=a.req.rid)
            a.pending_faults.clear()
        a.consec_faults = 0
        a.backoff_until = 0
        if self.breaker is not None and (
                self.breaker.failures or self.breaker.state != "closed"):
            self.breaker.record_success()

    def _degrade_mesh(self, site: int) -> None:
        """Array ``site`` went unhealthy: both executables re-lower onto
        the surviving mesh in place (a cache-miss re-lower through
        ``shard_program`` -- plan/lowered tiers all hit).  In-flight
        requests keep their KV state; only the *lowering* changed, and
        quantised recurrence feedback keeps the state trajectory
        bit-identical to the undegraded run."""
        mesh = self.prefill.mesh.degraded(1)
        self.injector.mark_injected("array_down", site=site,
                                    n_arrays=mesh.n_arrays)
        with trace.span("mesh_failover", ("fault", "array_down"),
                        site=site, n_arrays=mesh.n_arrays):
            self.prefill.remesh(mesh)
            self.decode.remesh(mesh)
        self._mesh_degraded += 1
        self.injector.mark_recovered("array_down", n_arrays=mesh.n_arrays)

    def _apply_fault_event(self, ev) -> None:
        """Dispatch one due scheduler-level fault event."""
        tick = self._ticks
        if ev.kind == "array_down":
            if self.prefill.mesh is None:
                self.injector.mark_skipped("array_down")
            else:
                self._degrade_mesh(ev.site)
        elif ev.kind == "kv_exhaust":
            held = self.kv_pool.reserve(ev.pages)
            self._kv_spikes.append((tick + ev.duration, held))
            self.injector.mark_injected("kv_exhaust", pages=len(held),
                                        until=tick + ev.duration)
        elif ev.kind == "cache_corrupt":
            cache = self.prefill.cache
            if not cache.path:
                self.injector.mark_skipped("cache_corrupt")
                return
            cache.save()
            if not self.injector.corrupt_cache_file(cache.path):
                self.injector.mark_skipped("cache_corrupt")
                return
            self.injector.mark_injected("cache_corrupt")
            before = cache.stats.disk_corrupt
            cache.load(cache.path)   # quarantines, never raises
            if cache.stats.disk_corrupt > before:
                self.injector.mark_recovered(
                    "cache_corrupt",
                    quarantined=cache.stats.disk_corrupt - before)

    def _release_due_spikes(self, drain: bool = False) -> None:
        """Expired pressure spikes hand their pages back (``drain``
        releases everything -- the loop finished under pressure, so the
        pool is whole again by construction)."""
        tick = self._ticks
        for until, held in [s for s in self._kv_spikes
                            if drain or s[0] <= tick]:
            self.kv_pool.unreserve(held)
            self._kv_spikes.remove((until, held))
            self.injector.mark_recovered("kv_exhaust", pages=len(held))

    def _overdue(self, active: list[_Active]) -> set[int]:
        """The rids of unfinished requests past their deadline.  On ranks
        of a process group every rank runs this loop in step (SPMD), and
        a decision taken from each rank's own clock would break the step:
        rank 0 decides, once a tick, and the others follow."""
        now = time.perf_counter()
        rids = {a.req.rid for a in active
                if a.req.deadline_s is not None and a.status == "ok"
                and now - a.t_start > a.req.deadline_s}
        if dist_ranks.world_size() > 1:
            rids = dist_ranks.broadcast_object(rids, src=0)
        return rids

    # -- snapshot / resume ----------------------------------------------------
    def snapshot(self) -> dict:
        """The deterministic request state a resumed process needs:
        every not-yet-finished request (pending queue + in-flight, which
        replay from their seeds) and every retired report.  Pair with
        ``dist.elastic.save_serving_snapshot`` for the atomic file."""
        pending = [dataclasses.asdict(a.req) for a in self._active]
        pending += [dataclasses.asdict(r) for r in self._pending]
        pending.sort(key=lambda r: r["rid"])
        return {"version": 1, "seed": self.seed,
                "next_rid": self._next_rid,
                "pending": pending,
                "done": [dataclasses.asdict(r)
                         for r in self._restored + self._done]}

    def restore(self, snap: dict) -> int:
        """Adopt a snapshot into a fresh scheduler: retired reports are
        kept verbatim, unfinished requests re-queue (same rid, same
        seed -- the replayed trajectory is bit-identical, so the resumed
        run's checksums match an uninterrupted one).  Returns the number
        of requests re-queued."""
        if snap.get("version") != 1:
            raise ValueError(f"unknown snapshot version "
                             f"{snap.get('version')!r}")
        if snap.get("seed") != self.seed:
            raise ValueError("snapshot seed mismatch: replayed requests "
                             "would not reproduce")
        self._next_rid = max(self._next_rid, int(snap["next_rid"]))
        now = time.perf_counter()
        for r in snap["pending"]:
            self._pending.append(dataclasses.replace(
                Request(**r), t_submit=now))
        self._restored = [RequestReport(**d) for d in snap["done"]]
        return len(snap["pending"])

    # -- the serving loop -----------------------------------------------------
    def run(self, max_ticks: int | None = None) -> SchedulerReport:
        """Serve every submitted request to completion.  The loop runs
        under a ``scheduler.run`` span; on return the report's totals
        (plus the cache's per-tier stats) are published into the shared
        metrics registry.

        ``max_ticks`` stops the loop early (chaos-kill simulation / an
        external drain signal): unfinished requests stay in the
        scheduler's state for :meth:`snapshot`, and the partial report
        covers only the retired ones."""
        with trace.span("scheduler.run", backend=self.backend_name,
                        batch_decode=self.batch_decode,
                        max_concurrent=self.max_concurrent):
            report = self._run_loop(max_ticks)
        report.publish_metrics()
        self.prefill.cache.publish_metrics()
        return report

    def _retire(self, a: _Active, per_bytes: list, per_cycles: list,
                done: list) -> None:
        """Retire one request (complete, timed out or failed): report,
        trace, evict its KV pages, fold its per-array accounting."""
        self._active.remove(a)
        pre = self.prefill.perf_stats()
        dec = self.decode.perf_stats()
        rep = self._report(a, pre, dec)
        done.append(rep)
        trace.instant("retire", ("request", a.req.rid),
                      decoded=a.decoded, status=a.status)
        if trace.enabled:
            # the request's whole lifetime as one backdrop
            # span on its swimlane (arrival -> retire)
            trace.record("request", ("request", a.req.rid),
                         a.t_start, time.perf_counter(),
                         rid=a.req.rid, decoded=a.decoded,
                         checksum=rep.state_checksum)
        a.kv.release()   # checksum gathered; evict the pages
        c, n = a.chunks_done, a.decoded
        # a degraded mesh shrinks the executables' per-array lists
        # mid-run; fold what both sides still account for
        n_fold = min(len(per_bytes), len(pre["per_array_minisa_bytes"]),
                     len(dec["per_array_minisa_bytes"]))
        for i in range(n_fold):
            per_bytes[i] += (
                c * pre["per_array_minisa_bytes"][i]
                + n * dec["per_array_minisa_bytes"][i])
            per_cycles[i] += (
                c * pre["per_array_cycles_minisa"][i]
                + n * dec["per_array_cycles_minisa"][i])

    def _resilience_summary(self, done: list) -> dict:
        if not self.resilient:
            return {}
        res = {
            "finite_check": self.finite_check,
            "max_retries": self.max_retries,
            "retries_total": sum(r.retries for r in done),
            "timed_out": sum(1 for r in done if r.status == "timed_out"),
            "failed": sum(1 for r in done if r.status == "failed"),
            "breaker": self.breaker.stats(),
            "mesh_degraded": self._mesh_degraded,
            "kv_spikes_live": len(self._kv_spikes),
        }
        if self.injector is not None:
            res.update(self.injector.summary())
        return res

    def _run_loop(self, max_ticks: int | None = None) -> SchedulerReport:
        t0 = time.perf_counter()
        n_arrays = self.prefill.n_arrays
        per_bytes = [0.0] * n_arrays
        per_cycles = [0.0] * n_arrays
        active = self._active
        done = self._done
        ran = 0
        decode_wall = prefill_wall = 0.0
        decode_ticks = decode_steps_total = decode_launches = 0
        chunk_tokens = max(1, self.prefill.tokens or 1)
        while (self._pending or active) and (max_ticks is None
                                             or ran < max_ticks):
            ran += 1
            self._ticks += 1
            ticks = self._ticks
            # 0) fault plan: due scheduler-level events apply first, and
            #    expired KV spikes hand their pages back
            if self.injector is not None:
                self._release_due_spikes()
                for ev in self.injector.begin_tick(ticks):
                    self._apply_fault_event(ev)
            # 1) decode phase: the whole ready batch advances one step
            ready = [a for a in active
                     if a.prefill_done and a.decoded < a.req.decode_steps]
            if self.resilient:
                gate = self.breaker.allow(ticks)
                ready = [a for a in ready
                         if gate and a.status == "ok"
                         and ticks >= a.backoff_until]
            if ready:
                td = time.perf_counter()
                l0 = getattr(self.backend, "n_launches", 0)
                with trace.span("decode_tick", tick=ticks,
                                n_ready=len(ready),
                                batched=self.batch_decode) as sp:
                    try:
                        if self.batch_decode:
                            self._decode_batch(ready)
                        else:
                            for a in ready:
                                try:
                                    self._decode_step(a)
                                except FaultError as e:
                                    self._on_fault(a, e)
                    except FaultError as e:
                        # batched transient: the whole batch missed its
                        # step (no state was committed anywhere)
                        for a in ready:
                            self._on_fault(a, e)
                    if sp:
                        sp.set(launches=getattr(self.backend,
                                                "n_launches", 0) - l0)
                decode_wall += time.perf_counter() - td
                decode_launches += (getattr(self.backend, "n_launches", 0)
                                    - l0)
                decode_ticks += 1
                decode_steps_total += len(ready)
            # 2) retire finished requests mid-batch, evicting their KV;
            #    overdue requests retire as timed_out, and requests past
            #    their retry budget as failed -- neither wedges the loop
            overdue = self._overdue(active)
            for a in list(active):
                finished = (a.prefill_done
                            and a.decoded >= a.req.decode_steps)
                if not finished:
                    if a.status == "ok" and a.req.rid in overdue:
                        a.status = "timed_out"
                        trace.instant("timeout", ("request", a.req.rid),
                                      decoded=a.decoded)
                    if a.status == "ok":
                        continue
                self._retire(a, per_bytes, per_cycles, done)
            # 3) prefill phase under the per-tick token budget: continue
            #    admitted prompts first (oldest-first), then admit new
            #    requests into free slots.  When nothing decoded and
            #    nothing progressed, one chunk is forced so the loop
            #    always makes progress.
            tp = time.perf_counter()
            budget = (self.token_budget if self.token_budget is not None
                      else float("inf"))
            progressed = False
            gate = (not self.resilient) or self.breaker.allow(ticks)
            with trace.span("prefill_phase", tick=ticks,
                            n_pending=len(self._pending)):
                for a in active:
                    if self.resilient and (a.status != "ok"
                                           or ticks < a.backoff_until):
                        continue
                    while (gate and not a.prefill_done
                           and (budget >= chunk_tokens
                                or (not ready and not progressed))):
                        try:
                            self._prefill_chunk(a)
                        except FaultError as e:
                            self._on_fault(a, e)
                            break
                        budget -= chunk_tokens
                        progressed = True
                while (gate and self._pending
                       and len(active) < self.max_concurrent):
                    if budget < chunk_tokens and (ready or progressed):
                        break
                    a = self._admit(self._pending[0])
                    if a is None:   # KV pool exhausted: wait for retires
                        self.kv_pool.admit_stalls += 1
                        break
                    self._pending.popleft()
                    active.append(a)
                    budget -= chunk_tokens
                    progressed = True
            prefill_wall += time.perf_counter() - tp
        if self.injector is not None and not (self._pending or active):
            self._release_due_spikes(drain=True)
        done = sorted(self._restored + done, key=lambda r: r.rid)
        fusion = self.decode.fusion_stats()
        return SchedulerReport(
            backend=self.backend_name, requests=done,
            wall_s=time.perf_counter() - t0, ticks=self._ticks,
            max_concurrent=self.max_concurrent,
            cache=self.prefill.cache.stats.summary(),
            n_arrays=self.prefill.n_arrays,
            per_array_minisa_bytes=per_bytes,
            per_array_cycles=per_cycles,
            decode_fused=self.use_fused,
            decode_fused_segments=fusion["n_fused_segments"],
            decode_segments=fusion["n_segments"],
            decode_hbm_elided_bytes=(fusion["hbm_bytes_elided"]
                                     if self.use_fused else 0.0),
            batch_decode=self.batch_decode,
            decode_wall_s=decode_wall,
            prefill_wall_s=prefill_wall,
            decode_steps_total=decode_steps_total,
            decode_ticks=decode_ticks,
            decode_launches=decode_launches,
            kv=self.kv_pool.stats(),
            resilience=self._resilience_summary(done))
