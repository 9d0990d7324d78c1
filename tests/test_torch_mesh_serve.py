"""The port's Scheduler on an ArrayMesh, under faults, and resumed from a
snapshot, against the JAX package's, on the CPU: the serving cases of
``tests/test_sharded.py`` and ``tests/test_faults.py``.  The port serves
on its ``"interpreter"`` and ``"cuda"`` backends with ``device="cpu"``;
the reference on Pallas in interpret mode, whose checksums equal its
interpreter's.  Held equal: per-request ``state_checksum``s bit for bit
(flat, on 2 and 4 arrays, under chaos, after a mesh failover and after a
resume, the reference's snapshot restored by the port's scheduler
included), per-array bytes, ``launches_per_decode_tick``,
``mesh_degraded`` and the injected fault kinds."""

import json
import os

import pytest
import torch

from repro.configs.feather import feather_config as j_feather
from repro.dist import ArrayMesh as JMesh
from repro.dist.elastic import save_serving_snapshot as j_save_snapshot
from repro.faults import FaultInjector as JInjector
from repro.faults import FaultPlan as JPlan
from repro.runtime import ModelExecutable as JExecutable
from repro.runtime import ProgramCache as JCache
from repro.runtime import Scheduler as JScheduler
from repro_torch.configs.feather import feather_config
from repro_torch.dist import ArrayMesh
from repro_torch.dist.elastic import (load_serving_snapshot,
                                      save_serving_snapshot)
from repro_torch.faults import (FaultEvent, FaultInjector, FaultPlan,
                                FaultyBackend)
from repro_torch.obs.export import fault_events, write_fault_events
from repro_torch.obs.trace import trace
from repro_torch.runtime import ModelExecutable, ProgramCache, Scheduler

CFG = feather_config(4, 16)
J_CFG = j_feather(4, 16)
BACKENDS = ["interpreter", "cuda"]


def _executables(ex_cls, cache, cfg, mesh):
    return tuple(ex_cls.for_cell("gemma-7b", shape, cfg, cache=cache,
                                 mesh=mesh)
                 for shape in ("prefill_tiny", "decode_tiny"))


def _scheduler(cache, backend, *, mesh=None, seed=7, faults=None, **kw):
    prefill, decode = _executables(ModelExecutable, cache, CFG, mesh)
    return Scheduler(prefill, decode, backend=backend, device="cpu",
                     max_concurrent=2, seed=seed, faults=faults, **kw)


def _serve(cache, backend, *, mesh=None, seed=7, faults=None,
           n_requests=3, decode_steps=4, **kw):
    sched = _scheduler(cache, backend, mesh=mesh, seed=seed, faults=faults,
                       **kw)
    for _ in range(n_requests):
        sched.submit(decode_steps=decode_steps)
    return sched.run()


def _j_scheduler(cache, *, mesh=None, seed=7, faults=None):
    prefill, decode = _executables(JExecutable, cache, J_CFG, mesh)
    return JScheduler(prefill, decode, backend="pallas", max_concurrent=2,
                      seed=seed, faults=faults)


def _j_serve(cache, *, mesh=None, seed=7, faults=None, n_requests=3,
             decode_steps=4):
    sched = _j_scheduler(cache, mesh=mesh, seed=seed, faults=faults)
    for _ in range(n_requests):
        sched.submit(decode_steps=decode_steps)
    return sched.run()


def _checksums(report):
    return [r.state_checksum for r in report.requests]


@pytest.fixture(scope="module")
def cache():
    return ProgramCache()


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's serves, each run once: flat and on 2 and 4 arrays
    (3 requests of 2 steps, seed 0 -- tests/test_sharded.py), then flat,
    on 2 arrays, and both under the standard fault plan (3 requests of 4
    steps, seed 7 -- tests/test_faults.py); as there, the flat chaos
    serve's cache is kept on disk (``cache_corrupt`` has a file to
    corrupt) and the mesh's is not."""
    jc = JCache()
    disk = JCache(path=tmp_path_factory.mktemp("ref") / "cache.bin")
    out = {}
    for n in (1, 2, 4):
        mesh = JMesh(n) if n > 1 else None
        sched = _j_scheduler(jc, mesh=mesh, seed=0)
        for _ in range(3):
            sched.submit(decode_steps=2)
        out[("mesh", n)] = sched.run()
    for n in (1, 2):
        mesh = JMesh(n) if n > 1 else None
        out[("base", n)] = _j_serve(jc, mesh=mesh)
        inj = JInjector(JPlan.standard(0, n_arrays=n))
        out[("chaos", n)] = (_j_serve(disk if n == 1 else jc, mesh=mesh,
                                      faults=inj), inj)
    return out


# ---------------------------------------------------------------------------
# Mesh-aware scheduler: determinism, per-array report, parity
# ---------------------------------------------------------------------------

def _sched_run(cache, backend, mesh=None, seed=0):
    sched = _scheduler(cache, backend, mesh=mesh, seed=seed)
    for _ in range(3):
        sched.submit(decode_steps=2)
    return sched.run()


def test_scheduler_run_bit_reproducible(cache, ref):
    """Same submissions -> identical checksums run to run and across
    backends, equal to the reference's; another seed diverges; traffic
    accounting is backend-independent byte for byte."""
    a = _sched_run(cache, "interpreter")
    b = _sched_run(cache, "interpreter")
    c = _sched_run(cache, "cuda")
    want = ref[("mesh", 1)]
    assert _checksums(a) == _checksums(b) == _checksums(c) == \
        _checksums(want)
    assert all(r.state_checksum for r in a.requests)
    other = _sched_run(cache, "interpreter", seed=7)
    assert _checksums(other) != _checksums(a)
    assert [r.minisa_bytes for r in a.requests] == \
        [r.minisa_bytes for r in c.requests] == \
        [r.minisa_bytes for r in want.requests]
    assert c.launches_per_decode_tick == want.launches_per_decode_tick


@pytest.mark.parametrize("n_arrays", [2, 4])
@pytest.mark.parametrize("backend", BACKENDS)
def test_scheduler_mesh_report(cache, ref, backend, n_arrays):
    """A mesh serve: per-array report fields, checksums equal to the
    flat serve and to the reference's mesh serve, per-array bytes and
    launches per decode tick equal to the reference's (which counts no
    launch of a plain sharded step, ROADMAP C)."""
    rep = _sched_run(cache, backend, mesh=ArrayMesh(n_arrays))
    want = ref[("mesh", n_arrays)]
    assert rep.n_arrays == n_arrays
    assert len(rep.per_array_minisa_bytes) == n_arrays
    assert all(b > 0 for b in rep.per_array_minisa_bytes)
    assert rep.load_imbalance >= 1.0
    s = rep.summary()
    assert s["n_arrays"] == n_arrays and len(s["per_array_cycles"]) == \
        n_arrays
    assert _checksums(rep) == _checksums(ref[("mesh", 1)]) == \
        _checksums(want)
    assert rep.per_array_minisa_bytes == want.per_array_minisa_bytes
    assert rep.per_array_cycles == want.per_array_cycles
    assert rep.launches_per_decode_tick == want.launches_per_decode_tick
    assert not rep.batch_decode


def test_mesh_scheduler_shares_the_flat_schedulers_weights(cache, ref):
    """A mesh Scheduler given a flat Scheduler's resident weights holds
    the same tensors and serves the reference's mesh checksums; a weight
    set that lacks one of the stream's weights is refused."""
    flat = _scheduler(cache, "cuda", seed=0)
    weights = (flat.prefill_weights, flat.decode_weights)
    sched = _scheduler(cache, "cuda", mesh=ArrayMesh(4), seed=0,
                       weights=weights)
    assert sched.prefill_weights is flat.prefill_weights
    assert sched.decode_weights is flat.decode_weights
    for _ in range(3):
        sched.submit(decode_steps=2)
    assert _checksums(sched.run()) == _checksums(ref[("mesh", 4)])
    short = dict(list(flat.decode_weights.items())[1:])
    with pytest.raises(ValueError, match="weight tensors"):
        _scheduler(cache, "cuda", weights=(flat.prefill_weights, short))


def test_scheduler_rejects_mismatched_meshes(cache):
    prefill = ModelExecutable.for_cell("gemma-7b", "prefill_tiny", CFG,
                                       cache=cache, mesh=ArrayMesh(4))
    decode = ModelExecutable.for_cell("gemma-7b", "decode_tiny", CFG,
                                      cache=cache)
    with pytest.raises(ValueError, match="ArrayMesh"):
        Scheduler(prefill, decode, device="cpu")


# ---------------------------------------------------------------------------
# Chaos acceptance: every fault kind injected, every one recovered, and
# the surviving checksums bit-identical to the fault-free run's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_chaos_run_matches_fault_free(cache, ref, backend, tmp_path):
    disk = ProgramCache(path=tmp_path / "cache.bin")
    # share the warm in-memory tiers so the test pays no search
    disk._plans.update(cache._plans)
    baseline = _serve(disk, backend)
    injector = FaultInjector(FaultPlan.standard(0, n_arrays=1))
    chaotic = _serve(disk, backend, faults=injector)
    assert set(injector.injected) == {"launch_transient", "launch_nan",
                                      "kv_exhaust", "cache_corrupt"}
    assert injector.unrecovered() == 0
    assert all(r.status == "ok" for r in chaotic.requests)
    assert any(r.retries > 0 for r in chaotic.requests)
    assert _checksums(chaotic) == _checksums(baseline) == \
        _checksums(ref[("base", 1)])
    res = chaotic.summary()["resilience"]
    assert res["unrecovered"] == 0 and res["retries_total"] > 0
    assert baseline.summary()["resilience"] == {}
    jrep, jinj = ref[("chaos", 1)]
    assert _checksums(chaotic) == _checksums(jrep)
    assert set(injector.injected) == set(jinj.injected)
    cache._plans.update(disk._plans)


@pytest.mark.parametrize("backend", BACKENDS)
def test_chaos_mesh_failover_matches_fault_free(cache, ref, backend):
    """array_down degrades the mesh mid-run; the re-lowered stream keeps
    serving and the request state trajectory is unchanged (and the
    reference's)."""
    baseline = _serve(cache, backend, mesh=ArrayMesh(2))
    injector = FaultInjector(FaultPlan.standard(0, n_arrays=2))
    chaotic = _serve(cache, backend, mesh=ArrayMesh(2), faults=injector)
    assert injector.injected.get("array_down") == 1
    assert injector.unrecovered() == 0
    assert chaotic.n_arrays == 1
    assert baseline.n_arrays == 2
    res = chaotic.summary()["resilience"]
    assert res["mesh_degraded"] == 1
    assert all(r.status == "ok" for r in chaotic.requests)
    assert _checksums(chaotic) == _checksums(baseline) == \
        _checksums(ref[("base", 2)])
    jrep, jinj = ref[("chaos", 2)]
    assert _checksums(chaotic) == _checksums(jrep)
    assert set(injector.injected) == set(jinj.injected)
    assert injector.injected == jinj.injected
    assert res["mesh_degraded"] == \
        jrep.summary()["resilience"]["mesh_degraded"]
    assert chaotic.n_arrays == jrep.n_arrays
    if backend == "cuda":   # the compiled backends' launch counts
        assert baseline.launches_per_decode_tick == \
            ref[("base", 2)].launches_per_decode_tick
        assert chaotic.launches_per_decode_tick == \
            jrep.launches_per_decode_tick


def _resident_slice_keys(sched):
    """The (source id, bounds) of every column slice that the cuda
    backend's per-step sharded path cuts from a resident weight on the
    scheduler's current mesh."""
    keys = set()
    for ex, weights in ((sched.prefill, sched.prefill_weights),
                        (sched.decode, sched.decode_weights)):
        for seg in ex.segments:
            if sched.use_fused and seg.fused is not None:
                continue
            for i in seg.indices:
                s = ex.steps[i]
                w = weights.get(s.weight_name)
                if w is None or s.sharded is None:
                    continue
                for sh in s.sharded.shards:
                    if not w[sh.k0:sh.k1, sh.n0:sh.n1].is_contiguous():
                        keys.add((id(w), (sh.k0, sh.k1, sh.n0, sh.n1)))
    return keys


def test_failover_keeps_only_the_surviving_meshs_weight_slices(cache):
    """A failover from 4 arrays to 3 re-cuts the resident weights: the
    cuda backend then holds the 3-array mesh's column-slice copies and
    none of the 4-array mesh's, and the serve's checksums equal the
    fault-free 4-array serve's."""
    baseline = _serve(cache, "cuda", mesh=ArrayMesh(4))
    plan = FaultPlan(events=(FaultEvent("array_down", at_tick=3, site=3),))
    sched = _scheduler(cache, "cuda", mesh=ArrayMesh(4), faults=plan)
    for _ in range(3):
        sched.submit(decode_steps=4)
    sched.run(max_ticks=2)
    on4 = _resident_slice_keys(sched)
    assert on4 and set(sched.backend.held_slices()) == on4
    copies = sched.backend.n_slice_copies
    rep = sched.run()
    assert rep.n_arrays == 3
    assert rep.summary()["resilience"]["mesh_degraded"] == 1
    on3 = _resident_slice_keys(sched)
    held = sched.backend.held_slices()
    assert on3 and on3 != on4 and set(held) == on3
    assert sched.backend.n_slice_copies - copies >= len(on3 - on4)
    weights = {id(w): w for w in (*sched.prefill_weights.values(),
                                  *sched.decode_weights.values())}
    for (src, (k0, k1, n0, n1)), copy in held.items():
        assert torch.equal(copy, weights[src][k0:k1, n0:n1])
    assert _checksums(rep) == _checksums(baseline)


def test_chaos_emits_fault_swimlane_and_artifact(cache, tmp_path):
    trace.clear().enable()
    try:
        _serve(cache, "interpreter",
               faults=FaultPlan.standard(0, n_arrays=1), n_requests=2)
        events = fault_events()
    finally:
        trace.disable()
    names = {e["name"] for e in events}
    assert {"fault", "recovery"} <= names
    kinds = {e["kind"] for e in events}
    assert {"launch_transient", "launch_nan", "kv_exhaust"} <= kinds
    path = write_fault_events(tmp_path / "faults.json")
    with open(path) as f:
        doc = json.load(f)
    assert doc["fault_events"] == events and len(events) > 0


# ---------------------------------------------------------------------------
# Retry / deadline state machine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_request_fails_after_max_retries(cache, backend):
    plan = FaultPlan(events=(
        FaultEvent(kind="launch_transient", at_tick=1, duration=400),))
    rep = _serve(cache, backend, faults=plan, n_requests=2, max_retries=2,
                 backoff_cap=1, breaker_cooldown=1)
    assert all(r.status == "failed" for r in rep.requests)
    assert all(r.retries >= 3 for r in rep.requests)
    res = rep.summary()["resilience"]
    assert res["failed"] == 2
    assert res["breaker"]["opens"] >= 1


def test_deadline_times_out(cache):
    sched = _scheduler(cache, "interpreter", finite_check=True)
    sched.submit(decode_steps=64, deadline_s=0.0)
    sched.submit(decode_steps=2)
    rep = sched.run()
    by_rid = {r.rid: r for r in rep.requests}
    assert by_rid[0].status == "timed_out"
    assert by_rid[1].status == "ok" and by_rid[1].state_checksum
    assert rep.summary()["resilience"]["timed_out"] == 1


# ---------------------------------------------------------------------------
# Snapshot / resume: a killed serve finishes identically
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", [None, ArrayMesh(2)], ids=["flat", "mesh2"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_snapshot_resume_matches_uninterrupted(cache, backend, mesh,
                                               tmp_path):
    full = _serve(cache, backend, mesh=mesh, n_requests=4)
    first = _scheduler(cache, backend, mesh=mesh)
    for _ in range(4):
        first.submit(decode_steps=4)
    first.run(max_ticks=2)
    snap_path = tmp_path / "serve.snap"
    save_serving_snapshot(snap_path, first.snapshot())
    assert [p for p in os.listdir(tmp_path) if p.endswith(".tmp")] == []
    snap = load_serving_snapshot(snap_path)
    assert snap is not None
    resumed = _scheduler(cache, backend, mesh=mesh)
    assert resumed.restore(snap) > 0
    rep = resumed.run()
    assert len(rep.requests) == 4
    assert _checksums(rep) == _checksums(full)


def test_reference_snapshot_resumes_in_the_port(cache, tmp_path):
    """A snapshot the reference's scheduler saved, after six ticks of
    its serve (two requests retired, two pending), restored by the
    port's: the resumed serve finishes with the reference's
    uninterrupted checksums."""
    jc = JCache()
    full = _j_serve(jc, n_requests=4)
    first = _j_scheduler(jc)
    for _ in range(4):
        first.submit(decode_steps=4)
    first.run(max_ticks=6)
    snap_path = tmp_path / "ref.snap"
    j_save_snapshot(snap_path, first.snapshot())
    snap = load_serving_snapshot(snap_path)
    assert snap is not None and snap["done"] and snap["pending"]
    for backend in BACKENDS:
        resumed = _scheduler(cache, backend)
        assert resumed.restore(snap) > 0
        rep = resumed.run()
        assert len(rep.requests) == 4
        assert _checksums(rep) == _checksums(full)


def test_snapshot_restore_validates(cache, tmp_path):
    sched = _scheduler(cache, "interpreter")
    sched.submit(decode_steps=2)
    snap = sched.snapshot()
    other = _scheduler(cache, "interpreter", seed=99)
    with pytest.raises(ValueError, match="seed"):
        other.restore(snap)
    with pytest.raises(ValueError, match="version"):
        _scheduler(cache, "interpreter").restore({**snap, "version": 42})
    assert load_serving_snapshot(tmp_path / "missing.snap") is None


# ---------------------------------------------------------------------------
# Faults off: the tolerance layer is inert
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_no_faults_means_no_wrapper_no_resilience(cache, backend):
    sched = _scheduler(cache, backend)
    assert sched.injector is None and not sched.resilient
    assert sched.breaker is None
    assert not isinstance(sched.backend, FaultyBackend)
    sched.submit(decode_steps=2)
    rep = sched.run()
    assert rep.resilience == {}
    assert rep.summary()["resilience"] == {}
    assert all(r.status == "ok" and r.retries == 0 for r in rep.requests)
