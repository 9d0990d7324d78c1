"""The port's fault layer against the JAX package's, on the CPU: the
serve-free cases of ``tests/test_faults.py`` -- seeded fault plans equal
to the reference's event for event, the breaker's state machine stepped
beside the reference's, the backend wrapper's guards (``run_sharded``
included), the finite check on arrays and tensors, the checksummed disk
cache quarantining corrupt entries, KV double release, degraded-mesh
re-lowering (per-array bytes equal to the reference's, outputs within
rtol 2e-4, atol 2e-4 + 2e-4*k of the reference's and the oracle), and
the atomic serving-snapshot file.  The serving cases (chaos, failover,
snapshot resume) are in ``test_torch_mesh_serve.py``."""

import dataclasses
import os
import pickle

import numpy as np
import pytest
import torch

from repro import backends as j_backends
from repro.configs.feather import feather_config as j_feather
from repro.core import mapper as j_mapper
from repro.core import program as j_program
from repro.dist import ArrayMesh as JMesh
from repro.faults import CircuitBreaker as JBreaker
from repro.faults import FaultPlan as JPlan
from repro_torch import backends
from repro_torch.configs.feather import feather_config
from repro_torch.core import mapper
from repro_torch.core import program as programlib
from repro_torch.dist import ArrayMesh
from repro_torch.dist.elastic import (load_serving_snapshot,
                                      save_serving_snapshot)
from repro_torch.faults import (FAULT_KINDS, CircuitBreaker, FaultEvent,
                                FaultInjector, FaultPlan, FaultyBackend,
                                TransientLaunchError, check_finite)
from repro_torch.runtime import ProgramCache
from repro_torch.runtime.scheduler import KVPool, PagedKV

CFG = feather_config(4, 16)
J_CFG = j_feather(4, 16)
RTOL = 2e-4


def _events(plan):
    return [dataclasses.asdict(e) for e in plan.events]


# ---------------------------------------------------------------------------
# FaultPlan: seeded determinism + validation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [3, 4, 11])
def test_fault_plan_from_seed_deterministic(seed):
    a = FaultPlan.from_seed(seed)
    b = FaultPlan.from_seed(seed)
    assert a.events == b.events and a.summary() == b.summary()
    assert a.events != FaultPlan.from_seed(seed + 1).events
    assert all(e.kind in FAULT_KINDS for e in a.events)
    ticks = [e.at_tick for e in a.events]
    assert ticks == sorted(ticks)
    for t in set(ticks):
        assert all(e.at_tick == t for e in a.due(t))
    # the reference's plan, event for event
    assert _events(a) == _events(JPlan.from_seed(seed))
    assert a.summary() == JPlan.from_seed(seed).summary()


def test_fault_plan_standard_covers_every_kind():
    plan = FaultPlan.standard(0, n_arrays=2)
    assert all(plan.counts()[k] >= 1 for k in FAULT_KINDS)
    flat = FaultPlan.standard(0, n_arrays=1)
    assert flat.counts()["array_down"] == 0
    for n in (1, 2, 4):
        assert _events(FaultPlan.standard(0, n_arrays=n)) == \
            _events(JPlan.standard(0, n_arrays=n))


def test_fault_event_validation():
    with pytest.raises(ValueError):
        FaultEvent(kind="meteor_strike", at_tick=1)
    with pytest.raises(ValueError):
        FaultEvent(kind="launch_nan", at_tick=0)
    with pytest.raises(ValueError):
        FaultEvent(kind="launch_nan", at_tick=1, duration=0)


# ---------------------------------------------------------------------------
# Breaker, backend wrapper, finite check
# ---------------------------------------------------------------------------

def test_circuit_breaker_state_machine():
    """The port's breaker steps through the reference's states on the
    same sequence of failures, successes and ticks."""
    brs = (CircuitBreaker(threshold=2, cooldown=3),
           JBreaker(threshold=2, cooldown=3))

    def both(fn):
        got = [fn(br) for br in brs]
        assert got[0] == got[1]
        return got[0]

    def state():
        return both(lambda br: (br.state, br.failures, br.opens))

    assert both(lambda br: br.allow(0)) and state()[0] == "closed"
    both(lambda br: br.record_failure(0))
    assert both(lambda br: br.allow(1))
    both(lambda br: br.record_failure(1))
    assert state()[0] == "open" and state()[2] == 1
    assert not both(lambda br: br.allow(2))
    assert both(lambda br: br.allow(4)) and state()[0] == "half_open"
    both(lambda br: br.record_failure(4))
    assert state()[0] == "open" and not both(lambda br: br.allow(5))
    assert both(lambda br: br.allow(7))
    both(lambda br: br.record_success())
    assert state()[:2] == ("closed", 0)
    assert both(lambda br: br.stats())


def test_faulty_backend_guard_and_passthrough():
    class Dummy:
        n_launches = 5

        def run_program(self, program, tensors=None):
            return {"O": torch.ones(2, 2)}

        def run_sharded(self, sharded, tensors=None):
            return {"O": torch.ones(3, 2)}

    inj = FaultInjector(FaultPlan(events=(
        FaultEvent(kind="launch_transient", at_tick=1),
        FaultEvent(kind="launch_nan", at_tick=2),
        FaultEvent(kind="launch_transient", at_tick=4),
        FaultEvent(kind="launch_nan", at_tick=5))))
    fb = inj.wrap(Dummy())
    assert isinstance(fb, FaultyBackend) and fb.n_launches == 5

    class P:
        out_name = "O"
    inj.begin_tick(1)
    with pytest.raises(TransientLaunchError):
        fb.run_program(P())
    inj.begin_tick(2)
    out = fb.run_program(P())["O"]
    assert isinstance(out, torch.Tensor) and not check_finite(out)
    inj.begin_tick(3)
    assert check_finite(fb.run_program(P())["O"])
    # the sharded entry point is guarded the same way
    inj.begin_tick(4)
    with pytest.raises(TransientLaunchError):
        fb.run_sharded(P())
    inj.begin_tick(5)
    out = fb.run_sharded(P())["O"]
    assert out.shape == (3, 2) and not check_finite(out)
    inj.begin_tick(6)
    assert check_finite(fb.run_sharded(P())["O"])
    assert inj.injected == {"launch_transient": 2, "launch_nan": 2}


def test_check_finite():
    assert check_finite(np.zeros(3))
    assert not check_finite(np.array([1.0, np.nan]))
    assert not check_finite(np.array([np.inf]))
    assert check_finite(torch.zeros(3))
    assert not check_finite(torch.tensor([1.0, float("nan")]))
    assert not check_finite(torch.tensor([float("-inf")]))


# ---------------------------------------------------------------------------
# Checksummed disk cache: corruption quarantines, never raises mid-serve
# ---------------------------------------------------------------------------

def _saved_cache(tmp_path):
    path = str(tmp_path / "cache.bin")
    cache = ProgramCache(path=path)
    for m in (8, 12):
        cache.plan(mapper.Gemm(m=m, k=8, n=8), CFG)
    cache.save()
    return path, len(cache._plans)


def test_corrupt_entry_quarantined_not_raised(tmp_path):
    path, n_entries = _saved_cache(tmp_path)
    inj = FaultInjector(FaultPlan(events=(
        FaultEvent(kind="cache_corrupt", at_tick=1),), seed=5))
    assert inj.corrupt_cache_file(path)
    fresh = ProgramCache(path=path)
    assert fresh.stats.disk_corrupt == 1
    assert fresh.stats.loaded_from_disk == n_entries - 1
    qdir = fresh.quarantine_dir(path)
    assert os.path.isdir(qdir) and len(os.listdir(qdir)) == 1
    assert len(fresh._plans) == n_entries - 1


def test_torn_payload_quarantined_not_raised(tmp_path):
    path, _ = _saved_cache(tmp_path)
    with open(path, "rb") as f:
        data = f.read()
    with open(path, "wb") as f:
        f.write(data[:len(data) // 2])
    fresh = ProgramCache(path=path)
    assert fresh.stats.loaded_from_disk == 0
    assert fresh.stats.disk_corrupt == 1
    assert len(fresh._plans) == 0
    assert os.path.isdir(fresh.quarantine_dir(path))


def test_stale_layout_still_raises(tmp_path):
    path, _ = _saved_cache(tmp_path)
    with open(path, "rb") as f:
        payload = pickle.load(f)
    for mutate in (lambda p: p.__setitem__("version", 1),
                   lambda p: p["schema"].__setitem__("plans", 99)):
        bad = pickle.loads(pickle.dumps(payload))
        mutate(bad)
        with open(path, "wb") as f:
            pickle.dump(bad, f)
        with pytest.raises(ValueError):
            ProgramCache(path=path)


def test_save_is_atomic_no_temp_litter(tmp_path):
    path, _ = _saved_cache(tmp_path)
    assert [p for p in os.listdir(tmp_path) if p.endswith(".tmp")] == []
    cache = ProgramCache(path=path)
    cache.save()
    assert ProgramCache(path=path).stats.loaded_from_disk > 0


# ---------------------------------------------------------------------------
# KV pool: double release + exhaustion reserve/unreserve
# ---------------------------------------------------------------------------

def _pool(pages=8):
    return KVPool({"K": ((8, 4), 0, 8, 4)}, 4, pages)


def test_kv_double_release_is_idempotent():
    pool = _pool()
    pages = pool.allocate()
    n_free = len(pool._free)
    pool.release(pages)
    assert len(pool._free) == n_free + len(pages)
    pool.release(pages)
    assert len(pool._free) == n_free + len(pages)
    assert pool.stats()["double_releases"] == len(pages)
    again = pool.allocate()
    assert sorted(again) == sorted(pages)


def test_paged_kv_release_idempotent():
    pool = _pool()
    kv = PagedKV(pool, pool.allocate())
    free0 = len(pool._free)
    kv.release()
    kv.release()
    assert len(pool._free) == free0 + 2
    assert pool.stats()["double_releases"] == 0


def test_kv_reserve_and_unreserve():
    pool = _pool()
    held = pool.reserve()
    assert pool.allocate() is None
    assert pool.stats()["reserved_pages"] == len(held)
    pool.unreserve(held)
    assert pool.allocate() is not None
    assert pool.stats()["reserved_pages"] == 0


# ---------------------------------------------------------------------------
# Degraded-mesh property: re-lowering onto fewer arrays conserves MINISA
# traffic and matches the einsum oracle and the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_from,n_down", [(4, 1), (4, 2), (2, 1)])
@pytest.mark.parametrize("seed", range(3))
def test_degraded_mesh_conserves_traffic_and_matches_oracle(
        seed, n_from, n_down):
    rng = np.random.default_rng(100 * n_from + 10 * n_down + seed)
    m, k, n = (int(rng.integers(5, 40)) for _ in range(3))
    prog = mapper.search(mapper.Gemm(m=m, k=k, n=n), CFG).program
    jprog = j_mapper.search(j_mapper.Gemm(m=m, k=k, n=n), J_CFG).program
    t = {"I": rng.standard_normal((m, k)).astype(np.float32),
         "W": rng.standard_normal((k, n)).astype(np.float32)}
    degraded = ArrayMesh(n_from).degraded(n_down)
    assert degraded.n_arrays == n_from - n_down
    assert degraded == ArrayMesh(n_from - n_down)
    for mesh in (ArrayMesh(n_from), degraded):
        sh = programlib.shard_program(prog, mesh)
        jsh = j_program.shard_program(jprog, JMesh(mesh.n_arrays))
        per = sh.per_array_minisa_bytes()
        assert len(per) == mesh.n_arrays
        assert sum(per) == sh.minisa_bytes()
        assert (sh.axis, per) == (jsh.axis, jsh.per_array_minisa_bytes())
        backends.cross_check(prog, t, mesh=mesh, device="cpu")
        want = j_backends.run_sharded(jprog, t, JMesh(mesh.n_arrays),
                                      backend="pallas")[jprog.out_name]
        got = backends.run_sharded(prog, t, mesh, backend="cuda",
                                   device="cpu")[prog.out_name]
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                                   atol=RTOL + RTOL * k)


def test_mesh_degraded_floors_at_one():
    assert ArrayMesh(2).degraded(1).n_arrays == 1
    assert ArrayMesh(2).degraded(5).n_arrays == 1
    assert ArrayMesh(4).degraded(0).n_arrays == 4
    assert ArrayMesh(4, axis_name="x").degraded(1).axis_name == "x"


# ---------------------------------------------------------------------------
# The serving snapshot file
# ---------------------------------------------------------------------------

def test_serving_snapshot_file_is_atomic_and_tolerant(tmp_path):
    snap = {"version": 1, "seed": 7, "next_rid": 2, "pending": [],
            "done": [{"rid": 0}]}
    path = tmp_path / "serve.snap"
    assert save_serving_snapshot(path, snap) == str(path)
    assert load_serving_snapshot(path) == snap
    assert [p for p in os.listdir(tmp_path) if p.endswith(".tmp")] == []
    # a second save replaces the first whole
    save_serving_snapshot(path, {**snap, "next_rid": 3})
    assert load_serving_snapshot(path)["next_rid"] == 3
    # missing, torn and non-dict files mean a cold start, not a crash
    assert load_serving_snapshot(tmp_path / "missing.snap") is None
    data = path.read_bytes()
    path.write_bytes(data[:len(data) // 2])
    assert load_serving_snapshot(path) is None
    with open(path, "wb") as f:
        pickle.dump([1, 2], f)
    assert load_serving_snapshot(path) is None
    # a save that fails mid-write leaves no temp file behind
    class Unpicklable:
        def __reduce__(self):
            raise RuntimeError("mid-write failure")
    with pytest.raises(RuntimeError, match="mid-write"):
        save_serving_snapshot(tmp_path / "bad.snap", {"x": Unpicklable()})
    assert sorted(os.listdir(tmp_path)) == ["serve.snap"]
