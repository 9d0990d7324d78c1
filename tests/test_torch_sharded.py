"""The port's multi-array path against the JAX package's, on the CPU: the
cases of ``tests/test_sharded.py`` run through both packages on the same
seeded numpy inputs.  The port runs its ``"interpreter"`` and ``"cuda"``
backends with ``device="cpu"`` (the kernels' plain versions); the JAX
package runs Pallas in interpret mode, which on one host device takes
the same sequential per-shard path.  Held equal: the chosen axis, the
shard ranges, per-array MINISA bytes and cycles, mesh plan aggregates;
outputs within rtol 2e-4, atol 2e-4 + 2e-4*k of the reference's and of
the einsum oracle.  The C.1 repair of ``core.planner.cross_check`` is
held here too."""

import numpy as np
import pytest
import torch

from repro import backends as j_backends
from repro.configs.feather import feather_config as j_feather
from repro.core import isa as j_isa
from repro.core import mapper as j_mapper
from repro.core import perf as j_perf
from repro.core import planner as j_planner
from repro.core import program as j_program
from repro.core import workloads as j_workloads
from repro.dist import ArrayMesh as JMesh
from repro.dist.sharding import gemm_shard_axis as j_axis
from repro.runtime import ModelExecutable as JExecutable
from repro.runtime import ProgramCache as JCache
from repro_torch import backends
from repro_torch.backends import CudaBackend
from repro_torch.configs.feather import feather_config as t_feather
from repro_torch.core import isa, mapper, perf, planner, program, workloads
from repro_torch.core.planner import GemmOp, plan_model
from repro_torch.dist import ArrayMesh
from repro_torch.dist.sharding import GEMM_AXIS_RULES, gemm_shard_axis
from repro_torch.runtime import ModelExecutable, ProgramCache

RTOL = 2e-4
CFG = t_feather(4, 16)
J_CFG = j_feather(4, 16)
SUITE = workloads.ci_suite()
J_SUITE = j_workloads.ci_suite()

# lowered plans shared by the whole module, one cache per package
_T_CACHE = ProgramCache(max_plans=1 << 20)
_J_CACHE = JCache(max_plans=1 << 20)


def _tensors(m, k, n, seed):
    rng = np.random.default_rng(seed)
    return {"I": rng.standard_normal((m, k)).astype(np.float32),
            "W": rng.standard_normal((k, n)).astype(np.float32)}


def _close(got, want, k, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=RTOL + RTOL * k, err_msg=msg)


def _np(out):
    return out.cpu().numpy() if isinstance(out, torch.Tensor) else out


def _ranges(sharded):
    return [(s.array, s.m0, s.m1, s.n0, s.n1, s.k0, s.k1)
            for s in sharded.shards]


def _choices(df="WOS", vn=4):
    """The test file's forced mapping choice in each package."""
    return tuple(m.MappingChoice(df=getattr(i.Dataflow, df), vn=vn, m_t=8,
                                 k_t=8, n_t=8, n_kg=1, n_nb=1, dup=4)
                 for m, i in ((j_mapper, j_isa), (mapper, isa)))


def _lowered(mkn, df="WOS", **kw):
    """(JAX Program, port Program) of one forced lowering."""
    jc, tc = _choices(df)
    m, k, n = mkn
    return (j_program.lower(j_mapper.Gemm(m=m, k=k, n=n), jc, J_CFG, **kw),
            program.lower(mapper.Gemm(m=m, k=k, n=n), tc, CFG, **kw))


def _same_partition(jsh, tsh):
    assert tsh.axis == jsh.axis
    assert _ranges(tsh) == _ranges(jsh)
    assert tsh.reduce == jsh.reduce
    assert tsh.per_array_minisa_bytes() == jsh.per_array_minisa_bytes()
    assert (tsh.epilogue_act is None) == (jsh.epilogue_act is None)


# ---------------------------------------------------------------------------
# Acceptance sweep: every ci_suite GEMM, the axis policy on 2 and 4 arrays,
# a 4-array mesh on both backends
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("idx", range(len(SUITE)),
                         ids=[f"{i}-{g.name}" for i, g in enumerate(SUITE)])
def test_sharded_equivalence_workload_sweep(idx):
    """The policy (axis=None) picks the reference's axis and shard ranges
    on 2 and 4 arrays; on a 4-array mesh interpreter == cuda == oracle,
    and both equal the reference's sharded Pallas run."""
    g, jg = SUITE[idx], J_SUITE[idx]
    assert (g.name, g.m, g.k, g.n) == (jg.name, jg.m, jg.k, jg.n)
    prog = _T_CACHE.plan(g, CFG).program
    jprog = _J_CACHE.plan(jg, J_CFG).program
    for n in (2, 4):
        _same_partition(j_program.shard_program(jprog, JMesh(n)),
                        program.shard_program(prog, ArrayMesh(n)))
    t = _tensors(g.m, g.k, g.n, idx)
    errs = backends.cross_check(prog, t, mesh=ArrayMesh(4), device="cpu")
    assert set(errs) == {"interpreter", "cuda"}
    want = j_backends.run_sharded(jprog, t, JMesh(4),
                                  backend="pallas")[jprog.out_name]
    for name in ("interpreter", "cuda"):
        got = backends.run_sharded(prog, t, ArrayMesh(4), backend=name,
                                   device="cpu")[prog.out_name]
        _close(_np(got), want, g.k, f"{name} on {g.name}")


# ---------------------------------------------------------------------------
# Property sweep: random GEMMs x mesh {1, 2, 4} x every axis x backends
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("n_arrays", [1, 2, 4])
def test_sharded_matches_unsharded_and_oracle(seed, n_arrays):
    rng = np.random.default_rng(seed)
    m, k, n = (int(rng.integers(5, 40)) for _ in range(3))
    prog = mapper.search(mapper.Gemm(m=m, k=k, n=n), CFG).program
    jprog = j_mapper.search(j_mapper.Gemm(m=m, k=k, n=n), J_CFG).program
    t = _tensors(m, k, n, 1000 + seed)
    oracle = t["I"] @ t["W"]
    unsharded = _np(backends.run(prog, t, device="cpu")[prog.out_name])
    for axis in (None, "m", "n", "k"):
        _same_partition(
            j_program.shard_program(jprog, JMesh(n_arrays), axis=axis),
            program.shard_program(prog, ArrayMesh(n_arrays), axis=axis))
        want = j_backends.run_sharded(jprog, t, JMesh(n_arrays),
                                      backend="pallas",
                                      axis=axis)[jprog.out_name]
        for name in ("interpreter", "cuda"):
            out = _np(backends.run_sharded(
                prog, t, ArrayMesh(n_arrays), backend=name, axis=axis,
                device="cpu")[prog.out_name])
            msg = f"{name} axis={axis} n={n_arrays} on {(m, k, n)}"
            _close(out, oracle, k, msg)
            _close(out, unsharded, k, msg)
            _close(out, want, k, msg)


def test_traffic_sums_to_single_array_total():
    """Per-array MINISA traffic is conserved and equal to the reference's
    byte for byte."""
    g = mapper.Gemm(m=65536, k=40, n=88, name="bconv-full")
    jg = j_mapper.Gemm(m=65536, k=40, n=88, name="bconv-full")
    prog = _T_CACHE.plan(g, t_feather(16, 64)).program
    jprog = _J_CACHE.plan(jg, j_feather(16, 64)).program
    base = prog.minisa_bytes()
    assert base == jprog.minisa_bytes()
    for n_arrays in (2, 4, 8):
        sh = program.shard_program(prog, ArrayMesh(n_arrays))
        _same_partition(j_program.shard_program(jprog, JMesh(n_arrays)), sh)
        per = sh.per_array_minisa_bytes()
        assert len(per) == n_arrays and all(b > 0 for b in per)
        assert sum(per) == sh.minisa_bytes()
        assert 0.95 <= sh.minisa_bytes() / base <= 1.25


def test_mesh_perf_parallel_speedup_and_imbalance():
    cfg, jcfg = t_feather(16, 64), j_feather(16, 64)
    plan = _T_CACHE.plan(mapper.Gemm(m=65536, k=40, n=88), cfg)
    jplan = _J_CACHE.plan(j_mapper.Gemm(m=65536, k=40, n=88), jcfg)
    mp = perf.simulate_sharded(
        program.shard_program(plan.program, ArrayMesh(4)), cfg)
    jmp = j_perf.simulate_sharded(
        j_program.shard_program(jplan.program, JMesh(4)), jcfg)
    assert [r.cycles for r in mp.per_array] == \
        [r.cycles for r in jmp.per_array]
    assert (mp.cycles, mp.load_imbalance, mp.macs) == \
        (jmp.cycles, jmp.load_imbalance, jmp.macs)
    assert 1.0 <= mp.load_imbalance <= 1.5
    assert plan.perf_minisa.cycles / mp.cycles > 2.0
    assert mp.macs == pytest.approx(plan.perf_minisa.macs)


# ---------------------------------------------------------------------------
# Axis policy + partition structure
# ---------------------------------------------------------------------------

def test_axis_policy_prefers_divisible_tensor_parallel():
    assert GEMM_AXIS_RULES == ("n", "m", "k")
    assert gemm_shard_axis(64, 64, 64, 4) == "n"
    assert gemm_shard_axis(64, 64, 3, 4) == "m"
    assert gemm_shard_axis(2, 64, 3, 4) == "k"
    assert gemm_shard_axis(64, 64, 64, 4,
                           tiles={"m": 8, "n": 1, "k": 1}) == "m"
    assert gemm_shard_axis(64, 64, 64, 2) == "n"
    # the whole policy against the reference's on a grid of extents and
    # tile counts
    rng = np.random.default_rng(3)
    for _ in range(300):
        m, k, n = (int(x) for x in rng.integers(1, 20, 3))
        n_arrays = int(rng.integers(1, 6))
        tiles = (None if rng.random() < 0.3 else
                 {ax: int(x) for ax, x in zip("mnk",
                                               rng.integers(0, 6, 3))})
        assert gemm_shard_axis(m, k, n, n_arrays, tiles=tiles) == \
            j_axis(m, k, n, n_arrays, tiles=tiles), (m, k, n, n_arrays, tiles)


def test_shard_slices_partition_the_problem():
    jprog, prog = _lowered((20, 12, 18))
    for axis in ("m", "n", "k"):
        sh = program.shard_program(prog, ArrayMesh(4), axis=axis)
        _same_partition(j_program.shard_program(jprog, JMesh(4), axis=axis),
                        sh)
        spans = [(s.m1 - s.m0) * (s.n1 - s.n0) * (s.k1 - s.k0)
                 for s in sh.shards]
        assert sum(spans) == 20 * 12 * 18
        assert sh.reduce == (axis == "k")
        assert sh.macs == prog.gemm.macs


def test_single_array_mesh_is_the_program_itself():
    _, prog = _lowered((10, 8, 6))
    sh = program.shard_program(prog, ArrayMesh(1))
    assert sh.n_shards == 1
    assert sh.shards[0].program is prog
    assert sh.minisa_bytes() == prog.minisa_bytes()


def test_chained_programs_refuse_to_shard():
    _, p1 = _lowered((10, 12, 8), out_name="O0")
    _, p2 = _lowered((10, 8, 6), out_name="O1")
    chained = program.chain([p1, p2])
    with pytest.raises(ValueError, match="commit"):
        program.shard_program(chained[0], ArrayMesh(2))
    with pytest.raises(ValueError, match="elided"):
        program.shard_program(chained[1], ArrayMesh(2))


# ---------------------------------------------------------------------------
# Activation hoisting across the mesh boundary
# ---------------------------------------------------------------------------

def _act_case(mkn, choice_kw, act_name, axis, seed):
    from repro.runtime.executable import ACTIVATIONS as J_ACTS
    from repro_torch.runtime.executable import ACTIVATIONS as T_ACTS
    m, k, n = mkn
    jprog = j_program.lower(
        j_mapper.Gemm(m=m, k=k, n=n),
        j_mapper.MappingChoice(df=j_isa.Dataflow.WOS, **choice_kw), J_CFG,
        activation=J_ACTS[act_name], act_name=act_name)
    prog = program.lower(
        mapper.Gemm(m=m, k=k, n=n),
        mapper.MappingChoice(df=isa.Dataflow.WOS, **choice_kw), CFG,
        activation=T_ACTS[act_name], act_name=act_name)
    sh = program.shard_program(prog, ArrayMesh(2), axis=axis)
    _same_partition(j_program.shard_program(jprog, JMesh(2), axis=axis), sh)
    t = _tensors(m, k, n, seed)
    backends.cross_check(prog, t, mesh=ArrayMesh(2), axis=axis, device="cpu")
    want = j_backends.run_sharded(jprog, t, JMesh(2), backend="pallas",
                                  axis=axis)[jprog.out_name]
    for name in ("interpreter", "cuda"):
        got = backends.run_sharded(prog, t, ArrayMesh(2), backend=name,
                                   axis=axis, device="cpu")[prog.out_name]
        _close(_np(got), want, k, f"{name} {act_name} axis={axis}")
    return sh


@pytest.mark.parametrize("axis", ["m", "n", "k"])
def test_elementwise_activation_sharded(axis):
    sh = _act_case((12, 10, 14), dict(vn=4, m_t=8, k_t=8, n_t=8, n_kg=1,
                                      n_nb=1, dup=4), "relu", axis, 21)
    # K split hoists (partial sums are pre-activation); M/N keep it local
    assert (sh.epilogue_act is not None) == (axis == "k")


@pytest.mark.parametrize("axis", ["m", "n", "k"])
def test_row_wise_activation_sharded(axis):
    """softmax needs full output rows: only a WO-S M split keeps rows
    shard-local; N/K splits hoist it to the assembled output."""
    sh = _act_case((8, 10, 12), dict(vn=4, m_t=8, k_t=12, n_t=12, n_kg=1,
                                     n_nb=1, dup=4), "softmax", axis, 22)
    assert (sh.epilogue_act is None) == (axis == "m")


# ---------------------------------------------------------------------------
# Plan.execute / cache tier / planner mesh plumbing
# ---------------------------------------------------------------------------

def test_plan_execute_with_mesh():
    plan = mapper.search(mapper.Gemm(m=17, k=24, n=21), CFG)
    jplan = j_mapper.search(j_mapper.Gemm(m=17, k=24, n=21), J_CFG)
    t = _tensors(17, 24, 21, 5)
    want = jplan.execute(t, backend="pallas", mesh=JMesh(3))["O"]
    for name in ("interpreter", "cuda"):
        out = _np(plan.execute(t, backend=name, mesh=ArrayMesh(3),
                               device="cpu")["O"])
        _close(out, t["I"] @ t["W"], 24, name)
        _close(out, want, 24, name)


def test_cache_sharded_tier_memoises_per_mesh_shape():
    cache = ProgramCache()
    plan = cache.plan(mapper.Gemm(m=16, k=16, n=16), CFG)
    s2a = cache.sharded(plan.program, ArrayMesh(2))
    s2b = cache.sharded(plan.program, ArrayMesh(2))
    s4 = cache.sharded(plan.program, ArrayMesh(4))
    assert s2a is s2b and s2a is not s4
    assert cache.stats.sharded_hits == 1
    assert cache.stats.sharded_misses == 2
    assert cache.stats.lowered_misses > 0
    assert "sharded" in cache.summary()["entries"]


def _toy_ops(gemm_mod, op_cls):
    return [op_cls(gemm=gemm_mod.Gemm(m=64, k=32, n=48, name="fc1",
                                      count=2)),
            op_cls(gemm=gemm_mod.Gemm(m=64, k=48, n=32, name="fc2"),
                   chained=True)]


def test_plan_model_mesh_aggregates():
    cache, jcache = ProgramCache(), JCache()
    single = plan_model("toy", "cell", _toy_ops(mapper, GemmOp), CFG,
                        cache=cache)
    meshed = plan_model("toy", "cell", _toy_ops(mapper, GemmOp), CFG,
                        cache=cache, mesh=ArrayMesh(4))
    jmeshed = j_planner.plan_model("toy", "cell",
                                   _toy_ops(j_mapper, j_planner.GemmOp),
                                   J_CFG, cache=jcache, mesh=JMesh(4))
    assert meshed.n_arrays == 4
    assert len(meshed.per_array_bytes) == 4
    assert sum(meshed.per_array_bytes) == pytest.approx(meshed.minisa_bytes)
    assert meshed.load_imbalance >= 1.0
    assert meshed.cycles_minisa < single.cycles_minisa
    assert meshed.summary() == jmeshed.summary()
    assert meshed.per_array_bytes == jmeshed.per_array_bytes
    assert meshed.per_array_cycles == jmeshed.per_array_cycles


# ---------------------------------------------------------------------------
# core.planner.cross_check (ROADMAP C.1): interpreter and cuda by default,
# backend kwargs forwarded
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reduced_gemma_plans():
    """A reduced gemma-7b prefill cell planned at 4x16 by each package,
    flat and on 2 arrays."""
    from repro.configs.base import reduced as j_reduced
    from repro.configs.registry import get_config as j_get_config
    from repro.core.model_gemms import gemm_workloads as j_workloads_of
    from repro.runtime.executable import TINY_SHAPES as J_TINY
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.core.model_gemms import gemm_workloads
    from repro_torch.runtime.executable import TINY_SHAPES
    ops = gemm_workloads(reduced(get_config("gemma-7b"), layers=2,
                                 d_model=64, vocab=256),
                         TINY_SHAPES["prefill_tiny"])
    jops = j_workloads_of(j_reduced(j_get_config("gemma-7b"), layers=2,
                                    d_model=64, vocab=256),
                          J_TINY["prefill_tiny"])
    cache, jcache = ProgramCache(), JCache()
    out = {}
    for mesh, jmesh in ((None, None), (ArrayMesh(2), JMesh(2))):
        out[mesh] = (
            j_planner.plan_model("gemma-7b", "prefill_tiny", jops, J_CFG,
                                 cache=jcache, mesh=jmesh),
            plan_model("gemma-7b", "prefill_tiny", ops, CFG, cache=cache,
                       mesh=mesh))
    return out


def test_planner_cross_check_interpreter_and_cuda(reduced_gemma_plans):
    jplan, plan = reduced_gemma_plans[None]
    assert planner.cross_check.__defaults__[0] == ("interpreter", "cuda")
    errs = planner.cross_check(plan, device="cpu")
    jerrs = j_planner.cross_check(jplan, backends=("interpreter",))
    assert errs and set(errs) == set(jerrs)
    for key, per in errs.items():
        k = key[1]
        assert set(per) == {"interpreter", "cuda"}
        for e in per.values():
            assert abs(e - jerrs[key]["interpreter"]) <= RTOL + RTOL * k


def test_planner_mesh_plan_matches_reference(reduced_gemma_plans):
    jplan, plan = reduced_gemma_plans[ArrayMesh(2)]
    assert plan.n_arrays == 2
    assert plan.per_array_bytes == jplan.per_array_bytes
    assert plan.per_array_cycles == jplan.per_array_cycles
    assert plan.summary() == jplan.summary()


# ---------------------------------------------------------------------------
# Mesh-aware executable
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh_decode():
    jex = JExecutable.for_cell("gemma-7b", "decode_tiny", J_CFG,
                               cache=JCache(), mesh=JMesh(4))
    ex = ModelExecutable.for_cell("gemma-7b", "decode_tiny", CFG,
                                  cache=ProgramCache(), mesh=ArrayMesh(4))
    return jex, ex


@pytest.mark.parametrize("backend", ["interpreter", "cuda"])
def test_executable_sharded_matches_stream_oracle(mesh_decode, backend):
    jex, ex = mesh_decode
    assert ex.describe()["n_sharded"] == len(ex.steps)
    assert [(s.sharded.axis, _ranges(s.sharded)) for s in ex.steps] == \
        [(s.sharded.axis, _ranges(s.sharded)) for s in jex.steps]
    res = ex.run(backend, check=True, device="cpu")
    assert res.checked and len(res.outputs) == len(ex.steps)
    want = jex.run("pallas").final
    _close(_np(res.final), want, max(s.op.gemm.k for s in ex.steps))
    stats = ex.perf_stats()
    assert stats["n_arrays"] == 4
    assert len(stats["per_array_minisa_bytes"]) == 4
    assert sum(stats["per_array_minisa_bytes"]) == pytest.approx(
        stats["minisa_bytes"])
    assert stats["load_imbalance"] >= 1.0
    jstats = jex.perf_stats()
    for key in ("per_array_minisa_bytes", "per_array_cycles_minisa",
                "minisa_bytes", "load_imbalance"):
        assert stats[key] == jstats[key], key


# ---------------------------------------------------------------------------
# One rank per array, where a process group is up; else the sequential path
# (tests/test_torch_ranks.py runs the ranks)
# ---------------------------------------------------------------------------

def test_device_mesh_absent_and_fallback_matches_oracle():
    """No process group is up in this process, so ``device_mesh()`` is
    None and every backend takes the sequential per-shard path: for
    both dataflows and every axis it matches the oracle and the
    reference's fallback."""
    mesh = ArrayMesh(2)
    assert not torch.distributed.is_initialized()
    assert mesh.device_mesh() is None
    for df in ("WOS", "IOS"):
        jprog, prog = _lowered((24, 16, 20), df=df)
        t = _tensors(24, 16, 20, 7)
        for axis in ("m", "n", "k"):
            want = j_backends.run_sharded(jprog, t, JMesh(mesh.n_arrays),
                                          backend="pallas",
                                          axis=axis)[jprog.out_name]
            for name in ("interpreter", "cuda"):
                out = _np(backends.run_sharded(
                    prog, t, mesh, backend=name, axis=axis,
                    device="cpu")[prog.out_name])
                msg = f"{name} {df} axis={axis}"
                _close(out, t["I"] @ t["W"], 16, msg)
                _close(out, want, 16, msg)


def test_array_mesh_validation():
    with pytest.raises(ValueError):
        ArrayMesh(0)
    assert ArrayMesh(1).device_mesh() is None
    assert ArrayMesh(2).shape == (2,)
    # without a process group: one array per visible card, one at least
    assert ArrayMesh.host().n_arrays == max(1, torch.cuda.device_count())
    assert repr(ArrayMesh(3)) == repr(JMesh(3))
    with pytest.raises(ValueError, match="axis"):
        _, prog = _lowered((8, 8, 8))
        program.shard_program(prog, ArrayMesh(2), axis="q")


# ---------------------------------------------------------------------------
# The CUDA backend's shard operands: N-split weight slices copied once
# ---------------------------------------------------------------------------

def test_weight_slices_copied_once_per_source():
    """An N split's column slice of a weight is made contiguous once per
    source tensor: a second call copies nothing, a new source (a KV
    operand, drawn per call) is copied again and its entry goes once the
    source has died, an in-place update of the weight is never served
    stale, and a cut for another mesh drops the old mesh's copies."""
    _, prog = _lowered((6, 16, 24))
    sharded = program.shard_program(prog, ArrayMesh(4), axis="n")
    be = CudaBackend(CFG, device="cpu")
    t = {name: torch.from_numpy(a) for name, a in
         _tensors(6, 16, 24, 9).items()}
    first = be.run_sharded(sharded, t)[prog.out_name].clone()
    assert be.n_slice_copies == 4
    again = be.run_sharded(sharded, t)[prog.out_name]
    assert be.n_slice_copies == 4 and torch.equal(first, again)
    _close(first.numpy(), (t["I"] @ t["W"]).numpy(), 16)
    fresh = {"I": t["I"], "W": t["W"].clone()}
    be.run_sharded(sharded, fresh)
    assert be.n_slice_copies == 8 and len(be._slices) == 2
    del fresh
    be.run_sharded(sharded, {"I": t["I"], "W": t["W"].clone()})
    assert be.n_slice_copies == 12 and len(be._slices) == 2
    t["W"].mul_(2.0)
    doubled = be.run_sharded(sharded, t)[prog.out_name]
    assert be.n_slice_copies == 16 and len(be._slices) == 1
    _close(doubled.numpy(), (t["I"] @ t["W"]).numpy(), 16)
    # an M or K split cuts rows of W: no copy at all
    for axis in ("m", "k"):
        be.run_sharded(program.shard_program(prog, ArrayMesh(4), axis=axis),
                       t)
    assert be.n_slice_copies == 16
    assert len(be.held_slices()) == 4
    # cut for another mesh (a failover's re-lowering), the source keeps
    # only that mesh's copies
    on3 = program.shard_program(prog, ArrayMesh(3), axis="n")
    be.run_sharded(on3, t)
    assert be.n_slice_copies == 16 + on3.n_shards
    assert set(be.held_slices()) == {
        (id(t["W"]), (sh.k0, sh.k1, sh.n0, sh.n1)) for sh in on3.shards}
