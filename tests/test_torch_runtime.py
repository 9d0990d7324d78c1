"""The port's runtime (ProgramCache, ModelExecutable, Scheduler) against the
JAX package's, on the CUDA backend with ``device="cpu"`` (the kernels'
plain versions): the same seeded tensors bit for bit, the same stream
structure and batch plans, the same numbers within the reference's
tolerances, and per-request ``state_checksum``s bit-equal to the
reference's sequential interpreter run in every row of
``tests/test_batched_decode.py``."""

import numpy as np
import pytest
import torch

from repro.configs.feather import feather_config as j_feather
from repro.runtime import ModelExecutable as JExecutable
from repro.runtime import ProgramCache as JCache
from repro.runtime import Scheduler as JScheduler
from repro_torch.configs.feather import feather_config as t_feather
from repro_torch.runtime import ModelExecutable as TExecutable
from repro_torch.runtime import ProgramCache as TCache
from repro_torch.runtime import Scheduler as TScheduler
from repro_torch.runtime import executable as t_executable
from repro_torch.runtime import tensors_from_numpy

#: mixed decode lengths and chunked prompts (tests/test_batched_decode.py)
SUBMISSIONS = [(3, None), (1, None), (2, 64), (4, 32), (2, None)]
ROWS = [(True, False, 5), (False, True, 5), (True, True, 5),
        (True, True, 2), (True, True, 3)]


@pytest.fixture(scope="module")
def cells():
    jc, tc = JCache(), TCache()
    ref = tuple(JExecutable.for_cell("gemma-7b", s, j_feather(4, 16),
                                     cache=jc)
                for s in ("prefill_tiny", "decode_tiny"))
    port = tuple(TExecutable.for_cell("gemma-7b", s, t_feather(4, 16),
                                      cache=tc)
                 for s in ("prefill_tiny", "decode_tiny"))
    return ref, port


def _serve(sched):
    for steps, prompt in SUBMISSIONS:
        sched.submit(decode_steps=steps, prompt_tokens=prompt)
    rep = sched.run()
    assert len(rep.requests) == len(SUBMISSIONS)
    return {r.rid: r.state_checksum for r in rep.requests}, rep


@pytest.fixture(scope="module")
def oracle_checksums(cells):
    """The reference's sequential per-request interpreter run."""
    (pre, dec), _ = cells
    sums, _ = _serve(JScheduler(pre, dec, backend="interpreter",
                                batch_decode=False, use_fused=False))
    return sums


# ---------------------------------------------------------------------------
# seeded tensors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kinds", [("weight", "dynamic", "input"),
                                   ("weight",), ("dynamic",),
                                   ("dynamic", "input"), ("input",)])
def test_make_tensors_bit_equal(cells, kinds, monkeypatch):
    # a tiny chunk makes every tensor a multi-chunk draw
    monkeypatch.setattr(t_executable, "_DRAW_CHUNK", 7)
    (jpre, jdec), (tpre, tdec) = cells
    for jex, tex in ((jpre, tpre), (jdec, tdec)):
        for seed in (0, 3, 1_000_004):
            want = jex.make_tensors(seed, kinds=kinds)
            got = tex.make_tensors(seed, kinds=kinds)
            assert list(got) == list(want)
            for name in want:
                assert got[name].dtype == np.float32
                assert np.array_equal(got[name], want[name]), name


def test_tensors_from_numpy_moves_any_reference_dict(cells):
    (_, jdec), _ = cells
    env = jdec.make_tensors(5)
    moved = tensors_from_numpy(env, "cpu")
    assert set(moved) == set(env)
    for name, arr in env.items():
        assert moved[name].dtype == torch.float32
        assert np.array_equal(moved[name].numpy(), arr)


# ---------------------------------------------------------------------------
# structure: steps, segments, fused geometry, batch plans
# ---------------------------------------------------------------------------

def _structure(ex) -> dict:
    return {
        "describe": {k: v for k, v in ex.describe().items() if k != "name"},
        "steps": [(s.op.gemm.m, s.op.gemm.k, s.op.gemm.n, s.input_mode,
                   s.program.act_name, s.host_act is not None, s.reps,
                   s.program.choice.df.name, s.program.n_tiles,
                   s.program.input_elided) for s in ex.steps],
        "segments": [(seg.indices, None if seg.fused is None
                      else seg.fused.describe()) for seg in ex.segments],
        "plans": {n: ([(b.kind, b.indices, b.fused is not None, b.m_rows)
                       for b in ex.batch_plan(n).segments],
                      ex.batch_plan(n).launches_per_tick)
                  for n in (1, 2, 3, 5)},
        "fusion": ex.fusion_stats(),
        "perf": {k: v for k, v in ex.perf_stats().items()},
    }


def _compiled_segments(ex, compile_segment) -> list:
    segs = [s.fused for s in ex.segments if s.fused is not None]
    segs += [b.fused for n in (1, 2, 3, 5)
             for b in ex.batch_plan(n).segments if b.fused is not None]
    return [compile_segment(seg).describe() for seg in segs]


def test_reduced_cells_same_structure(cells):
    from repro.backends import compile_segment as j_compile_segment
    from repro_torch.backends import compile_segment as t_compile_segment
    (jpre, jdec), (tpre, tdec) = cells
    for jex, tex in ((jpre, tpre), (jdec, tdec)):
        assert _structure(tex) == _structure(jex)
        assert _compiled_segments(tex, t_compile_segment) == \
            _compiled_segments(jex, j_compile_segment)
    assert tdec.batch_plan(1).launches_per_tick == 7


@pytest.mark.parametrize("shape", ["prefill_tiny", "decode_tiny"])
@pytest.mark.parametrize("fused", [False, True])
def test_run_matches_reference(cells, shape, fused):
    (jpre, jdec), (tpre, tdec) = cells
    jex, tex = (jpre, tpre) if shape == "prefill_tiny" else (jdec, tdec)
    env = jex.make_tensors(7)
    got = tex.run("cuda", tensors=env, check=True, fused=fused,
                  device="cpu")
    want = jex.run("pallas", tensors=env, fused=fused)
    assert got.fused_segments == want.fused_segments
    k_max = max(s.op.gemm.k for s in tex.steps)
    np.testing.assert_allclose(got.final.numpy(), want.final, rtol=2e-4,
                               atol=2e-4 * k_max)


def test_run_batch_matches_sequential_and_reference(cells):
    (_, jdec), (_, tdec) = cells
    weights = jdec.make_tensors(0, kinds=("weight",))
    envs = []
    for r in range(5):
        env = dict(weights)
        env.update(jdec.make_tensors(10 + r, kinds=("dynamic",)))
        env.update(jdec.make_tensors(100 + r, kinds=("input",)))
        envs.append(env)
    be = tdec.make_backend("cuda", device="cpu")
    l0 = be.n_launches
    got = tdec.run_batch(be, envs, fused=True)
    assert be.n_launches - l0 == tdec.batch_plan(5).launches_per_tick
    want = jdec.run_batch("pallas", envs, fused=True)
    k_max = max(s.op.gemm.k for s in tdec.steps)
    for r in range(5):
        seq = tdec.run(be, tensors=envs[r]).final
        np.testing.assert_allclose(got[r].numpy(), seq.numpy(), rtol=2e-4,
                                   atol=2e-4 * k_max)
        np.testing.assert_allclose(got[r].numpy(), want[r], rtol=2e-4,
                                   atol=2e-4 * k_max)


# ---------------------------------------------------------------------------
# the spine: checksums bit-equal to the reference's interpreter oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch,fused,conc", ROWS)
def test_checksums_match_reference_oracle(cells, oracle_checksums, batch,
                                          fused, conc):
    (jpre, jdec), (tpre, tdec) = cells
    sums, rep = _serve(TScheduler(tpre, tdec, device="cpu",
                                  batch_decode=batch, use_fused=fused,
                                  max_concurrent=conc))
    assert sums == oracle_checksums
    assert rep.batch_decode == batch and rep.decode_fused == fused
    _, jrep = _serve(JScheduler(jpre, jdec, backend="pallas",
                                batch_decode=batch, use_fused=fused,
                                max_concurrent=conc))
    assert rep.launches_per_decode_tick == jrep.launches_per_decode_tick
    assert rep.decode_launches == jrep.decode_launches
    if batch and fused:
        assert rep.launches_per_decode_tick == \
            tdec.batch_plan(1).launches_per_tick


#: the interpreter rows of tests/test_batched_decode.py: the sequential
#: oracle, batched per-layer programs (two batch compositions), a KV pool
#: holding one request, a one-chunk token budget
INTERP_ROWS = [(False, 5, "none"), (True, 5, "none"), (True, 3, "none"),
               (False, 4, "kv_one"), (True, 5, "budget")]


@pytest.mark.parametrize("batch,conc,limit", INTERP_ROWS)
def test_interpreter_checksums_match_reference_oracle(cells, oracle_checksums,
                                                      batch, conc, limit):
    """The port's interpreter serves the cell with per-request checksums
    bit-equal to the reference's interpreter oracle, and the same launch
    accounting as the reference's interpreter serve (it launches
    nothing)."""
    (jpre, jdec), (tpre, tdec) = cells
    kw = dict(batch_decode=batch, use_fused=False, max_concurrent=conc)
    if limit == "kv_one":
        kw["kv_pages"] = TScheduler(tpre, tdec, device="cpu") \
            .kv_pool.pages_per_request
    elif limit == "budget":
        kw["token_budget"] = tpre.tokens or 1
    sched = TScheduler(tpre, tdec, backend="interpreter", device="cpu", **kw)
    assert sched.backend.name == "interpreter"
    assert not sched.use_fused
    sums, rep = _serve(sched)
    assert sums == oracle_checksums
    assert rep.batch_decode == batch
    _, jrep = _serve(JScheduler(jpre, jdec, backend="interpreter", **kw))
    assert rep.launches_per_decode_tick == jrep.launches_per_decode_tick
    assert rep.decode_launches == jrep.decode_launches == 0
    if limit == "kv_one":
        assert rep.kv["admit_stalls"] > 0
        assert rep.kv["high_water_pages"] == kw["kv_pages"]


def test_interpreter_defaults_to_the_per_program_path(cells):
    """Like the reference, the interpreter backend defaults to sequential
    per-Program decode (its machine state is the chain semantics)."""
    _, (tpre, tdec) = cells
    sched = TScheduler(tpre, tdec, backend="interpreter", device="cpu")
    assert not sched.use_fused and not sched.batch_decode


def test_interpreter_run_batch_matches_sequential_and_reference(cells):
    """Stacked-M execution on the interpreter equals its per-request runs
    and the reference's interpreter ``run_batch``."""
    (_, jdec), (_, tdec) = cells
    weights = jdec.make_tensors(0, kinds=("weight",))
    envs = []
    for r in range(5):
        env = dict(weights)
        env.update(jdec.make_tensors(10 + r, kinds=("dynamic",)))
        env.update(jdec.make_tensors(100 + r, kinds=("input",)))
        envs.append(env)
    got = tdec.run_batch("interpreter", envs, fused=False, device="cpu")
    want = jdec.run_batch("interpreter", envs, fused=False)
    k_max = max(s.op.gemm.k for s in tdec.steps)
    for r in range(5):
        seq = tdec.run("interpreter", tensors=envs[r], device="cpu").final
        np.testing.assert_allclose(got[r].numpy(), seq.numpy(), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(got[r].numpy(), want[r], rtol=2e-4,
                                   atol=2e-4 * k_max)


@pytest.mark.parametrize("shape", ["prefill_tiny", "decode_tiny"])
@pytest.mark.parametrize("fused", [False, True])
def test_interpreter_run_checks_against_the_stream_oracle(cells, shape,
                                                          fused):
    """``ModelExecutable.run("interpreter", check=True)``: every step (or
    fused segment, which the interpreter replays Program by Program)
    against the einsum replay, the final carrier equal to the reference
    interpreter's."""
    (jpre, jdec), (tpre, tdec) = cells
    jex, tex = (jpre, tpre) if shape == "prefill_tiny" else (jdec, tdec)
    env = jex.make_tensors(7)
    got = tex.run("interpreter", tensors=env, check=True, fused=fused,
                  device="cpu")
    want = jex.run("interpreter", tensors=env, fused=fused)
    assert got.fused_segments == want.fused_segments
    k_max = max(s.op.gemm.k for s in tex.steps)
    np.testing.assert_allclose(got.final.numpy(), np.asarray(want.final),
                               rtol=2e-4, atol=2e-4 * k_max)


def test_scheduler_defaults_key_on_the_cuda_backend(cells):
    """The fused and batched fast paths default on for ``"cuda"`` (the
    reference keys them on ``"pallas"``), and a warm cache costs no
    searches or compiles."""
    _, (tpre, tdec) = cells
    sched = TScheduler(tpre, tdec, device="cpu")
    assert sched.use_fused and sched.batch_decode
    _serve(sched)
    snap = tpre.cache.stats.snapshot()
    sums, rep = _serve(TScheduler(tpre, tdec, device="cpu",
                                  max_concurrent=5))
    delta = tpre.cache.stats.delta(snap)
    assert delta["plan_misses"] == 0 and delta["compile_misses"] == 0
    assert rep.launches_per_decode_tick == 7


# ---------------------------------------------------------------------------
# full width, structure only
# ---------------------------------------------------------------------------

def test_full_width_structure_matches_reference():
    """gemma-7b at full width on the 16x256 array: the same steps,
    modes and choices, no fused segment (the fused VMEM budget rejects
    every full-width segment), and 9 launches per decode tick."""
    for shape in ("prefill_tiny", "decode_tiny"):
        jex = JExecutable.for_cell("gemma-7b", shape, j_feather(16, 256),
                                   cache=JCache(), reduce_model=False)
        tex = TExecutable.for_cell("gemma-7b", shape, t_feather(16, 256),
                                   cache=TCache(), reduce_model=False)
        assert _structure(tex) == _structure(jex)
        assert [repr(s.program.choice) for s in tex.steps] == \
            [repr(s.program.choice) for s in jex.steps]
        assert all(seg.fused is None for seg in tex.segments)
        assert tex.tensor_specs() == jex.tensor_specs()
    assert tex.batch_plan(1).launches_per_tick == 9
    assert [s.kind for s in tex.batch_plan(4).segments].count("static") == 6


# ---------------------------------------------------------------------------
# the ProgramCache never loads the reference's cache file
# ---------------------------------------------------------------------------

def test_cache_refuses_a_reference_cache_file(tmp_path):
    from repro.core.mapper import Gemm as JGemm
    from repro_torch.core.mapper import Gemm as TGemm
    path = tmp_path / "plans.pkl"
    jcache = JCache(path)
    jcache.plan(JGemm(m=8, k=16, n=16), j_feather(4, 16))
    jcache.save()
    with pytest.raises(ValueError, match="backend"):
        TCache(path)
    tpath = tmp_path / "port.pkl"
    tcache = TCache(tpath)
    tcache.plan(TGemm(m=8, k=16, n=16), t_feather(4, 16))
    tcache.save()
    fresh = TCache(tpath)
    assert fresh.stats.loaded_from_disk == 1
    fresh.plan(TGemm(m=8, k=16, n=16), t_feather(4, 16))
    assert fresh.stats.searches == 0


# ---------------------------------------------------------------------------
# the scheduler's numpy glue: vectorised/prefix forms == the reference loops
# ---------------------------------------------------------------------------

def test_host_glue_equals_reference(cells):
    """Paged KV seed/gather/commit and the carry -> inputs path are
    bit-equal to the reference's loop versions, for carries longer and
    shorter than what the next step reads."""
    from repro.runtime import scheduler as jsched
    from repro_torch.runtime import scheduler as tsched
    (_, jdec), (_, tdec) = cells
    jpool = jsched.KVPool(jsched._kv_specs(jdec), 3, 12)
    tpool = tsched.KVPool(tsched._kv_specs(tdec), 3, 12)
    rng = np.random.default_rng(4)
    pages = [7, 2, 9, 0, 11, 5]
    jkv, tkv = jsched.PagedKV(jpool, pages), tsched.PagedKV(tpool, pages)
    dyn = jdec.make_tensors(9, kinds=("dynamic",))
    jkv.seed(dyn)
    tkv.seed(dyn)
    for pos, size in enumerate((1, 5, 16, 300, 4096)):
        out = rng.standard_normal((1, size)).astype(np.float32) * 2
        jkv.commit(out, pos)
        tkv.commit(out, pos)
        want, got = jkv.gather(), tkv.gather()
        assert list(got) == list(want)
        for name in want:
            assert np.array_equal(got[name], want[name]), (name, size)
        jin = jdec.inputs_from(jsched._stabilize(out))
        tin = tsched._carry_inputs(tdec, out)
        assert list(tin) == list(jin)
        for name in jin:
            assert np.array_equal(tin[name].numpy(), jin[name]), name
    for name in jpool.arenas:
        assert np.array_equal(tpool.arenas[name], jpool.arenas[name])


# ---------------------------------------------------------------------------
# block-fused decode attention: one launch, equal to the JAX backend's
# ---------------------------------------------------------------------------

def _attention_proj_inputs(dec, bucket):
    plan = dec.batch_plan(bucket)
    bseg = next(s for s in plan.segments if s.kind == "attention")
    nxt = dec.steps[bseg.indices[-1] + 1]
    assert nxt.input_mode == "adapt"
    g = nxt.op.gemm                      # the wo step's adapt geometry
    qk, pv = bseg.programs
    rng = np.random.default_rng(7)
    q = rng.standard_normal((bucket, qk.gemm.m, qk.gemm.k)).astype(
        np.float32)
    kT = rng.standard_normal((bucket, qk.gemm.k, qk.gemm.n)).astype(
        np.float32)
    v = rng.standard_normal((bucket, pv.gemm.k, pv.gemm.n)).astype(
        np.float32)
    wo = rng.standard_normal((g.k, g.n)).astype(np.float32)
    return bseg.programs, q, kT, v, wo, g


@pytest.mark.parametrize("ragged", [False, True])
def test_batched_attention_proj_one_launch_matches_reference(cells, ragged):
    """attention + Wo for the whole batch is ONE launch on the CUDA
    backend (the plain versions here), equal to the JAX Pallas backend's
    and to the base oracle (attention launch + adapt + GEMM)."""
    from repro_torch.backends import Backend
    from repro_torch.obs.metrics import REGISTRY
    (_, jdec), (_, tdec) = cells
    progs_t, q, kT, v, wo, g = _attention_proj_inputs(tdec, 3)
    progs_j = _attention_proj_inputs(jdec, 3)[0]
    lengths = (np.array([kT.shape[2], 3, 7], np.int32) if ragged
               else None)
    want = jdec.make_backend("pallas").run_batched_attention_proj(
        progs_j, q, kT, v, wo, m_out=g.m, k_out=g.k, lengths=lengths)
    be = tdec.make_backend("cuda", device="cpu")
    counter = REGISTRY.counter("backend_launches_total")
    c0 = counter.value(kernel="flash_decode_proj")
    l0 = be.n_launches
    got = be.run_batched_attention_proj(progs_t, q, kT, v, wo, m_out=g.m,
                                        k_out=g.k, lengths=lengths)
    assert be.n_launches - l0 == 1
    assert counter.value(kernel="flash_decode_proj") - c0 == 1
    assert got.shape == (3, g.m, g.n)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    oracle = Backend.run_batched_attention_proj(
        be, progs_t, q, kT, v, wo, m_out=g.m, k_out=g.k, lengths=lengths)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), rtol=2e-4,
                               atol=2e-4 * g.k)


def test_faulty_backend_guards_attention_proj(cells):
    from repro_torch.faults import (FaultEvent, FaultInjector, FaultPlan,
                                    TransientLaunchError, check_finite)
    _, (_, tdec) = cells
    progs, q, kT, v, wo, g = _attention_proj_inputs(tdec, 2)
    inj = FaultInjector(FaultPlan(events=(
        FaultEvent(kind="launch_transient", at_tick=1),
        FaultEvent(kind="launch_nan", at_tick=2))))
    fb = inj.wrap(tdec.make_backend("cuda", device="cpu"))

    def launch():
        return fb.run_batched_attention_proj(progs, q, kT, v, wo,
                                             m_out=g.m, k_out=g.k)
    inj.begin_tick(1)
    with pytest.raises(TransientLaunchError):
        launch()
    inj.begin_tick(2)
    assert not check_finite(launch())      # NaN-poisoned copy
    inj.begin_tick(3)
    assert check_finite(launch())
    assert fb.n_launches == 2              # the transient never launched
    assert inj.injected == {"launch_transient": 1, "launch_nan": 1}


# ---------------------------------------------------------------------------
# the joint segment search: the frontier the autotuner measures
# ---------------------------------------------------------------------------

def _fused_runs(ex):
    runs = [(list(s.fused.programs), tuple(s.fused.adapts))
            for s in ex.segments if s.fused is not None]
    runs += [(list(b.fused.programs), tuple(b.fused.adapts))
             for n in (1, 2, 3, 5) for b in ex.batch_plan(n).segments
             if b.fused is not None]
    return runs


def test_frontier_points_match_reference(cells):
    """Every fused segment of the reduced cells has the reference's
    Pareto frontier: the same (bm, layer_bks) points at the same cycles,
    traffic and on-chip bytes, in the same order."""
    (jpre, jdec), (tpre, tdec) = cells
    n_runs = 0
    for jex, tex in ((jpre, tpre), (jdec, tdec)):
        jruns, truns = _fused_runs(jex), _fused_runs(tex)
        assert len(jruns) == len(truns) > 0
        for (jprogs, jad), (tprogs, tad) in zip(jruns, truns):
            assert jad == tad
            jf = jex.cache.frontier(jprogs, adapts=jad)
            tf = tex.cache.frontier(tprogs, adapts=tad)
            assert [(p.choice.bm, p.choice.layer_bks, p.cycles,
                     p.traffic_bytes, p.vmem_bytes) for p in tf.points] \
                == [(p.choice.bm, p.choice.layer_bks, p.cycles,
                     p.traffic_bytes, p.vmem_bytes) for p in jf.points]
            assert (tf.n_enumerated, tf.n_feasible) == \
                (jf.n_enumerated, jf.n_feasible)
            n_runs += 1
    assert n_runs >= 3
