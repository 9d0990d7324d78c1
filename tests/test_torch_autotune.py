"""The port's measured autotuning (``repro_torch.runtime.autotune``) and the
ProgramCache tuned tier, on the CUDA backend with ``device="cpu"`` (the
kernels' plain versions): ports of ``tests/test_autotune.py``'s warm-cache,
executable, serving-checksum and disk round-trip tests, plus the port's own
rule that a winner measured on the CPU never answers for the card."""

import numpy as np
import pytest

from repro_torch.backends import CudaBackend
from repro_torch.configs.feather import feather_config
from repro_torch.core import mapper, program, workloads
from repro_torch.runtime import (ModelExecutable, ProgramCache, Scheduler,
                                 autotune_segment, segment_key)
from repro_torch.runtime.autotune import TunedGeometry, tuning_state
from repro_torch.runtime.executable import ACTIVATIONS

CFG = feather_config(4, 16)


def _build_chain(m, widths, acts, cache=None):
    cache = cache or ProgramCache()
    progs = []
    for i in range(len(widths) - 1):
        g = mapper.Gemm(m=m, k=widths[i], n=widths[i + 1], name=f"at-l{i}")
        plan = cache.plan(g, CFG)
        progs.append(cache.lower(
            plan.gemm, plan.choice, CFG,
            activation=ACTIVATIONS.get(acts[i]), act_name=acts[i],
            out_name=f"O{i}"))
    return program.chain(progs, lower_fn=cache.lower), cache


def _ci_chain_dims():
    """(m, widths) anchored on the fhe-ntt CI family extents."""
    g = next(g for g in workloads.ci_suite() if "fhe-ntt" in g.name)
    return g.m, [g.k, g.n, g.k]


def _cpu_backend(cache=None):
    return CudaBackend(CFG, device="cpu", compile_cache=cache)


def test_tuning_state_names_the_device():
    """The key carries the device type: "cpu" measured the plain
    versions, "cuda" the kernels."""
    assert tuning_state(_cpu_backend()) == ("cuda", "cpu", 2048)
    assert tuning_state(CudaBackend(CFG, device="cpu", max_block=512)) \
        == ("cuda", "cpu", 512)


def test_tuned_winner_matches_the_chain_oracle():
    """The measured winner's geometry runs the same Programs: the fused
    launch at the tuned geometry equals the numpy chain."""
    m, widths = _ci_chain_dims()
    acts = ["relu", "none"]
    chained, cache = _build_chain(m, widths, acts)
    be = _cpu_backend(cache)
    rep = autotune_segment(chained, be, cache=cache, top_k=2, iters=1)
    assert rep is not None and not rep.cached
    w = rep.winner
    assert w.n_points_measured == len(rep.trials) >= 1
    assert 0.0 <= w.kernel_frac <= 1.0 and w.measured_s > 0.0
    assert min(t["median_s"] for t in rep.trials) == w.measured_s
    tuned = program.fuse_segment(chained, bm=w.bm, layer_bks=w.layer_bks)
    assert tuned is not None
    rng = np.random.default_rng(3)
    x = rng.standard_normal((m, widths[0])).astype(np.float32)
    ws = [(rng.standard_normal((widths[i], widths[i + 1]))
           / np.sqrt(widths[i])).astype(np.float32) for i in range(2)]
    want = x
    for i, w_ in enumerate(ws):
        want = want @ w_
        if acts[i] != "none":
            want = np.maximum(want, 0.0)
    t = {"I": x, **{f"W{i}": w_ for i, w_ in enumerate(ws)}}
    got = be.run_segment(tuned, t)[tuned.out_name].numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4,
                               atol=2e-4 + 2e-4 * max(widths))


def test_warm_cache_serves_tuned_without_work():
    """Second autotune of a structurally identical segment: zero joint
    searches, zero compiles, zero launches -- one tuned-tier lookup."""
    m, widths = _ci_chain_dims()
    chained, cache = _build_chain(m, widths, ["relu", "none"])
    be = _cpu_backend(cache)
    first = autotune_segment(chained, be, cache=cache, top_k=2, iters=1)
    assert not first.cached
    before = cache.stats.snapshot()
    launches = be.n_launches
    again = autotune_segment(chained, be, cache=cache, top_k=2, iters=1)
    assert again.cached and again.winner == first.winner
    delta = cache.stats.delta(before)
    assert delta["frontier_misses"] == 0
    assert delta["fused_misses"] == 0 and delta["compile_misses"] == 0
    assert delta["tuned_hits"] == 1
    assert be.n_launches == launches


def test_cpu_winner_is_not_served_for_the_card():
    """A winner measured with the plain versions answers only lookups
    made for the CPU: under the card's tuning state it misses, so the
    card measures its own."""
    m, widths = _ci_chain_dims()
    chained, cache = _build_chain(m, widths, ["relu", "none"])
    be = _cpu_backend(cache)
    rep = autotune_segment(chained, be, cache=cache, top_k=1, iters=1)
    card = ("cuda", "cuda", be.max_block)
    k_cpu = segment_key(chained, tuning=tuning_state(be))
    k_card = segment_key(chained, tuning=card)
    assert k_cpu != k_card and k_cpu[:-1] == k_card[:-1]
    assert cache.lookup_tuned(k_card) is None
    assert cache.tuned_geometry(chained, tuning=card) is None
    assert cache.tuned_geometry(chained, tuning=tuning_state(be)) \
        == rep.winner


def test_executable_consumes_tuned_geometry():
    """A rebuilt ModelExecutable picks the stored winner's geometry up
    through ``_fuse_with_tuned`` -- no explicit tuning plumbing."""
    cache = ProgramCache()
    exe = ModelExecutable.for_cell("gemma-7b", "decode_tiny", CFG,
                                   cache=cache)
    segs = [s for s in exe.segments if s.fused is not None]
    assert segs, "decode_tiny must have at least one fused segment"
    be = exe.make_backend("cuda", device="cpu")
    tuned = {}
    for s in segs:
        rep = autotune_segment(list(s.fused.programs), be, cache=cache,
                               adapts=s.fused.adapts, top_k=1, iters=1)
        assert rep is not None
        tuned[tuple(s.indices)] = rep.winner
    rebuilt = ModelExecutable.for_cell("gemma-7b", "decode_tiny", CFG,
                                       cache=cache)
    for s in rebuilt.segments:
        if s.fused is None:
            continue
        w = tuned[tuple(s.indices)]
        assert (s.fused.bm, s.fused.layer_bks) == (w.bm, w.layer_bks)


def test_executable_builds_fuse_from_a_stored_geometry():
    """A stored geometry other than the greedy one is the one a rebuilt
    executable's fused segment launches with."""
    cache = ProgramCache()
    exe = ModelExecutable.for_cell("gemma-7b", "decode_tiny", CFG,
                                   cache=cache)
    seg = next(s.fused for s in exe.segments if s.fused is not None)
    front = cache.frontier(list(seg.programs), adapts=seg.adapts)
    other = next((p for p in front.points
                  if (p.choice.bm, p.choice.layer_bks)
                  != (seg.bm, seg.layer_bks)), None)
    assert other is not None, "the frontier holds only the greedy geometry"
    key = segment_key(list(seg.programs), adapts=seg.adapts,
                      tuning=("cuda", "cpu", 2048))
    cache.store_tuned(key, TunedGeometry(
        bm=other.choice.bm, layer_bks=other.choice.layer_bks,
        measured_s=1e-6, kernel_frac=1.0, analytic_cycles=other.cycles,
        traffic_bytes=other.traffic_bytes, vmem_bytes=other.vmem_bytes,
        n_points_measured=1))
    rebuilt = ModelExecutable.for_cell("gemma-7b", "decode_tiny", CFG,
                                       cache=cache)
    got = next(s.fused for s in rebuilt.segments if s.fused is not None)
    assert (got.bm, got.layer_bks) == (other.choice.bm,
                                       other.choice.layer_bks)


def test_tuned_serving_checksums_identical():
    """Serving from a tuned cache gives the untuned checksums: the tuned
    geometry changes the K-tile walk of the fused launch, and the
    quantised recurrence absorbs the accumulation-order rounding."""
    def serve(cache):
        prefill = ModelExecutable.for_cell("gemma-7b", "prefill_tiny",
                                           CFG, cache=cache)
        decode = ModelExecutable.for_cell("gemma-7b", "decode_tiny",
                                          CFG, cache=cache)
        sched = Scheduler(prefill, decode, device="cpu", max_concurrent=2,
                          seed=0)
        for steps, prompt in [(2, None), (1, 64)]:
            sched.submit(decode_steps=steps, prompt_tokens=prompt)
        rep = sched.run()
        return [r.state_checksum for r in rep.requests]

    untuned = serve(ProgramCache())
    cache = ProgramCache()
    n_tuned = 0
    for cell in ("prefill_tiny", "decode_tiny"):
        exe = ModelExecutable.for_cell("gemma-7b", cell, CFG, cache=cache)
        be = exe.make_backend("cuda", device="cpu")
        for s in exe.segments:
            if s.fused is not None:
                rep = autotune_segment(list(s.fused.programs), be,
                                       cache=cache, adapts=s.fused.adapts,
                                       top_k=1, iters=1)
                n_tuned += rep is not None
    assert n_tuned >= 2
    assert serve(cache) == untuned
    assert all(untuned)


def test_cache_roundtrip_carries_tuned_tier(tmp_path):
    path = str(tmp_path / "cache.pkl")
    m, widths = _ci_chain_dims()
    chained, cache = _build_chain(m, widths, ["relu", "none"])
    cache.path = path
    be = _cpu_backend(cache)
    rep = autotune_segment(chained, be, cache=cache, top_k=1, iters=1)
    assert not rep.cached                  # autotune saved to disk

    fresh = ProgramCache(path=path)
    assert fresh.stats.loaded_from_disk >= 1
    # the same structural segment in a new process: tuned-tier hit,
    # winner equal, and the executables' struct index is rebuilt
    chained2, _ = _build_chain(m, widths, ["relu", "none"], cache=fresh)
    rep2 = autotune_segment(chained2, _cpu_backend(fresh), cache=fresh,
                            top_k=1, iters=1)
    assert rep2.cached and rep2.winner == rep.winner
    assert fresh.tuned_geometry(chained2) == rep.winner


def test_cache_rejects_tuned_tier_schema_mismatch(tmp_path):
    import pickle
    from repro_torch.runtime import cache as cachelib
    path = str(tmp_path / "schema.pkl")
    with open(path, "wb") as f:
        pickle.dump({"version": cachelib._PERSIST_VERSION,
                     "backend": cachelib.BACKEND,
                     "schema": {"plans": 2, "tuned": 99},
                     "tiers": {}}, f)
    with pytest.raises(ValueError, match="schema"):
        ProgramCache(path=path)


def test_full_width_segments_are_not_tunable():
    """gemma-7b at full width on the 16x256 array: no chained run is
    fusion-legal, so autotune has nothing to measure (returns None) and
    launches nothing."""
    cfg = feather_config(16, 256)
    cache = ProgramCache()
    be = CudaBackend(cfg, device="cpu", compile_cache=cache)
    n_chained = 0
    for shape in ("prefill_tiny", "decode_tiny"):
        ex = ModelExecutable.for_cell("gemma-7b", shape, cfg, cache=cache,
                                      reduce_model=False)
        for seg in ex.segments:
            if len(seg.indices) < 2:
                continue
            steps = [ex.steps[i] for i in seg.indices]
            adapts = (False,) + tuple(s.input_mode == "adapt"
                                      for s in steps[1:])
            assert autotune_segment([s.program for s in steps], be,
                                    cache=cache, adapts=adapts) is None
            n_chained += 1
    assert n_chained == 4 and be.n_launches == 0
