"""The port's functional machine (``repro_torch.core.machine`` behind
``InterpreterBackend``) against the JAX package's, on the CPU: every case
of ``tests/test_machine.py`` -- searched and forced groupings, VN sizes,
activation and chain, layout orders, strided stationary patterns, the
Fig. 4 regimes, flat trace == Program execution -- runs through both
interpreters on the same numpy inputs, each held against the JAX
``InterpreterBackend`` and the einsum oracle at rtol 2e-4, atol
2e-4 + 2e-4*k.  The Eq. 1 index lattices and the VN views are identical
to ``repro.core.mapping``'s and ``repro.core.vn``'s."""

import numpy as np
import pytest
import torch

from repro.configs.feather import feather_config as j_feather
from repro.core import isa as j_isa
from repro.core import machine as j_machine
from repro.core import mapper as j_mapper
from repro.core import mapping as j_mapping
from repro.core import program as j_program
from repro.core import vn as j_vn
from repro_torch import backends
from repro_torch.backends import InterpreterBackend
from repro_torch.configs.feather import feather_config as t_feather
from repro_torch.core import isa as t_isa
from repro_torch.core import machine as t_machine
from repro_torch.core import mapper as t_mapper
from repro_torch.core import mapping as t_mapping
from repro_torch.core import program as t_program
from repro_torch.core import vn as t_vn

RTOL = 2e-4


def _inputs(gemm, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((gemm[0], gemm[1])).astype(np.float32),
            rng.standard_normal((gemm[1], gemm[2])).astype(np.float32))


def _choice(pkg, **kw):
    isa = j_isa if pkg == "jax" else t_isa
    mapper = j_mapper if pkg == "jax" else t_mapper
    df = getattr(isa.Dataflow, kw.pop("df"))
    return mapper.MappingChoice(df=df, **kw)


def _programs(mkn, ah, aw, choice=None, **lower_kw):
    """The same GEMM lowered by each package (searched, or the forced
    ``choice`` kwargs); returns (JAX Program, port Program)."""
    m, k, n = mkn
    out = []
    for pkg, mapper, program, feather in (
            ("jax", j_mapper, j_program, j_feather),
            ("port", t_mapper, t_program, t_feather)):
        cfg = feather(ah, aw)
        gemm = mapper.Gemm(m=m, k=k, n=n)
        ch = (mapper.search(gemm, cfg).choice if choice is None
              else _choice(pkg, **dict(choice)))
        out.append(program.lower(gemm, ch, cfg, **lower_kw))
    assert repr(out[1].choice) == repr(out[0].choice)
    return out


def _check(mkn, ah, aw, choice=None, seed=0, act=None, **lower_kw):
    """Both interpreters on the same inputs: the port against the JAX
    interpreter and the einsum oracle."""
    jprog, tprog = _programs(mkn, ah, aw, choice, **lower_kw)
    i, w = _inputs(mkn, seed)
    want = np.asarray(j_machine.run_program(jprog.cfg, jprog,
                                            {"I": i, "W": w})["O"])
    got = t_machine.run_program(tprog.cfg, tprog, {"I": i, "W": w},
                                device="cpu")["O"]
    assert got.device.type == "cpu" and got.dtype == torch.float32
    oracle = i @ w
    if act is not None:
        oracle = act(oracle)
    atol = RTOL + RTOL * mkn[1]
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=atol)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=RTOL, atol=atol)
    return tprog


@pytest.mark.parametrize("m,k,n", [
    (4, 4, 4), (8, 8, 8), (16, 16, 16),
    (5, 7, 3), (6, 10, 21), (1, 40, 88), (17, 40, 88), (32, 3, 50),
])
@pytest.mark.parametrize("ah,aw", [(4, 4), (4, 16), (8, 8)])
def test_machine_matches_reference_searched(m, k, n, ah, aw):
    _check((m, k, n), ah, aw, seed=m * 1000 + k * 10 + n)


@pytest.mark.parametrize("df", ["WOS", "IOS"])
@pytest.mark.parametrize("n_kg,n_nb", [(1, 1), (2, 1), (1, 2), (4, 1),
                                       (2, 2), (1, 4)])
def test_machine_matches_reference_forced_grouping(df, n_kg, n_nb):
    dup = (4 // n_kg) // n_nb
    _check((12, 16, 12), 4, 4, dict(df=df, vn=4, m_t=12, k_t=16, n_t=12,
                                    n_kg=n_kg, n_nb=n_nb, dup=dup))


@pytest.mark.parametrize("vn", [1, 2, 3, 4])
def test_machine_vn_sizes(vn):
    """VN_size < AH activates only vn rows (no double counting)."""
    k = 2 * vn + 1
    _check((6, k, 9), 4, 4, dict(df="WOS", vn=vn, m_t=6, k_t=k, n_t=9,
                                 n_kg=1, n_nb=1, dup=4))


@pytest.mark.parametrize("em,es", [
    # tests/test_machine.py's §IV-E case study, then strided, offset and
    # replicated lattices
    ((0, 0, 2, 1, 1, 0), (0, 3, 3, 4)),
    ((1, 2, 1, 2, 2, 1), (5, 1, 4, 2)),
    ((3, 0, 4, 1, 1, 0), (2, 2, 2, 4)),
    ((0, 4, 1, 1, 4, 0), (0, 1, 1, 1)),
])
def test_eq1_indices_identical(em, es):
    """Eq. 1 + the §IV-E streaming formulas, the MAC count and the unique
    outputs, identical to the JAX package's ``core.mapping``."""
    keys = ("r0", "c0", "g_r", "g_c", "s_r", "s_c")
    skeys = ("m0", "s_m", "t", "vn_size")
    jem, tem = (isa.ExecuteMapping(**dict(zip(keys, em)))
                for isa in (j_isa, t_isa))
    jes, tes = (isa.ExecuteStreaming(**dict(zip(skeys, es)))
                for isa in (j_isa, t_isa))
    want = j_mapping.tile_indices(jem, jes, ah=4, aw=4)
    got = t_mapping.tile_indices(tem, tes, ah=4, aw=4)
    for f in ("r", "c", "m"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.t_steps == want.t_steps
    assert t_mapping.tile_macs(tem, tes, 4, 4, 3, 9, 7) == \
        j_mapping.tile_macs(jem, jes, 4, 4, 3, 9, 7)
    assert t_mapping.tile_unique_outputs(tem, tes, 4, 4) == \
        j_mapping.tile_unique_outputs(jem, jes, 4, 4)
    if em == (0, 0, 2, 1, 1, 0):
        # §IV-E case study: columns 0,1 -> j=0; columns 2,3 -> j=1, and
        # m = m0 + 3t + (a_w mod 2) // 1
        np.testing.assert_array_equal(got.r, [0, 0, 1, 1])
        np.testing.assert_array_equal(got.m, [[0, 1, 0, 1], [3, 4, 3, 4],
                                              [6, 7, 6, 7]])


def test_activation_and_chain():
    """The Activation instruction applies on the drained output."""
    relu = lambda x: np.maximum(x, 0)      # noqa: E731
    _check((6, 8, 5), 4, 4, act=relu, activation=relu, act_name="relu")


@pytest.mark.parametrize("act", ["gelu", "softmax", "layernorm"])
def test_activation_registry_on_the_device(act):
    """Registry activations run as the runtime's ``ACTIVATIONS`` (tanh
    gelu, max-subtracted softmax, population-variance layernorm with
    eps 1e-6), matching the JAX machine's device twins.  WO-S with one
    full-row output tile, as the runtime puts row-wise ones in-program."""
    from repro.runtime.executable import ACTIVATIONS as j_acts
    fn = j_acts[act]
    prog = _check((6, 8, 5), 4, 4, dict(df="WOS", vn=4, m_t=6, k_t=8,
                                        n_t=5, n_kg=1, n_nb=1, dup=4),
                  act=lambda x: np.asarray(fn(x)), activation=fn,
                  act_name=act)
    assert prog.n_n == 1


def test_chain_commits_on_chip():
    """A chained pair: layer 0's committing Write places its output in
    the operand buffer and layer 1's elided input reads it there (no
    host 'I'), equal to the JAX interpreter and the oracle."""
    outs = []
    i, w0 = _inputs((8, 16, 12), 3)
    w1 = np.random.default_rng(4).standard_normal((12, 10)).astype(
        np.float32)
    for mapper, program, feather, run in (
            (j_mapper, j_program, j_feather, None),
            (t_mapper, t_program, t_feather, "port")):
        cfg = feather(4, 4)
        progs = [mapper.search(mapper.Gemm(m=8, k=16, n=12), cfg).program,
                 mapper.search(mapper.Gemm(m=8, k=12, n=10), cfg).program]
        progs = program.chain(progs)
        assert progs[1].input_elided
        if run is None:
            from repro.backends import InterpreterBackend as JInterp
            be = JInterp(cfg)
        else:
            be = InterpreterBackend(cfg, device="cpu")
        be.run_program(progs[0], {"I": i, "W": w0})
        out = be.run_program(progs[1], {"W": w1})[progs[1].out_name]
        outs.append(np.asarray(out))
    np.testing.assert_allclose(outs[1], outs[0], rtol=RTOL,
                               atol=RTOL + RTOL * 16)
    np.testing.assert_allclose(outs[1], (i @ w0) @ w1, rtol=RTOL,
                               atol=RTOL + RTOL * 16)


def test_layout_orders_do_not_change_semantics():
    """Any legal Tab. III order gives the same result (layout is a
    performance knob, not a semantic one)."""
    base = j_mapper.search(j_mapper.Gemm(m=8, k=12, n=10),
                           j_feather(4, 4)).choice
    for o in range(6):
        fields = {f: getattr(base, f) for f in base.__dataclass_fields__}
        fields.update(df=base.df.name, order_w=o, order_i=(o + 1) % 6,
                      order_o=(o + 2) % 6)
        _check((8, 12, 10), 4, 4, fields, seed=o)


@pytest.mark.parametrize("df", ["WOS", "IOS"])
@pytest.mark.parametrize("n_nb", [2, 4])
def test_strided_stationary_pattern(df, n_nb):
    """Tab. VII's strided c-pattern (s_r=G_c, s_c=1)."""
    dup = (4 // 1) // n_nb
    _check((8, 8, 16), 4, 4, dict(df=df, vn=4, m_t=8, k_t=8, n_t=16,
                                  n_kg=1, n_nb=n_nb, dup=dup,
                                  strided=True))


def test_fig4_mapping_regimes():
    """Fig. 4's three ExecuteMapping regimes on a 4x4 NEST: full
    replication, two groups, and per-column distinct W_VNs."""
    for n_kg, n_nb in [(1, 1), (2, 1), (4, 1), (1, 4)]:
        dup = (4 // n_kg) // n_nb
        _check((16, 16, 16), 4, 4, dict(df="WOS", vn=4, m_t=16, k_t=16,
                                        n_t=16, n_kg=n_kg, n_nb=n_nb,
                                        dup=dup), seed=n_kg * 10 + n_nb)


def test_flat_trace_equals_program_execution():
    """run_trace over the flattened TraceOp stream == run_program (the
    flat trace is the same artifact, not a second lowering)."""
    tprog = _check((17, 40, 24), 4, 16, seed=5)
    i, w = _inputs((17, 40, 24), 5)
    a = t_machine.run_program(tprog.cfg, tprog, {"I": i, "W": w},
                              device="cpu")["O"]
    b = t_machine.run_trace(tprog.cfg, list(tprog.trace_ops()),
                            {"I": i, "W": w}, device="cpu")["O"]
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the VN views
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,vn", [((7, 5), 3), ((8, 4), 4), ((1, 9), 2),
                                      ((10, 3), 1)])
def test_vn_views_identical(shape, vn):
    x = np.random.default_rng(sum(shape) + vn).standard_normal(shape) \
        .astype(np.float32)
    for fn in ("to_weight_vns", "to_input_vns", "to_output_vns"):
        want = getattr(j_vn, fn)(x, vn)
        got = getattr(t_vn, fn)(x, vn)
        assert got.shape == want.shape and np.array_equal(got, want), fn
    o_vn = j_vn.to_output_vns(x, vn)
    assert np.array_equal(t_vn.from_output_vns(o_vn, *shape),
                          j_vn.from_output_vns(o_vn, *shape))
    assert np.array_equal(t_vn.from_output_vns(o_vn, *shape), x)
    for fn in ("weight_vn_shape", "input_vn_shape", "output_vn_shape"):
        assert dataclasses_equal(getattr(t_vn, fn)(*shape, vn),
                                 getattr(j_vn, fn)(*shape, vn))


def dataclasses_equal(a, b) -> bool:
    return (a.rows, a.cols, a.vn_size, a.count) == \
        (b.rows, b.cols, b.vn_size, b.count)


# ---------------------------------------------------------------------------
# the backend
# ---------------------------------------------------------------------------

def test_interpreter_backend_registered_and_cross_checked():
    """``"interpreter"`` is in the registry, launches nothing, and
    ``cross_check`` holds interpreter == cuda (plain versions) == oracle
    over a few ci_suite programs at 4x16 by default."""
    from repro_torch.core import workloads
    assert backends.BACKENDS["interpreter"] is InterpreterBackend
    cfg = t_feather(4, 16)
    be = backends.get_backend("interpreter", cfg, device="cpu")
    assert isinstance(be, InterpreterBackend) and be.device.type == "cpu"
    suite = workloads.ci_suite()
    for idx, g in enumerate(suite[:4]):
        prog = t_mapper.search(g, cfg).program
        i, w = _inputs((g.m, g.k, g.n), idx)
        errs = backends.cross_check(prog, {"I": i, "W": w}, device="cpu")
        assert set(errs) == {"interpreter", "cuda"}
    out = be.run_program(prog, {"I": i, "W": w})[prog.out_name]
    assert be.n_launches == 0 and out.shape == (g.m, g.n)


def test_sharded_path_waits_for_a7():
    """The sharded path ROADMAP item A.7 ported: the interpreter runs a
    ShardedProgram on one machine per array (shard backends on its
    device, with its ``max_depth``), equal to the JAX interpreter's
    sharded run and the oracle for every axis and both dataflows."""
    from repro.backends import InterpreterBackend as JInterp
    from repro.dist import ArrayMesh as JMesh
    from repro_torch.dist import ArrayMesh
    be = InterpreterBackend(t_feather(4, 16), device="cpu", max_depth=64)
    sub = be._make_shard_backend()
    assert isinstance(sub, InterpreterBackend)
    assert (sub.device, sub.max_depth) == (be.device, 64)
    mkn = (14, 12, 18)
    i, w = _inputs(mkn, 4)
    for df in ("WOS", "IOS"):
        jprog, tprog = _programs(mkn, 4, 16, dict(
            df=df, vn=4, m_t=8, k_t=8, n_t=8, n_kg=1, n_nb=1, dup=4))
        for axis in ("m", "n", "k"):
            jsh = j_program.shard_program(jprog, JMesh(3), axis=axis)
            tsh = t_program.shard_program(tprog, ArrayMesh(3), axis=axis)
            want = np.asarray(JInterp(jprog.cfg).run_program(
                jsh, {"I": i, "W": w})["O"])
            be.reset()
            got = be.run_program(tsh, {"I": i, "W": w})["O"]
            assert got.device.type == "cpu" and be.n_launches == 0
            atol = RTOL + RTOL * mkn[1]
            np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                                       atol=atol)
            np.testing.assert_allclose(got.numpy(), i @ w, rtol=RTOL,
                                       atol=atol)
    assert sorted(be._shard_subs) == [0, 1, 2]


def test_reduction_order_is_fixed_at_any_thread_count():
    """A K-heavy GEMM whose batches reduce ~2^16 contributions into 16
    output cells, far past the size at which PyTorch's CPU
    ``index_put_(accumulate=True)`` splits its indices over threads (and
    adds with atomics): run 10 times at 8 threads, the output is
    torch.equal every time and to a run at 1 thread, and within the
    tolerance of the JAX interpreter and the oracle."""
    mkn = (4, 65536, 4)
    jprog, tprog = _programs(mkn, 4, 4)
    i, w = _inputs(mkn, 11)
    threads = torch.get_num_threads()
    try:
        torch.set_num_threads(1)
        first = t_machine.run_program(tprog.cfg, tprog, {"I": i, "W": w},
                                      device="cpu")["O"]
        torch.set_num_threads(8)
        for _ in range(10):
            got = t_machine.run_program(tprog.cfg, tprog, {"I": i, "W": w},
                                        device="cpu")["O"]
            assert torch.equal(got, first)
    finally:
        torch.set_num_threads(threads)
    want = np.asarray(j_machine.run_program(jprog.cfg, jprog,
                                            {"I": i, "W": w})["O"])
    atol = RTOL + RTOL * mkn[1]
    np.testing.assert_allclose(first.numpy(), want, rtol=RTOL, atol=atol)
    np.testing.assert_allclose(first.numpy(), i @ w, rtol=RTOL, atol=atol)
