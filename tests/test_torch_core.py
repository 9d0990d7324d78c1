"""The port's numpy-only core (configs, ISA, Program IR, mapper, perf model)
against the JAX package's: over every ``workloads.ci_suite()`` GEMM the
mapper picks the same MappingChoice, lowers the same tile stream (tile
count, MINISA and micro bytes), the perf model gives the same cycles, and
the compiled backends derive the same launch geometry."""

import dataclasses

import numpy as np
import pytest

from repro.backends import compile_program as j_compile
from repro.configs.feather import feather_config as j_feather
from repro.core import mapper as j_mapper
from repro.core import perf as j_perf
from repro.core import planner as j_planner
from repro.core import workloads as j_workloads
from repro_torch.backends import compile_program as t_compile
from repro_torch.backends import cross_check as t_cross_check
from repro_torch.configs.feather import feather_config as t_feather
from repro_torch.configs.registry import get_config as t_get_config
from repro_torch.core import mapper as t_mapper
from repro_torch.core import model_gemms as t_model_gemms
from repro_torch.core import perf as t_perf
from repro_torch.core import planner as t_planner
from repro_torch.core import workloads as t_workloads

ARRAYS = [(4, 16), (16, 256)]
SUITE = list(zip(j_workloads.ci_suite(), t_workloads.ci_suite()))


def _choice(c) -> tuple:
    return tuple(f.name if hasattr(f, "name") else f
                 for f in dataclasses.astuple(c))


def _program_facts(plan, perf) -> dict:
    p = plan.program
    return {
        "n_tiles": p.n_tiles,
        "minisa_bytes": p.minisa_bytes(),
        "micro_bytes": p.micro_storage_bytes(),
        "cycles_minisa": perf.simulate(p.tile_costs("minisa"),
                                       p.cfg).cycles,
        "cycles_micro": perf.simulate(p.tile_costs("micro"), p.cfg).cycles,
        "residency": dict(p.residency),
    }


def test_ci_suite_is_the_same_suite():
    assert len(SUITE) == len(j_workloads.ci_suite()) >= 50
    for jg, tg in SUITE:
        assert (jg.m, jg.k, jg.n, jg.name) == (tg.m, tg.k, tg.n, tg.name)


@pytest.mark.parametrize("ah,aw", ARRAYS)
@pytest.mark.parametrize("pair", SUITE, ids=lambda p: p[0].name)
def test_mapping_program_and_cycles_match(pair, ah, aw):
    jg, tg = pair
    jp = j_mapper.search(jg, j_feather(ah, aw))
    tp = t_mapper.search(tg, t_feather(ah, aw))
    assert _choice(tp.choice) == _choice(jp.choice)
    assert _program_facts(tp, t_perf) == _program_facts(jp, j_perf)
    assert t_compile(tp.program).describe() == \
        j_compile(jp.program).describe()


@pytest.mark.parametrize("pair", SUITE, ids=lambda p: p[0].name)
def test_cuda_backend_matches_oracle_ci_suite(pair):
    """Every mapping the mapper emits for the sweep, run on the CUDA
    backend's plain versions and on the interpreter (``cross_check``'s
    default pair), equals the einsum oracle at the fp32 accumulate
    tolerance (``repro``'s tests/test_backends.py spine)."""
    _, g = pair
    plan = t_mapper.search(g, t_feather(4, 16))
    rng = np.random.default_rng(g.m * 7 + g.k * 3 + g.n)
    tensors = {"I": rng.standard_normal((g.m, g.k)).astype(np.float32),
               "W": rng.standard_normal((g.k, g.n)).astype(np.float32)}
    errs = t_cross_check(plan.program, tensors, device="cpu")
    assert set(errs) == {"interpreter", "cuda"}


def test_tab1_stall_at_16x256():
    """Table I: the micro-instruction baseline's fetch-stall share for
    I[65536, 40] x W[40, 88] on the 16x256 array (paper: 96.9%)."""
    g = t_mapper.Gemm(m=65536, k=40, n=88, name="tab1")
    stall = t_mapper.search(g, t_feather(16, 256)).perf_micro.stall_ifetch_frac
    jstall = j_mapper.search(j_mapper.Gemm(m=65536, k=40, n=88),
                             j_feather(16, 256)).perf_micro.stall_ifetch_frac
    assert stall == jstall
    assert round(stall, 4) == 0.9689


def test_planner_aggregates_match_on_gemma():
    """The analytic planner over gemma-7b decode at 16x256: same MINISA
    and micro totals as the reference."""
    from repro.configs.registry import get_config as j_get_config
    from repro.core import model_gemms as j_model_gemms
    from repro.configs.base import SHAPES as J_SHAPES
    from repro_torch.configs.base import SHAPES as T_SHAPES
    shape = "decode_32k"
    jops = j_model_gemms.gemm_workloads(j_get_config("gemma-7b"),
                                        J_SHAPES[shape])
    tops = t_model_gemms.gemm_workloads(t_get_config("gemma-7b"),
                                        T_SHAPES[shape])
    assert [(o.gemm.m, o.gemm.k, o.gemm.n, o.activation, o.chained,
             o.dynamic) for o in tops] == \
        [(o.gemm.m, o.gemm.k, o.gemm.n, o.activation, o.chained, o.dynamic)
         for o in jops]
    jplan = j_planner.plan_model("gemma-7b", shape, jops, j_feather(16, 256))
    tplan = t_planner.plan_model("gemma-7b", shape, tops, t_feather(16, 256))
    assert tplan.summary() == jplan.summary()
