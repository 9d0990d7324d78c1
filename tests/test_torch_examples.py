"""The port's examples (``examples/torch_*.py``) on the CPU at small
sizes, against the JAX package: the quickstart's mapping, trace and
summary equal to the JAX mapper's and both backends within 1e-3 of the
oracle; the serving example's per-request checksums, on both backends,
bit-equal to the JAX ``examples/serve_lm.py`` path's on its interpreter;
the planning example's rows equal to the JAX planner's, with the
backends checked; the training example run and resumed."""

import importlib.util
import pathlib
import shutil

import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.feather import feather_config as jfeather_config
from repro.configs.registry import get_config as jget_config
from repro.core import mapper as jmapper
from repro.core.isa import trace_summary as jtrace_summary
from repro.core.model_gemms import gemm_workloads as jgemm_workloads
from repro.core.planner import plan_model as jplan_model
from repro.runtime import ModelExecutable as JModelExecutable
from repro.runtime import ProgramCache as JProgramCache
from repro.runtime import Scheduler as JScheduler

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


def example(name: str):
    spec = importlib.util.spec_from_file_location(
        name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart():
    got = example("torch_quickstart").main(["--device", "cpu"])
    cfg = jfeather_config(8, 8)
    plan = jmapper.search(jmapper.Gemm(m=96, k=40, n=88, name="quickstart"),
                          cfg)
    ch = plan.choice
    assert got["choice"] == {"df": ch.df.name, "vn": ch.vn,
                             "tile": (ch.m_t, ch.k_t, ch.n_t),
                             "groups": (ch.n_kg, ch.n_nb), "dup": ch.dup}
    assert got["trace"] == jtrace_summary(plan.program.instructions(), cfg)
    assert got["summary"] == plan.summary()
    assert set(got["errs"]) == {"interpreter", "cuda"}
    assert max(got["errs"].values()) < 1e-3


def jax_serve_checksums(requests: int, steps: int) -> dict:
    """The JAX ``examples/serve_lm.py`` path on its interpreter."""
    cfg = jfeather_config(4, 16)
    cache = JProgramCache()
    pre = JModelExecutable.for_cell("minitron-4b", "prefill_tiny", cfg,
                                    cache=cache)
    dec = JModelExecutable.for_cell("minitron-4b", "decode_tiny", cfg,
                                    cache=cache)
    sched = JScheduler(pre, dec, backend="interpreter", max_concurrent=2)
    for _ in range(requests):
        sched.submit(decode_steps=steps)
    return {r.rid: r.state_checksum for r in sched.run().requests}


def test_serve_lm_checksums_equal_the_reference():
    argv = ["--device", "cpu", "--requests", "3", "--steps", "2"]
    mod = example("torch_serve_lm")
    want = jax_serve_checksums(3, 2)
    for backend in ("cuda", "interpreter"):
        got = mod.main(argv + ["--backend", backend])
        assert got["checksums"] == want, backend
        assert got["summary"]["backend"] == backend
        assert got["summary"]["n_requests"] == 3


def test_minisa_plan_rows_equal_the_reference():
    got = example("torch_minisa_plan").main(
        ["--arch", "gemma-7b", "granite-moe-3b-a800m", "--device", "cpu",
         "--check-backends"])
    cfg = jfeather_config(16, 256)
    for arch, row in got.items():
        ops = jgemm_workloads(jget_config(arch), JSHAPES["decode_32k"])
        plan = jplan_model(arch, "decode_32k", ops, cfg)
        assert row["summary"] == plan.summary()
        assert row["n_tiles"] == sum(p.program.n_tiles
                                     for p in plan.plans.values())
        assert row["n_unique"] == len(plan.plans)
        # cross_check raises on a backend past its tolerance
        assert 0 < len(row["checked"]) < row["n_unique"]


def test_train_lm_runs_and_resumes(tmp_path, capsys):
    """Two steps, then continued to three (``--resume auto``); and a
    straight three-step run with a checkpoint after two, resumed from
    that checkpoint: the resumed run's parameters and optimizer state
    ``torch.equal`` to the straight run's."""
    mod = example("torch_train_lm")
    argv = ["--device", "cpu", "--layers", "2", "--d-model", "64",
            "--batch", "2", "--seq", "32"]
    first = mod.main(argv + ["--steps", "2", "--ckpt-dir",
                             str(tmp_path / "a")])
    assert first["start"] == 0 and len(first["losses"]) == 2
    assert np.isfinite(first["losses"]).all()
    again = mod.main(argv + ["--steps", "3", "--ckpt-dir",
                             str(tmp_path / "a")])
    assert "resumed from step 2" in capsys.readouterr().out
    assert again["start"] == 2 and len(again["losses"]) == 1

    straight = mod.main(argv + ["--steps", "3", "--ckpt-every", "2",
                                "--ckpt-dir", str(tmp_path / "b")])
    shutil.copytree(tmp_path / "b" / "step_00000002",
                    tmp_path / "c" / "step_00000002")
    resumed = mod.main(argv + ["--steps", "3", "--ckpt-dir",
                               str(tmp_path / "c")])
    assert resumed["start"] == 2
    assert resumed["losses"] == straight["losses"][2:]
    a, b = straight["run"], resumed["run"]
    for (n, p), (m, q) in zip(a.model.net.named_parameters(),
                              b.model.net.named_parameters()):
        assert n == m and torch.equal(p, q), n
    for k in ("master", "mu", "nu"):
        for n in a.opt_state[k]:
            assert torch.equal(a.opt_state[k][n], b.opt_state[k][n]), (k, n)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA device is "
                    "present")
@pytest.mark.parametrize("name,argv", [
    ("torch_quickstart", []), ("torch_serve_lm", ["--requests", "1"]),
    ("torch_minisa_plan", ["--arch", "gemma-7b", "--check-backends"]),
    ("torch_train_lm", ["--steps", "1", "--layers", "1", "--d-model", "32",
                        "--batch", "1", "--seq", "8"])])
def test_examples_default_to_the_card(name, argv, tmp_path):
    """Without ``--device`` every example runs on the card, and raises
    without one (nothing falls back to the CPU)."""
    if name == "torch_train_lm":
        argv = argv + ["--ckpt-dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="CUDA device"):
        example(name).main(argv)
