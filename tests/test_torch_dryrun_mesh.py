"""The partitioned dry run (``launch.dryrun.partitioned``: a cell's step
on DTensors of ``meta`` shards over a fake process group,
``launch.mesh.fake_group``) and what ``launch.graph_analysis`` counts
of it.  For reduced gemma-7b and zamba2-1.2b (train, prefill, decode at
16 tokens, a batch of 4) on a (2, 2) mesh:

  * the trace over a fake group of 4 equals, exactly, what rank 0 counts
    when the same step runs for real on 4 gloo CPU ranks
    (``tests/_torch_dryrun_mesh_fns.py``): per-device dot flops, tensor
    bytes, and collectives by kind and by mesh axis;
  * a second trace in the same process counts the same;
  * per-device dot flops within 5% of the JAX package's
    ``hlo_analysis.analyze`` on its compiled 4-device program for the
    same cell (``tests/_jax_dryrun_mesh_ref.py``, a process of its own);
    its collective bytes are not compared (GSPMD and DTensor choose
    their collectives independently).

And the fake group itself: it refuses to stand in for a group already
up, and leaves none behind, also after a sweep whose cell fails."""

import json
import os
import subprocess
import sys

import pytest
import torch.distributed as dist

from _torch_dryrun_mesh_fns import CELLS, KEYS, MESH, cell, counts
from repro_torch.dist import ranks
from repro_torch.dist.sharding import abstract_mesh
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_group

HERE = os.path.dirname(os.path.abspath(__file__))
FLOPS_RTOL = 0.05
IDS = [f"{a}-{k}" for a, k in CELLS]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the JAX reference's counts, rank 0's counts on the gloo ranks),
    by ``<arch>|<kind>``; the two run at once."""
    tmp = tmp_path_factory.mktemp("dryrun_mesh")
    out = tmp / "ref.json"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (os.path.join(os.path.dirname(HERE), "src"),
                    env.get("PYTHONPATH")) if p)
    proc = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_jax_dryrun_mesh_ref.py"),
         str(out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
    try:
        real = ranks.spawn(counts, 4, str(tmp), timeout_s=120,
                           deadline_s=600)[0]
        log, _ = proc.communicate(timeout=600)
    except BaseException:
        proc.kill()
        raise
    if proc.returncode:
        raise RuntimeError(f"the JAX reference failed:\n{log.decode()}")
    return json.loads(out.read_text()), real


@pytest.fixture(scope="module")
def traces():
    """Each cell traced twice over a fake group of 4, in this process."""
    mesh = abstract_mesh(MESH, ("data", "model"))
    out = {}
    for arch, kind in CELLS:
        cfg, shape = cell(arch, kind)
        out[f"{arch}|{kind}"] = [dryrun.partitioned(cfg, shape, mesh)
                                 for _ in range(2)]
    return out


@pytest.mark.parametrize("arch,kind", CELLS, ids=IDS)
def test_trace_equals_a_real_run_on_four_ranks(arch, kind, runs, traces):
    _, real = runs
    first, second = traces[f"{arch}|{kind}"]
    want = real[f"{arch}|{kind}"]
    for key in KEYS:
        assert first[key] == want[key], (key, first[key], want[key])
        assert second[key] == first[key], (key, second[key], first[key])
    assert set(first["collectives_by_axis"]) <= {"data", "model"}
    assert first["collective_bytes"] == sum(
        sum(k.values()) for k in first["collectives_by_axis"].values())


@pytest.mark.parametrize("arch,kind", CELLS, ids=IDS)
def test_per_device_flops_match_the_jax_partitioned_program(arch, kind,
                                                            runs, traces):
    ref, _ = runs
    got = traces[f"{arch}|{kind}"][0]["dot_flops"]
    want = ref[f"{arch}|{kind}"]["dot_flops"]
    assert abs(got - want) <= FLOPS_RTOL * want, (got, want, got / want)


def test_fake_group_never_stands_in_for_a_real_one():
    mesh = abstract_mesh((2, 2), ("data", "model"))
    with fake_group(mesh) as dmesh:
        assert dist.get_world_size() == 4 and dist.get_rank() == 0
        assert dmesh.mesh_dim_names == ("data", "model")
        with pytest.raises(RuntimeError, match="already up"):
            with fake_group(mesh):
                pass
    assert not dist.is_initialized()


def test_a_sweep_leaves_no_group_behind(monkeypatch):
    """A cell whose partitioned trace raises is FAIL (never the ideal
    split), and the group it brought up is gone."""
    cfg, _ = cell("gemma-7b", "decode")

    def broken(*args, **kwargs):
        raise RuntimeError("no rule")
    monkeypatch.setattr(dryrun, "get_config", lambda arch: cfg)
    mesh = abstract_mesh(MESH, ("data", "model"))
    records = dryrun.sweep([("gemma-7b", "decode_32k")], mesh,
                           verbose=False)
    assert records[0]["status"] == "OK"
    assert not dist.is_initialized()
    monkeypatch.setattr(dryrun, "place_cache", broken)
    records = dryrun.sweep([("gemma-7b", "decode_32k")], mesh,
                           verbose=False)
    assert records[0]["status"].startswith("FAIL RuntimeError: no rule")
    assert not dist.is_initialized()
