"""Training on a mesh through its entry points: a checkpoint saved on
(2, 2) restored on (1, 4) and in one process, and one the JAX package
wrote restored onto the port's mesh, all ``torch.equal``;
``launch.train.main`` on 4 gloo ranks printing rank 0's lines only, the
same as one process's, and resuming onto the mesh's placements;
``--production-mesh`` raising below 256 ranks."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_train_mesh_fns as fns
from _train_mesh_common import flatten
from repro.ckpt.manager import CheckpointManager as JCheckpointManager
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import reduced as jreduced
from repro.configs.registry import get_config as jget_config
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models.api import build_model as jbuild_model
from repro.train import optimizer as joptlib
from repro.train.trainer import TrainConfig as JTrainConfig
from repro.train.trainer import make_train_step as jmake_train_step
from repro_torch.dist import ranks
from repro_torch.launch import train as launch_train

CKPT_ARCH = "zamba2-1.2b"
CLI = ["--arch", "zamba2-1.2b", "--reduced", "--reduced-layers", "2",
       "--reduced-dmodel", "64", "--batch", "4", "--seq", "32",
       "--log-every", "1", "--device", "cpu"]


def _jax_init(arch):
    """The JAX package's initial parameters of reduced ``arch``, numpy."""
    model = jbuild_model(jreduced(jget_config(arch)))
    return jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))


def _equal_trees(got, want):
    got, want = flatten(got), flatten(want)
    assert set(got) == set(want)
    for path, w in want.items():
        np.testing.assert_array_equal(np.asarray(got[path], np.float32),
                                      np.asarray(w, np.float32),
                                      err_msg=path)


def test_checkpoint_crosses_meshes(tmp_path):
    """A state saved on (2, 2) (gathered by every rank, written by rank 0)
    restored onto (1, 4) by ``elastic.resume`` onto ``state_placements``,
    and in one process: every array torch.equal to the state saved, each
    rank's parameters at the (1, 4) placements."""
    ckpt = str(tmp_path / "ckpt")
    saved = ranks.spawn(fns.ckpt_save, 4, str(tmp_path),
                        args=((2, 2), CKPT_ARCH, ckpt, _jax_init(CKPT_ARCH)),
                        timeout_s=120, deadline_s=600)[0]
    restored = ranks.spawn(fns.ckpt_restore, 4, str(tmp_path),
                           args=((1, 4), CKPT_ARCH, ckpt), timeout_s=120,
                           deadline_s=600)
    for r in restored:
        assert r["step"] == 1 and r["restored_is_dtensor"]
        _equal_trees(r["state"], saved)
        assert any("Shard" in p for p in r["placements"].values())
    one = fns.ckpt_restore(0, 1, None, CKPT_ARCH, ckpt)
    assert one["step"] == 1
    _equal_trees(one["state"], saved)


def test_jax_checkpoint_restores_onto_the_mesh(tmp_path):
    """A checkpoint the JAX package writes after one step (its manager,
    its {"params", "opt"} tree) resumed onto the port's (2, 2) mesh: every
    array, gathered back, torch.equal to the JAX package's state."""
    cfg = jreduced(jget_config(CKPT_ARCH))
    model = jbuild_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    opt = joptlib.OptimizerConfig(**fns.OPT)
    step = jax.jit(jmake_train_step(model, JTrainConfig(opt=opt)))
    data = JSyntheticLM(JDataConfig(vocab_size=cfg.vocab_size), cfg,
                        JShapeConfig("t", fns.SEQ, fns.BATCH, "train"))
    state = joptlib.init(params)
    params, state, _ = step(params, state,
                            jax.tree.map(jnp.asarray, data.batch(0)))
    tree = {"params": params, "opt": state}
    JCheckpointManager(str(tmp_path / "ckpt")).save(1, tree)
    got = ranks.spawn(fns.ckpt_restore, 4, str(tmp_path),
                      args=((2, 2), CKPT_ARCH, str(tmp_path / "ckpt")),
                      timeout_s=120, deadline_s=600)
    want = jax.tree.map(np.asarray, tree)
    for r in got:
        assert r["step"] == 1
        _equal_trees(r["state"], want)


_STEP = re.compile(r"step +(\d+) loss (\S+) ppl (\S+) gnorm (\S+) lr (\S+)")


def _steps(text):
    return [tuple(map(float, m.groups())) for m in _STEP.finditer(text)]


def test_cli_on_ranks_prints_on_rank_0_and_resumes_on_the_mesh(tmp_path,
                                                               capsys):
    """``launch.train.main`` on 4 gloo ranks (the (1, 4) host mesh): only
    rank 0 prints, its ``step`` lines within 2e-4 + 2e-4 * |x| of one
    process's (as printed); ``--resume auto`` on the ranks resumes onto
    the mesh (``resumed from step 3`` once) and continues as one process
    resuming its own checkpoint does."""
    mesh_dir, one_dir = str(tmp_path / "mesh"), str(tmp_path / "one")
    argv = CLI + ["--steps", "3"]
    out = ranks.spawn(fns.cli, 4, str(tmp_path),
                      args=(argv + ["--ckpt-dir", mesh_dir],),
                      timeout_s=120, deadline_s=600)
    assert all(o == "" for o in out[1:])
    launch_train.main(argv + ["--ckpt-dir", one_dir])
    one = capsys.readouterr().out
    assert out[0].endswith("done\n") and one.endswith("done\n")
    got, want = _steps(out[0]), _steps(one)
    assert [g[0] for g in got] == [w[0] for w in want] == [0, 1, 2]
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)

    argv = CLI + ["--steps", "4", "--resume", "auto"]
    out = ranks.spawn(fns.cli, 4, str(tmp_path),
                      args=(argv + ["--ckpt-dir", mesh_dir],),
                      timeout_s=120, deadline_s=600)
    assert all(o == "" for o in out[1:])
    assert out[0].count("resumed from step 3") == 1
    launch_train.main(argv + ["--ckpt-dir", one_dir])
    one = capsys.readouterr().out
    got, want = _steps(out[0]), _steps(one)
    assert [g[0] for g in got] == [w[0] for w in want] == [3]
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_production_mesh_needs_256_ranks(tmp_path):
    """``--production-mesh`` raises in one process and on 4 ranks, naming
    the 256 ranks it needs and the group's size."""
    argv = CLI + ["--steps", "1", "--production-mesh"]
    with pytest.raises(NotImplementedError,
                       match=r"256 ranks; this one has 1"):
        launch_train.main(argv)
    out = ranks.spawn(fns.cli_raises, 4, str(tmp_path), args=(argv,),
                      timeout_s=120, deadline_s=600)
    for o in out:
        assert o.startswith("NotImplementedError") and \
            "256 ranks; this one has 4" in o, o
