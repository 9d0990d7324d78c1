"""The port's training substrate against the JAX package's on the CPU:
the optimizer, the data pipeline, checkpoints, gradient compression and
the train step (``repro_torch.train``, ``data``, ``ckpt``, ``dist``), the
twins of ``tests/test_substrate.py``'s tests of the same; three train
steps, gradient accumulation and int8 compression against the JAX
package's ``make_train_step``; a checkpoint written by the JAX package
restored into the port; the train CLI with ``--resume auto``; and the
twin of ``test_training_reduces_loss``.  Parameters are the JAX
package's init loaded with ``Model.load_numpy``, inputs seeded numpy,
fp32."""

import dataclasses
import os
import shutil
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.ckpt.manager import CheckpointManager as JCheckpointManager
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import reduced as jreduced
from repro.configs.registry import get_config as jget_config
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.dist.compression import fake_quantize_int8 as jfake_quantize_int8
from repro.models import build_model as jbuild_model
from repro.train import optimizer as joptlib
from repro.train.trainer import TrainConfig as JTrainConfig
from repro.train.trainer import make_train_step as jmake_train_step
from repro_torch.ckpt.manager import CheckpointManager, _flatten
from repro_torch.configs.base import ShapeConfig, reduced
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.dist import elastic
from repro_torch.dist.compression import fake_quantize_int8
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.models.common import to_numpy
from repro_torch.train import optimizer as optlib
from repro_torch.train.trainer import (TrainConfig, load_state,
                                       make_train_step, state_tree)
from test_torch_models import np_tree

RNG = np.random.default_rng(0)


@pytest.fixture(autouse=True)
def _one_thread():
    """Each test on one CPU thread: its ops are small, and with several
    pytest workers each using every core they run ~10x slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# checkpoint manager
# ---------------------------------------------------------------------------

def _tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones(5),
                  "d": [torch.zeros(2, 2), torch.full((3,), 7.0)]}}


def _like(tree, device="meta"):
    return jax.tree.map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                              device=device), tree)


def test_ckpt_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    mgr.save(10, tree)
    assert mgr.latest_step() == 10
    restored = mgr.restore(10, _like(tree))
    assert jax.tree.structure(restored) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(restored)):
        assert b.device.type == "cpu" and torch.equal(a, b)


def test_ckpt_async_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save_async(s, {"x": torch.full((4,), float(s))})
    mgr.wait()
    assert mgr.all_steps() == [3, 4]
    r = mgr.restore(4, {"x": torch.empty(4, device="meta")})
    assert float(r["x"][0]) == 4.0


def test_ckpt_snapshot_owns_its_memory():
    """The host snapshot ``save`` hands its writer shares no memory with
    any CPU tensor of a ``state_tree``: ``optimizer.update`` changes
    those tensors in place while an asynchronous save writes."""
    cfg = dataclasses.replace(reduced(get_config("minitron-4b")),
                              num_layers=1, d_model=32, vocab_size=64)
    model = build_model(cfg, device="cpu")
    state = optlib.init(dict(model.net.named_parameters()))
    flat = _flatten(state_tree(model, state))
    tensors = [t.detach() for t in model.net.parameters()] + [
        t for k in ("master", "mu", "nu") for t in state[k].values()]
    views = [t.numpy() for t in tensors if t.dtype == torch.float32]
    assert len(views) == len(tensors)
    for key, arr in flat.items():
        assert arr.flags.owndata, key
        assert not any(np.may_share_memory(arr, v) for v in views), key


def test_ckpt_save_async_writes_the_values_at_the_call(tmp_path,
                                                       monkeypatch):
    """``save_async`` of a large fp32 CPU tensor, and of ``to_numpy`` of
    one (a ``state_tree`` leaf), each changed in place right after the
    call, writes the values they had at the call.  The writer thread is
    held until the change is made, so a snapshot that aliased either
    would be caught every time."""
    mgr = CheckpointManager(str(tmp_path))
    go = threading.Event()
    write = mgr._write
    monkeypatch.setattr(mgr, "_write",
                        lambda step, flat: (go.wait(), write(step, flat)))
    w, u = torch.full((1 << 22,), 1.0), torch.full((1 << 20,), 3.0)
    mgr.save_async(1, {"w": w, "u": to_numpy(u)})
    w.fill_(2.0)
    u.fill_(4.0)
    go.set()
    mgr.wait()
    r = mgr.restore(1, {"w": torch.empty(w.shape, device="meta"),
                        "u": torch.empty(u.shape, device="meta")})
    assert bool((r["w"] == 1.0).all()) and bool((r["u"] == 3.0).all())


def test_ckpt_shape_mismatch_rejected(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": torch.zeros(4)})
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore(1, {"x": torch.empty(5, device="meta")})


def test_ckpt_atomicity_no_tmp_left(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(7, _tree())
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))


def test_ckpt_bf16_and_dtypes(tmp_path):
    """A bf16 tensor goes to disk as fp32 (exact) and comes back in the
    target's dtype; numpy leaves and numbers come back as numpy."""
    mgr = CheckpointManager(str(tmp_path))
    w = torch.randn(6, generator=torch.Generator().manual_seed(0)).to(
        torch.bfloat16)
    mgr.save(2, {"w": w, "step": np.asarray(5, np.int32)})
    r = mgr.restore(2, {"w": torch.empty(6, dtype=torch.bfloat16,
                                         device="meta"),
                        "step": np.zeros((), np.int32)})
    assert r["w"].dtype == torch.bfloat16 and torch.equal(r["w"], w)
    assert r["step"].dtype == np.int32 and int(r["step"]) == 5


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_ckpt_cross_package_format(tmp_path, writer):
    """Each package restores the other's checkpoint of the same nested
    tree (the same ``arrays.npz`` keys)."""
    tree = {"a": np.arange(6.0, dtype=np.float32).reshape(2, 3),
            "b": {"c": [np.ones(3, np.float32),
                        np.full((2,), 7.0, np.float32)]},
            "step": np.asarray(3, np.int32)}
    if writer == "jax":
        JCheckpointManager(str(tmp_path)).save(
            5, jax.tree.map(jnp.asarray, tree))
        got = CheckpointManager(str(tmp_path)).restore(5, tree)
    else:
        CheckpointManager(str(tmp_path)).save(5, tree)
        got = JCheckpointManager(str(tmp_path)).restore(
            5, jax.eval_shape(lambda: jax.tree.map(jnp.asarray, tree)))
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(got)):
        np.testing.assert_array_equal(np.asarray(b), a)


def test_elastic_resume(tmp_path):
    """``elastic.resume``: (None, 0) on an empty directory, else the
    latest step restored onto the device asked for."""
    mgr = CheckpointManager(str(tmp_path))
    tree, step = elastic.resume(mgr, {}, None)
    assert tree is None and step == 0
    mgr.save(3, {"w": torch.arange(64.0).reshape(8, 8)})
    mgr.save(5, {"w": torch.arange(64.0).reshape(8, 8) + 1})
    tree, step = elastic.resume(mgr, {"w": torch.empty(8, 8,
                                                       device="meta")},
                                device="cpu")
    assert step == 5 and float(tree["w"][0, 0]) == 1.0


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def test_adamw_converges_quadratic():
    cfg = optlib.OptimizerConfig(peak_lr=0.1, warmup_steps=5,
                                 total_steps=200, weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = optlib.init(params)
    for _ in range(200):
        w = params["w"].clone().requires_grad_()
        ((w - 1.0) ** 2).sum().backward()
        optlib.update(cfg, params, {"w": w.grad}, state)
    assert float(((params["w"] - 1.0) ** 2).sum()) < 1e-2


def test_adamw_master_weights_decouple_dtype():
    cfg = optlib.OptimizerConfig(peak_lr=1e-2, warmup_steps=1,
                                 total_steps=10)
    params = {"w": torch.ones(4, dtype=torch.bfloat16)}
    state = optlib.init(params)
    optlib.update(cfg, params, {"w": torch.full((4,), 1e-3,
                                                dtype=torch.bfloat16)},
                  state)
    assert params["w"].dtype == torch.bfloat16
    assert state["master"]["w"].dtype == torch.float32
    assert state["step"] == 1


def test_grad_clip():
    clipped, norm = optlib.clip_by_global_norm(
        {"a": torch.full((100,), 10.0)}, 1.0)
    assert float(norm) == pytest.approx(100.0)
    assert float(optlib.global_norm(clipped.values())) == pytest.approx(
        1.0, rel=1e-5)


@pytest.mark.parametrize("step", [0, 1, 3, 7, 10, 55, 100, 120])
def test_schedule_matches(step):
    cfg = optlib.OptimizerConfig(peak_lr=1e-3, warmup_steps=7,
                                 total_steps=100)
    jcfg = joptlib.OptimizerConfig(peak_lr=1e-3, warmup_steps=7,
                                   total_steps=100)
    want = float(joptlib.schedule(jcfg, jnp.asarray(step, jnp.int32)))
    assert optlib.schedule(cfg, step) == pytest.approx(want, rel=1e-6,
                                                       abs=1e-12)


def test_adamw_update_matches():
    """One update of a two-tensor tree (one bf16) against the JAX
    package's, from the same state: masters, moments and parameters."""
    cfg = optlib.OptimizerConfig(peak_lr=1e-2, warmup_steps=2,
                                 total_steps=10)
    jcfg = joptlib.OptimizerConfig(peak_lr=1e-2, warmup_steps=2,
                                   total_steps=10)
    p = {"a": RNG.standard_normal((5, 3)).astype(np.float32),
         "b": RNG.standard_normal((4,)).astype(np.float32)}
    g = {"a": RNG.standard_normal((5, 3)).astype(np.float32) * 3,
         "b": RNG.standard_normal((4,)).astype(np.float32)}
    jp = {"a": jnp.asarray(p["a"]), "b": jnp.asarray(p["b"], jnp.bfloat16)}
    jstate = joptlib.init(jp)
    params = {"a": torch.from_numpy(p["a"]).clone(),
              "b": torch.from_numpy(p["b"]).to(torch.bfloat16)}
    state = optlib.init(params)
    for _ in range(3):
        jg = {"a": jnp.asarray(g["a"]), "b": jnp.asarray(g["b"],
                                                         jnp.bfloat16)}
        jp, jstate, jm = joptlib.update(jcfg, jp, jg, jstate)
        m = optlib.update(cfg, params, {"a": torch.from_numpy(g["a"]),
                                        "b": torch.from_numpy(g["b"]).to(
                                            torch.bfloat16)}, state)
    assert m["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                  rel=1e-6)
    for k in ("master", "mu", "nu"):
        for n in p:
            np.testing.assert_allclose(state[k][n].numpy(),
                                       np.asarray(jstate[k][n]),
                                       rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(
        params["b"].float().numpy(), np.asarray(jp["b"], np.float32))


# ---------------------------------------------------------------------------
# data pipeline, compression
# ---------------------------------------------------------------------------

def test_data_deterministic_per_step():
    cfg = reduced(get_config("gemma-7b"))
    shape = ShapeConfig("t", 64, 4, "train")
    d1 = SyntheticLM(DataConfig(seed=1), cfg, shape)
    d2 = SyntheticLM(DataConfig(seed=1), cfg, shape)
    np.testing.assert_array_equal(d1.batch(17)["tokens"],
                                  d2.batch(17)["tokens"])
    assert not np.array_equal(d1.batch(17)["tokens"],
                              d1.batch(18)["tokens"])


@pytest.mark.parametrize("arch", ["gemma-7b", "internvl2-26b",
                                  "whisper-base", "zamba2-1.2b"])
def test_data_matches_the_jax_package(arch):
    """Every array of a batch ``np.array_equal`` to the JAX package's
    (tokens, a vlm's patches, an encdec model's frames)."""
    cfg, jcfg = reduced(get_config(arch)), jreduced(jget_config(arch))
    shape, jshape = (ShapeConfig("t", 24, 3, "train"),
                     JShapeConfig("t", 24, 3, "train"))
    got = SyntheticLM(DataConfig(seed=5, vocab_size=300), cfg, shape)
    want = JSyntheticLM(JDataConfig(seed=5, vocab_size=300), jcfg, jshape)
    for step in (0, 9):
        a, b = got.batch(step), want.batch(step)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_int8_fake_quant_error_bounded():
    x = torch.from_numpy(RNG.standard_normal((64, 64)).astype(np.float32))
    q = fake_quantize_int8(x)
    assert q.dtype == x.dtype
    assert float((q - x).abs().max()) <= float(x.abs().max()) / 254 + 1e-6
    assert not fake_quantize_int8(torch.zeros(8)).any()


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_int8_fake_quant_matches(dtype):
    x = RNG.standard_normal((33, 7)).astype(np.float32) * 3
    if dtype == "bfloat16":
        got = fake_quantize_int8(torch.from_numpy(x).to(torch.bfloat16))
        want = jfake_quantize_int8(jnp.asarray(x, jnp.bfloat16))
    else:
        got = fake_quantize_int8(torch.from_numpy(x))
        want = jfake_quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


# ---------------------------------------------------------------------------
# the train step against the JAX package's
# ---------------------------------------------------------------------------

#: the reduced hybrid (both kernels with gradients), fp32
STEP_ARCH = "zamba2-1.2b"
STEP_SHAPE = (4, 16)           # batch, seq


def _models(arch, extra=()):
    jcfg = dataclasses.replace(jreduced(jget_config(arch)), **dict(extra))
    cfg = dataclasses.replace(reduced(get_config(arch)), **dict(extra))
    jm = jbuild_model(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    model = build_model(cfg, device="cpu").load_numpy(np_tree(params))
    return jm, params, model


def _batches(cfg, n):
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size), cfg,
                       ShapeConfig("t", STEP_SHAPE[1], STEP_SHAPE[0],
                                   "train"))
    return [data.batch(i) for i in range(n)]


def _close_trees(got, want, rtol, atol):
    got = jax.tree_util.tree_flatten_with_path(got)[0]
    want = jax.tree_util.tree_flatten_with_path(np_tree(want))[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=rtol,
                                   atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


#: three AdamW steps from the same parameters: the gradients agree within
#: ~1e-6 (test_torch_train.py), and AdamW's m / sqrt(v) turns an element
#: whose gradient is near zero into a step of about lr (1e-3) whichever
#: its sign, so a parameter may differ by a few lr where its gradient
#: vanishes; every other element stays within 2e-4 + 2e-4 * |ref|
STEP_LR = 1e-3


@pytest.mark.parametrize("compress,steps", [(False, 3), (True, 1)])
def test_three_train_steps_match(compress, steps):
    """Three ``make_train_step`` steps against the JAX package's (jitted):
    the losses and metrics at every step, then the parameters and the
    AdamW state.  With ``compress_grads`` one step: the int8 round trip
    rounds x / scale, so a gradient ~1e-6 away from a rounding edge
    lands one int8 step (amax / 127) apart in the two packages, and the
    steps after it see different parameters there."""
    jm, params, model = _models(STEP_ARCH)
    opt = optlib.OptimizerConfig(peak_lr=STEP_LR, warmup_steps=2,
                                 total_steps=10)
    jopt = joptlib.OptimizerConfig(peak_lr=STEP_LR, warmup_steps=2,
                                   total_steps=10)
    step = make_train_step(model, TrainConfig(opt=opt,
                                              compress_grads=compress))
    jstep = jax.jit(jmake_train_step(jm, JTrainConfig(
        opt=jopt, compress_grads=compress)))
    state = optlib.init(dict(model.net.named_parameters()))
    jstate = joptlib.init(params)
    for batch in _batches(model.cfg, steps):
        m = step(state, batch)
        params, jstate, jm_ = jstep(params, jstate,
                                    jax.tree.map(jnp.asarray, batch))
        for key in ("loss", "nll"):
            np.testing.assert_allclose(float(m[key]), float(jm_[key]),
                                       rtol=2e-5)
        # the norm is taken after the round trip: an element one int8
        # step apart moves it by ~amax / 127 / norm
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm_["grad_norm"]),
                                   rtol=1e-3 if compress else 2e-5)
        assert m["lr"] == pytest.approx(float(jm_["lr"]), rel=1e-6)
    assert state["step"] == int(jstate["step"]) == steps
    tree = state_tree(model, state)
    _close_trees(tree["params"], params, 2e-4, 3 * STEP_LR)
    _close_trees(tree["opt"]["master"], jstate["master"], 2e-4,
                 3 * STEP_LR)
    _close_trees(tree["opt"]["mu"], jstate["mu"], 2e-4, 2e-4)


def test_grad_accum_matches_full_batch():
    """Microbatch accumulation == one big batch (the twin of the JAX
    package's test, its bound), and the port's accumulated step matches
    the JAX package's."""
    jm, params, model = _models("minitron-4b", (("num_layers", 2),
                                                ("d_model", 32),
                                                ("vocab_size", 128)))
    batch = {"tokens": RNG.integers(0, 128, (4, 32)).astype(np.int32)}
    start = {k: v.clone() for k, v in model.state_dict().items()}
    out = []
    for accum in (1, 2):
        model.load_state_dict(start)
        state = optlib.init(dict(model.net.named_parameters()))
        m = make_train_step(model, TrainConfig(grad_accum=accum))(state,
                                                                  batch)
        out.append(({k: v.clone() for k, v in model.state_dict().items()},
                    m))
    d = max(float((a - b).abs().max()) for a, b in
            zip(out[0][0].values(), out[1][0].values()))
    assert d < 5e-3
    assert set(out[1][1]) == {"loss", "lr", "grad_norm"}
    jp, _, jm_ = jax.jit(jmake_train_step(jm, JTrainConfig(grad_accum=2)))(
        params, joptlib.init(params), jax.tree.map(jnp.asarray, batch))
    np.testing.assert_allclose(float(out[1][1]["loss"]), float(jm_["loss"]),
                               rtol=2e-5)
    model.load_state_dict(out[1][0])
    _close_trees(model.numpy_tree(), jp, 2e-4, 2e-4)


def test_jax_checkpoint_restores_into_the_port(tmp_path):
    """A checkpoint the JAX package writes after one step (its manager,
    its {"params", "opt"} tree) restored into the port by
    ``elastic.resume``: the state equal to the JAX package's, and the
    next step equal to the JAX package's next step."""
    jm, params, model = _models(STEP_ARCH)
    opt = optlib.OptimizerConfig(peak_lr=STEP_LR, warmup_steps=2,
                                 total_steps=10)
    jstep = jax.jit(jmake_train_step(jm, JTrainConfig(
        opt=joptlib.OptimizerConfig(peak_lr=STEP_LR, warmup_steps=2,
                                    total_steps=10))))
    b0, b1 = _batches(model.cfg, 2)
    jstate = joptlib.init(params)
    params, jstate, _ = jstep(params, jstate, jax.tree.map(jnp.asarray, b0))
    JCheckpointManager(str(tmp_path)).save(1, {"params": params,
                                                "opt": jstate})
    state = optlib.init(dict(model.net.named_parameters()))
    tree, step = elastic.resume(CheckpointManager(str(tmp_path)),
                                state_tree(model, state, meta=True), "cpu")
    assert step == 1
    load_state(model, state, tree)
    assert state["step"] == 1
    _close_trees(model.numpy_tree(), params, 0, 0)
    _close_trees(state_tree(model, state)["opt"]["nu"], jstate["nu"], 0, 0)
    m = make_train_step(model, TrainConfig(opt=opt))(state, b1)
    params, jstate, jm_ = jstep(params, jstate,
                                jax.tree.map(jnp.asarray, b1))
    np.testing.assert_allclose(float(m["loss"]), float(jm_["loss"]),
                               rtol=2e-5)
    _close_trees(model.numpy_tree(), params, 2e-4, 2 * STEP_LR)


# ---------------------------------------------------------------------------
# the CLI and convergence
# ---------------------------------------------------------------------------

CLI = ["--arch", "minitron-4b", "--reduced", "--reduced-layers", "2",
       "--reduced-dmodel", "32", "--batch", "2", "--seq", "32",
       "--ckpt-every", "2", "--log-every", "100", "--device", "cpu"]


def test_train_cli_resume(tmp_path, capsys):
    """The twin of the JAX CLI test: 4 steps, then ``--resume auto`` to
    6 prints ``resumed from step 4`` and does not start again from 0."""
    ck = str(tmp_path / "ck")
    launch_train.main(CLI + ["--ckpt-dir", ck, "--steps", "4"])
    out = capsys.readouterr().out
    assert "step     0" in out and out.rstrip().endswith("done")
    launch_train.main(CLI + ["--ckpt-dir", ck, "--steps", "6",
                             "--resume", "auto"])
    out = capsys.readouterr().out
    assert "resumed from step 4" in out
    assert "step     0 " not in out and "step     5 " in out


def test_train_cli_resume_equals_a_straight_run(tmp_path, capsys):
    """A straight 6-step run (checkpoints after 2, 4 and 6 updates), and
    a run resumed from its checkpoint of 4 updates: the resumed run's
    final checkpoint equal to the straight run's, array for array."""
    straight, resumed = str(tmp_path / "a"), str(tmp_path / "b")
    launch_train.main(CLI + ["--ckpt-dir", straight, "--steps", "6"])
    assert CheckpointManager(straight).all_steps() == [2, 4, 6]
    shutil.copytree(os.path.join(straight, "step_00000004"),
                    os.path.join(resumed, "step_00000004"))
    launch_train.main(CLI + ["--ckpt-dir", resumed, "--steps", "6",
                             "--resume", "auto"])
    assert "resumed from step 4" in capsys.readouterr().out
    a, b = (np.load(os.path.join(d, "step_00000006", "arrays.npz"))
            for d in (straight, resumed))
    assert sorted(a.files) == sorted(b.files) and "opt/step" in a.files
    for key in a.files:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_train_cli_refuses_the_production_mesh():
    with pytest.raises(NotImplementedError, match="production-mesh"):
        launch_train.main(CLI + ["--production-mesh", "--steps", "1"])


@pytest.mark.parametrize("arch", ["gemma-7b"])
def test_training_reduces_loss(arch):
    """The twin of the JAX package's test: 30 steps of a reduced model on
    ``SyntheticLM``, the mean loss of the last 5 below the first 5's by
    0.2."""
    cfg = reduced(get_config(arch), layers=2, d_model=64, vocab=256)
    model = build_model(cfg, device="cpu")
    data = SyntheticLM(DataConfig(vocab_size=256), cfg,
                       ShapeConfig("t", 64, 4, "train"))
    step = make_train_step(model, TrainConfig(opt=optlib.OptimizerConfig(
        peak_lr=1e-2, warmup_steps=2, total_steps=30)))
    state = optlib.init(dict(model.net.named_parameters()))
    losses = [float(step(state, data.batch(i))["loss"]) for i in range(30)]
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2
