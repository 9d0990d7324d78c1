"""What each rank runs in ``tests/test_torch_train_mesh*.py``: the port's
train step on a mesh of the ranks of a process group.

The ranks start by the ``spawn`` method, so the functions they run live
in a module they can import by name, one that imports neither JAX nor
the JAX package.  Every function here returns picklable numpy and Python
values.
"""

from __future__ import annotations

import contextlib
import io

import numpy as np
import torch

from repro_torch.configs.base import ShapeConfig, reduced
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.dist.sharding import abstract_mesh
from repro_torch.launch.mesh import device_mesh
from repro_torch.models.api import build_model
from repro_torch.train import optimizer as optlib
from repro_torch.train.trainer import TrainConfig, make_train_step, place

#: the JAX reference's run (tests/_jax_train_mesh_ref.py)
STEPS = 2
BATCH, SEQ = 4, 16
OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)


def case_id(arch: str, mesh: tuple, accum: int, compress: bool) -> str:
    return f"{arch}|{mesh[0]}x{mesh[1]}|{accum}|{int(compress)}"


def train(case, init: dict, mesh=None) -> dict:
    """``STEPS`` steps of ``case`` (arch, mesh shape, grad_accum,
    compress_grads) from the JAX pytree ``init``: on ``mesh`` (a named
    ``DeviceMesh``; every rank calls this) or, with None, in one process
    without one.  Returns each step's loss, grad_norm and parameters (the
    JAX layout), the batches, and each parameter's, master's and
    moment's placements as text."""
    arch, _, accum, compress = case
    cfg = reduced(get_config(arch))
    model = build_model(cfg, device="cpu").load_numpy(init)
    if mesh is not None:
        place(model, mesh)
    opt_state = optlib.init(dict(model.net.named_parameters()))
    step = make_train_step(model, TrainConfig(
        opt=optlib.OptimizerConfig(**OPT), grad_accum=accum,
        compress_grads=compress))
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size), cfg,
                       ShapeConfig("t", SEQ, BATCH, "train"))
    out = {"loss": [], "grad_norm": [], "params": [], "batches": []}
    for i in range(STEPS):
        batch = data.batch(i)
        m = step(opt_state, batch)
        out["batches"].append(batch)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        # copied: a CPU parameter's numpy view changes with the next step
        out["params"].append(as_numpy(model.numpy_tree()))
    if mesh is not None:
        out["placements"] = {
            k: {n: str(tuple(t.placements)) for n, t in opt_state[k].items()}
            for k in ("master", "mu", "nu")}
        out["placements"]["params"] = {
            n: str(tuple(p.placements))
            for n, p in model.net.named_parameters()}
    return out


def train_cases(rank: int, n: int, cases: list, inits: dict) -> dict:
    """Every case on its mesh of the ``n`` ranks; rank 0's results by case
    id (the other ranks return None: their arrays are rank 0's)."""
    out = {}
    for case in cases:
        arch, shape, accum, compress = case
        mesh = device_mesh(abstract_mesh(tuple(shape), ("data", "model")),
                           "cpu")
        out[case_id(*case)] = train(case, inits[case_id(*case)], mesh)
    return out if rank == 0 else None


def cli(rank: int, n: int, argv: list) -> str:
    """``launch.train.main(argv)`` on this rank: what it printed."""
    from repro_torch.launch import train as launch_train

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        launch_train.main(argv)
    return buf.getvalue()


def cli_raises(rank: int, n: int, argv: list) -> str:
    """The text of what ``launch.train.main(argv)`` raises on this rank."""
    from repro_torch.launch import train as launch_train

    try:
        launch_train.main(argv)
    except Exception as e:  # noqa: BLE001 - the test reads its message
        return f"{type(e).__name__}: {e}"
    return "no exception"


def ckpt_save(rank: int, n: int, shape: tuple, arch: str, ckpt_dir: str,
              init: dict) -> dict | None:
    """One step of reduced ``arch`` on a ``shape`` mesh, then its state
    saved by ``launch.train``'s rule (gathered by every rank, written by
    rank 0); rank 0 returns the state it saved."""
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.train.trainer import state_tree

    cfg = reduced(get_config(arch))
    mesh = device_mesh(abstract_mesh(tuple(shape), ("data", "model")), "cpu")
    model = build_model(cfg, device="cpu").load_numpy(init)
    place(model, mesh)
    opt_state = optlib.init(dict(model.net.named_parameters()))
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size), cfg,
                       ShapeConfig("t", SEQ, BATCH, "train"))
    make_train_step(model, TrainConfig(opt=optlib.OptimizerConfig(**OPT)))(
        opt_state, data.batch(0))
    tree = state_tree(model, opt_state)
    if rank == 0:
        CheckpointManager(ckpt_dir).save(1, tree)
        return tree
    return None


def ckpt_restore(rank: int, n: int, shape, arch: str, ckpt_dir: str
                 ) -> dict:
    """The latest checkpoint in ``ckpt_dir`` resumed onto a ``shape`` mesh
    (``elastic.resume`` onto ``state_placements``, then ``load_state``),
    or in one process without a mesh (``shape`` None): the state as
    placed (each rank's local shards), gathered whole again, and its
    placements as text."""
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.dist import elastic
    from repro_torch.train.trainer import (load_state, state_placements,
                                           state_tree)

    cfg = reduced(get_config(arch))
    model = build_model(cfg, device="cpu")
    mesh = None
    if shape is not None:
        mesh = device_mesh(abstract_mesh(tuple(shape), ("data", "model")),
                           "cpu")
        place(model, mesh)
    opt_state = optlib.init(dict(model.net.named_parameters()))
    restored, step = elastic.resume(
        CheckpointManager(ckpt_dir), state_tree(model, opt_state, meta=True),
        placements=None if mesh is None else state_placements(model, mesh))
    load_state(model, opt_state, restored)
    out = {"step": step, "state": state_tree(model, opt_state)}
    if mesh is not None:
        out["placements"] = {n: str(tuple(p.placements))
                             for n, p in model.net.named_parameters()}
        out["restored_is_dtensor"] = all(
            hasattr(leaf, "placements") for leaf in
            _leaves(restored["params"]))
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def as_numpy(tree):
    """``tree`` with every leaf a numpy array of its own memory."""
    if isinstance(tree, dict):
        return {k: as_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [as_numpy(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().float().numpy().copy()
    return np.array(tree, copy=True)


#: the kernel ops' sharding-rule cases: (op, shapes) at (2, 2); "H=1"
#: and "B=3" have a dim that does not divide its mesh axis
OPS_CASES = {
    "attention": ("attention", (4, 12, 4, 8)),
    "attention-H=1": ("attention", (4, 12, 1, 8)),
    "attention-B=3": ("attention", (3, 12, 4, 8)),
    "scan": ("scan", (4, 9, 4, 8)),
    "scan-D=3": ("scan", (4, 9, 3, 8)),
    "scan-heads": ("scan_heads", (4, 4, 9, 3, 8)),
    "scan-heads-H=1": ("scan_heads", (2, 1, 9, 3, 8)),
}


def ops_inputs(op: str, shape: tuple, seed: int = 0) -> list:
    """Seeded inputs and output cotangents of a kernel op case."""
    rng = np.random.default_rng(seed)

    def normal(*s, scale=1.0):
        return (rng.standard_normal(s) * scale).astype(np.float32)
    if op == "attention":
        b, s, h, d = shape
        return [normal(b, s, h, d) for _ in range(4)]
    if op == "scan":
        b, seq, d, n = shape
        return [rng.uniform(0.6, 0.99, shape).astype(np.float32),
                normal(*shape, scale=0.3), normal(b, seq, n),
                normal(b, d, n, scale=0.3), normal(b, seq, d),
                normal(b, d, n)]
    b, h, seq, p, n = shape
    return [rng.uniform(0.6, 0.99, shape).astype(np.float32),
            normal(*shape, scale=0.3), normal(b, h, seq, n),
            normal(b, h, p, n, scale=0.3), normal(b, h, seq, p),
            normal(b, h, p, n)]


def ops_call(op: str, arrays: list, place=None):
    """The op on ``arrays`` (tensors with gradients; DTensors when
    ``place(t)`` distributes them), its outputs' sum against the
    cotangents backpropagated: (outputs, input gradients, outputs'
    placements), gathered to plain tensors."""
    from repro_torch.kernels import ops

    n_in = 3 if op == "attention" else 4
    ts = [torch.from_numpy(a) for a in arrays]
    args = [(place(t) if place else t.clone()).requires_grad_()
            for t in ts[:n_in]]
    if op == "attention":
        outs = (ops.flash_attention(*args, causal=True),)
    elif op == "scan":
        outs = ops.mamba_scan(*args)
    else:
        outs = ops.mamba_scan_heads(*args)
    cots = ts[n_in:]
    total = sum(((o * (place(c) if place else c)).sum()
                 for o, c in zip(outs, cots)))
    total.backward()
    def whole(t):
        return (t.full_tensor() if hasattr(t, "full_tensor") else t
                ).detach().numpy()
    where = [str(tuple(o.placements)) for o in outs if hasattr(o,
                                                               "placements")]
    return ([whole(o) for o in outs], [whole(a.grad) for a in args], where)


def mesh_ops(rank: int, n: int) -> dict:
    """Every ``OPS_CASES`` op on DTensors on a (2, 2) mesh (inputs placed
    batch over data, replicated over model, as a model's activations
    come), the ``constrain_*`` anchors and ``like`` on it, and
    ``make_host_mesh`` under the group."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.dist import sharding as sh
    from repro_torch.launch.mesh import make_host_mesh

    mesh = device_mesh(abstract_mesh((2, 2), ("data", "model")), "cpu")

    def place(t):
        return distribute_tensor(t, mesh, (Shard(0) if t.shape[0] % 2 == 0
                                           else Replicate(), Replicate()),
                                 src_data_rank=None)
    out = {"host_mesh": make_host_mesh("cpu").axis_sizes, "ops": {}}
    for name, (op, shape) in OPS_CASES.items():
        out["ops"][name] = ops_call(op, ops_inputs(op, shape), place)
    x = distribute_tensor(torch.arange(4 * 6 * 4.0).reshape(4, 6, 4), mesh,
                          (Replicate(), Replicate()))
    table = distribute_tensor(torch.arange(12 * 4.0).reshape(12, 4), mesh,
                              (Shard(1), Shard(0)))
    scores = distribute_tensor(torch.ones(4, 3, 8), mesh,
                               (Replicate(), Replicate()))
    made = sh.like(torch.ones(3), x)
    out["anchors"] = {
        "batch": str(tuple(sh.constrain_batch(x).placements)),
        "batch_model": str(tuple(sh.constrain_batch(
            x, extra=("", "model")).placements)),
        "rows_model": str(tuple(sh.constrain_rows_model(table).placements)),
        "seq_scores": str(tuple(sh.constrain_seq_scores(scores)
                                .placements)),
        "like": (str(tuple(made.placements)), made.full_tensor().tolist()),
        "values": bool(torch.equal(sh.constrain_batch(x).full_tensor(),
                                   x.full_tensor())),
    }
    return out


def host_staged(rank: int, n: int) -> dict:
    """The collectives DTensors issue, over ``ranks.HOST_STAGED`` (the
    group this rank joined): each one's result, and the seconds counted
    in ``collective_seconds_total``."""
    import torch.distributed as dist
    from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                          distribute_tensor)

    from repro_torch.dist import ranks

    c0 = ranks.collective_seconds()
    x = torch.arange(8.0) + 10 * rank
    out = {"backend": dist.get_backend()}
    y = x.clone()
    dist.all_reduce(y)
    out["all_reduce"] = y.tolist()
    g = torch.empty(8 * n)
    dist.all_gather_into_tensor(g, x)
    out["all_gather"] = g.tolist()
    parts = [torch.empty(8) for _ in range(n)]
    dist.all_gather(parts, x)
    out["all_gather_list"] = torch.cat(parts).tolist()
    rs = torch.empty(8 // n)
    dist.reduce_scatter_tensor(rs, x)
    out["reduce_scatter"] = rs.tolist()
    a2a = torch.empty(8)
    dist.all_to_all_single(a2a, x)
    out["all_to_all"] = a2a.tolist()
    b = x.clone()
    dist.broadcast(b, 1)
    out["broadcast"] = b.tolist()
    mesh = device_mesh(abstract_mesh((2, 2), ("data", "model")), "cpu")
    full = torch.arange(64.0).reshape(8, 8)
    d = distribute_tensor(full, mesh, (Shard(0), Shard(1)),
                          src_data_rank=None)
    p = DTensor.from_local(full.clone(), mesh, (Partial(), Replicate()))
    r = distribute_tensor(full, mesh, (Replicate(), Shard(0)),
                          src_data_rank=None)
    out["dtensor"] = [
        bool(torch.equal(d.redistribute(mesh, (Replicate(), Replicate()))
                         .to_local(), full)),
        bool(torch.equal(p.redistribute(mesh, (Shard(0), Replicate()))
                         .full_tensor(), 2 * full)),
        bool(torch.equal(r.redistribute(mesh, (Replicate(), Shard(1)))
                         .full_tensor(), full))]
    out["seconds"] = ranks.collective_seconds() - c0
    return out
