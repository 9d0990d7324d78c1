"""The train step (counterpart of ``repro/train/trainer.py``): the loss
and its gradients, global-norm clipping and AdamW, with optional
gradient accumulation over microbatches and int8 gradient compression.

The step updates the model's parameters and the optimizer state in
place and returns its metrics.  :func:`shardings_for` gives the specs
(``dist.sharding``) and the ``meta`` shapes of the parameters, the
optimizer state and a batch on a mesh, as the JAX package's does.

On a mesh -- a named ``DeviceMesh`` over the ranks of a process group --
:func:`place` applies those specs: each parameter becomes a DTensor
parameter (``optimizer.init`` then gives its master weights and moments
its placements), and the step places each batch (or microbatch) over
the data axes and runs the same code on DTensors, the twin of the JAX package's ``jax.jit`` over
in and out shardings.  Each gradient is redistributed to its
parameter's placements before the update (the data-parallel reduction
the JAX ``out_shardings`` imply), so the step computes what the
single-process step computes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.dist import sharding as shlib
from repro_torch.dist.compression import fake_quantize_int8
from repro_torch.models import common
from repro_torch.models.api import Model
from repro_torch.train import optimizer as optlib


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: optlib.OptimizerConfig = optlib.OptimizerConfig()
    grad_accum: int = 1
    remat: bool = True
    compress_grads: bool = False   # the int8 round trip (dist.compression)


def _microbatches(batch: dict, n: int) -> list[dict]:
    """``batch`` cut into ``n`` equal microbatches along axis 0."""
    def cut(x, i):
        m = x.shape[0] // n
        return x[i * m:(i + 1) * m]
    return [{k: cut(v, i) for k, v in batch.items()} for i in range(n)]


def place_batch(batch: dict, mesh) -> dict:
    """``batch`` (numpy arrays or tensors, the same on every rank) as
    DTensors on ``mesh``, each leading dim over the data axes where it
    divides them (``dist.sharding.batch_sharding``), on the mesh's
    device (``meta`` entries, the dry run's, stay ``meta``); each rank
    keeps its own rows."""
    device = torch.device(mesh.device_type, torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device("cpu")
    tensors = {k: v if isinstance(v, torch.Tensor) and v.is_meta
               else torch.as_tensor(v, device=device)
               for k, v in batch.items()}
    specs = shlib.batch_sharding(mesh, tensors)
    return {k: shlib.distribute(t, specs[k], mesh)
            for k, t in tensors.items()}


def place_cache(model: Model, cache, mesh):
    """A decode cache (``Model.cache_spec``'s structure; whole tensors,
    the same on every rank, or DTensors) on ``mesh`` at
    ``tree_shardings(model.cache_axes(), cache, mesh)``, the JAX dry
    run's cache shardings: each rank keeps its own shard."""
    return shlib.place_tree(model.cache_axes(), cache, mesh)


def _plain(t: torch.Tensor) -> torch.Tensor:
    """A DTensor metric (replicated, or partial: a sum over ranks not yet
    taken) as a plain tensor, the same on every rank."""
    return t.full_tensor() if shlib.is_dtensor(t) else t


def make_train_step(model: Model, tcfg: TrainConfig):
    """``train_step(opt_state, batch) -> metrics`` for ``model``, whose
    parameters get ``requires_grad`` here.  ``batch`` is a dict of numpy
    arrays or tensors (``tokens``, and ``patches``/``frames``).  Metrics:
    ``loss`` (and, without accumulation, ``nll``, ``aux`` and
    ``perplexity``) as 0-d tensors, ``lr`` a float, ``grad_norm`` the
    norm before clipping.  With ``grad_accum`` > 1 the batch is cut into
    that many microbatches along axis 0, each one's gradients summed in
    fp32, and the sum and the loss divided by their number.  On a mesh
    (the parameters placed by :func:`place`, before or after this is
    called) every rank calls the step with the same whole batch; each
    (micro)batch is placed by :func:`place_batch`, and the metrics are
    plain tensors, the same on every rank."""
    model.requires_grad_(True)

    def grads_of(params, batch, mesh):
        for p in params.values():
            p.grad = None
        if mesh is not None:
            batch = place_batch(batch, mesh)
        loss, metrics = model.loss(batch, remat=tcfg.remat)
        loss.backward()
        grads = {n: p.grad for n, p in params.items()}
        for p in params.values():
            p.grad = None
        if mesh is not None:
            grads = {n: g if g.placements == params[n].placements
                     else g.redistribute(mesh, params[n].placements)
                     for n, g in grads.items()}
        return _plain(loss.detach()), \
            {k: _plain(v.detach()) for k, v in metrics.items()}, grads

    def train_step(opt_state: dict, batch: dict) -> dict:
        params = dict(model.net.named_parameters())
        mesh = model.mesh
        if tcfg.grad_accum > 1:
            gsum, lsum = None, None
            for mb in _microbatches(batch, tcfg.grad_accum):
                loss, _, grads = grads_of(params, mb, mesh)
                if gsum is None:
                    gsum = {n: g.float() for n, g in grads.items()}
                    lsum = loss
                else:
                    for n, g in grads.items():
                        gsum[n] += g.float()
                    lsum = lsum + loss
            grads = {n: g / tcfg.grad_accum for n, g in gsum.items()}
            loss, metrics = lsum / tcfg.grad_accum, {}
        else:
            loss, metrics, grads = grads_of(params, batch, mesh)
        if tcfg.compress_grads:
            grads = {n: fake_quantize_int8(g) for n, g in grads.items()}
        opt_metrics = optlib.update(tcfg.opt, params, grads, opt_state)
        return {**metrics, **opt_metrics, "loss": loss}

    return train_step


def shardings_for(model: Model, mesh, batch_spec):
    """((params, opt_state, batch) specs, (params, opt_state) ``meta``
    shapes) on ``mesh``, in the JAX package's pytree layout: the
    parameters by :data:`~repro_torch.dist.sharding.RULES`, the fp32
    master weights and moments as their parameters, the step
    replicated, and the batch's leading dim over the data axes."""
    params_axes = model.axes()
    params_shapes = model.shapes()
    p_sh = shlib.tree_shardings(params_axes, params_shapes, mesh)

    def fp32(tree):
        if isinstance(tree, dict):
            return {k: fp32(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [fp32(v) for v in tree]
        return torch.empty(tree.shape, dtype=torch.float32, device="meta")
    opt_shapes = {k: fp32(params_shapes) for k in ("master", "mu", "nu")}
    opt_shapes["step"] = torch.empty((), dtype=torch.int32, device="meta")
    opt_axes = optlib.state_axes(params_axes)
    o_sh = {k: shlib.tree_shardings(opt_axes[k], opt_shapes[k], mesh)
            for k in ("master", "mu", "nu")}
    o_sh["step"] = shlib.replicated(mesh)
    b_sh = shlib.batch_sharding(mesh, batch_spec)
    return (p_sh, o_sh, b_sh), (params_shapes, opt_shapes)



def place(model: Model, mesh, inference: bool = False,
          values: dict | None = None) -> None:
    """Put ``model``'s parameters on ``mesh``, a named ``DeviceMesh``, by
    :func:`shardings_for`'s specs, in place: each module's parameter
    becomes a DTensor parameter at ``placements`` of its ``spec_for``
    (the JAX package's spec with the stacked ``"layers"`` entry
    dropped).  Every rank passes the same whole values and keeps its own
    shards.  ``optimizer.init`` of the placed parameters then gives the
    master weights and moments their placements (the step count stays an
    int, the same on every rank), and the step places each batch
    (:func:`place_batch`): the JAX launcher's ``device_put`` of all
    three.  With ``inference`` the specs are the serving ones
    (``dist.sharding.INFERENCE_RULES``: no FSDP, every ``embed`` dim
    whole), the JAX dry run's ``tree_shardings(..., inference=True)``;
    ``Model.prefill`` and ``Model.decode_step`` then serve on the mesh,
    the cache at :func:`place_cache`'s placements.  ``values`` ({name:
    whole tensor}, ``named_parameters``' names) replaces the parameters'
    own values, so that a model built on ``meta`` is placed from
    weights held elsewhere (another process's, shared by CUDA IPC): each
    rank copies its own shards out of them."""
    rules = shlib.INFERENCE_RULES if inference else shlib.RULES
    with torch.no_grad():
        for prefix, mod in model.net.named_modules():
            for name, p in list(mod.named_parameters(recurse=False)):
                spec = shlib.spec_for(p.logical_axes, tuple(p.shape), mesh,
                                      rules)
                whole = p if values is None else values[
                    f"{prefix}.{name}" if prefix else name]
                dp = torch.nn.Parameter(shlib.distribute(whole, spec, mesh),
                                        requires_grad=p.requires_grad)
                dp.logical_axes = p.logical_axes
                setattr(mod, name, dp)


def state_placements(model: Model, mesh) -> dict:
    """Where each leaf of :func:`state_tree` goes on ``mesh`` (a named
    ``DeviceMesh``): a ``(mesh, placements)`` pair from
    :func:`shardings_for`'s specs, in the JAX package's layout (a stacked
    leaf's ``"layers"`` dim whole), and None for the step; the
    ``placements`` tree ``dist.elastic.resume`` takes."""
    (p_sh, o_sh, _), (p_shapes, o_shapes) = shardings_for(model, mesh, {})

    def pairs(specs, shapes):
        if isinstance(shapes, dict):
            return {k: pairs(specs[k], shapes[k]) for k in shapes}
        if isinstance(shapes, list):
            return [pairs(a, b) for a, b in zip(specs, shapes)]
        return (mesh, shlib.placements(specs, shapes.ndim, mesh))
    opt = {k: pairs(o_sh[k], o_shapes[k]) for k in ("master", "mu", "nu")}
    opt["step"] = None
    return {"params": pairs(p_sh, p_shapes), "opt": opt}


def state_tree(model: Model, opt_state: dict, meta: bool = False) -> dict:
    """The training state as the JAX package's launcher checkpoints it:
    ``{"params": pytree, "opt": {"master", "mu", "nu": pytrees, "step"}}``,
    numpy on the host, whole (a DTensor state is gathered: every rank of
    the mesh calls this, and gets the same arrays).  With ``meta`` the
    same structure as ``meta`` tensors, a restore's target (shapes and
    dtypes, no data)."""
    def tree(named):
        if meta:
            return common.nest({n: torch.empty(t.shape, dtype=t.dtype,
                                               device="meta")
                                for n, t in named.items()})
        return common.nest({n: common.to_numpy(t) for n, t in named.items()})
    opt = {k: tree(opt_state[k]) for k in ("master", "mu", "nu")}
    opt["step"] = (torch.empty((), dtype=torch.int32, device="meta") if meta
                   else np.asarray(opt_state["step"], np.int32))
    return {"params": tree(dict(model.net.named_parameters())), "opt": opt}


def load_state(model: Model, opt_state: dict, tree: dict) -> None:
    """Put a restored :func:`state_tree` (tensors or numpy, the JAX
    package's layout) into ``model``'s parameters (copied) and
    ``opt_state`` (each entry the restored tree's slice).  On a mesh each
    rank takes its own shards of the whole arrays."""
    model.load_numpy(tree["params"])
    for k in ("master", "mu", "nu"):
        flat = common.flatten_tree(tree["opt"][k])
        if set(flat) != set(opt_state[k]):
            raise KeyError(f"optimizer state {k} names differ")
        opt_state[k] = {n: shlib.shard_like(torch.as_tensor(flat[n]).to(
            device=opt_state[k][n].device, dtype=torch.float32),
            opt_state[k][n]) for n in opt_state[k]}
    opt_state["step"] = int(tree["opt"]["step"])
