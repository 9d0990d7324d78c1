"""The train step (counterpart of ``repro/train/trainer.py``): the loss
and its gradients, global-norm clipping and AdamW, with optional
gradient accumulation over microbatches and int8 gradient compression.

The step updates the model's parameters and the optimizer state in
place and returns its metrics.  :func:`shardings_for` gives the specs
(``dist.sharding``) and the ``meta`` shapes of the parameters, the
optimizer state and a batch on a mesh, as the JAX package's does.
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


def make_train_step(model: Model, tcfg: TrainConfig):
    """``train_step(opt_state, batch) -> metrics`` for ``model``, whose
    parameters get ``requires_grad`` here.  ``batch`` is a dict of numpy
    arrays or tensors (``tokens``, and ``patches``/``frames``).  Metrics:
    ``loss`` (and, without accumulation, ``nll``, ``aux`` and
    ``perplexity``) as 0-d tensors, ``lr`` a float, ``grad_norm`` the
    norm before clipping.  With ``grad_accum`` > 1 the batch is cut into
    that many microbatches along axis 0, each one's gradients summed in
    fp32, and the sum and the loss divided by their number."""
    params = dict(model.net.named_parameters())
    model.requires_grad_(True)

    def grads_of(batch):
        for p in params.values():
            p.grad = None
        loss, metrics = model.loss(batch, remat=tcfg.remat)
        loss.backward()
        grads = {n: p.grad for n, p in params.items()}
        for p in params.values():
            p.grad = None
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    def train_step(opt_state: dict, batch: dict) -> dict:
        if tcfg.grad_accum > 1:
            gsum, lsum = None, None
            for mb in _microbatches(batch, tcfg.grad_accum):
                loss, _, grads = grads_of(mb)
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
            loss, metrics, grads = grads_of(batch)
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



def state_tree(model: Model, opt_state: dict, meta: bool = False) -> dict:
    """The training state as the JAX package's launcher checkpoints it:
    ``{"params": pytree, "opt": {"master", "mu", "nu": pytrees, "step"}}``,
    numpy on the host.  With ``meta`` the same structure as ``meta``
    tensors, a restore's target (shapes and dtypes, no data)."""
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
    ``opt_state`` (each entry the restored tree's slice)."""
    model.load_numpy(tree["params"])
    for k in ("master", "mu", "nu"):
        flat = common.flatten_tree(tree["opt"][k])
        if set(flat) != set(opt_state[k]):
            raise KeyError(f"optimizer state {k} names differ")
        opt_state[k] = {n: torch.as_tensor(flat[n]).to(
            device=opt_state[k][n].device, dtype=torch.float32)
            for n in opt_state[k]}
    opt_state["step"] = int(tree["opt"]["step"])
