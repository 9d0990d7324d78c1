"""AdamW with fp32 master weights, global-norm clipping and a
warmup + cosine schedule (counterpart of ``repro/train/optimizer.py``).

The state is the JAX package's: ``{"master", "mu", "nu", "step"}``, the
first three fp32 copies keyed as the parameters are (here a module's
parameter names; ``models.common.nest`` gives the JAX package's pytree
for a checkpoint).  Unlike the JAX package, which returns new arrays,
:func:`update` works in place -- the moments, the master weights and
the parameters -- so a step holds no second copy of the state: at
zamba2-1.2b's 1.1e9 parameters that copy would be 17 GB.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.dist.sharding import is_dtensor


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    min_lr: float = 3e-5
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def schedule(cfg: OptimizerConfig, step: int) -> float:
    """The learning rate at ``step``: linear warmup to ``peak_lr``, then a
    cosine to ``min_lr`` at ``total_steps``; in fp32, as the JAX package
    computes it."""
    f = np.float32
    step = f(step)
    if step < cfg.warmup_steps:
        return float(f(cfg.peak_lr) * step / f(max(cfg.warmup_steps, 1)))
    t = np.clip((step - f(cfg.warmup_steps))
                / f(max(cfg.total_steps - cfg.warmup_steps, 1)),
                f(0.0), f(1.0))
    return float(f(cfg.min_lr) + f(0.5) * f(cfg.peak_lr - cfg.min_lr)
                 * (f(1.0) + np.cos(f(np.pi) * t, dtype=f)))


def init(params: dict) -> dict:
    """AdamW state for ``{name: parameter}``: fp32 master copies, zero
    moments (each with its parameter's placements on a mesh), step 0."""
    with torch.no_grad():
        return {
            "master": {n: p.detach().to(torch.float32, copy=True)
                       for n, p in params.items()},
            "mu": {n: torch.zeros_like(p, dtype=torch.float32)
                   for n, p in params.items()},
            "nu": {n: torch.zeros_like(p, dtype=torch.float32)
                   for n, p in params.items()},
            "step": 0,
        }


def _owned_sum(g) -> torch.Tensor:
    """A DTensor's local sum of squares in fp32, counted on one rank of
    each group that holds the same shard (zero on the others), so that
    the sum over every rank is the whole tensor's."""
    coord = g.device_mesh.get_coordinate()
    first = all(c == 0 for c, p in zip(coord, g.placements)
                if p.is_replicate())
    s = g.to_local().float().square().sum()
    return s if first else torch.zeros_like(s)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of every element's square, in fp32 (each tensor's
    sum, then their sum, in order).  Of DTensors (a mesh over every rank
    of the default group): each tensor's sum is its ranks' local sums,
    added by one all-reduce of them all; then the same ordered sum, the
    same on every rank."""
    tensors = list(tensors)
    if tensors and is_dtensor(tensors[0]):
        sums = torch.stack([_owned_sum(g) for g in tensors])
        dist.all_reduce(sums)
        sums = list(sums)
    else:
        sums = [g.float().square().sum() for g in tensors]
    total = None
    for s in sums:
        total = s if total is None else total + s
    return torch.sqrt(total)


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (its own memory, so written in place), or
    a plain tensor itself."""
    return t.to_local() if is_dtensor(t) else t


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads: dict, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, in fp32;
    the norm before)."""
    norm = global_norm(grads.values())
    scale = _clip_scale(norm, max_norm)
    return {n: g.float() * scale for n, g in grads.items()}, norm


@torch.no_grad()
def update(cfg: OptimizerConfig, params: dict, grads: dict,
           state: dict) -> dict:
    """One AdamW step, in place: clip ``grads`` ({name: gradient}) by the
    global norm, update ``state``'s moments and master weights, and copy
    the masters into ``params`` in their dtypes.  Each gradient is
    clipped (in fp32) as its parameter's turn comes, so no fp32 copy of
    every gradient exists at once.  DTensors (each gradient, master and
    moment placed as its parameter) are updated on their local shards.
    Returns {"lr", "grad_norm"} (the norm before clipping, a 0-d plain
    tensor)."""
    gnorm = global_norm(grads.values())
    scale = _clip_scale(gnorm, cfg.clip_norm)
    state["step"] += 1
    step = state["step"]
    lr = schedule(cfg, step)
    f = np.float32
    b1c = float(f(1.0) - f(cfg.b1) ** f(step))
    b2c = float(f(1.0) - f(cfg.b2) ** f(step))
    for name, p in params.items():
        g = _local(grads[name]).float() * scale
        master, mu, nu = (_local(state[k][name])
                          for k in ("master", "mu", "nu"))
        p = _local(p)
        mu.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        nu.mul_(cfg.b2).add_(g.square_() * (1 - cfg.b2))
        step_dir = (mu / b1c) / (torch.sqrt(nu / b2c) + cfg.eps)
        master.sub_((step_dir + master * cfg.weight_decay) * lr)
        p.copy_(master)
    return {"lr": lr, "grad_norm": gnorm}


def state_axes(params_axes) -> dict:
    """Optimizer-state logical axes mirror the parameter axes."""
    return {"master": params_axes, "mu": params_axes, "nu": params_axes,
            "step": ()}
