"""Mixture-of-Experts with sort-based, row-local dispatch (counterpart of
``repro/models/moe.py``).

As in the JAX package: the router runs in fp32 (softmax, top-k, the
top-k gates renormalised); each batch row routes its own tokens, sorted
by expert (a stable sort, ``jnp.argsort``'s order, so the same tokens
overflow); an expert takes at most ``cap`` tokens a row, the rest are
dropped (combine weight zero) and unused slots stay zero; every expert's
FFN runs over its whole ``[B, E, cap, d]`` buffer as batched products
(the JAX package leaves them to XLA's ``einsum`` too); shared experts add
a dense gated MLP; ``aux`` is the Switch-style load-balancing loss.

Fixed sums: the dispatch writes each kept slot once (a plain index copy;
dropped choices go to a spare slot that is cut off, where the JAX package
adds zeros to the last slot), and the combine gathers a token's k
contributions to ``[B, S, k, d]`` through the inverse of the sort and
sums over k, where the JAX package scatter-adds them; ``aux`` counts
each expert's choices by a compare and a sum (exact), so the result does
not change from run to run on the card.  Routing, dispatch and combine
are row-local, so on a mesh each rank routes its own batch rows.
"""

from __future__ import annotations

import functools
import math

import torch
from torch import nn

from repro_torch.dist.sharding import (constrain_batch, is_dtensor,
                                       leading_spec, like, mesh_sizes,
                                       placements, row_local)
from repro_torch.models.common import Maker, activation
from repro_torch.models.mlp import GATED


def capacity(seq: int, top_k: int, num_experts: int,
             capacity_factor: float) -> int:
    """Slots an expert has in a batch row of ``seq`` tokens."""
    cap = int(math.ceil(seq * top_k / num_experts * capacity_factor))
    return max(cap, min(seq * top_k, 8), 1)


def choose(probs: torch.Tensor, top_k: int) -> torch.Tensor:
    """The router's choice: each token's ``top_k`` most probable experts,
    [B, S, k], most probable first."""
    return torch.topk(probs, top_k, -1).indices


def gates(probs: torch.Tensor, gate_idx: torch.Tensor) -> torch.Tensor:
    """The chosen experts' probabilities, renormalised to sum to 1."""
    vals = torch.gather(probs, -1, gate_idx)
    return vals / vals.sum(-1, keepdim=True).clamp_min(1e-9)


def route(gate_idx: torch.Tensor, num_experts: int, cap: int):
    """``_route_row`` over every batch row at once.  gate_idx [B, S, k]
    expert ids -> (order, token, slot, keep), each [B, S*k] in expert
    order: ``order`` the stable sort of the flattened (token, choice)
    pairs by expert, ``token`` their tokens, ``slot`` their place in a
    row's ``E * cap`` buffer (0 where dropped) and ``keep`` whether the
    expert had room."""
    b, s, k = gate_idx.shape
    flat = gate_idx.reshape(b, s * k)
    order = torch.argsort(flat, dim=1, stable=True)
    expert = torch.gather(flat, 1, order)
    token = order // k
    counts = torch.zeros((b, num_experts), dtype=torch.long,
                         device=flat.device)
    counts.scatter_add_(1, flat, torch.ones_like(flat))
    starts = torch.cumsum(counts, 1) - counts
    pos = (torch.arange(s * k, device=flat.device)
           - torch.gather(starts, 1, expert))
    keep = pos < cap
    slot = expert * cap + torch.where(keep, pos, 0)
    return order, token, slot, keep


def expert_ffn(xs: torch.Tensor, *ws, kind: str) -> torch.Tensor:
    """xs [B, E, cap, d] through each expert's FFN, ``ws`` its (w_gate,)
    w_up [E, d, f] and w_down [E, f, d], as the JAX package's einsums:
    a product copies at most xs, laid out by expert, and never a weight
    (a broadcast ``xs @ w`` writes B copies of w)."""
    w_down = ws[-1].to(xs.dtype)

    def up(w):
        return torch.einsum("becd,edf->becf", xs, w.to(xs.dtype))
    if kind in GATED:
        h = activation(GATED[kind])(up(ws[0])) * up(ws[1])
    else:
        h = activation(kind)(up(ws[0]))
    return torch.einsum("becf,efd->becd", h, w_down)


def experts_on_mesh(fn, xs, ws):
    """``fn(xs, *ws)`` (:func:`expert_ffn`) on DTensors, in a ``local_map``
    region: each rank takes its batch rows of xs (over the data axes,
    where the batch divides them) and every expert's weights whole but
    for their ffn columns (over ``"model"``, where f divides it, as
    ``expert_ffn``'s RULES place them), so no weight is laid out by batch
    row.  The output is each rank's ffn columns' part, partial over
    ``"model"``; a weight's gradient is each rank's rows' part, partial
    over the data axes; xs's is partial over ``"model"``."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    ref = next(t for t in (xs, *ws) if is_dtensor(t))
    mesh = ref.device_mesh
    xs, ws = like(xs, ref), tuple(like(w, ref) for w in ws)
    sizes = mesh_sizes(mesh)
    bspec = leading_spec((xs.shape[0],), sizes)
    rows = set(bspec[0] if bspec and isinstance(bspec[0], tuple)
               else bspec)
    cols = ("model",) if ("model" in sizes
                          and ws[-1].shape[1] % sizes["model"] == 0) else ()

    def place(spec, ndim, partial=()):
        out = placements(spec, ndim, mesh)
        return tuple(Partial() if n in partial else p
                     for n, p in zip(sizes, out))
    w_specs = [(None, None) + cols] * (len(ws) - 1) + [(None,) + cols]
    part = place(bspec, 4, cols)
    return local_map(
        fn, out_placements=list(part),
        in_placements=(place(bspec, 4), *(place(w, 3) for w in w_specs)),
        in_grad_placements=(part, *(place(w, 3, rows) for w in w_specs)),
        device_mesh=mesh, redistribute_inputs=True)(xs, *ws)


class SharedExperts(nn.Module):
    """``moe_params``' ``shared``: a gated MLP over every token."""

    def __init__(self, mk: Maker, d_model: int, d_ff: int):
        super().__init__()
        self.w_gate = mk.param((d_model, d_ff), ("embed", "ffn"))
        self.w_up = mk.param((d_model, d_ff), ("embed", "ffn"))
        self.w_down = mk.param((d_ff, d_model), ("ffn", "embed"))


class MoE(nn.Module):
    """``moe_params`` and ``moe``: ``router [d, E]`` (scale 0.02),
    ``w_gate``/``w_up [E, d, f]`` (no gate for the plain kinds),
    ``w_down [E, f, d]`` and, with ``num_shared``, ``shared``."""

    def __init__(self, mk: Maker, d_model: int, d_ff: int, num_experts: int,
                 kind: str, *, top_k: int, capacity_factor: float = 1.25,
                 num_shared: int = 0, shared_d_ff: int = 0):
        super().__init__()
        e = num_experts
        self.kind, self.num_experts, self.top_k = kind, e, top_k
        self.capacity_factor = capacity_factor
        self.router = mk.param((d_model, e), ("embed", "experts"),
                               scale=0.02)
        if kind in GATED:
            self.w_gate = mk.param((e, d_model, d_ff),
                                   ("experts", "embed", "expert_ffn"))
        self.w_up = mk.param((e, d_model, d_ff),
                             ("experts", "embed", "expert_ffn"))
        self.w_down = mk.param((e, d_ff, d_model),
                               ("experts", "expert_ffn", "embed"))
        self.shared = (SharedExperts(mk, d_model, shared_d_ff
                                     or d_ff * num_shared)
                       if num_shared else None)

    def _expert_ffn(self, xs: torch.Tensor) -> torch.Tensor:
        """xs [B, E, cap, d] -> [B, E, cap, d] through each expert's FFN.
        On a mesh each rank runs it on its own batch rows and experts'
        ffn columns (:func:`experts_on_mesh`)."""
        ws = ((self.w_gate,) if self.kind in GATED else ()) \
            + (self.w_up, self.w_down)
        fn = functools.partial(expert_ffn, kind=self.kind)
        if any(is_dtensor(t) for t in (xs, *ws)):
            return experts_on_mesh(fn, xs, ws)
        return fn(xs, *ws)

    def _dispatch(self, x: torch.Tensor, probs: torch.Tensor):
        """Routing and dispatch, row by row: x [B, S, d], probs [B, S, E]
        -> (buf [B, E, cap, d], gate_vals [B, S, k], gate_idx, order,
        slot, keep): each kept (token, choice) in its own slot, the
        dropped ones in a spare slot past the buffer (no mask, so no wait
        on the card for its count)."""
        b, s, d = x.shape
        e, k = self.num_experts, self.top_k
        gate_idx = choose(probs, k)
        gate_vals = gates(probs, gate_idx)
        cap = capacity(s, k, e, self.capacity_factor)
        order, token, slot, keep = route(gate_idx, e, cap)
        rows = torch.arange(b, device=x.device)[:, None]
        buf = x.new_zeros((b, e * cap + 1, d))
        buf[rows, torch.where(keep, slot, e * cap)] = torch.gather(
            x, 1, token[..., None].expand(-1, -1, d))
        return (buf[:, :-1].reshape(b, e, cap, d).contiguous(), gate_vals,
                gate_idx, order,
                slot, keep)

    @staticmethod
    def _combine(out_buf, gate_vals, order, slot, keep):
        """Each token's k experts' outputs back in (token, choice) order,
        weighted, summed over k: out_buf [B, E, cap, d] -> [B, S, d]."""
        b, s, k = gate_vals.shape
        d = out_buf.shape[-1]
        out_buf = out_buf.reshape(b, -1, d)
        inv = torch.argsort(order, dim=1)
        slot_tk = torch.gather(slot, 1, inv)
        keep_tk = torch.gather(keep, 1, inv)
        gathered = torch.gather(out_buf, 1,
                                slot_tk[..., None].expand(-1, -1, d))
        weight = (gate_vals.reshape(b, s * k) * keep_tk).to(out_buf.dtype)
        return (gathered * weight[..., None]).view(b, s, k, d).sum(2)

    def forward(self, x: torch.Tensor):
        """x [B, S, d] -> (out [B, S, d], aux).  The routing, dispatch and
        combine are row-local (``dist.sharding.row_local``): on a mesh
        each rank routes its own batch rows."""
        b, s, _ = x.shape
        e, k = self.num_experts, self.top_k
        logits = x.float() @ self.router.float()                 # [B, S, E]
        probs = torch.softmax(logits, -1)
        buf, gate_vals, gate_idx, order, slot, keep = row_local(
            self._dispatch, x, probs, n_out=6)
        out_buf = constrain_batch(self._expert_ffn(constrain_batch(buf)))
        out = row_local(self._combine, out_buf, gate_vals, order, slot, keep,
                        n_out=1)

        if self.shared is not None:
            sh = self.shared
            act = activation(GATED.get(self.kind, "silu"))
            hs = act(x @ sh.w_gate.to(x.dtype)) * (x @ sh.w_up.to(x.dtype))
            out = out + hs @ sh.w_down.to(x.dtype)

        # load-balancing aux loss (Switch-style), over the whole batch:
        # each expert's choices counted (exactly, in fp32) by a compare
        me = probs.mean((0, 1))
        experts = like(torch.arange(e, device=x.device), gate_idx)
        ce = (gate_idx[..., None] == experts).float().sum((0, 1, 2)) \
            / (b * s * k)
        aux = e * torch.sum(me * ce)
        return out, aux
