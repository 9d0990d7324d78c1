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
sums over k, where the JAX package scatter-adds them; the only atomics
count experts for ``aux`` (adds of 1.0, exact), so the result does not
change from run to run on the card.
"""

from __future__ import annotations

import math

import torch
from torch import nn

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
        """xs [B, E, cap, d] -> [B, E, cap, d] through each expert's FFN."""
        def up(w):
            return torch.einsum("becd,edf->becf", xs, w.to(xs.dtype))
        if self.kind in GATED:
            h = activation(GATED[self.kind])(up(self.w_gate)) * up(self.w_up)
        else:
            h = activation(self.kind)(up(self.w_up))
        return torch.einsum("becf,efd->becd", h, self.w_down.to(xs.dtype))

    def forward(self, x: torch.Tensor):
        """x [B, S, d] -> (out [B, S, d], aux)."""
        b, s, d = x.shape
        e, k = self.num_experts, self.top_k
        logits = x.float() @ self.router.float()                 # [B, S, E]
        probs = torch.softmax(logits, -1)
        gate_idx = choose(probs, k)
        gate_vals = gates(probs, gate_idx)
        cap = capacity(s, k, e, self.capacity_factor)
        order, token, slot, keep = route(gate_idx, e, cap)

        # dispatch: each kept (token, choice) to its own slot, the dropped
        # ones to a spare slot past the buffer (no mask, so no wait on the
        # card for its count)
        rows = torch.arange(b, device=x.device)[:, None]
        buf = x.new_zeros((b, e * cap + 1, d))
        buf[rows, torch.where(keep, slot, e * cap)] = torch.gather(
            x, 1, token[..., None].expand(-1, -1, d))
        out_buf = self._expert_ffn(buf[:, :-1].view(b, e, cap, d)).reshape(
            b, e * cap, d)

        # combine: back to (token, choice) order, weighted, summed over k
        inv = torch.argsort(order, dim=1)
        slot_tk = torch.gather(slot, 1, inv)
        keep_tk = torch.gather(keep, 1, inv)
        gathered = torch.gather(out_buf, 1,
                                slot_tk[..., None].expand(-1, -1, d))
        weight = (gate_vals.reshape(b, s * k) * keep_tk).to(x.dtype)
        out = (gathered * weight[..., None]).view(b, s, k, d).sum(2)

        if self.shared is not None:
            sh = self.shared
            act = activation(GATED.get(self.kind, "silu"))
            hs = act(x @ sh.w_gate.to(x.dtype)) * (x @ sh.w_up.to(x.dtype))
            out = out + hs @ sh.w_down.to(x.dtype)

        # load-balancing aux loss (Switch-style), over the whole batch
        me = probs.mean((0, 1))
        ce = torch.zeros(e, device=x.device).index_add_(
            0, gate_idx.reshape(-1), probs.new_ones(b * s * k)) / (b * s * k)
        aux = e * torch.sum(me * ce)
        return out, aux
