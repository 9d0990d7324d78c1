"""Selective state-space blocks, Mamba-1 (falcon-mamba-7b) and Mamba-2
(zamba2-1.2b's blocks), on the hand-written scan (counterpart of
``repro/models/ssm.py``).

Recurrence (per channel d, state n):

    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t * x_t
    y_t = C_t . h_t + D * x_t

Mamba-1: ``da`` and ``dbx`` are formed as the JAX package's
``REPRO_SSM_UNFUSED`` path forms them (its fused path computes the same
values a chunk at a time): ``da = exp(dt * A)`` with dt cast to fp32
first, ``dbx`` from ``dt * x`` multiplied in the model's dtype, then cast
to fp32 and multiplied by B.

Mamba-2 (multi-head, a scalar decay a head, B and C shared by a group of
heads): dt in fp32, ``da = exp(dt * a)`` a head and step, ``dbx = (dt *
x) * B`` in fp32, as the reference's fused chunk body forms them.  dt,
x, B and C are made head-major before the products, so that dbx is born
in that layout: da and dbx ``[B, H, L, P, N]`` (da a head's scalar
expanded over (P, N): 4.2 MB a layer a decode step at zamba2's batch 4),
c ``[B, H, L, N]``, h0 ``[B, H, P, N]``, the final state the
reference's layout.  ``kernels.ops.mamba_scan_heads`` folds the heads
into the scan's batch (``[B * H, L, P, N]``), after a mesh has cut them
over ``"model"``.

Either scan is one ``kernels.ops.mamba_scan`` call (the ``mamba_scan``
kernel on the card, its plain version on the CPU), for a whole prompt or
for one decode step.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from repro_torch.dist.sharding import constrain_batch, grad_placed_as
from repro_torch.models.common import Maker, RMSNorm, zeros


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv; x: [b, l, di], w: [k, di].  Returns (y,
    new_state), the state being the last k - 1 inputs.  The taps are
    summed in the JAX package's order."""
    k = w.shape[0]
    if state is None:
        state = zeros(x, (x.shape[0], k - 1, x.shape[2]))
    xp = torch.cat([state, x], 1)
    y = 0
    for i in range(k):
        y = y + xp[:, i:i + x.shape[1]] * w[i].to(x.dtype)
    new_state = xp[:, -(k - 1):] if k > 1 else state
    return y + b.to(x.dtype), new_state


class Mamba(nn.Module):
    """``mamba_params`` and ``mamba_block``."""

    def __init__(self, mk: Maker, cfg):
        super().__init__()
        d, di, n = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state
        self.di, self.n, self.dt_rank = di, n, cfg.ssm_dt_rank
        self.w_in = mk.param((d, 2 * di), ("embed", "ssm_inner"))
        self.conv_w = mk.param((cfg.ssm_d_conv, di), ("conv", "ssm_inner"),
                               scale=0.5)
        self.conv_b = mk.param((di,), ("ssm_inner",), init="zeros")
        self.w_x = mk.param((di, self.dt_rank + 2 * n),
                            ("ssm_inner", "ssm_proj"))
        self.w_dt = mk.param((self.dt_rank, di), ("ssm_proj", "ssm_inner"))
        self.dt_bias = mk.param((di,), ("ssm_inner",), init="zeros")
        self.a_log = mk.param((di, n), ("ssm_inner", "ssm_state"),
                               init="zeros")
        self.d_skip = mk.param((di,), ("ssm_inner",), init="ones")
        self.w_out = mk.param((di, d), ("ssm_inner", "embed"))

    def forward(self, x, state=None):
        """x: [b, l, d] -> (y, new_state); state = {"conv": [b, k-1, di],
        "ssm": [b, di, n] fp32} is the decode carry."""
        di, n, r = self.di, self.n, self.dt_rank
        dtype = x.dtype
        xz = x @ self.w_in.to(dtype)
        xs, z = xz[..., :di], xz[..., di:]
        xs, new_conv = _causal_conv(xs, self.conv_w, self.conv_b,
                                    state["conv"] if state else None)
        xs = F.silu(xs)
        # the product sums over ssm_inner, which a mesh cuts over "model":
        # anchored whole over "model" here (one reduction), so no later
        # product meets it partial
        proj = constrain_batch(xs @ self.w_x.to(dtype), grad=False)
        # jax.nn.softplus has no threshold; torch's returns x past 20,
        # where log1p(exp(-x)) < 2.1e-9: under 1e-8 from the JAX package's
        dt = _by_channels(F.softplus(proj[..., :r] @ self.w_dt.to(dtype)
                                     + self.dt_bias.to(dtype)))  # [b, l, di]
        b_t = proj[..., r:r + n]                                 # [b, l, n]
        c_t = proj[..., r + n:]                                  # [b, l, n]
        a = -torch.exp(self.a_log.float())                       # [di, n]
        h0 = (state["ssm"].float() if state else
              zeros(x, (x.shape[0], di, n), torch.float32))
        da = torch.exp(dt.float()[..., None] * a)
        dbx = _by_channels((dt * xs).float())[..., None] \
            * b_t.float()[..., None, :]
        y, h_last = ops.mamba_scan(da, dbx, c_t.float(), h0)
        y = y.to(dtype) + xs * self.d_skip.to(dtype)
        y = y * F.silu(z)
        # the channels' parts summed and anchored, as the MLP's output
        return constrain_batch(y @ self.w_out.to(dtype)), {
            "conv": new_conv, "ssm": h_last}


def _by_channels(t: torch.Tensor) -> torch.Tensor:
    """A [b, l, di] tensor anchored with its batch over the data axes and
    its channels over "model", as the scan's rule takes da and dbx (the
    identity off a mesh)."""
    return constrain_batch(t, extra=("", "model"), grad=False)


def _by_heads(t: torch.Tensor) -> torch.Tensor:
    """A head-major [b, h, ...] tensor, contiguous, anchored with its
    batch over the data axes and its heads over "model" (off a mesh only
    made contiguous)."""
    return constrain_batch(t, extra=("model",), grad=False).contiguous()


class Mamba2(nn.Module):
    """``mamba2_params`` and ``mamba2_block``."""

    def __init__(self, mk: Maker, cfg):
        super().__init__()
        d, di, n = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state
        h, g = cfg.ssm_heads, cfg.ssm_groups
        self.di, self.n, self.h, self.g = di, n, h, g
        self.w_in = mk.param((d, 2 * di + 2 * g * n + h),
                             ("embed", "ssm_inner"))
        self.conv_w = mk.param((cfg.ssm_d_conv, di + 2 * g * n),
                               ("conv", "ssm_inner"), scale=0.5)
        self.conv_b = mk.param((di + 2 * g * n,), ("ssm_inner",),
                               init="zeros")
        self.a_log = mk.param((h,), ("ssm_heads",), init="zeros")
        self.dt_bias = mk.param((h,), ("ssm_heads",), init="zeros")
        self.d_skip = mk.param((h,), ("ssm_heads",), init="ones")
        self.norm = RMSNorm(mk, di, "ssm_inner")
        self.w_out = mk.param((di, d), ("ssm_inner", "embed"))

    def forward(self, x, state=None):
        """x: [b, l, d] -> (y, new_state); state = {"conv": [b, k-1, di +
        2gn], "ssm": [b, h, p, n] fp32} is the decode carry."""
        di, n, h, g = self.di, self.n, self.h, self.g
        p = di // h
        b, l, _ = x.shape
        dtype = x.dtype
        # anchored whole over "model" on a mesh: one gather, where each of
        # the slices below would gather it again (they do not fall on the
        # shards' edges)
        zxbcdt = constrain_batch(x @ self.w_in.to(dtype), grad=False)
        z, xbc, dt_raw = (zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * g * n],
                          zxbcdt[..., -h:])
        xbc, new_conv = _causal_conv(xbc, self.conv_w, self.conv_b,
                                     state["conv"] if state else None)
        # whole again: sliced below
        xbc = constrain_batch(F.silu(xbc), grad=False)
        # head-major [b, h, l, ...]; B and C repeated from g groups to h
        # heads in jnp.repeat's order.  On a mesh dt, B and C are cut over
        # "model" by their heads here, so that da and dbx are born cut as
        # the scan's rule takes them (no rank forms another's heads)
        # (the heads' gradient made contiguous on each rank before the
        # view back: a transposed shard's cannot be viewed)
        xs = grad_placed_as(xbc[..., :di].unflatten(-1, (h, p)),
                            placed=False).transpose(1, 2).float().contiguous()
        b_t, c_t = (_by_heads(xbc[..., di + i * g * n:di + (i + 1) * g * n]
                              .unflatten(-1, (g, n))
                              .repeat_interleave(h // g, 2).transpose(1, 2)
                              .float()) for i in (0, 1))
        # softplus as in Mamba-1 (under 1e-8 from the JAX package's)
        dt = _by_heads(F.softplus(dt_raw.float() + self.dt_bias.float())
                       .transpose(1, 2))                       # [b, h, l]
        a = -torch.exp(self.a_log.float())                       # [h]
        da = torch.exp(dt * a[:, None])[..., None, None].expand(b, h, l, p, n)
        dbx = _by_heads(dt[..., None] * xs)[..., None] * b_t[..., None, :]
        h0 = (state["ssm"].float() if state else
              zeros(x, (b, h, p, n), torch.float32))
        y, h_last = ops.mamba_scan_heads(da, dbx, c_t, h0)
        y = y + xs * self.d_skip.float()[:, None, None]
        y = y.transpose(1, 2).reshape(b, l, di).to(dtype)
        y = self.norm(y * F.silu(z))
        # the channels' parts summed and anchored, as the MLP's output
        return constrain_batch(y @ self.w_out.to(dtype)), {
            "conv": new_conv, "ssm": h_last}
