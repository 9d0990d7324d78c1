"""GQA/MQA attention (optionally biased) and DeepSeek's MLA on the
hand-written kernels (counterpart of ``repro/models/attention.py``).

The JAX package computes attention with ``jnp.einsum`` and
``jax.nn.softmax``: dense masked attention below 8192 keys and a
blockwise online-softmax scan above, causal or full, at scale
``d**-0.5``.  Here both are one ``kernels.ops.flash_attention`` call (on
the card the ``flash_attention`` kernel; on the CPU its plain version),
with K/V repeated to the query heads for GQA (``repeat_interleave`` along
the head axis is ``jnp.repeat``'s order, the reference's
``q.reshape(b, s, kvh, g, d)`` grouping).  ``causal=False`` and
``use_rope=False`` are whisper's encoder (full, no rope) and decoder
(causal, no rope); its cross attention (``cross_attention`` at prefill,
``cross_decode`` at a decode step) attends to the encoder's K/V, all
``frontend_len`` of them, in the same two kernels.

Decode writes the new K/V into the cache by index (the JAX package's
one-hot blend writes the same values) and runs one
``kernels.ops.flash_decode`` over ``[B * KVH, g, D]`` query groups
against the cache, masked to ``position + 1`` keys at scale ``d**-0.5``.
The cache is head-major, ``[B, KVH, S_max, D]`` a layer, so that
``[B * KVH, S_max, D]`` is a free view (the JAX package holds
``[B, S, KVH, D]``).

MLA (low-rank KV with a decoupled rope part) keeps the JAX package's
latent cache, ``c [B, S, kvr]`` and ``rope [B, S, dr]`` a layer.  Its
prefill is one ``ops.flash_attention`` over ``dn + dr``-wide query and
key heads (the rope key broadcast to every head) with ``dv``-wide values,
at scale ``(dn + dr)**-0.5``.  Its decode is the absorbed form: ``wk_b``
folded into the query (``q_lat = q_nope . wk_b^T``), then one
``ops.flash_decode`` a layer in which a request's heads are its query
rows, ``[B, h, kvr + dr]`` against keys ``[c || rope]`` ``[B, S, kvr +
dr]`` (concatenated each step) and values ``c`` ``[B, S, kvr]``, masked
to ``position + 1`` at the same scale; ``wv_b`` and ``wo`` after it.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.dist.sharding import (constrain_batch, grad_placed_as,
                                       is_dtensor, like,
                                       local_shape_and_offset, mesh_sizes)
from repro_torch.kernels import ops
from repro_torch.models.common import Maker, RMSNorm, rope


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk", x, w)`` as one product.  On a mesh the
    product's columns are anchored over ``"model"`` only where the heads
    divide it, so that each rank's columns are whole heads."""
    d = w.shape[0]
    w2 = w.to(x.dtype).reshape(d, -1)
    if not is_dtensor(w2):
        return (x @ w2).unflatten(-1, w.shape[1:])
    sizes = mesh_sizes(w2.device_mesh)
    cut = "model" in sizes and w.shape[1] % sizes["model"] == 0
    if not cut:
        # its gradient kept whole over "model" too, for the view back
        w2 = grad_placed_as(w2)
    out = constrain_batch(x @ w2, extra=(None,) * (x.ndim - 2)
                          + ("model" if cut else None,))
    return out.unflatten(-1, w.shape[1:])


def _head_major(k: torch.Tensor, v: torch.Tensor):
    """[b, s, kv, hd] K and V as [b, kv, s, hd], the cache's layout."""
    return k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()


def write_at(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor,
             dim: int) -> None:
    """``cache[b, ..., pos[b], ...] = new[b]`` (``pos`` indexing dim
    ``dim``), in place, ``new`` cast to the cache's dtype.

    On a mesh (``cache`` a DTensor) each rank writes its own shard: its
    batch rows, its heads, and along ``dim`` only the positions its
    shard holds (a ``kvseq``-cut cache), with no collective beyond
    placing ``new`` and ``pos`` as the shard is placed.  A position
    outside the shard writes back the value already there."""
    if not is_dtensor(cache):
        rows = torch.arange(cache.shape[0], device=cache.device)
        index = (rows,) + (slice(None),) * (dim - 1) + (pos,)
        cache[index] = new.to(cache.dtype)
        return
    from torch.distributed.tensor import Replicate, Shard

    mesh, where = cache.device_mesh, cache.placements
    local = cache.to_local()
    shape, offset = local_shape_and_offset(cache.shape, mesh, where)

    def drop(d):                   # the placement of a dim of ``new``
        return Replicate() if d == dim else Shard(d - (d > dim))
    new = like(new, cache).redistribute(mesh, tuple(
        drop(p.dim) if p.is_shard() else Replicate() for p in where))
    pos = like(pos, cache).redistribute(mesh, tuple(
        p if p.is_shard() and p.dim == 0 else Replicate() for p in where))
    new, pos = new.to_local().to(local.dtype), pos.to_local() - offset[dim]
    inside = (pos >= 0) & (pos < shape[dim])
    rows = torch.arange(shape[0], device=local.device)
    index = (rows,) + (slice(None),) * (dim - 1) + (
        pos.clamp(0, shape[dim] - 1),)
    keep = inside.view(-1, *(1,) * (new.ndim - 1))
    local[index] = torch.where(keep, new, local[index])


class GQA(nn.Module):
    """``gqa_params``: ``wq [d, h, hd]``, ``wk``/``wv [d, kv, hd]``,
    ``wo [h, hd, d]`` and, with ``qkv_bias``, ``bq``/``bk``/``bv``."""

    def __init__(self, mk: Maker, cfg):
        super().__init__()
        d = cfg.d_model
        h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        self.rope_theta = cfg.rope_theta
        self.wq = mk.param((d, h, hd), ("embed", "heads", "head_dim"))
        self.wk = mk.param((d, kv, hd), ("embed", "kv_heads", "head_dim"))
        self.wv = mk.param((d, kv, hd), ("embed", "kv_heads", "head_dim"))
        self.wo = mk.param((h, hd, d), ("heads", "head_dim", "embed"))
        if getattr(cfg, "qkv_bias", False):
            self.bq = mk.param((h, hd), ("heads", "head_dim"),
                               init="zeros")
            self.bk = mk.param((kv, hd), ("kv_heads", "head_dim"),
                               init="zeros")
            self.bv = mk.param((kv, hd), ("kv_heads", "head_dim"),
                               init="zeros")
        else:
            self.bq = self.bk = self.bv = None

    def _project_qkv(self, x, positions, use_rope=True):
        """q [b, s, h, hd] and k [b, s, kv, hd], both rotated unless
        ``use_rope`` is False, and v [b, s, kv, hd]."""
        q, k, v = (_project(x, w) for w in (self.wq, self.wk, self.wv))
        if self.bq is not None:
            q = q + self.bq.to(x.dtype)
            k = k + self.bk.to(x.dtype)
            v = v + self.bv.to(x.dtype)
        if not use_rope:
            return q, k, v
        return (rope(q, positions, self.rope_theta),
                rope(k, positions, self.rope_theta), v)

    def _out(self, ctx: torch.Tensor) -> torch.Tensor:
        """``einsum("bshk,hkd->bsd", ctx, wo)``; on a mesh the heads' parts
        summed and anchored to the batch over the data axes (the merged
        heads' gradient placed as they are, for the view back)."""
        b, s = ctx.shape[:2]
        wo = self.wo.to(ctx.dtype)
        return constrain_batch(grad_placed_as(ctx.reshape(b, s, -1))
                               @ wo.reshape(-1, wo.shape[-1]))

    def _attend(self, q, k, v, causal: bool):
        """``attend``: q [b, s, h, hd] against k, v [b, s_kv, kv, hd] in
        one ``ops.flash_attention`` (K/V repeated to the query heads)."""
        g = q.shape[2] // k.shape[2]
        if g > 1:
            k, v = k.repeat_interleave(g, 2), v.repeat_interleave(g, 2)
        return ops.flash_attention(q, k, v, causal=causal)

    def self_attention(self, x, positions, causal=True, use_rope=True):
        """``gqa_self_attention``, the prefill path: returns (out, (k, v))
        with k and v head-major, [b, kv, s, hd], for the cache."""
        q, k, v = self._project_qkv(x, positions, use_rope)
        ctx = self._attend(q, k, v, causal)
        return self._out(ctx), _head_major(k, v)

    def cross_attention(self, x, enc_out):
        """``_enc_kv`` and ``_cross_attend``: x [b, s, d] against the
        encoder's output [b, t, d], full, no rope, no bias.  Returns (out,
        (k, v)) with k and v head-major, [b, kv, t, hd], for the cache."""
        q = _project(x, self.wq)
        k, v = _project(enc_out, self.wk), _project(enc_out, self.wv)
        return self._out(self._attend(q, k, v, False)), _head_major(k, v)

    def cross_decode(self, x, cache_k, cache_v):
        """One token (x [b, 1, d]) against the cached encoder K/V [b, kv,
        t, hd], every key attended to."""
        lengths = torch.full((x.shape[0],), cache_k.shape[2],
                             dtype=torch.int32, device=x.device)
        return self._decode_attend(_project(x, self.wq), cache_k, cache_v,
                                  lengths)

    def _decode_attend(self, q, cache_k, cache_v, lengths):
        """One query token a request (q [b, 1, h, hd]) against a head-major
        [b, kv, S, hd] cache, keys below ``lengths`` ([b]) attended to, at
        scale ``hd**-0.5``, in one ``ops.flash_decode`` over [b * kv, g,
        hd] query groups; returns the output projected, [b, 1, d]."""
        b, kvh, _, hd = cache_k.shape
        g = q.shape[2] // kvh
        if is_dtensor(q) and kvh % mesh_sizes(q.device_mesh).get("model", 1):
            # the KV heads cannot take "model" (the cache is cut along its
            # sequence there): the query heads are made whole first, as
            # the split into groups cannot keep them cut
            q = constrain_batch(q)
        ctx = ops.flash_decode(q.reshape(b, kvh, g, hd), cache_k, cache_v,
                               lengths.to(torch.int32), scale=hd ** -0.5)
        return self._out(ctx.reshape(b, 1, -1, hd))

    def decode_attention(self, x, cache_k, cache_v, position, use_rope=True):
        """``gqa_decode_attention``: one token (x [b, 1, d]) against a
        head-major [b, kv, S_max, hd] cache.  The new K/V is written at
        ``position`` ([b]) in place, and keys at or before it are
        attended to.  Returns (out, (cache_k, cache_v))."""
        q, k_new, v_new = self._project_qkv(x, position[:, None], use_rope)
        pos = position.long()
        write_at(cache_k, k_new[:, 0], pos, 2)
        write_at(cache_v, v_new[:, 0], pos, 2)
        return (self._decode_attend(q, cache_k, cache_v, pos + 1),
                (cache_k, cache_v))


class MLA(nn.Module):
    """``mla_params``: ``wq_a [d, qr]``, ``q_norm``, ``wq_b [qr, h, dn +
    dr]``, ``wkv_a [d, kvr + dr]``, ``kv_norm``, ``wk_b [kvr, h, dn]``,
    ``wv_b [kvr, h, dv]``, ``wo [h, dv, d]``."""

    def __init__(self, mk: Maker, cfg):
        super().__init__()
        d, h = cfg.d_model, cfg.num_heads
        qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
        dn, dr, dv = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                      cfg.v_head_dim)
        self.dn, self.kvr, self.rope_theta = dn, kvr, cfg.rope_theta
        self.scale = (dn + dr) ** -0.5
        self.wq_a = mk.param((d, qr), ("embed", "q_lora"))
        self.q_norm = RMSNorm(mk, qr, "q_lora")
        self.wq_b = mk.param((qr, h, dn + dr),
                             ("q_lora", "heads", "head_dim"))
        self.wkv_a = mk.param((d, kvr + dr), ("embed", "kv_lora"))
        self.kv_norm = RMSNorm(mk, kvr, "kv_lora")
        self.wk_b = mk.param((kvr, h, dn), ("kv_lora", "heads", "head_dim"))
        self.wv_b = mk.param((kvr, h, dv), ("kv_lora", "heads", "head_dim"))
        self.wo = mk.param((h, dv, d), ("heads", "head_dim", "embed"))

    def _q(self, x, positions):
        """``_mla_q``: (q_nope [b, s, h, dn], q_rope [b, s, h, dr])."""
        q = _project(self.q_norm(x @ self.wq_a.to(x.dtype)), self.wq_b)
        return (q[..., :self.dn],
                rope(q[..., self.dn:], positions, self.rope_theta))

    def _latent(self, x, positions):
        """``_mla_latent``: (c_kv [b, s, kvr], k_rope [b, s, dr])."""
        kv = x @ self.wkv_a.to(x.dtype)
        k_rope = rope(kv[..., None, self.kvr:], positions, self.rope_theta)
        return self.kv_norm(kv[..., :self.kvr]), k_rope[..., 0, :]

    def _out(self, ctx: torch.Tensor) -> torch.Tensor:
        """``einsum("bshk,hkd->bsd", ctx, wo)``; on a mesh the heads' parts
        summed and anchored to the batch over the data axes (the merged
        heads' gradient placed as they are, for the view back)."""
        b, s = ctx.shape[:2]
        wo = self.wo.to(ctx.dtype)
        return constrain_batch(grad_placed_as(ctx.reshape(b, s, -1))
                               @ wo.reshape(-1, wo.shape[-1]))

    def self_attention(self, x, positions):
        """``mla_self_attention``, causal, the prefill path: returns (out,
        (c_kv, k_rope)) for the latent cache."""
        q_nope, q_rope = self._q(x, positions)
        c_kv, k_rope = self._latent(x, positions)
        k_nope = _project(c_kv, self.wk_b)
        v = _project(c_kv, self.wv_b)
        q = torch.cat([q_nope, q_rope], -1)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
            *k_nope.shape[:3], k_rope.shape[-1])], -1)
        ctx = ops.flash_attention(q, k, v, causal=True)
        return self._out(ctx), (c_kv, k_rope)

    def decode_attention(self, x, cache_c, cache_rope, position):
        """``mla_decode_attention``, absorbed: one token (x [b, 1, d])
        against a latent cache (cache_c [b, S_max, kvr], cache_rope [b,
        S_max, dr]).  The new latent is written at ``position`` ([b]) in
        place, and keys at or before it are attended to.  Returns (out,
        (cache_c, cache_rope))."""
        q_nope, q_rope = self._q(x, position[:, None])
        c_new, rope_new = self._latent(x, position[:, None])
        pos = position.long()
        write_at(cache_c, c_new[:, 0], pos, 1)
        write_at(cache_rope, rope_new[:, 0], pos, 1)
        # q_lat[b, h, r] = q_nope . wk_b^T, the heads as query rows
        q_lat = torch.einsum("bhk,rhk->bhr", q_nope[:, 0],
                             self.wk_b.to(x.dtype))
        q = torch.cat([q_lat, q_rope[:, 0]], -1)
        k = torch.cat([cache_c, cache_rope], -1)
        o_lat = ops.flash_decode(q, k, cache_c, (pos + 1).to(torch.int32),
                                 scale=self.scale)
        ctx = torch.einsum("bhr,rhk->bhk", o_lat, self.wv_b.to(x.dtype))
        return self._out(ctx[:, None]), (cache_c, cache_rope)
