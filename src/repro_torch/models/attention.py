"""GQA/MQA attention (optionally biased) and DeepSeek's MLA on the
hand-written kernels (counterpart of ``repro/models/attention.py``).

The JAX package computes attention with ``jnp.einsum`` and
``jax.nn.softmax``: dense masked attention below 8192 keys and a
blockwise online-softmax scan above, both causal at scale ``d**-0.5``.
Here both are one ``kernels.ops.flash_attention`` call (on the card the
``flash_attention`` kernel; on the CPU its plain version), with K/V
repeated to the query heads for GQA (``repeat_interleave`` along the
head axis is ``jnp.repeat``'s order, the reference's
``q.reshape(b, s, kvh, g, d)`` grouping).

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

from repro_torch.kernels import ops
from repro_torch.models.common import Maker, RMSNorm, rope


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk", x, w)`` as one product."""
    d = w.shape[0]
    return (x @ w.to(x.dtype).reshape(d, -1)).unflatten(-1, w.shape[1:])


class GQA(nn.Module):
    """``gqa_params``: ``wq [d, h, hd]``, ``wk``/``wv [d, kv, hd]``,
    ``wo [h, hd, d]`` and, with ``qkv_bias``, ``bq``/``bk``/``bv``."""

    def __init__(self, mk: Maker, cfg):
        super().__init__()
        d = cfg.d_model
        h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        self.rope_theta = cfg.rope_theta
        self.wq = mk.param((d, h, hd))
        self.wk = mk.param((d, kv, hd))
        self.wv = mk.param((d, kv, hd))
        self.wo = mk.param((h, hd, d))
        if getattr(cfg, "qkv_bias", False):
            self.bq = mk.param((h, hd), init="zeros")
            self.bk = mk.param((kv, hd), init="zeros")
            self.bv = mk.param((kv, hd), init="zeros")
        else:
            self.bq = self.bk = self.bv = None

    def _project_qkv(self, x, positions):
        """q [b, s, h, hd] and k [b, s, kv, hd], both rotated, and v [b, s,
        kv, hd]."""
        q, k, v = (_project(x, w) for w in (self.wq, self.wk, self.wv))
        if self.bq is not None:
            q = q + self.bq.to(x.dtype)
            k = k + self.bk.to(x.dtype)
            v = v + self.bv.to(x.dtype)
        return (rope(q, positions, self.rope_theta),
                rope(k, positions, self.rope_theta), v)

    def _out(self, ctx: torch.Tensor) -> torch.Tensor:
        """``einsum("bshk,hkd->bsd", ctx, wo)``."""
        b, s = ctx.shape[:2]
        wo = self.wo.to(ctx.dtype)
        return ctx.reshape(b, s, -1) @ wo.reshape(-1, wo.shape[-1])

    def self_attention(self, x, positions):
        """``gqa_self_attention``, causal, the prefill path: returns (out,
        (k, v)) with k and v head-major, [b, kv, s, hd], for the cache."""
        q, k, v = self._project_qkv(x, positions)
        g = q.shape[2] // k.shape[2]
        kr, vr = (k, v) if g == 1 else (k.repeat_interleave(g, 2),
                                        v.repeat_interleave(g, 2))
        ctx = ops.flash_attention(q, kr, vr, causal=True)
        return self._out(ctx), (k.transpose(1, 2).contiguous(),
                                v.transpose(1, 2).contiguous())

    def decode_attention(self, x, cache_k, cache_v, position):
        """``gqa_decode_attention``: one token (x [b, 1, d]) against a
        head-major [b, kv, S_max, hd] cache.  The new K/V is written at
        ``position`` ([b]) in place, and keys at or before it are
        attended to.  Returns (out, (cache_k, cache_v))."""
        q, k_new, v_new = self._project_qkv(x, position[:, None])
        b, kvh, s_max, hd = cache_k.shape
        rows = torch.arange(b, device=x.device)
        pos = position.long()
        cache_k[rows, :, pos] = k_new[:, 0].to(cache_k.dtype)
        cache_v[rows, :, pos] = v_new[:, 0].to(cache_v.dtype)
        g = q.shape[2] // kvh
        lengths = (pos + 1).to(torch.int32).repeat_interleave(kvh)
        ctx = ops.flash_decode(q.reshape(b * kvh, g, hd),
                               cache_k.view(b * kvh, s_max, hd),
                               cache_v.view(b * kvh, s_max, hd), lengths,
                               scale=hd ** -0.5)
        return self._out(ctx.reshape(b, 1, -1, hd)), (cache_k, cache_v)


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
        self.wq_a = mk.param((d, qr))
        self.q_norm = RMSNorm(mk, qr)
        self.wq_b = mk.param((qr, h, dn + dr))
        self.wkv_a = mk.param((d, kvr + dr))
        self.kv_norm = RMSNorm(mk, kvr)
        self.wk_b = mk.param((kvr, h, dn))
        self.wv_b = mk.param((kvr, h, dv))
        self.wo = mk.param((h, dv, d))

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
        """``einsum("bshk,hkd->bsd", ctx, wo)``."""
        b, s = ctx.shape[:2]
        wo = self.wo.to(ctx.dtype)
        return ctx.reshape(b, s, -1) @ wo.reshape(-1, wo.shape[-1])

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
        b = x.shape[0]
        rows = torch.arange(b, device=x.device)
        pos = position.long()
        cache_c[rows, pos] = c_new[:, 0].to(cache_c.dtype)
        cache_rope[rows, pos] = rope_new[:, 0].to(cache_rope.dtype)
        # q_lat[b, h, r] = q_nope . wk_b^T, the heads as query rows
        q_lat = torch.einsum("bhk,rhk->bhr", q_nope[:, 0],
                             self.wk_b.to(x.dtype))
        q = torch.cat([q_lat, q_rope[:, 0]], -1)
        k = torch.cat([cache_c, cache_rope], -1)
        o_lat = ops.flash_decode(q, k, cache_c, (pos + 1).to(torch.int32),
                                 scale=self.scale)
        ctx = torch.einsum("bhr,rhk->bhk", o_lat, self.wv_b.to(x.dtype))
        return self._out(ctx[:, None]), (cache_c, cache_rope)
