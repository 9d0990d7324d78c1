"""Plain PyTorch versions of the hand-written CUDA kernels.

Each function computes what its kernel computes, in the JAX package's
arithmetic order (``repro.kernels``: the blocked-K accumulation of
``nest_gemm``, the per-layer K-tile loop of ``fused_chain``, the
online-softmax recurrence of ``flash_decode``, ``flash_decode_proj`` and
``flash_attention``, the per-step recurrence of ``mamba_scan``).  The wrappers in
``kernels.ops`` take these only for tensors on the CPU -- the
counterpart of Pallas interpret mode -- and ``chip_smoke.py`` holds each
kernel against its plain version on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _softmax(x: torch.Tensor) -> torch.Tensor:
    z = x - x.amax(dim=-1, keepdim=True)
    e = torch.exp(z)
    return e / e.sum(dim=-1, keepdim=True)


def _rmsnorm(x: torch.Tensor) -> torch.Tensor:
    return x / torch.sqrt((x * x).mean(dim=-1, keepdim=True) + 1e-6)


def _layernorm(x: torch.Tensor) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) * (x - mu)).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + 1e-6)


#: Elementwise activations fusable at the output-store step.  ``gelu`` is
#: the tanh approximation (``jax.nn.gelu``'s default).
ACT_FNS = {
    "relu": lambda x: torch.clamp_min(x, 0.0),
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
}

#: Activations applicable inside the fused chain: the elementwise set
#: plus the row-wise ones (a fused block holds full output rows).
FUSED_ACT_FNS = {
    **ACT_FNS,
    "softmax": _softmax,
    "rmsnorm": _rmsnorm,
    "layernorm": _layernorm,
}


def _rnd(x: int) -> int:
    """Largest power of two <= x (min 8): the JAX wrappers' block sizing
    on small shapes (``repro.kernels.ops._rnd``)."""
    p = 8
    while p * 2 <= x:
        p *= 2
    return p


def nest_gemm_ref(x: torch.Tensor, w: torch.Tensor, *, bk: int = 128,
                  out_block_t: bool = False,
                  act: str | None = None) -> torch.Tensor:
    """``act(X[M, K] @ W[K, N])`` accumulated over K blocks of ``bk`` in
    fp32; with ``out_block_t`` the result is stored as (N, M)."""
    m, k = x.shape
    n = w.shape[1]
    x = x.to(torch.float32)
    w = w.to(torch.float32)
    bk_ = min(bk, _rnd(k))
    acc = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    for k0 in range(0, k, bk_):
        acc += x[:, k0:k0 + bk_] @ w[k0:k0 + bk_]
    if act is not None:
        acc = ACT_FNS[act](acc)
    return acc.T.contiguous() if out_block_t else acc


def adapt_rows(acc: torch.Tensor, m_l: int, m_next: int,
               k_next: int) -> torch.Tensor:
    """The runtime ``adapt`` glue on the true rows of an accumulator:
    ravel row-major, cycle to ``m_next * k_next`` elements, reshape."""
    flat = acc[:m_l].reshape(-1)
    need = m_next * k_next
    if need > flat.numel():
        flat = flat.repeat(-(-need // flat.numel()))
    return flat[:need].reshape(m_next, k_next)


def fused_chain_ref(x: torch.Tensor, ws, *, bks, acts, adapts=None,
                    dims=None) -> torch.Tensor:
    """``act_{L-1}(... act_0(X @ W_0) ... @ W_{L-1})``, each layer summed
    over its own K tiles of ``bks[l]``; ``adapts[l]`` applies the
    head-split/merge glue before layer ``l``; ``dims`` are the true
    per-layer (m, k, n)."""
    n_layers = len(ws)
    if adapts is None:
        adapts = (False,) * n_layers
    if dims is None:
        dims = tuple((x.shape[0], w.shape[0], w.shape[1]) for w in ws)
    h = x.to(torch.float32)
    for layer, w in enumerate(ws):
        m_l, k_l, n_l = dims[layer]
        bk = max(1, min(bks[layer], k_l))
        w = w.to(torch.float32)
        acc = torch.zeros((h.shape[0], n_l), dtype=torch.float32,
                          device=h.device)
        for k0 in range(0, k_l, bk):
            acc += h[:, k0:k0 + bk] @ w[k0:k0 + bk]
        if acts[layer] is not None:
            acc = FUSED_ACT_FNS[acts[layer]](acc)
        if layer == n_layers - 1:
            return acc[:dims[-1][0]]
        if adapts[layer + 1]:
            m_next, k_next = dims[layer + 1][:2]
            h = adapt_rows(acc, m_l, m_next, k_next)
        else:
            h = acc
    raise ValueError("fused_chain needs at least one weight")


def flash_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, *, bkv: int = 128,
                     scale: float = 1.0) -> torch.Tensor:
    """Batched ragged decode attention by the online-softmax recurrence
    over KV blocks; request ``b`` attends to ``k[b, :lengths[b]]`` and a
    fully masked score contributes p = 0.  Sums run in fp32; as in the TPU
    kernel, p is rounded to v's dtype before the PV product and the
    result takes q's dtype (both no-ops in fp32)."""
    b, sq, d = q.shape
    sk = k.shape[1]
    out_dtype, p_dtype = q.dtype, v.dtype
    q = q.to(torch.float32)
    k = k.to(torch.float32)
    v = v.to(torch.float32)
    lens = lengths.reshape(b, 1, 1).to(device=q.device)
    bkv_ = min(bkv, _rnd(sk))
    m = torch.full((b, sq, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, sq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sq, v.shape[2]), dtype=torch.float32,
                      device=q.device)
    for k0 in range(0, sk, bkv_):
        kb = k[:, k0:k0 + bkv_]
        vb = v[:, k0:k0 + bkv_]
        s = (q @ kb.transpose(1, 2)) * scale
        kpos = k0 + torch.arange(kb.shape[1], device=q.device)
        s = torch.where(kpos.reshape(1, 1, -1) < lens, s,
                        torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where(s <= NEG_INF / 2, torch.zeros_like(s),
                        torch.exp(s - m_new))
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p.to(p_dtype).to(torch.float32) @ vb
        m = m_new
    return (acc / torch.clamp_min(l, 1e-30)).to(out_dtype)


def flash_decode_proj_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          lengths: torch.Tensor, wo: torch.Tensor, *,
                          m_out: int, k_out: int, bkv: int = 128,
                          scale: float = 1.0) -> torch.Tensor:
    """Block-fused decode attention: each request's :func:`flash_decode_ref`
    context ([sq, d], every row a true row) raveled row-major, cycled to
    ``m_out * k_out`` elements, refolded to [m_out, k_out] (the runtime
    ``adapt`` head-merge) and multiplied by the shared ``wo [k_out, n_out]``.
    Returns [B, m_out, n_out]."""
    ctx = flash_decode_ref(q, k, v, lengths, bkv=bkv, scale=scale)
    h = torch.stack([adapt_rows(c, c.shape[0], m_out, k_out) for c in ctx])
    return h @ wo.to(torch.float32)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, bq: int = 128,
                        bkv: int = 128,
                        kv_len: int | None = None) -> torch.Tensor:
    """Prefill attention over [BH, S, d] by the online-softmax recurrence
    over KV blocks of ``bkv`` for each query block of ``bq``: scale
    ``d**-0.5``, KV blocks strictly after a causal query block skipped,
    key positions at or past ``kv_len`` masked, and p = 0 wherever a score
    is masked.  With bf16 inputs p is rounded to v's dtype before the PV
    product; sums run in fp32 and the result takes q's dtype."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    kv_len = sk if kv_len is None else kv_len
    scale = d ** -0.5
    qf, kf, vf = (t.to(torch.float32) for t in (q, k, v))
    out = torch.empty((bh, sq, v.shape[2]), dtype=torch.float32,
                      device=q.device)
    for q0 in range(0, sq, bq):
        qb = qf[:, q0:q0 + bq]
        rows = qb.shape[1]
        qpos = q0 + torch.arange(rows, device=q.device).reshape(-1, 1)
        m = torch.full((bh, rows, 1), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((bh, rows, 1), dtype=torch.float32, device=q.device)
        acc = torch.zeros((bh, rows, v.shape[2]), dtype=torch.float32,
                          device=q.device)
        for k0 in range(0, sk, bkv):
            if causal and k0 > q0 + bq - 1:
                break                # every later block lies after q0's
            kb, vb = kf[:, k0:k0 + bkv], vf[:, k0:k0 + bkv]
            s = (qb @ kb.transpose(1, 2)) * scale
            kpos = k0 + torch.arange(kb.shape[1], device=q.device)
            keep = (kpos < kv_len).reshape(1, -1)
            if causal:
                keep = keep & (kpos.reshape(1, -1) <= qpos)
            s = torch.where(keep, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.where(s <= NEG_INF / 2, torch.zeros_like(s),
                            torch.exp(s - m_new))
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + p.to(v.dtype).to(torch.float32) @ vb
            m = m_new
        out[:, q0:q0 + rows] = acc / torch.clamp_min(l, 1e-30)
    return out.to(q.dtype)


def mamba_scan_ref(da: torch.Tensor, dbx: torch.Tensor, c: torch.Tensor,
                   h0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The selective scan step by step: ``h = da_t * h + dbx_t`` over
    [B, D, N], ``y_t = sum_n c_t[n] * h[:, n]``.  da, dbx [B, L, D, N],
    c [B, L, N], h0 [B, D, N]; returns (y [B, L, D], h_last [B, D, N])."""
    b, seq, d, _ = da.shape
    h = h0.to(torch.float32)
    y = torch.empty((b, seq, d), dtype=torch.float32, device=da.device)
    for t in range(seq):
        h = da[:, t].to(torch.float32) * h + dbx[:, t].to(torch.float32)
        y[:, t] = (h * c[:, t, None, :].to(torch.float32)).sum(dim=-1)
    return y, h
