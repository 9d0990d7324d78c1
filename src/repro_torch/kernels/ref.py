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


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The type the attention and scan versions sum in: fp32, or fp64 for
    fp64 inputs (``torch.autograd.gradcheck``'s)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


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


def flash_decode_split_ref(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, lengths: torch.Tensor, *,
                           split: int, chunk: int,
                           scale: float = 1.0) -> torch.Tensor:
    """:func:`flash_decode_ref` as the bf16 route cuts it: the keys in
    ranges of ``split`` from 0, each range by the recurrence over blocks
    of ``chunk`` keys with its own (m, l, acc), then the ranges merged in
    order: m = max m_i, l = sum l_i e^(m_i - m), out = sum acc_i
    e^(m_i - m) / l.  A range past a request's length has m_i = -1e30,
    l_i = 0, acc_i = 0 and adds nothing; a request of length 0 gives
    zeros.  p is rounded to v's dtype before P V, l sums it unrounded,
    the result takes q's dtype."""
    b, sq, _ = q.shape
    sk = k.shape[1]
    out_dtype, p_dtype = q.dtype, v.dtype
    q, k, v = (t.to(torch.float32) for t in (q, k, v))
    lens = lengths.reshape(b, 1, 1).to(device=q.device)
    parts = []
    for r0 in range(0, max(sk, 1), split):
        m = torch.full((b, sq, 1), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, sq, 1), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, sq, v.shape[2]), dtype=torch.float32,
                          device=q.device)
        for k0 in range(r0, min(r0 + split, sk), chunk):
            k1 = min(k0 + chunk, r0 + split, sk)
            s = (q @ k[:, k0:k1].transpose(1, 2)) * scale
            kpos = torch.arange(k0, k1, device=q.device).reshape(1, 1, -1)
            s = torch.where(kpos < lens, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.where(s <= NEG_INF / 2, torch.zeros_like(s),
                            torch.exp(s - m_new))
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + p.to(p_dtype).to(torch.float32) @ v[:, k0:k1]
            m = m_new
        parts.append((m, l, acc))
    m = torch.stack([part[0] for part in parts]).amax(0)
    l = torch.zeros_like(m)
    out = torch.zeros_like(parts[0][2])
    for m_i, l_i, acc_i in parts:
        w = torch.exp(m_i - m)
        l = l + l_i * w
        out = out + acc_i * w
    return (out / torch.clamp_min(l, 1e-30)).to(out_dtype)


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
                        bkv: int = 128, kv_len: int | None = None,
                        return_lse: bool = False):
    """Prefill attention over [BH, S, d] by the online-softmax recurrence
    over KV blocks of ``bkv`` for each query block of ``bq``: scale
    ``d**-0.5``, KV blocks strictly after a causal query block skipped,
    key positions at or past ``kv_len`` masked, and p = 0 wherever a score
    is masked.  With bf16 inputs p is rounded to v's dtype before the PV
    product; sums run in fp32 and the result takes q's dtype.  With
    ``return_lse`` also each row's log-sum-exp of its scaled scores, [BH,
    S] fp32 (``m + log(l)``; +inf for a row with every key masked, so
    that the backward's ``exp(s - lse)`` is 0 there)."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    kv_len = sk if kv_len is None else kv_len
    scale = d ** -0.5
    f32 = _acc(q.dtype)
    qf, kf, vf = (t.to(f32) for t in (q, k, v))
    out = torch.empty((bh, sq, v.shape[2]), dtype=f32,
                      device=q.device)
    lse = torch.empty((bh, sq), dtype=f32, device=q.device)
    for q0 in range(0, sq, bq):
        qb = qf[:, q0:q0 + bq]
        rows = qb.shape[1]
        qpos = q0 + torch.arange(rows, device=q.device).reshape(-1, 1)
        m = torch.full((bh, rows, 1), NEG_INF, dtype=f32,
                       device=q.device)
        l = torch.zeros((bh, rows, 1), dtype=f32, device=q.device)
        acc = torch.zeros((bh, rows, v.shape[2]), dtype=f32,
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
            acc = acc * alpha + p.to(v.dtype).to(f32) @ vb
            m = m_new
        out[:, q0:q0 + rows] = acc / torch.clamp_min(l, 1e-30)
        lse[:, q0:q0 + rows] = torch.where(
            l > 0, m + torch.log(l), torch.full_like(l, float("inf")))[..., 0]
    if return_lse:
        return out.to(q.dtype), lse
    return out.to(q.dtype)


def _attention_keep(sq: int, sk: int, causal: bool, kv_len: int,
                    device) -> torch.Tensor:
    """[sq, sk]: which (query, key) pairs attend (key below ``kv_len``,
    and at or before the query when causal)."""
    qpos = torch.arange(sq, device=device).reshape(-1, 1)
    kpos = torch.arange(sk, device=device).reshape(1, -1)
    keep = (kpos < kv_len).expand(sq, sk)
    return keep & (kpos <= qpos) if causal else keep


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True,
                            kv_len: int | None = None):
    """The gradients of :func:`flash_attention_ref` by the explicit
    formulas, in fp32: ``P = exp(S * scale - lse)`` on the kept pairs (0
    elsewhere) from the forward's log-sum-exp ``lse`` [BH, S], ``D =
    rowsum(dO * O)``, ``dV = P^T dO``, ``dS = P * (dO V^T - D)``, ``dQ =
    dS K * scale`` and ``dK = dS^T Q * scale``.  q, o, do [BH, S, d], k, v
    [BH, S_kv, d]; returns (dq, dk, dv), each in its input's dtype.  A row
    with every key masked has P = 0 and gives zero gradients."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    kv_len = sk if kv_len is None else kv_len
    scale = d ** -0.5
    f32 = _acc(q.dtype)
    qf, kf, vf, of, dof = (t.to(f32) for t in (q, k, v, o, do))
    keep = _attention_keep(sq, sk, causal, kv_len, q.device)
    s = (qf @ kf.transpose(1, 2)) * scale
    p = torch.where(keep, torch.exp(s - lse[..., None]),
                    torch.zeros_like(s))
    dd = (dof * of).sum(-1, keepdim=True)
    dv = p.transpose(1, 2) @ dof
    ds = p * (dof @ vf.transpose(1, 2) - dd)
    dq = (ds @ kf) * scale
    dk = (ds.transpose(1, 2) @ qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


#: the scan stores the state each chunk of this many steps starts from
#: for its backward (``csrc/mamba_scan.cu``, ``csrc/mamba_scan_bwd.cu``)
SCAN_CHUNK = 16


def mamba_scan_ref(da: torch.Tensor, dbx: torch.Tensor, c: torch.Tensor,
                   h0: torch.Tensor, *, return_states: bool = False):
    """The selective scan step by step: ``h = da_t * h + dbx_t`` over
    [B, D, N], ``y_t = sum_n c_t[n] * h[:, n]``.  da, dbx [B, L, D, N],
    c [B, L, N], h0 [B, D, N]; returns (y [B, L, D], h_last [B, D, N]),
    with ``return_states`` also the state each chunk of
    :data:`SCAN_CHUNK` steps starts from, [B, ceil(L / SCAN_CHUNK), D,
    N] (h0, h_15, h_31, ...)."""
    f32 = _acc(da.dtype)
    h = h0.to(f32)
    # the steps unbound and the outputs stacked, not indexed and written
    # in place: differentiated by autograd, a step's slice then costs no
    # full-size gradient (one stack for all of them)
    ys, states = [], []
    for t, (da_t, dbx_t, c_t) in enumerate(zip(da.unbind(1), dbx.unbind(1),
                                               c.unbind(1))):
        if t % SCAN_CHUNK == 0:
            states.append(h)
        h = da_t.to(f32) * h + dbx_t.to(f32)
        ys.append((h * c_t[:, None, :].to(f32)).sum(dim=-1))
    if not return_states:
        return torch.stack(ys, 1), h
    return torch.stack(ys, 1), h, torch.stack(states, 1)


def mamba_scan_bwd_ref(da, dbx, c, h0, dy, dh_last=None, states=None):
    """The gradients of :func:`mamba_scan_ref` by the reverse scan, in
    fp32: with ``g_t`` the gradient reaching ``h_t`` (``dh_last`` and
    ``c_L * dy_L`` at the last step), ``g_t = c_t * dy_t + da_{t+1} *
    g_{t+1}``, ``ddbx_t = g_t``, ``dda_t = g_t * h_{t-1}``, ``dc_t =
    sum_d dy_t * h_t`` and ``dh0 = da_1 * g_1``.  The states are
    recomputed as the forward computes them: from h0, or, given the
    forward's ``states`` (``return_states``), each chunk from the state
    it starts from.  dy [B, L, D], dh_last [B, D, N] or None (zero);
    returns (dda, ddbx, dc, dh0)."""
    b, seq, d, n = da.shape
    f32 = _acc(da.dtype)
    hs = [h0.to(f32)]
    for t in range(seq):
        if states is not None and t % SCAN_CHUNK == 0:
            hs[t] = states[:, t // SCAN_CHUNK].to(f32)
        hs.append(da[:, t].to(f32) * hs[t] + dbx[:, t].to(f32))
    dda = torch.empty((b, seq, d, n), dtype=f32, device=da.device)
    ddbx = torch.empty_like(dda)
    dc = torch.empty((b, seq, n), dtype=f32, device=da.device)
    g_next = (torch.zeros_like(hs[0]) if dh_last is None
              else dh_last.to(f32))
    for t in range(seq - 1, -1, -1):
        dy_t = dy[:, t].to(f32)[..., None]
        g = c[:, t, None, :].to(f32) * dy_t + g_next
        ddbx[:, t] = g
        dda[:, t] = g * hs[t]
        dc[:, t] = (dy_t * hs[t + 1]).sum(dim=1)
        g_next = da[:, t].to(f32) * g
    return dda, ddbx, dc, g_next
