"""Ragged-safe public wrappers around the CUDA kernels.

Each wrapper launches its hand-written kernel for tensors on the card
(raising on anything the kernel does not take) and takes the kernel's
plain PyTorch version (``kernels.ref``) only when every tensor it was
given lies on the CPU -- the counterpart of the JAX package's Pallas
interpret mode.  The kernels mask ragged edges themselves; only
``flash_attention`` pads, as the JAX package's wrapper does, so that
both versions see the same blocks.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fused_chain as _fc
from repro_torch.kernels import mamba_scan as _ms
from repro_torch.kernels import nest_gemm as _ng
from repro_torch.kernels import ref


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def nest_gemm(x, w, *, bk=128, out_block_t=False, act=None):
    """``act(x @ w)``, stored (N, M) with ``out_block_t``; ``bk`` sets the
    plain version's K blocks (the kernel's K order is its own, fixed by
    K alone)."""
    if _on_cpu(x, w):
        return ref.nest_gemm_ref(x, w, bk=bk, out_block_t=out_block_t,
                                 act=act)
    return _ng.nest_gemm(x.contiguous(), w.contiguous(),
                         out_block_t=out_block_t, act=act)


def fused_chain(x, ws, *, bm=128, bks=None, acts=None, adapts=None,
                dims=None):
    """ONE launch for ``act_{L-1}(... act_0(x @ ws[0]) ...) @ ws[-1]``;
    ``bks`` sets each layer's K tile, ``acts`` names per-layer
    activations from ``ref.FUSED_ACT_FNS``, ``adapts``/``dims`` carry the
    runtime's shape-glue boundaries and true per-layer (m, k, n)."""
    n_layers = len(ws)
    if bks is None:
        bks = (128,) * n_layers
    if acts is None:
        acts = (None,) * n_layers
    bks = tuple(max(1, min(bk, w.shape[0])) for bk, w in zip(bks, ws))
    adapts = None if adapts is None else tuple(adapts)
    dims = None if dims is None else tuple(tuple(d) for d in dims)
    if _on_cpu(x, *ws):
        return ref.fused_chain_ref(x, ws, bks=bks, acts=tuple(acts),
                                   adapts=adapts, dims=dims)
    return _fc.fused_chain(x.contiguous(), [w.contiguous() for w in ws],
                           bm=bm, bks=bks, acts=tuple(acts), adapts=adapts,
                           dims=dims)


def _lengths(lengths, b: int, sk: int, device) -> torch.Tensor:
    """[B] or [B, 1] true KV lengths (default: all ``sk``) as [B] int32."""
    if lengths is None:
        lengths = torch.full((b,), sk, dtype=torch.int32)
    return torch.as_tensor(lengths).reshape(b).to(device=device,
                                                  dtype=torch.int32)


def flash_decode(q, k, v, lengths=None, *, bkv=128, scale=1.0):
    """Batched decode attention, one launch for the whole batch.

    q: [B, sq, d], k, v: [B, skv, d], all float32 or all bfloat16 (the
    result takes their dtype), lengths: [B] or [B, 1] true KV lengths
    (defaults to the full skv for every request).  ``bkv`` sets the plain
    version's KV blocks."""
    lengths = _lengths(lengths, q.shape[0], k.shape[1], q.device)
    if _on_cpu(q, k, v):
        return ref.flash_decode_ref(q, k, v, lengths, bkv=bkv, scale=scale)
    return _fa.flash_decode(q.contiguous(), k.contiguous(), v.contiguous(),
                            lengths.contiguous(), scale=scale)


def flash_decode_proj(q, k, v, wo, lengths=None, *, m_out, k_out, bkv=128,
                      scale=1.0):
    """Block-fused batched decode attention: one launch computes
    softmax(q k^T) v AND the adapt-cycled output projection ``wo`` for
    every request in the batch.

    q: [B, sq, d], k, v: [B, skv, d], wo: [k_out, n_out] shared across
    requests, lengths: [B] or [B, 1] true KV lengths.  Each request's
    [sq, d] context is raveled row-major, cycled to m_out * k_out
    elements and refolded to [m_out, k_out] (the runtime ``adapt``
    head-merge) before the projection.  Returns [B, m_out, n_out].
    ``bkv`` sets the plain version's KV blocks."""
    lengths = _lengths(lengths, q.shape[0], k.shape[1], q.device)
    if _on_cpu(q, k, v, wo):
        return ref.flash_decode_proj_ref(q, k, v, lengths, wo, m_out=m_out,
                                         k_out=k_out, bkv=bkv, scale=scale)
    return _fa.flash_decode_proj(q.contiguous(), k.contiguous(),
                                 v.contiguous(), lengths.contiguous(),
                                 wo.contiguous(), m_out=m_out, k_out=k_out,
                                 scale=scale)


def _pad_rows(x: torch.Tensor, block: int) -> torch.Tensor:
    """Zero-pad dim 1 of ``x`` up to a multiple of ``block``."""
    pad = -x.shape[1] % block
    if not pad:
        return x
    return torch.cat([x, x.new_zeros((x.shape[0], pad, *x.shape[2:]))], 1)


def flash_attention(q, k, v, *, causal=True, bq=128, bkv=128):
    """q, k: [B, S, H, D], v: [B, S, H, Dv] with Dv <= D -> [B, S, H, Dv],
    scale ``D**-0.5``.

    Heads fold into the batch ([B*H, S, D]); query and key sequences are
    zero-padded to the block sizes (``bq``/``bkv``, cut to the largest
    power of two <= S as the JAX wrapper does) with the true key length
    passed as ``kv_len``, so padded keys never contribute.  A narrower v
    (MLA's value heads) is zero-padded to D and the output cut back."""
    b, s, h, d = q.shape
    sk, dv = k.shape[1], v.shape[3]
    if dv > d:
        raise ValueError(f"value width {dv} exceeds the query width {d}")
    if dv < d:
        v = torch.cat([v, v.new_zeros((*v.shape[:3], d - dv))], -1)
    bq_, bkv_ = min(bq, ref._rnd(s)), min(bkv, ref._rnd(sk))

    def fold(x):
        return x.transpose(1, 2).reshape(b * h, x.shape[1], d)
    qf = _pad_rows(fold(q), bq_)
    kf, vf = _pad_rows(fold(k), bkv_), _pad_rows(fold(v), bkv_)
    if _on_cpu(q, k, v):
        o = ref.flash_attention_ref(qf, kf, vf, causal=causal, bq=bq_,
                                    bkv=bkv_, kv_len=sk)
    else:
        o = _fa.flash_attention(qf.contiguous(), kf.contiguous(),
                                vf.contiguous(), causal=causal, kv_len=sk)
    return o[:, :s].reshape(b, h, s, d).transpose(1, 2)[..., :dv]


def mamba_scan(da, dbx, c, h0):
    """The selective scan: da, dbx [B, L, D, N], c [B, L, N], h0 [B, D, N]
    -> (y [B, L, D], h_last [B, D, N]).  The TPU kernel's channel and L
    blocks only tile VMEM, so neither version takes a block size; the
    kernel's state width N is padded with zeros (an inert state) to the
    next width it takes."""
    if _on_cpu(da, dbx, c, h0):
        return ref.mamba_scan_ref(da, dbx, c, h0)
    n = da.shape[-1]
    n_pad = next((w for w in _ms.STATE_WIDTHS if w >= n), n)
    if n_pad != n:
        def pad(x):
            return torch.cat([x, x.new_zeros((*x.shape[:-1], n_pad - n))],
                             -1)
        da, dbx, c, h0 = pad(da), pad(dbx), pad(c), pad(h0)
    y, h_last = _ms.mamba_scan(da.contiguous(), dbx.contiguous(),
                               c.contiguous(), h0.contiguous())
    return y, h_last[..., :n]
