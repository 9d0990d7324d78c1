"""Ragged-safe public wrappers around the CUDA kernels.

Each wrapper launches its hand-written kernel for tensors on the card
(raising on anything the kernel does not take) and takes the kernel's
plain PyTorch version (``kernels.ref``) only when every tensor it was
given lies on the CPU -- the counterpart of the JAX package's Pallas
interpret mode.  The kernels mask ragged edges themselves, so nothing is
padded here.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fused_chain as _fc
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


def flash_decode(q, k, v, lengths=None, *, bkv=128, scale=1.0):
    """Batched decode attention, one launch for the whole batch.

    q: [B, sq, d], k, v: [B, skv, d], lengths: [B] or [B, 1] true KV
    lengths (defaults to the full skv for every request).  ``bkv`` sets
    the plain version's KV blocks."""
    b = q.shape[0]
    sk = k.shape[1]
    if lengths is None:
        lengths = torch.full((b,), sk, dtype=torch.int32)
    lengths = torch.as_tensor(lengths).reshape(b).to(
        device=q.device, dtype=torch.int32)
    if _on_cpu(q, k, v):
        return ref.flash_decode_ref(q, k, v, lengths, bkv=bkv, scale=scale)
    return _fa.flash_decode(q.contiguous(), k.contiguous(), v.contiguous(),
                            lengths.contiguous(), scale=scale)
