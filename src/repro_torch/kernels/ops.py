"""Ragged-safe public wrappers around the CUDA kernels.

Each wrapper launches its hand-written kernel for tensors on the card
(raising on anything the kernel does not take) and takes the kernel's
plain PyTorch version (``kernels.ref``) only when every tensor it was
given lies on the CPU -- the counterpart of the JAX package's Pallas
interpret mode.  The kernels mask ragged edges themselves; only
``flash_attention`` pads, as the JAX package's wrapper does, so that
both versions see the same blocks.

``flash_attention`` and ``mamba_scan`` carry gradients.  When one is
wanted (grad mode on and an input that requires it) the raw kernel call
-- and only it -- runs inside a ``torch.autograd.Function``: forward by
the kernel (its plain version on the CPU), backward by the backward
kernel (``flash_attention_bwd``, ``mamba_scan_bwd``; on the CPU their
plain versions).  The head folding, padding and cutting around it are
plain torch ops that autograd differentiates.  There is no fallback: a
backward kernel that fails to build or launch raises.  Without a
gradient the wrappers run exactly as before, the forward kernels'
results bit for bit the same.

On the ``meta`` device the model zoo's three kernel ops (and their
backwards) take ``kernels.meta``: outputs of the right shapes, no data,
and the kernel's reckoned work told to the dry run's tracer.

On a mesh (training with the parameters as DTensors, ``train.trainer``)
``flash_attention``, ``mamba_scan`` and ``mamba_scan_heads`` are given
DTensors at their unfolded shapes.  Each then runs in a
``local_map`` region under its sharding rule (:func:`_rule`): the batch
dim over the data axes and the heads (the scan's channels) over
``"model"``, each only where it divides, as ``dist.sharding.spec_for``
assigns an axis, and replicated where it does not.  Inside the region
the folding, padding, autograd Functions and kernels run unchanged on
each rank's local shard, with no collective: a head (a channel) never
reads another.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.dist import sharding as _sh
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fused_chain as _fc
from repro_torch.kernels import mamba_scan as _ms
from repro_torch.kernels import meta as _meta
from repro_torch.kernels import nest_gemm as _ng
from repro_torch.kernels import ref


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


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
    if _meta.on_meta(q, k, v):
        return _meta.flash_decode(q, k, v)
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


def _rule(mesh, batch: int, channels: int):
    """A kernel op's sharding rule on ``mesh``: ``place(dim)`` gives the
    placements of an operand whose dim 0 is the batch and whose dim
    ``dim`` holds the heads (the scan's channels; None for an operand
    that has none, such as Mamba-1's ``c``).  The batch goes over the
    data axes and the heads over ``"model"``, each only when its size
    divides the axes' (``batch``, ``channels``), as ``spec_for`` assigns
    an axis; a dim that does not divide (kv_heads below the model size,
    a batch below the data size) is replicated, and every rank of that
    axis computes all of it.  ``place(dim, grad=True)`` gives its
    gradient's: an operand with no heads dim, used by every rank's heads,
    gets a partial gradient over ``"model"`` (each rank's heads' part),
    summed where it is used."""
    from torch.distributed.tensor import Partial

    sizes = _sh.mesh_sizes(mesh)
    batch_spec = _sh.leading_spec((batch,), sizes)
    heads = "model" in sizes and channels % sizes["model"] == 0

    def place(dim, grad=False):
        spec = [batch_spec[0] if batch_spec else None]
        if heads and dim is not None:
            spec += [None] * (dim - 1) + ["model"]
        out = _sh.placements(tuple(spec), len(spec), mesh)
        if grad and heads and dim is None:
            out = tuple(Partial() if n == "model" else p
                        for n, p in zip(sizes, out))
        return out
    return place


def _on_mesh(fn, args: tuple, dims: tuple, out_dims: tuple, channels: int):
    """``fn(*args)`` in a ``local_map`` region: ``args`` (DTensors; a plain
    tensor is taken as replicated) redistributed to :func:`_rule`'s
    placements (``dims``: each one's heads dim), ``fn`` run on the local
    shards, its outputs DTensors placed by ``out_dims``."""
    from torch.distributed.tensor.experimental import local_map

    ref = next(a for a in args if _sh.is_dtensor(a))
    args = tuple(_sh.like(a, ref) for a in args)
    mesh = ref.device_mesh
    place = _rule(mesh, ref.shape[0], channels)
    outs = tuple(place(d) for d in out_dims)
    # one output's placements go as a list (a tuple holds one an output)
    return local_map(fn, out_placements=outs if len(outs) > 1
                     else list(outs[0]),
                     in_placements=tuple(place(d) for d in dims),
                     in_grad_placements=tuple(place(d, grad=True)
                                              for d in dims),
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def flash_attention(q, k, v, *, causal=True, bq=128, bkv=128):
    """q, k: [B, S, H, D], v: [B, S, H, Dv] with Dv <= D -> [B, S, H, Dv],
    scale ``D**-0.5``.

    Heads fold into the batch ([B*H, S, D]); query and key sequences are
    zero-padded to the block sizes (``bq``/``bkv``, cut to the largest
    power of two <= S as the JAX wrapper does) with the true key length
    passed as ``kv_len``, so padded keys never contribute.  A narrower v
    (MLA's value heads) is zero-padded to D and the output cut back.
    DTensors run on each rank's batch rows and heads (:func:`_rule`)."""
    fn = functools.partial(_flash_attention, causal=causal, bq=bq, bkv=bkv)
    if any(_sh.is_dtensor(t) for t in (q, k, v)):
        heads = q.shape[2] if k.shape[2] == q.shape[2] == v.shape[2] else 1
        return _on_mesh(fn, (q, k, v), (2, 2, 2), (2,), heads)
    return fn(q, k, v)


def _flash_attention(q, k, v, *, causal, bq, bkv):
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
    if not _on_cpu(qf, kf, vf):
        qf, kf, vf = qf.contiguous(), kf.contiguous(), vf.contiguous()
    o = attention_core(qf, kf, vf, causal=causal, bq=bq_, bkv=bkv_,
                       kv_len=sk)
    return o[:, :s].reshape(b, h, s, d).transpose(1, 2)[..., :dv]


class _FlashAttention(torch.autograd.Function):
    """The folded, padded attention call with its gradient: the forward
    saves its output and log-sum-exp, the backward reads them."""

    @staticmethod
    def forward(ctx, q, k, v, causal, bq, bkv, kv_len):
        if _on_cpu(q, k, v):
            o, lse = ref.flash_attention_ref(q, k, v, causal=causal, bq=bq,
                                             bkv=bkv, kv_len=kv_len,
                                             return_lse=True)
        elif _meta.on_meta(q, k, v):
            o, lse = _meta.flash_attention(q, k, v, causal=causal,
                                           kv_len=kv_len, return_lse=True)
        else:
            o, lse = _fa.flash_attention(q, k, v, causal=causal,
                                         kv_len=kv_len, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.kv_len = causal, kv_len
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if _on_cpu(q, k, v):
            grads = ref.flash_attention_bwd_ref(q, k, v, o, lse, do,
                                                causal=ctx.causal,
                                                kv_len=ctx.kv_len)
        elif _meta.on_meta(q, k, v):
            grads = _meta.flash_attention_bwd(q, k, v, o, lse, do,
                                              causal=ctx.causal,
                                              kv_len=ctx.kv_len)
        else:
            grads = _fa.flash_attention_bwd(q, k, v, o, lse,
                                            do.contiguous(),
                                            causal=ctx.causal,
                                            kv_len=ctx.kv_len)
        return (*grads, None, None, None, None)


def attention_core(qf, kf, vf, *, causal, bq, bkv, kv_len):
    """The attention call on folded, padded [BH, S, D] operands (the
    kernel's own layout): through :class:`_FlashAttention` when a
    gradient is wanted, else the kernel (the plain version on the
    CPU)."""
    if _wants_grad(qf, kf, vf):
        return _FlashAttention.apply(qf, kf, vf, causal, bq, bkv, kv_len)
    if _on_cpu(qf, kf, vf):
        return ref.flash_attention_ref(qf, kf, vf, causal=causal, bq=bq,
                                       bkv=bkv, kv_len=kv_len)
    if _meta.on_meta(qf, kf, vf):
        return _meta.flash_attention(qf, kf, vf, causal=causal,
                                     kv_len=kv_len)
    return _fa.flash_attention(qf, kf, vf, causal=causal, kv_len=kv_len)


class _MambaScan(torch.autograd.Function):
    """The scan with its gradient: the forward also stores the state each
    chunk of ``ref.SCAN_CHUNK`` steps starts from, and the backward
    recomputes each chunk's states from it.  The states go through
    ``save_for_backward``, so that ``torch.utils.checkpoint`` drops them
    with the inputs and rebuilds them in its recompute.  An output whose
    gradient is not wanted (h_last when only y is used) reaches the
    backward as None, not zeros."""

    @staticmethod
    def forward(ctx, da, dbx, c, h0):
        ctx.set_materialize_grads(False)
        if _on_cpu(da, dbx, c, h0):
            y, h_last, states = ref.mamba_scan_ref(da, dbx, c, h0,
                                                   return_states=True)
        elif _meta.on_meta(da, dbx, c, h0):
            y, h_last, states = _meta.mamba_scan(da, dbx, c, h0,
                                                 return_states=True)
        else:
            y, h_last, states = _ms.mamba_scan(da, dbx, c, h0,
                                               return_states=True)
        ctx.save_for_backward(da, dbx, c, h0, states)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        da, dbx, c, h0, states = ctx.saved_tensors
        if dy is None:
            dy = da.new_zeros(da.shape[:3])
        if _on_cpu(da, dbx, c, h0):
            return ref.mamba_scan_bwd_ref(da, dbx, c, h0, dy, dh_last,
                                          states)
        if _meta.on_meta(da, dbx, c, h0):
            return _meta.mamba_scan_bwd(da, dbx, c, h0, dy, dh_last, states)
        return _ms.mamba_scan_bwd(
            da, dbx, c, h0, dy.contiguous(),
            None if dh_last is None else dh_last.contiguous(), states)


def scan_core(da, dbx, c, h0):
    """The scan call: through :class:`_MambaScan` when a gradient is
    wanted, else the kernel (the plain version on the CPU)."""
    if _wants_grad(da, dbx, c, h0):
        return _MambaScan.apply(da, dbx, c, h0)
    if _on_cpu(da, dbx, c, h0):
        return ref.mamba_scan_ref(da, dbx, c, h0)
    if _meta.on_meta(da, dbx, c, h0):
        return _meta.mamba_scan(da, dbx, c, h0)
    return _ms.mamba_scan(da, dbx, c, h0)


def mamba_scan(da, dbx, c, h0):
    """The selective scan: da, dbx [B, L, D, N], c [B, L, N], h0 [B, D, N]
    -> (y [B, L, D], h_last [B, D, N]).  The TPU kernel's channel and L
    blocks only tile VMEM, so neither version takes a block size.  The
    kernel takes N a power of two up to 64 (``mamba_scan.STATE_WIDTHS``);
    a width below 64 that is not one is padded with zeros (an inert
    state) to the next, and one past 64 is refused.  DTensors run on
    each rank's batch rows and channels (:func:`_rule`; ``c`` is
    replicated over ``"model"``)."""
    if any(_sh.is_dtensor(t) for t in (da, dbx, c, h0)):
        return _on_mesh(_mamba_scan, (da, dbx, c, h0), (2, 2, None, 1),
                        (2, 1), da.shape[2])
    return _mamba_scan(da, dbx, c, h0)


def mamba_scan_heads(da, dbx, c, h0):
    """Mamba-2's scan with its heads a dim of their own: da, dbx [B, H,
    L, P, N], c [B, H, L, N], h0 [B, H, P, N] -> (y [B, H, L, P], h_last
    [B, H, P, N]).  The heads fold into the scan's batch ([B*H, L, P,
    N]) for one :func:`mamba_scan`; DTensors fold on each rank, after
    its batch rows and heads are cut (:func:`_rule`)."""
    if any(_sh.is_dtensor(t) for t in (da, dbx, c, h0)):
        return _on_mesh(_mamba_scan_heads, (da, dbx, c, h0), (1, 1, 1, 1),
                        (1, 1), da.shape[1])
    return _mamba_scan_heads(da, dbx, c, h0)


def _mamba_scan_heads(da, dbx, c, h0):
    b, h, l, p, n = da.shape
    y, h_last = _mamba_scan(da.reshape(b * h, l, p, n),
                            dbx.reshape(b * h, l, p, n),
                            c.reshape(b * h, l, n), h0.reshape(b * h, p, n))
    return y.view(b, h, l, p), h_last.view(b, h, p, n)


def _mamba_scan(da, dbx, c, h0):
    if _on_cpu(da, dbx, c, h0):
        return scan_core(da, dbx, c, h0)
    n = da.shape[-1]
    n_pad = next((w for w in _ms.STATE_WIDTHS if w >= n), n)
    if n_pad != n:
        def pad(x):
            return torch.cat([x, x.new_zeros((*x.shape[:-1], n_pad - n))],
                             -1)
        da, dbx, c, h0 = pad(da), pad(dbx), pad(c), pad(h0)
    y, h_last = scan_core(da.contiguous(), dbx.contiguous(), c.contiguous(),
                          h0.contiguous())
    return y, h_last[..., :n]
