"""The kernel ops on the ``meta`` device: outputs of the kernel's shapes
and dtypes, no data, and the work the kernel would do reckoned as
``chip_smoke.py`` reckons its bound.

``kernels.ops`` takes these when every tensor a wrapper is given lies on
``meta`` (the dry run traces whole models there: the plain versions loop
over blocks in Python, far too slowly at 32k tokens, and the kernels
need a card).  Each call tells every sink in :data:`SINKS` its
``(name, flops, nbytes)``: the flops of the kernel's products (a
softmax's or a scan's elementwise work as its bound counts it) and the
bytes of its inputs read once and its outputs written once.  Where the
work depends on data a ``meta`` tensor does not hold (decode's true KV
lengths), the whole cache is counted.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.ref import SCAN_CHUNK

#: callables ``sink(name, flops, nbytes)``; ``launch.graph_analysis``
#: adds one while it traces
SINKS: list = []


def on_meta(*tensors) -> bool:
    return all(t.device.type == "meta" for t in tensors)


def counted(run, reckon, *tensors, **kw):
    """``run()``, a kernel op's plain version on real tensors.  While a
    tracer listens (:data:`SINKS`), the ops it dispatches are hidden from
    the tracer and the kernel's work is reckoned instead, as on ``meta``:
    ``reckon`` (this module's function of the op) on ``meta`` twins of
    ``tensors`` with ``kw``.  So a step run for real counts what its
    trace on ``meta`` counts."""
    if not SINKS:
        return run()
    from torch.utils._python_dispatch import _disable_current_modes

    with _disable_current_modes():
        out = run()
        reckon(*(None if t is None else t.to("meta") for t in tensors), **kw)
    return out


def _reckon(name: str, flops: float, inputs, outputs) -> None:
    nbytes = sum(t.numel() * t.element_size()
                 for t in (*inputs, *outputs) if t is not None)
    for sink in SINKS:
        sink(name, float(flops), float(nbytes))


def _pairs(sq: int, sk: int, causal: bool, kv_len: int) -> int:
    """(query, key) pairs that attend: keys below ``kv_len`` and, causal,
    at or before the query's position."""
    keys = min(kv_len, sk)
    if not causal:
        return sq * keys
    inside = min(sq, keys)           # rows whose keys grow with them
    return inside * (inside + 1) // 2 + (sq - inside) * keys


def flash_attention(q, k, v, *, causal: bool, kv_len: int,
                    return_lse: bool = False):
    """q, k [BH, S, d], v [BH, S_kv, dv] -> o [BH, S, dv] in q's dtype
    (and lse [BH, S] fp32): two products over the attending pairs."""
    bh, sq, d = q.shape
    dv = v.shape[2]
    o = q.new_empty((bh, sq, dv))
    lse = q.new_empty((bh, sq), dtype=torch.float32) if return_lse else None
    pairs = bh * _pairs(sq, k.shape[1], causal, kv_len)
    _reckon("flash_attention", 2.0 * pairs * (d + dv), (q, k, v), (o, lse))
    return (o, lse) if return_lse else o


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool, kv_len: int):
    """(dq, dk, dv) in their inputs' dtypes: five products over the
    attending pairs."""
    grads = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
    pairs = q.shape[0] * _pairs(q.shape[1], k.shape[1], causal, kv_len)
    _reckon("flash_attention_bwd", 5 * 2.0 * pairs * q.shape[2],
            (q, k, v, o, lse, do), grads)
    return grads


def flash_decode(q, k, v):
    """q [B, sq, d], k [B, S_kv, d], v [B, S_kv, dv] -> [B, sq, dv]:
    every cached key counted."""
    b, sq, d = q.shape
    dv = v.shape[2]
    out = q.new_empty((b, sq, dv))
    _reckon("flash_decode", 2.0 * b * sq * k.shape[1] * (d + dv),
            (q, k, v), (out,))
    return out


def mamba_scan(da, dbx, c, h0, *, return_states: bool = False):
    """(y [B, L, D], h_last [B, D, N]) fp32, with ``return_states`` the
    chunk states [B, ceil(L / 16), D, N]: four flops a state element a
    step."""
    b, seq, d, n = da.shape
    f32 = dict(dtype=torch.float32)
    y, h_last = da.new_empty((b, seq, d), **f32), da.new_empty((b, d, n),
                                                                **f32)
    states = (da.new_empty((b, math.ceil(seq / SCAN_CHUNK), d, n), **f32)
              if return_states else None)
    _reckon("mamba_scan", 4.0 * b * seq * d * n, (da, dbx, c, h0),
            (y, h_last, states))
    return (y, h_last, states) if return_states else (y, h_last)


def mamba_scan_bwd(da, dbx, c, h0, dy, dh_last, states):
    """(dda, ddbx, dc, dh0) fp32: six flops a state element a step."""
    b, seq, d, n = da.shape
    f32 = dict(dtype=torch.float32)
    grads = (da.new_empty(da.shape, **f32), da.new_empty(da.shape, **f32),
             da.new_empty(c.shape, **f32), da.new_empty(h0.shape, **f32))
    _reckon("mamba_scan_bwd", 6.0 * b * seq * d * n,
            (da, dbx, c, h0, dy, dh_last, states), grads)
    return grads
