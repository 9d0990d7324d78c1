"""Operations and bytes of one call of each kernel op, from its shapes.

Conventions (the same as the bound column of ``PERF.md``'s kernel
table): each input byte counts once as read and each output byte once as
written, whatever a kernel reads again; an input that is a broadcast view
(a stride of 0) counts only the bytes it holds (:func:`held_bytes`);
causal masks and ragged lengths count only the (query, key) pairs these
inputs need.  A product of m x k by k x n counts 2mkn operations.  The
attention backward counts five products over the attending pairs
(S = QK^T, dP = dO V^T, dV = P^T dO, dQ = dS K, dK = dS^T Q); the scan
four operations a state element a step forward and six backward.
"""

from __future__ import annotations

import math

#: the steps a scan's stored state covers (``kernels.ref.SCAN_CHUNK``)
SCAN_CHUNK = 16


def held_bytes(shape, stride, element_size: int) -> int:
    """Bytes a tensor of ``shape`` and ``stride`` holds: its broadcast
    dims (stride 0) counted once."""
    return element_size * math.prod(n for n, s in zip(shape, stride)
                                    if s != 0 or n == 1)


def attending_pairs(sq: int, sk: int, causal: bool, kv_len: int) -> int:
    """(query, key) pairs that attend in one sequence: keys below
    ``kv_len`` and, causal, at or before the query's position."""
    keys = min(kv_len, sk)
    if not causal:
        return sq * keys
    inside = min(sq, keys)
    return inside * (inside + 1) // 2 + (sq - inside) * keys


def flash_attention(bh: int, sq: int, sk: int, d: int, dv: int, *,
                    causal: bool, elt: int, lse: bool,
                    kv_len: int | None = None) -> tuple[float, float]:
    """(flops, bytes) of the forward over ``bh`` folded heads: q, k
    [sq|sk, d], v [sk, dv] read, o [sq, dv] (and the fp32 log-sum-exp)
    written."""
    pairs = bh * attending_pairs(sq, sk, causal, sk if kv_len is None
                                 else kv_len)
    nbytes = elt * bh * (sq * d + sk * d + sk * dv + sq * dv) \
        + (4 * bh * sq if lse else 0)
    return 2.0 * pairs * (d + dv), float(nbytes)


def flash_attention_bwd(bh: int, sq: int, sk: int, d: int, dv: int, *,
                        causal: bool, elt: int,
                        kv_len: int | None = None) -> tuple[float, float]:
    """(flops, bytes) of the backward: q, k, v, o, dO and the fp32
    log-sum-exp read, dq, dk, dv written; five products."""
    pairs = bh * attending_pairs(sq, sk, causal, sk if kv_len is None
                                 else kv_len)
    nbytes = elt * bh * 2 * (sq * d + sk * d + sk * dv + sq * dv) \
        + 4 * bh * sq
    return 2.0 * pairs * (3 * d + 2 * dv), float(nbytes)


def flash_decode(b: int, sq: int, d: int, dv: int, used_rows: int, *,
                 elt: int) -> tuple[float, float]:
    """(flops, bytes) of a decode attention over ``b`` rows of ``sq``
    queries, ``used_rows`` cached keys in all (the sum of the lengths):
    q read, the keys [d] and values [dv] the lengths need read, the output
    written, the int32 lengths read."""
    nbytes = elt * (b * sq * d + used_rows * (d + dv) + b * sq * dv) + 4 * b
    return 2.0 * sq * used_rows * (d + dv), float(nbytes)


def mamba_scan(b: int, seq: int, d: int, n: int, *, in_bytes: int,
               states: bool) -> tuple[float, float]:
    """(flops, bytes) of the scan forward over ``b`` rows: ``in_bytes``
    the bytes its inputs (da, dbx, c, h0) hold; y [seq, d], h_last [d, n]
    and, with ``states``, the state every ``SCAN_CHUNK`` steps written,
    fp32."""
    out = b * seq * d + b * d * n
    if states:
        out += b * math.ceil(seq / SCAN_CHUNK) * d * n
    return 4.0 * b * seq * d * n, float(in_bytes + 4 * out)


def mamba_scan_bwd(b: int, seq: int, d: int, n: int, *, da_bytes: int,
                   dbx_bytes: int) -> tuple[float, float]:
    """(flops, bytes) of the scan backward: da (``da_bytes`` held), dbx,
    c, the stored states and dy read; dda, ddbx [seq, d, n], dc and dh0
    written, fp32."""
    states = b * math.ceil(seq / SCAN_CHUNK) * d * n
    read = da_bytes + dbx_bytes + 4 * (b * seq * n + states + b * seq * d)
    written = 4 * (2 * b * seq * d * n + b * seq * n + b * d * n)
    return 6.0 * b * seq * d * n, float(read + written)
