"""Attention as hand-written CUDA kernels: the three TPU kernels of
``repro/kernels/flash_attention.py``.

``flash_decode(q, k, v, lengths)`` launches ``csrc/flash_decode.cu``: one
launch advances a whole batch of decode requests, each row attending
over its own K/V masked to its own true length, by the online-softmax
recurrence over KV blocks, on fp32 or bf16 operands with fp32 sums.
Like the TPU kernel it applies no ``d**-0.5`` by default: the MINISA
GEMM stream's score GEMM carries none.  The bf16 route cuts the keys
into ranges by :func:`decode_plan` (skv alone sets them), one block of a
thread-block cluster a range, and merges the ranges' partial results in
rank order (``kernels.ref.flash_decode_split_ref`` is its plain
version); the fp32 route is the kernel of the MINISA serve, unchanged.

``flash_decode_proj(q, k, v, lengths, wo, ...)`` launches
``csrc/flash_decode_proj.cu``: the same attention for every request,
then the runtime ``adapt`` head-merge of each context and its product
with the shared output projection ``wo`` -- attention + Wo for the whole
batch in one launch.

``flash_attention(q, k, v, ...)`` launches ``csrc/flash_attention.cu``:
prefill attention over [BH, S, d], causal or full, scale ``d**-0.5``,
fp32 or bf16 inputs with fp32 sums; with ``return_lse`` it also writes
each row's log-sum-exp, for the backward.

``flash_attention_bwd(q, k, v, o, lse, do, ...)`` launches
``csrc/flash_attention_bwd.cu``: the gradients (dq, dk, dv) of that
attention, from its output and log-sum-exp (the TPU kernel has no
backward; the JAX package differentiates its plain train-path attention
by autodiff).

Each kernel has its own launch counter.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

#: launches of each kernel since its count was last set to 0
launches = 0                 # flash_decode
proj_launches = 0            # flash_decode_proj
attention_launches = 0       # flash_attention
attention_bwd_launches = 0   # flash_attention_bwd

#: shared memory a flash_decode_proj block allows itself (within the
#: 227 KB a block can have)
PROJ_SMEM_LIMIT = 200 * 1024
#: flash_decode_proj's ranks a cluster, its wo ring in floats (9 x 32 x
#: 64) and the projection's part of its scratch (the h window, 8 x 512,
#: and two inboxes of partial sums, 2 x 8 x 64)
#: (``csrc/flash_decode_proj.cu``)
_PROJ_CLUSTER = 4
_PROJ_RING_FLOATS = 9 * 32 * 64
_PROJ_WINDOW_FLOATS = 8 * 512 + 2 * 8 * 64
#: the widest head_dim flash_attention takes
MAX_HEAD_DIM = 256

_FN: dict = {}
_PLAN_FN = None
_PROJ_FN = None
_ATTN_FN = None
_ATTN_BWD_FN = None


#: flash_decode's C entry for each operand type
_DECODE_ENTRIES = {torch.float32: "flash_decode_f32",
                   torch.bfloat16: "flash_decode_bf16"}


def _fn(dtype):
    fn = _FN.get(dtype)
    if fn is None:
        fn = getattr(build.load("flash_decode"), _DECODE_ENTRIES[dtype])
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 \
            + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN[dtype] = fn
    return fn


#: the bf16 route's cut (``csrc/flash_decode.cu``, ``plan``): at most 8
#: ranges (a cluster) of at least 128 keys, each a multiple of 64; chunks
#: of 64 keys, 32 where one of 64 passes 96 KB; as many chunks in flight
#: as fit in 200 KB beside q, P and the row sums (at most 8); a strip of
#: at most 512 columns of v (128 below 16 query rows), padded to 64, 128,
#: 256 or 512
_MAX_SPLITS, _SPLIT_MIN, _SPLIT_ALIGN = 8, 128, 64
_MAX_STRIP, _FEW_ROWS_STRIP = 512, 128
_STAGE_BUDGET, _SMEM_BUDGET, _MAX_STAGES = 96 << 10, 200 << 10, 8
_PLAN_KEYS = ("split", "n_split", "chunk", "stages", "dp", "dvp", "strip",
              "strips", "smem")


def decode_plan(skv: int, d: int, dv: int, sq: int) -> dict:
    """How the bf16 route cuts a launch at (skv, d, dv, sq), whatever the
    batch: ``split`` keys a range and ``n_split`` ranges (the cluster's
    ranks; skv alone sets both), ``chunk`` keys a chunk, ``stages``
    chunks in flight, ``dp`` and ``dvp`` the padded widths, ``strip``
    columns of v a block (``strips`` of them; one of up to 512 where a
    block's 16 rows share their scores, 128 below 16 query rows, where
    each strip scores its one row again), ``smem`` bytes a block (the
    kernel's ``plan``; :func:`decode_plan_on_card` asks the kernel
    itself)."""
    dp = -(-max(d, 1) // 16) * 16
    strip = _FEW_ROWS_STRIP if sq < 16 else _MAX_STRIP
    strips = -(-dv // strip)
    cols = min(dv, strip)
    dvp = next(w for w in (64, 128, 256, 512) if cols <= w)
    n = min(_MAX_SPLITS, -(-skv // _SPLIT_MIN)) if skv > 0 else 1
    split = -(-(-(-max(skv, 1) // n)) // _SPLIT_ALIGN) * _SPLIT_ALIGN
    n_split = -(-skv // split) if skv > 0 else 1

    def stage(kc):
        return 2 * kc * ((dp + 8) + (dvp + 8))
    chunk = 64 if stage(64) <= _STAGE_BUDGET else 32
    fixed = 2 * 16 * ((dp + 8) + (chunk + 8)) + 4 * 2 * 4 * 16
    fit = max(1, (_SMEM_BUDGET - fixed) // stage(chunk))
    stages = min(split // chunk, fit, _MAX_STAGES)
    smem = fixed + max(stage(chunk) * stages, 4 * (16 * dvp + 2 * 16))
    return dict(zip(_PLAN_KEYS, (split, n_split, chunk, stages, dp, dvp,
                                 strip, strips, smem)))


def decode_plan_on_card(skv: int, d: int, dv: int, sq: int) -> dict:
    """:func:`decode_plan` as the built kernel computes it."""
    global _PLAN_FN
    if _PLAN_FN is None:
        fn = build.load("flash_decode").flash_decode_bf16_plan
        fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = None
        _PLAN_FN = fn
    out = (ctypes.c_int * len(_PLAN_KEYS))()
    _PLAN_FN(skv, d, dv, sq, ctypes.cast(out, ctypes.c_void_p))
    return dict(zip(_PLAN_KEYS, list(out)))


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lengths: torch.Tensor, *,
                 scale: float = 1.0) -> torch.Tensor:
    """q [B, sq, d], k [B, skv, d], v [B, skv, dv], all float32 or all
    bfloat16, and lengths [B] int32 (each <= skv) on the card; returns
    [B, sq, dv] in their dtype."""
    global launches
    dtype = q.dtype
    if dtype not in _DECODE_ENTRIES:
        raise ValueError(f"flash_decode takes float32 or bfloat16, got "
                         f"{dtype}")
    build.check_operand(q, "q", 3, dtype)
    build.check_operand(k, "k", 3, dtype)
    build.check_operand(v, "v", 3, dtype)
    build.check_operand(lengths, "lengths", 1, torch.int32)
    b, sq, d = q.shape
    skv = k.shape[1]
    if (k.shape[0], k.shape[2]) != (b, d) or tuple(v.shape[:2]) != (b, skv) \
            or lengths.shape[0] != b:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, lengths "
                         f"{tuple(lengths.shape)} do not match")
    if len({t.device for t in (q, k, v, lengths)}) != 1:
        raise ValueError("q, k, v and lengths must share one device")
    dv = v.shape[2]
    out = torch.empty((b, sq, dv), dtype=dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = _fn(dtype)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         lengths.data_ptr(), out.data_ptr(), b, sq, skv, d,
                         dv, float(scale), build.stream_handle())
    build.raise_on_error(err, "flash_decode")
    launches += 1
    return out


def _proj_fn():
    global _PROJ_FN
    if _PROJ_FN is None:
        fn = build.load("flash_decode_proj").flash_decode_proj_f32
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 \
            + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _PROJ_FN = fn
    return _PROJ_FN


def _proj_tile_keys(d: int, dv: int) -> int:
    """Keys a K/V tile of ``flash_decode_proj`` (the kernel's
    ``tile_keys``): up to 16, the tile within 32 KB."""
    return max(1, min(16, 8192 // (d + dv)))


def proj_group(b: int, sq: int, d: int, dv: int) -> int:
    """How many requests' contexts ``flash_decode_proj`` keeps in its
    clusters' shared memory at once: each of a cluster's ranks holds as
    many as fit beside the wo ring and a scratch that the attention (q
    rows, a K/V tile, scores) and the projection (the h window) share.
    All ``b`` when they fit; raises when a rank cannot hold even one."""
    attention = sq * d + _proj_tile_keys(d, dv) * (d + dv) + sq * (16 + 3)
    scratch = -(-max(attention, _PROJ_WINDOW_FLOATS) // 4) * 4
    fit = (PROJ_SMEM_LIMIT // 4 - _PROJ_RING_FLOATS - scratch) // (sq * dv)
    if fit < 1:
        raise ValueError(f"flash_decode_proj: one context [{sq}, {dv}] with "
                         f"q [{sq}, {d}] exceeds {PROJ_SMEM_LIMIT} bytes of "
                         f"shared memory")
    return min(b, _PROJ_CLUSTER * fit)


def flash_decode_proj(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      lengths: torch.Tensor, wo: torch.Tensor, *,
                      m_out: int, k_out: int,
                      scale: float = 1.0) -> torch.Tensor:
    """q [B, sq, d], k [B, skv, d], v [B, skv, dv], lengths [B] int32,
    wo [k_out, n_out] on the card; returns [B, m_out, n_out]: each
    request's context adapted to [m_out, k_out] and multiplied by wo."""
    global proj_launches
    build.check_operand(q, "q", 3)
    build.check_operand(k, "k", 3)
    build.check_operand(v, "v", 3)
    build.check_operand(lengths, "lengths", 1, torch.int32)
    build.check_operand(wo, "wo", 2)
    b, sq, d = q.shape
    skv = k.shape[1]
    if (k.shape[0], k.shape[2]) != (b, d) or tuple(v.shape[:2]) != (b, skv) \
            or lengths.shape[0] != b or wo.shape[0] != k_out:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, lengths "
                         f"{tuple(lengths.shape)}, wo {tuple(wo.shape)} "
                         f"(k_out {k_out}) do not match")
    if len({t.device for t in (q, k, v, lengths, wo)}) != 1:
        raise ValueError("q, k, v, lengths and wo must share one device")
    if m_out < 1 or k_out < 1 or sq < 1:
        raise ValueError(f"m_out {m_out}, k_out {k_out} and sq {sq} must "
                         f"be positive")
    dv, n_out = v.shape[2], wo.shape[1]
    group = proj_group(b, sq, d, dv)
    out = torch.empty((b, m_out, n_out), dtype=torch.float32,
                      device=q.device)
    with torch.cuda.device(q.device):
        err = _proj_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         lengths.data_ptr(), wo.data_ptr(), out.data_ptr(),
                         b, sq, skv, d, dv, m_out, k_out, n_out, group,
                         float(scale), build.stream_handle())
    build.raise_on_error(err, "flash_decode_proj")
    proj_launches += 1
    return out


def _attn_fn():
    global _ATTN_FN
    if _ATTN_FN is None:
        fn = build.load("flash_attention").flash_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 \
            + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _ATTN_FN = fn
    return _ATTN_FN


def _check_attention(q, k, v, kv_len):
    """The checks both attention kernels make; returns kv_len (default
    S_kv)."""
    dtype = q.dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention takes float32 or bfloat16, got "
                         f"{dtype}")
    build.check_operand(q, "q", 3, dtype)
    build.check_operand(k, "k", 3, dtype)
    build.check_operand(v, "v", 3, dtype)
    bh, s, d = q.shape
    sk = k.shape[1]
    if (k.shape[0], k.shape[2]) != (bh, d) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if len({t.device for t in (q, k, v)}) != 1:
        raise ValueError("q, k and v must share one device")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention takes head_dim 1..{MAX_HEAD_DIM},"
                         f" got {d}")
    kv_len = sk if kv_len is None else kv_len
    if not 0 <= kv_len <= sk:
        raise ValueError(f"kv_len {kv_len} outside 0..{sk}")
    return kv_len


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, kv_len: int | None = None,
                    return_lse: bool = False):
    """q [BH, S, d], k and v [BH, S_kv, d] on the card, all float32 or all
    bfloat16; returns [BH, S, d] in their dtype, scaled by ``d**-0.5``.
    Keys at or past ``kv_len`` (default S_kv) are masked.  With
    ``return_lse`` returns (out, lse), lse [BH, S] fp32 each row's
    log-sum-exp of its scaled scores (+inf where every key is masked);
    ``out`` is the same either way."""
    global attention_launches
    kv_len = _check_attention(q, k, v, kv_len)
    bh, s, d = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((bh, s), dtype=torch.float32, device=q.device)
           if return_lse else None)
    with torch.cuda.device(q.device):
        err = _attn_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), None if lse is None else
                         lse.data_ptr(), bh, s, k.shape[1], d, kv_len,
                         int(causal), int(q.dtype == torch.bfloat16),
                         d ** -0.5, build.stream_handle())
    build.raise_on_error(err, "flash_attention")
    attention_launches += 1
    return (out, lse) if return_lse else out


def _attn_bwd_fn():
    global _ATTN_BWD_FN
    if _ATTN_BWD_FN is None:
        fn = build.load("flash_attention_bwd").flash_attention_bwd
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 \
            + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _ATTN_BWD_FN = fn
    return _ATTN_BWD_FN


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool = True, kv_len: int | None = None):
    """The gradients of :func:`flash_attention`: q, k, v as it took them,
    its output ``o`` and log-sum-exp ``lse`` [BH, S] fp32, and the
    output's gradient ``do`` (o's shape and dtype), on the card; returns
    (dq, dk, dv) in the inputs' dtype.  Two launches (dQ with D =
    rowsum(dO * O), then dK and dV), counted as one call."""
    global attention_bwd_launches
    kv_len = _check_attention(q, k, v, kv_len)
    build.check_operand(o, "o", 3, q.dtype)
    build.check_operand(do, "do", 3, q.dtype)
    build.check_operand(lse, "lse", 2)
    bh, s, d = q.shape
    if tuple(o.shape) != tuple(q.shape) or tuple(do.shape) != tuple(q.shape) \
            or tuple(lse.shape) != (bh, s):
        raise ValueError(f"shapes q {tuple(q.shape)}, o {tuple(o.shape)}, "
                         f"do {tuple(do.shape)}, lse {tuple(lse.shape)} do "
                         f"not match")
    if len({t.device for t in (q, k, v, o, lse, do)}) != 1:
        raise ValueError("q, k, v, o, lse and do must share one device")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    dsum = torch.empty((bh, s), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _attn_bwd_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             o.data_ptr(), lse.data_ptr(), do.data_ptr(),
                             dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                             dsum.data_ptr(), bh, s, k.shape[1], d, kv_len,
                             int(causal), int(q.dtype == torch.bfloat16),
                             d ** -0.5, build.stream_handle())
    build.raise_on_error(err, "flash_attention_bwd")
    attention_bwd_launches += 1
    return dq, dk, dv
