"""Batched ragged decode attention as a hand-written CUDA kernel.

``flash_decode(q, k, v, lengths)`` launches ``csrc/flash_decode.cu``: one
launch advances a whole batch of decode requests, each row attending
over its own K/V masked to its own true length, by the online-softmax
recurrence over KV blocks.  Like the TPU kernel it replaces
(``repro/kernels/flash_attention.py``, ``flash_decode``) it applies no
``d**-0.5`` by default: the MINISA GEMM stream's score GEMM carries none.

The file's other two TPU kernels -- the block-fused ``flash_decode_proj``
and the prefill ``flash_attention`` -- are not ported yet.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

#: kernel launches since the count was last set to 0
launches = 0

_FN = None


def _fn():
    global _FN
    if _FN is None:
        fn = build.load("flash_decode").flash_decode_f32
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 \
            + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lengths: torch.Tensor, *,
                 scale: float = 1.0) -> torch.Tensor:
    """q [B, sq, d], k [B, skv, d], v [B, skv, dv], lengths [B] int32
    (each <= skv) on the card; returns [B, sq, dv]."""
    global launches
    build.check_operand(q, "q", 3)
    build.check_operand(k, "k", 3)
    build.check_operand(v, "v", 3)
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
    out = torch.empty((b, sq, dv), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    lengths.data_ptr(), out.data_ptr(), b, sq, skv, d, dv,
                    float(scale), build.stream_handle())
    build.raise_on_error(err, "flash_decode")
    launches += 1
    return out
