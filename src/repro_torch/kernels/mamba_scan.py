"""Selective scan (the Mamba-1 and Mamba-2 inner recurrence) as a
hand-written CUDA kernel.

``mamba_scan(da, dbx, c, h0)`` launches ``csrc/mamba_scan.cu``:
``h_t = da_t * h_{t-1} + dbx_t`` over [B, D, N] and
``y_t = sum_n c_t[n] * h_t[:, n]``, each state element held by one
thread for the whole sequence (the TPU kernel it replaces is
``repro/kernels/mamba_scan.py``).  Returns (y [B, L, D], h_last [B, D, N]).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

#: the state widths the kernel takes (a channel's elements lie on min(N,
#: 32) lanes of one warp, two a lane at 64)
STATE_WIDTHS = (1, 2, 4, 8, 16, 32, 64)

#: kernel launches since the count was last set to 0
launches = 0

_FN = None


def _fn():
    global _FN
    if _FN is None:
        fn = build.load("mamba_scan").mamba_scan_f32
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def mamba_scan(da: torch.Tensor, dbx: torch.Tensor, c: torch.Tensor,
               h0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """da, dbx [B, L, D, N], c [B, L, N], h0 [B, D, N], fp32 on the card,
    N in :data:`STATE_WIDTHS`; returns (y [B, L, D], h_last [B, D, N])."""
    global launches
    build.check_operand(da, "da", 4)
    build.check_operand(dbx, "dbx", 4)
    build.check_operand(c, "c", 3)
    build.check_operand(h0, "h0", 3)
    b, seq, d, n = da.shape
    if tuple(dbx.shape) != tuple(da.shape) or tuple(c.shape) != (b, seq, n) \
            or tuple(h0.shape) != (b, d, n):
        raise ValueError(f"shapes da {tuple(da.shape)}, dbx "
                         f"{tuple(dbx.shape)}, c {tuple(c.shape)}, h0 "
                         f"{tuple(h0.shape)} do not match")
    if len({t.device for t in (da, dbx, c, h0)}) != 1:
        raise ValueError("da, dbx, c and h0 must share one device")
    if n not in STATE_WIDTHS:
        raise ValueError(f"mamba_scan takes N in {STATE_WIDTHS}, got {n}")
    y = torch.empty((b, seq, d), dtype=torch.float32, device=da.device)
    h_last = torch.empty((b, d, n), dtype=torch.float32, device=da.device)
    with torch.cuda.device(da.device):
        err = _fn()(da.data_ptr(), dbx.data_ptr(), c.data_ptr(),
                    h0.data_ptr(), y.data_ptr(), h_last.data_ptr(), b, seq,
                    d, n, build.stream_handle())
    build.raise_on_error(err, "mamba_scan")
    launches += 1
    return y, h_last
