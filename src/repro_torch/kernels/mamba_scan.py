"""Selective scan (the Mamba-1 and Mamba-2 inner recurrence) as a
hand-written CUDA kernel.

``mamba_scan(da, dbx, c, h0)`` launches ``csrc/mamba_scan.cu``:
``h_t = da_t * h_{t-1} + dbx_t`` over [B, D, N] and
``y_t = sum_n c_t[n] * h_t[:, n]``, each state element held by one
thread for the whole sequence (the TPU kernel it replaces is
``repro/kernels/mamba_scan.py``).  Returns (y [B, L, D], h_last [B, D, N]);
with ``return_states`` also the state each chunk of ``ref.SCAN_CHUNK``
steps starts from, for the backward (y and h_last the same bits).

``mamba_scan_bwd(da, dbx, c, h0, dy, dh_last, states)`` launches
``csrc/mamba_scan_bwd.cu``: the gradients (dda, ddbx, dc, dh0) by the
reverse recurrence over each chunk's states, recomputed from the
forward's stored ones, with dc's sum over D in a fixed order (the TPU
kernel has no backward; the JAX package differentiates its chunked scan
by autodiff).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

#: the state widths the kernel takes (a channel's elements lie on min(N,
#: 32) lanes of one warp, two a lane at 64)
STATE_WIDTHS = (1, 2, 4, 8, 16, 32, 64)

#: kernel launches since the count was last set to 0
launches = 0                 # mamba_scan
bwd_launches = 0             # mamba_scan_bwd

_FN = None
_BWD = None


def _fn():
    global _FN
    if _FN is None:
        lib = build.load("mamba_scan")
        _check_chunk(lib.mamba_scan_chunk(), "mamba_scan")
        fn = lib.mamba_scan_f32
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _check_chunk(chunk: int, kernel: str) -> None:
    """The kernels store and read a state every ``ref.SCAN_CHUNK`` steps."""
    if chunk != ref.SCAN_CHUNK:
        raise RuntimeError(f"{kernel} stores a state every {chunk} steps, "
                           f"not {ref.SCAN_CHUNK}")


def _states_shape(b: int, seq: int, d: int, n: int) -> tuple:
    return (b, -(-seq // ref.SCAN_CHUNK), d, n)


def _check(da, dbx, c, h0):
    """The checks both scan kernels make; returns (B, L, D, N)."""
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
    return b, seq, d, n


def mamba_scan(da: torch.Tensor, dbx: torch.Tensor, c: torch.Tensor,
               h0: torch.Tensor, *, return_states: bool = False):
    """da, dbx [B, L, D, N], c [B, L, N], h0 [B, D, N], fp32 on the card,
    N in :data:`STATE_WIDTHS`; returns (y [B, L, D], h_last [B, D, N]).
    With ``return_states`` returns (y, h_last, states), states [B,
    ceil(L / SCAN_CHUNK), D, N] the state each chunk starts from (h0,
    h_15, h_31, ...); y and h_last are the same either way."""
    global launches
    b, seq, d, n = _check(da, dbx, c, h0)
    kw = dict(dtype=torch.float32, device=da.device)
    y = torch.empty((b, seq, d), **kw)
    h_last = torch.empty((b, d, n), **kw)
    states = (torch.empty(_states_shape(b, seq, d, n), **kw)
              if return_states else None)
    with torch.cuda.device(da.device):
        err = _fn()(da.data_ptr(), dbx.data_ptr(), c.data_ptr(),
                    h0.data_ptr(), y.data_ptr(), h_last.data_ptr(),
                    None if states is None else states.data_ptr(), b, seq,
                    d, n, build.stream_handle())
    build.raise_on_error(err, "mamba_scan")
    launches += 1
    return (y, h_last, states) if return_states else (y, h_last)


def _bwd():
    global _BWD
    if _BWD is None:
        lib = build.load("mamba_scan_bwd")
        _check_chunk(lib.mamba_scan_bwd_chunk(), "mamba_scan_bwd")
        fn = lib.mamba_scan_bwd_f32
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.mamba_scan_bwd_blocks.argtypes = [ctypes.c_int] * 2
        lib.mamba_scan_bwd_blocks.restype = ctypes.c_int
        _BWD = lib
    return _BWD


def mamba_scan_bwd(da: torch.Tensor, dbx: torch.Tensor, c: torch.Tensor,
                   h0: torch.Tensor, dy: torch.Tensor,
                   dh_last: torch.Tensor | None = None,
                   states: torch.Tensor | None = None):
    """The gradients of :func:`mamba_scan`: its inputs, and the gradients
    of its outputs, dy [B, L, D] and dh_last [B, D, N] (None: zero), fp32
    on the card; ``states`` the forward's (``return_states``; None: the
    forward kernel runs first to store them, one launch of
    :func:`mamba_scan`).  Returns (dda, ddbx [B, L, D, N], dc [B, L, N],
    dh0 [B, D, N]).  Two launches (the scan, then dc's partials added in
    block order), counted as one call; two calls give the same bits."""
    global bwd_launches
    b, seq, d, n = _check(da, dbx, c, h0)
    build.check_operand(dy, "dy", 3)
    if tuple(dy.shape) != (b, seq, d):
        raise ValueError(f"dy {tuple(dy.shape)} is not {(b, seq, d)}")
    if dh_last is not None:
        build.check_operand(dh_last, "dh_last", 3)
        if tuple(dh_last.shape) != (b, d, n):
            raise ValueError(f"dh_last {tuple(dh_last.shape)} is not "
                             f"{(b, d, n)}")
    if states is None:
        states = mamba_scan(da, dbx, c, h0, return_states=True)[2]
    build.check_operand(states, "states", 4)
    if tuple(states.shape) != _states_shape(b, seq, d, n):
        raise ValueError(f"states {tuple(states.shape)} is not "
                         f"{_states_shape(b, seq, d, n)}")
    if len({t.device for t in (da, dy, states) + (
            () if dh_last is None else (dh_last,))}) != 1:
        raise ValueError("the inputs and gradients must share one device")
    lib = _bwd()
    blocks = lib.mamba_scan_bwd_blocks(d, n)
    kw = dict(dtype=torch.float32, device=da.device)
    dda, ddbx = torch.empty_like(da), torch.empty_like(dbx)
    dc, dh0 = torch.empty((b, seq, n), **kw), torch.empty((b, d, n), **kw)
    dc_part = torch.empty((b, blocks, seq, n), **kw)
    with torch.cuda.device(da.device):
        err = lib.mamba_scan_bwd_f32(
            da.data_ptr(), dbx.data_ptr(), c.data_ptr(), states.data_ptr(),
            dy.data_ptr(), None if dh_last is None else dh_last.data_ptr(),
            dda.data_ptr(), ddbx.data_ptr(), dc.data_ptr(), dh0.data_ptr(),
            dc_part.data_ptr(), b, seq, d, n, build.stream_handle())
    build.raise_on_error(err, "mamba_scan_bwd")
    bwd_launches += 1
    return dda, ddbx, dc, dh0
