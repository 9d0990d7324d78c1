"""Fused chained GEMM: one CUDA launch for a whole MINISA chained segment.

``fused_chain(x, ws, ...)`` launches ``csrc/fused_chain.cu``:
``act_{L-1}(... act_0(X @ W_0) ... @ W_{L-1})`` with every interior
activation kept in the block (the TPU megakernel it replaces is
``repro/kernels/fused_chain.py``).  Each layer sums its own K tiles of
``bks[l]``, applies its activation at the last tile (elementwise, or
row-wise: softmax, rmsnorm, layernorm -- a block holds full output rows),
and commits to the slab the next layer reads.  ``adapts[l]`` lowers the
runtime's head-split/merge glue before layer ``l`` to a static index map
on the slab, which needs every row in one block.

The launch geometry is the TPU kernel's (:func:`geometry`): one block per
M block of ``bm`` rows, the slab ``(bm, k_slab)`` and the accumulator
``(bm, n_max)`` in shared memory when they fit :data:`SMEM_LIMIT`, else
in a global scratch buffer allocated here (:func:`placement` says which).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

#: activation name -> the kernel's code
ACT_CODES = {None: 0, "relu": 1, "gelu": 2, "silu": 3, "softmax": 4,
             "rmsnorm": 5, "layernorm": 6}

#: shared memory the kernel allows itself for slab + accumulator
SMEM_LIMIT = 200 * 1024
MAX_LAYERS = 16

#: kernel launches since the count was last set to 0
launches = 0

_FN = None


def _fn():
    global _FN
    if _FN is None:
        fn = build.load("fused_chain").fused_chain_f32
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def geometry(dims, bm: int, bks, adapts):
    """The TPU kernel's launch geometry for true per-layer ``dims``:
    (bm, n_m blocks, clamped bks, k_slab, n_max)."""
    bks = tuple(max(1, min(bk, d[1])) for bk, d in zip(bks, dims))
    padded_ks = tuple(-(-d[1] // bk) * bk for d, bk in zip(dims, bks))
    m0 = dims[0][0]
    if any(adapts):
        bm = max(bm, max(d[0] for d in dims))
        n_m = 1
    else:
        bm = max(1, min(bm, m0))
        n_m = -(-m0 // bm)
    k_slab = max(padded_ks[1:] or (1,))
    n_max = max(d[2] for d in dims)
    return bm, n_m, bks, k_slab, n_max


def placement(bm: int, k_slab: int, n_max: int) -> str:
    """Where the slab and accumulator live: "shared" or "global"."""
    return "shared" if 4 * bm * (k_slab + n_max) <= SMEM_LIMIT else "global"


def fused_chain(x: torch.Tensor, ws, *, bm: int, bks, acts, adapts=None,
                dims=None) -> torch.Tensor:
    """One launch of the chain on the card; returns [m_out, n_out]."""
    global launches
    n_layers = len(ws)
    if not 1 <= n_layers <= MAX_LAYERS:
        raise ValueError(f"fused_chain takes 1..{MAX_LAYERS} layers, "
                         f"got {n_layers}")
    if adapts is None:
        adapts = (False,) * n_layers
    if dims is None:
        dims = tuple((x.shape[0], w.shape[0], w.shape[1]) for w in ws)
    if not (len(bks) == len(acts) == len(adapts) == len(dims) == n_layers):
        raise ValueError("bks, acts, adapts and dims need one entry per "
                         "layer")
    if adapts[0]:
        raise ValueError("layer 0 reads the host input, not the slab")
    build.check_operand(x, "x", 2)
    if tuple(x.shape) != tuple(dims[0][:2]):
        raise ValueError(f"x is {tuple(x.shape)}, layer 0 expects "
                         f"{tuple(dims[0][:2])}")
    for l, (w, d) in enumerate(zip(ws, dims)):
        build.check_operand(w, f"ws[{l}]", 2)
        if w.device != x.device or tuple(w.shape) != tuple(d[1:]):
            raise ValueError(f"ws[{l}] is {tuple(w.shape)} on {w.device}, "
                             f"expected {tuple(d[1:])} on {x.device}")
        if l and not adapts[l] and d[1] != dims[l - 1][2]:
            raise ValueError(f"chain shape mismatch at layer {l}")
        if acts[l] not in ACT_CODES:
            raise ValueError(f"unknown activation {acts[l]!r}")
    bm, n_m, bks, k_slab, n_max = geometry(dims, bm, bks, adapts)
    use_smem = placement(bm, k_slab, n_max) == "shared"
    m_out, n_out = dims[-1][0], dims[-1][2]
    out = torch.empty((m_out, n_out), dtype=torch.float32, device=x.device)
    scratch = torch.empty(0 if use_smem else n_m * bm * (k_slab + n_max),
                          dtype=torch.float32, device=x.device)
    w_ptrs = (ctypes.c_void_p * n_layers)(*[w.data_ptr() for w in ws])
    flat = [v for d in dims for v in d]
    with torch.cuda.device(x.device):
        err = _fn()(
            x.data_ptr(), w_ptrs, (ctypes.c_int * len(flat))(*flat),
            (ctypes.c_int * n_layers)(*bks),
            (ctypes.c_int * n_layers)(*[ACT_CODES[a] for a in acts]),
            (ctypes.c_int * n_layers)(*[int(bool(a)) for a in adapts]),
            n_layers, out.data_ptr(),
            scratch.data_ptr() if scratch.numel() else None,
            n_m, bm, k_slab, n_max, m_out, int(use_smem),
            build.stream_handle())
    build.raise_on_error(err, "fused_chain")
    launches += 1
    return out
