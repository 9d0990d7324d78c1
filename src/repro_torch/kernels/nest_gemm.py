"""NEST GEMM: the paper's compute atom as a hand-written CUDA kernel.

``nest_gemm(x, w)`` launches ``csrc/nest_gemm.cu`` on the current stream:
``act(X[M, K] @ W[K, N])`` in full fp32, with the activation (relu,
tanh-gelu, silu) applied at the store and, with ``out_block_t``, the
(N, M) transposed output stored directly -- the IO-S output relayout of
the TPU kernel (``repro/kernels/nest_gemm.py``).  Every output's K sum
runs in an order that depends on K alone, so a row stacked into a decode
batch is bit-equal to the same row launched alone.

``backends.cuda_backend`` compiles lowered Programs onto this kernel
through the ragged-safe wrapper ``kernels.ops.nest_gemm``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

#: activation name -> the kernel's code
ACT_CODES = {None: 0, "relu": 1, "gelu": 2, "silu": 3}

#: kernel launches since the count was last set to 0 (two for a call on
#: the wide-weight path: the X relayout, then the GEMM)
launches = 0

#: the wide-weight path's geometry (``csrc/nest_gemm.cu``): rows a block,
#: the K groups, and the first N it takes
WIDE_ROWS, GROUPS, WIDE_N = 32, 64, 8192

_FN = None


def _fn():
    global _FN
    if _FN is None:
        fn = build.load("nest_gemm").nest_gemm_f32
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p, ctypes.c_longlong,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def scratch_floats(m: int, k: int, n: int, w_ptr: int) -> int:
    """Floats of scratch the kernel needs: X laid out group-major where
    the wide-weight path runs (more than 16 rows, N >= 8192, N % 4 == 0
    and w 16-byte aligned), else 0.  A group's k are padded to whole
    chunks of 48 where they divide by 48, else of 16."""
    if m <= 16 or n < WIDE_N or n % 4 or w_ptr % 16:
        return 0
    jg = -(-k // GROUPS)
    j = 48 if jg and jg % 48 == 0 else 16
    jp = -(-jg // j) * j if jg else j
    return -(-m // WIDE_ROWS) * GROUPS * jp * WIDE_ROWS


def nest_gemm(x: torch.Tensor, w: torch.Tensor, *,
              out_block_t: bool = False,
              act: str | None = None) -> torch.Tensor:
    """O = act(X[M, K] @ W[K, N]) on the card; (N, M) with out_block_t."""
    global launches
    build.check_operand(x, "x", 2)
    build.check_operand(w, "w", 2)
    if x.device != w.device:
        raise ValueError(f"x on {x.device}, w on {w.device}")
    m, k = x.shape
    k2, n = w.shape
    if k != k2:
        raise ValueError(f"inner dims differ: {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    if act not in ACT_CODES:
        raise ValueError(f"unknown activation {act!r}")
    out = torch.empty((n, m) if out_block_t else (m, n),
                      dtype=torch.float32, device=x.device)
    n_scratch = scratch_floats(m, k, n, w.data_ptr())
    scratch = (torch.empty(n_scratch, dtype=torch.float32, device=x.device)
               if n_scratch else None)
    with torch.cuda.device(x.device):
        err = _fn()(x.data_ptr(), w.data_ptr(), out.data_ptr(), m, k, n,
                    int(out_block_t), ACT_CODES[act],
                    scratch.data_ptr() if n_scratch else None, n_scratch,
                    build.stream_handle())
    build.raise_on_error(err, "nest_gemm")
    if m and n:
        launches += 2 if n_scratch else 1
    return out
