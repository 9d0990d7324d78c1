"""Virtual Neuron (VN) abstraction (paper §IV-A/B).

A VN is the minimal hardware dot-product atom: ``vn_size`` (<= AH)
consecutive elements along the *reduction* rank of an operand.

For a GEMM  O[M, N] = I[M, K] @ W[K, N]:

  I_VN(m, j): j in [0, ceil(K / vn)),  I[m, j*vn:(j+1)*vn]      (reduce K)
  W_VN(r, c): r in [0, ceil(K / vn)),  W[r*vn:(r+1)*vn, c]      (reduce K)
  O_VN(p, q): grouped along Q=N (which is the next layer's reduction rank J)

Out-of-range elements are zero-padded (paper: "implicitly zero-padded").
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


def num_vns(reduction_extent: int, vn_size: int) -> int:
    return math.ceil(reduction_extent / vn_size)


@dataclasses.dataclass(frozen=True)
class VNShape:
    """Logical 2-D VN array: rows = reduction-tile index, cols = free rank."""
    rows: int  # ceil(reduction / vn_size)
    cols: int  # free-rank extent
    vn_size: int

    @property
    def count(self) -> int:
        return self.rows * self.cols


def weight_vn_shape(k: int, n: int, vn_size: int) -> VNShape:
    return VNShape(rows=num_vns(k, vn_size), cols=n, vn_size=vn_size)


def input_vn_shape(m: int, k: int, vn_size: int) -> VNShape:
    # I_VN is indexed (m, j): free rank M, reduction tiles along K=J.
    return VNShape(rows=num_vns(k, vn_size), cols=m, vn_size=vn_size)


def output_vn_shape(m: int, n: int, vn_size: int) -> VNShape:
    # O_VN grouped along Q=N (next layer's reduction rank).
    return VNShape(rows=num_vns(n, vn_size), cols=m, vn_size=vn_size)


# ---------------------------------------------------------------------------
# Dense VN views (numpy; the machine builds these on its device)
# ---------------------------------------------------------------------------

def to_weight_vns(w: np.ndarray, vn_size: int) -> np.ndarray:
    """W[K, N] -> W_VN[rows, N, vn_size] with zero padding along K."""
    k, n = w.shape
    rows = num_vns(k, vn_size)
    pad = rows * vn_size - k
    wp = np.pad(w, ((0, pad), (0, 0)))
    return np.transpose(wp.reshape(rows, vn_size, n), (0, 2, 1))


def to_input_vns(i: np.ndarray, vn_size: int) -> np.ndarray:
    """I[M, K] -> I_VN[rows, M, vn_size] (row index = reduction tile j)."""
    m, k = i.shape
    rows = num_vns(k, vn_size)
    pad = rows * vn_size - k
    ip = np.pad(i, ((0, 0), (0, pad)))
    return np.transpose(ip.reshape(m, rows, vn_size), (1, 0, 2))


def from_output_vns(o_vn: np.ndarray, m: int, n: int) -> np.ndarray:
    """O_VN[rows, M, vn_size] -> O[M, N] (inverse of output grouping)."""
    rows, m_, vn = o_vn.shape
    assert m_ == m
    o = np.transpose(o_vn, (1, 0, 2)).reshape(m, rows * vn)
    return o[:, :n]


def to_output_vns(o: np.ndarray, vn_size: int) -> np.ndarray:
    """O[M, N] -> O_VN[rows, M, vn_size] grouped along N."""
    m, n = o.shape
    rows = num_vns(n, vn_size)
    pad = rows * vn_size - n
    op = np.pad(o, ((0, 0), (0, pad)))
    return np.transpose(op.reshape(m, rows, vn_size), (1, 0, 2))
