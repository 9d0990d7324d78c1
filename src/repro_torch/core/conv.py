"""Convolution -> GEMM lowering via im2col (paper Fig. 1).

The paper's workload model: "Convolution is converted to MatMul via
im2col"; the artifact's search handles "GEMM/conv." uniformly.  This
module provides the shape-level lowering used by the mapper/planner and a
functional im2col for end-to-end validation through the FEATHER+ machine.

Conv2D: input [N, H, W, C_in], kernel [KH, KW, C_in, C_out], stride s,
'SAME'/'VALID' padding  ->  GEMM  [N*OH*OW, KH*KW*C_in] x
[KH*KW*C_in, C_out].
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.mapper import Gemm


@dataclasses.dataclass(frozen=True)
class Conv2D:
    n: int
    h: int
    w: int
    c_in: int
    kh: int
    kw: int
    c_out: int
    stride: int = 1
    padding: str = "SAME"
    name: str = ""

    @property
    def out_hw(self) -> tuple[int, int]:
        if self.padding == "SAME":
            oh = math.ceil(self.h / self.stride)
            ow = math.ceil(self.w / self.stride)
        else:
            oh = (self.h - self.kh) // self.stride + 1
            ow = (self.w - self.kw) // self.stride + 1
        return oh, ow

    def to_gemm(self) -> Gemm:
        oh, ow = self.out_hw
        return Gemm(m=self.n * oh * ow, k=self.kh * self.kw * self.c_in,
                    n=self.c_out,
                    name=self.name or
                    f"conv{self.kh}x{self.kw}s{self.stride}-"
                    f"{self.c_in}->{self.c_out}")


def _pad_amount(size: int, k: int, s: int) -> tuple[int, int]:
    out = math.ceil(size / s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def im2col(x: np.ndarray, conv: Conv2D) -> np.ndarray:
    """x: [N, H, W, C_in] -> patches [N*OH*OW, KH*KW*C_in]."""
    n, h, w, c = x.shape
    assert (n, h, w, c) == (conv.n, conv.h, conv.w, conv.c_in)
    if conv.padding == "SAME":
        ph = _pad_amount(h, conv.kh, conv.stride)
        pw = _pad_amount(w, conv.kw, conv.stride)
        x = np.pad(x, ((0, 0), ph, pw, (0, 0)))
    oh, ow = conv.out_hw
    cols = np.empty((n, oh, ow, conv.kh, conv.kw, c), x.dtype)
    for i in range(conv.kh):
        for j in range(conv.kw):
            cols[:, :, :, i, j, :] = x[
                :, i:i + oh * conv.stride:conv.stride,
                j:j + ow * conv.stride:conv.stride, :]
    return cols.reshape(n * oh * ow, conv.kh * conv.kw * c)


def conv2d_ref(x: np.ndarray, kern: np.ndarray, conv: Conv2D) -> np.ndarray:
    """Reference conv via the lowered GEMM; kern: [KH, KW, C_in, C_out]."""
    patches = im2col(x, conv)
    wmat = kern.reshape(-1, conv.c_out)
    oh, ow = conv.out_hw
    return (patches @ wmat).reshape(conv.n, oh, ow, conv.c_out)
