"""The precision a reference computes its products in.

``fp32``: every product in fp32 (the reference).  ``fp8``: both operands
of every product of a linear layer rounded to float8 e4m3 with one scale
a tensor (its largest magnitude mapped to 448, the usual fp8 recipe),
the sum in fp32: the control, the nearest precision below the
configurations' bf16.  :func:`products` says whether the card's fp32
products run as TF32 (operands rounded to 10 mantissa bits, the sums in
fp32): off by default; a cell's check may ask for it where the fp32
reference would take longer than the window (still three bits finer
than the served bf16)."""

from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.detach().abs().amax().clamp_min(1e-12) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Numerics:
    def __init__(self, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(precision)
        self.precision = precision

    def round(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` in fp32, rounded to the operands' precision."""
        t = t.float()
        return _fp8(t) if self.precision == "fp8" else t

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x @ w`` of a linear layer, in this precision."""
        return self.round(x) @ self.round(w)


@contextlib.contextmanager
def products(tf32: bool = False):
    """The card's fp32 products as TF32 (``tf32``) or in fp32 while the
    block runs, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
