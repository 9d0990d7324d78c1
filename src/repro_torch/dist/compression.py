"""Gradient compression for cross-replica sync (counterpart of
``repro/dist/compression.py``).

``fake_quantize_int8`` is the quantise -> dequantise round trip: the
error model of int8 on the wire, without int8 collectives.  The JAX
package's ``compressed_dp_allreduce`` (the round trip inside a
data-parallel mean over a mesh of cards) waits for the port's multi-card
path (ROADMAP A.7).
"""

from __future__ import annotations

import torch


def fake_quantize_int8(x: torch.Tensor) -> torch.Tensor:
    """Per-tensor symmetric int8 quantise -> dequantise, in x's dtype
    (|err| <= amax/254 plus representation noise; exactly 0 for the zero
    tensor).  Rounding is half to even, as ``jnp.round``'s."""
    amax = x.abs().max()
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(x / scale), -127, 127)
    return (q * scale).to(x.dtype)
