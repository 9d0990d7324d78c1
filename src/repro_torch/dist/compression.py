"""Gradient compression for cross-replica sync (counterpart of
``repro/dist/compression.py``).

``fake_quantize_int8`` is the quantise -> dequantise round trip: the
error model of int8 on the wire, without int8 collectives.
``compressed_dp_allreduce`` applies it on each rank before the mean over
a ``DeviceMesh``'s ``"data"`` dimension, so the replicas exchange values
at int8 fidelity, as a real compressed all-reduce delivers them.
"""

from __future__ import annotations

import torch

from repro_torch.dist import ranks


def fake_quantize_int8(x: torch.Tensor) -> torch.Tensor:
    """Per-tensor symmetric int8 quantise -> dequantise, in x's dtype
    (|err| <= amax/254 plus representation noise; exactly 0 for the zero
    tensor).  Rounding is half to even, as ``jnp.round``'s."""
    amax = x.abs().max()
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(x / scale), -127, 127)
    return (q * scale).to(x.dtype)


def compressed_dp_allreduce(grads: dict[str, torch.Tensor], mesh
                            ) -> dict[str, torch.Tensor]:
    """Quantised mean of a dict of gradients over ``mesh``'s ``"data"``
    dimension (a ``torch.distributed`` ``DeviceMesh``, such as
    ``launch.mesh.device_mesh`` makes).

    Each rank rounds its local gradient through int8
    (:func:`fake_quantize_int8`); the mean is an all-gather of those,
    summed in rank order (in fp32 at least) from zeros and divided by the
    dimension's size, so the result, a new dict in the input dtypes, is
    bit-identical on every rank (a reduction's order is the
    transport's; gloo has no mean).  With a one-rank ``"data"``
    dimension it is the round trip itself."""
    group = mesh.get_group("data")
    out = {}
    for name, g in grads.items():
        parts = ranks.all_gather(fake_quantize_int8(g), group)
        acc = torch.zeros(g.shape, device=g.device,
                          dtype=torch.promote_types(g.dtype, torch.float32))
        for p in parts:
            acc += p
        out[name] = (acc / len(parts)).to(g.dtype)
    return out
