"""Roofline quantities of an eager PyTorch step, read from the ops it
dispatches (counterpart of ``repro/launch/hlo_analysis.py``).

The JAX package compiles a step and parses its HLO text: it splits the
module into computations, recovers each ``while`` loop's trip count and
multiplies the loop body's quantities by it, because XLA's cost analysis
counts a loop body once.  PyTorch has no HLO.  :func:`analyze` runs the
step under a ``TorchDispatchMode`` instead and counts every op that
reaches the dispatcher.  An eager trace executes every iteration of a
Python loop, so nothing needs multiplying and no trip count is
recovered (the HLO analyser's ``while_trips`` has no counterpart).  On
the ``meta`` device the step allocates nothing.

  * dot flops: ``torch.utils.flop_counter``'s formulas for aten's
    products (2 * numel(out) * contraction for ``mm``/``bmm``/
    ``addmm``/``baddbmm``, and convolutions), plus the flops that each
    kernel op reckons for itself on ``meta`` (``kernels.meta``);
  * a tensor-traffic proxy: operand plus result bytes of every
    dispatched op, views and allocations left out (they move nothing),
    plus each kernel op's bytes -- the eager twin of the HLO analyser's
    operand + result bytes of top-level ops;
  * collective bytes: the result bytes of every functional collective
    (``torch.distributed._functional_collectives``), by kind (none on
    one card).
"""

from __future__ import annotations

import collections

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import meta as kernel_meta

_aten = torch.ops.aten
#: ops that move no bytes but are not tagged as views: allocations, and
#: the view that ``reshape`` returns of a fresh tensor
_NO_TRAFFIC = {_aten.empty, _aten.empty_like, _aten.new_empty,
               _aten.empty_strided, _aten.new_empty_strided,
               _aten._unsafe_view}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional")
#: the functional collectives (an in-place one ends in ``_``)
_COLLECTIVES = {"all_reduce", "all_reduce_coalesced", "all_gather_into_tensor",
                "all_gather_into_tensor_coalesced", "reduce_scatter_tensor",
                "reduce_scatter_tensor_coalesced", "all_to_all_single",
                "broadcast"}


def _bytes(tree) -> float:
    return float(sum(t.numel() * t.element_size() for t in tree_leaves(tree)
                     if isinstance(t, torch.Tensor)))


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.aten_dot_flops = 0.0
        self.aten_bytes = 0.0
        self.collectives: dict[str, float] = collections.defaultdict(float)
        self.kernels: dict[str, dict] = {}
        self.ops = 0

    def kernel(self, name: str, flops: float, nbytes: float) -> None:
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                           "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        packet = func.overloadpacket
        if packet in flop_registry:
            self.aten_dot_flops += float(
                flop_registry[packet](*args, **kwargs, out_val=out))
        kind = packet.__name__.removesuffix("_")
        if func.namespace in _COLLECTIVE_NAMESPACES and kind in _COLLECTIVES:
            self.collectives[kind] += _bytes(out)
        if not func.is_view and packet not in _NO_TRAFFIC:
            self.aten_bytes += _bytes((args, kwargs)) + _bytes(out)
        return out


def analyze(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once and count what it dispatched.

    Returns ``dot_flops``, ``tensor_bytes``, ``collectives`` ({kind:
    bytes}) and ``collective_bytes`` (the JAX analyser's keys, less
    ``while_trips``), with ``aten_dot_flops`` and ``kernels`` ({name:
    {calls, flops, bytes}}, the kernel ops run on ``meta``) split out,
    and ``ops`` the count of dispatched ops."""
    counter = _Counter()
    kernel_meta.SINKS.append(counter.kernel)
    try:
        with counter:
            fn(*args, **kwargs)
    finally:
        kernel_meta.SINKS.remove(counter.kernel)
    k_flops = sum(k["flops"] for k in counter.kernels.values())
    k_bytes = sum(k["bytes"] for k in counter.kernels.values())
    collectives = dict(counter.collectives)
    return {"dot_flops": counter.aten_dot_flops + k_flops,
            "tensor_bytes": counter.aten_bytes + k_bytes,
            "collectives": collectives,
            "collective_bytes": sum(collectives.values()),
            "aten_dot_flops": counter.aten_dot_flops,
            "kernels": counter.kernels, "ops": counter.ops}
