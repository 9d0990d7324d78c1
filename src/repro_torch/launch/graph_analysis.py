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
    one card), and by the mesh axis of the group each one names.

A step on DTensors (a model placed on a ``DeviceMesh``, as
``launch.dryrun`` traces it over a fake process group) is counted as
one device runs it: an op on DTensors is left to DTensor's own
dispatch, and what that dispatches on the local shards -- the
products, the copies, the collectives of a redistribution -- is
counted.  DTensor's sharding propagation runs ops at global shapes (on fake
tensors) to learn an op's outputs' shapes or to derive its rule, once
an op and input layout before its cache holds them: none of that is
counted, so a trace counts the same the first time and every time
after.
"""

from __future__ import annotations

import collections
import contextlib

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


def mesh_axes(device_mesh) -> dict[str, str]:
    """{process group name: mesh axis name} of a named ``DeviceMesh``:
    what :func:`analyze` reads a collective's axis from."""
    return {device_mesh.get_group(i).group_name: name
            for i, name in enumerate(device_mesh.mesh_dim_names)}


class _Hidden:
    """A sharding propagator's entry point, during which ``counter``
    counts nothing (its other attributes those of the entry point)."""

    def __init__(self, fn, counter):
        self.fn, self.counter = fn, counter

    def __call__(self, *args, **kwargs):
        self.counter.hidden += 1
        try:
            return self.fn(*args, **kwargs)
        finally:
            self.counter.hidden -= 1

    def __getattr__(self, name):
        return getattr(self.fn, name)


#: DTensor's sharding propagator's entry points: the cached one and the
#: one each cache miss (or an uncached op) runs
_PROPAGATION = ("propagate_op_sharding", "propagate_op_sharding_non_cached")


@contextlib.contextmanager
def _propagation_hidden(counter):
    """While DTensor's sharding propagator runs (the ops it runs at global
    shapes on fake tensors to learn an op's output shapes, or to derive a
    rule from an op's decomposition), the counter counts nothing."""
    from torch.distributed.tensor import DTensor

    prop = DTensor._op_dispatcher.sharding_propagator
    names = [n for n in _PROPAGATION if hasattr(prop, n)]
    if not names:
        raise RuntimeError("graph_analysis: this torch's DTensor sharding "
                           f"propagator has none of {_PROPAGATION}")
    own = {n: vars(prop).get(n) for n in names}
    for n in names:
        setattr(prop, n, _Hidden(getattr(prop, n), counter))
    try:
        yield
    finally:
        for n in names:
            if own[n] is None:
                delattr(prop, n)
            else:
                setattr(prop, n, own[n])


class _Counter(TorchDispatchMode):
    def __init__(self, axes: dict[str, str] | None = None):
        super().__init__()
        from torch.distributed.tensor import DTensor

        self.dtensor = DTensor
        self.axes = axes or {}
        self.hidden = 0
        self.aten_dot_flops = 0.0
        self.aten_bytes = 0.0
        self.collectives: dict[str, float] = collections.defaultdict(float)
        self.by_axis: dict[str, dict] = collections.defaultdict(
            lambda: collections.defaultdict(float))
        self.kernels: dict[str, dict] = {}
        self.ops = 0

    def kernel(self, name: str, flops: float, nbytes: float) -> None:
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                           "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, self.dtensor) for t in types):
            # DTensor's dispatch runs the local ops, which come back here
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.hidden:
            return out
        self.ops += 1
        packet = func.overloadpacket
        if packet in flop_registry:
            self.aten_dot_flops += float(
                flop_registry[packet](*args, **kwargs, out_val=out))
        kind = packet.__name__.removesuffix("_")
        if func.namespace in _COLLECTIVE_NAMESPACES and kind in _COLLECTIVES:
            nbytes = _bytes(out)
            self.collectives[kind] += nbytes
            # the group's name is the last string a collective takes
            group = next((a for a in reversed((*args, *kwargs.values()))
                          if isinstance(a, str)), None)
            self.by_axis[self.axes.get(group, "other")][kind] += nbytes
        # a collective's wait moves nothing (a fake group's collectives
        # complete at once and issue none)
        if not func.is_view and packet not in _NO_TRAFFIC \
                and kind != "wait_tensor":
            self.aten_bytes += _bytes((args, kwargs)) + _bytes(out)
        return out


def analyze(fn, *args, axes: dict[str, str] | None = None,
            **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once and count what it dispatched.

    Returns ``dot_flops``, ``tensor_bytes``, ``collectives`` ({kind:
    bytes}) and ``collective_bytes`` (the JAX analyser's keys, less
    ``while_trips``), with ``aten_dot_flops`` and ``kernels`` ({name:
    {calls, flops, bytes}}, the kernel ops run on ``meta``, or reckoned
    on the CPU) split out, ``ops`` the count of dispatched ops, and
    ``collectives_by_axis`` ({axis: {kind: bytes}}): ``axes``
    (:func:`mesh_axes`) names each group's mesh axis, and a group it
    does not name counts under ``"other"``."""
    counter = _Counter(axes)
    kernel_meta.SINKS.append(counter.kernel)
    try:
        with _propagation_hidden(counter), counter:
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
            "collectives_by_axis": {a: dict(k) for a, k in
                                    counter.by_axis.items()},
            "aten_dot_flops": counter.aten_dot_flops,
            "kernels": counter.kernels, "ops": counter.ops}
