"""Logical-axis sharding rules (counterpart of ``repro/dist/sharding.py``).

Every parameter names its dims with *logical* axes (``Maker.param``'s
``axes``; ``Model.axes``, ``Model.cache_axes``); this module maps those
names onto the axes of a mesh:

  train (RULES):
    batch            -> all pure-data axes, jointly: ('pod', 'data')
    heads/kv_heads,
    ffn/expert_ffn,
    vocab, ssm_inner -> 'model'   (tensor parallelism)
    embed            -> 'data'    (FSDP: shard weights over data, gather
                                   at use)
    kvseq/seq        -> 'model'   (sequence fallback when the preferred
                                   TP axis is taken or indivisible)
    experts          -> unsharded (each expert's ffn dim is sharded
                                   instead)

  inference (INFERENCE_RULES): identical minus the FSDP entry.

An axis is only assigned when the dim is divisible by the mesh axis size
and the mesh axis is not already used by another dim of the same tensor.

A spec is a tuple with one entry a tensor dim -- ``None``, a mesh axis
name, or a tuple of names (a joint sharding) -- with trailing ``None``s
dropped: the twin of ``jax.sharding.PartitionSpec``.  The mesh these
read is an :class:`AbstractMesh` (named axis sizes, no devices), the
twin of the JAX package's ``abstract_mesh``; :func:`placements` turns a
spec into ``torch.distributed.tensor`` placements for a real
``DeviceMesh`` of the same axes (``launch.mesh.device_mesh``).

The second half is the Program spine's axis policy: which GEMM rank a
lowered Program is split along across an
:class:`~repro_torch.dist.mesh.ArrayMesh`.  It is the same policy
projected onto the one contraction every lowered Program is: N is the
weight's free rank (ffn / heads / vocab -> tensor parallelism, each
array holds a weight column slice), M is the streamed token rank (batch
-> data parallelism), and K is the contraction (splittable only with a
reduction epilogue, so it is the last resort).
"""

from __future__ import annotations

import dataclasses
import math

# name -> (priority, candidate mesh axes).  Lower priority wins contended
# mesh axes; candidates are tried in order; tuple candidates are joint
# (multi-axis) shardings.
RULES: dict[str, tuple[int, tuple]] = {
    "batch":      (0, (("pod", "data"),)),
    "kv_heads":   (1, ("model",)),
    "heads":      (1, ("model",)),
    "vocab":      (1, ("model",)),
    "ffn":        (1, ("model",)),
    "expert_ffn": (1, ("model",)),
    "ssm_inner":  (1, ("model",)),
    "embed":      (2, ("data",)),
    "kvseq":      (3, ("model",)),
    "seq":        (3, ("model",)),
}

#: Serving drops FSDP: weight-bearing 'embed' dims replicate over 'data'.
INFERENCE_RULES: dict[str, tuple[int, tuple]] = {
    k: v for k, v in RULES.items() if k != "embed"
}

_DATA_AXES = ("pod", "data")


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's named axis sizes, with no devices behind it."""
    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"{self.axis_sizes} and {self.axis_names} "
                             f"differ in length")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def abstract_mesh(axis_sizes: tuple[int, ...],
                  axis_names: tuple[str, ...]) -> AbstractMesh:
    return AbstractMesh(tuple(int(s) for s in axis_sizes),
                        tuple(axis_names))


def _mesh_sizes(mesh) -> dict[str, int]:
    return {str(k): int(v) for k, v in dict(mesh.shape).items()}


def spec_for(axes: tuple[str, ...], shape: tuple[int, ...], mesh,
             rules: dict | None = None) -> tuple:
    """Logical axes + concrete shape -> spec on ``mesh``."""
    rules = RULES if rules is None else rules
    sizes = _mesh_sizes(mesh)
    assign: list = [None] * len(axes)
    used: set[str] = set()
    order = sorted(range(len(axes)),
                   key=lambda i: (rules[axes[i]][0]
                                  if axes[i] in rules else 99, i))
    for i in order:
        name = axes[i]
        if name not in rules:
            continue
        for cand in rules[name][1]:
            cand = (cand,) if isinstance(cand, str) else tuple(cand)
            present = tuple(a for a in cand if a in sizes and a not in used)
            if not present:
                continue
            total = math.prod(sizes[a] for a in present)
            if total <= 0 or shape[i] % total:
                continue
            assign[i] = present[0] if len(present) == 1 else present
            used.update(present)
            break
    while assign and assign[-1] is None:
        assign.pop()
    return tuple(assign)


# ---------------------------------------------------------------------------
# Tree helpers (params / optimizer / batch / cache specs)
# ---------------------------------------------------------------------------

def _is_axes_leaf(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, str) for a in x)


def _zip_tree(axes_tree, shapes_tree, fn):
    """``fn(axes, tensor)`` at each pair of leaves of two trees of one
    structure (dicts, lists, tuples), in the shapes tree's structure."""
    if _is_axes_leaf(axes_tree):
        return fn(axes_tree, shapes_tree)
    if isinstance(axes_tree, dict):
        if set(axes_tree) != set(shapes_tree):
            raise ValueError(f"axes/shape trees disagree: "
                             f"{sorted(axes_tree)} vs {sorted(shapes_tree)}")
        return {k: _zip_tree(axes_tree[k], shapes_tree[k], fn)
                for k in shapes_tree}
    if len(axes_tree) != len(shapes_tree):
        raise ValueError(f"axes/shape trees disagree: {len(axes_tree)} vs "
                         f"{len(shapes_tree)} leaves")
    return type(shapes_tree)(_zip_tree(a, s, fn)
                             for a, s in zip(axes_tree, shapes_tree))


def tree_shardings(axes_tree, shapes_tree, mesh, inference: bool = False):
    """Matching trees of logical axes and tensors (``meta`` ones will
    do) -> the same tree of specs."""
    rules = INFERENCE_RULES if inference else RULES
    return _zip_tree(axes_tree, shapes_tree,
                     lambda a, t: spec_for(a, tuple(t.shape), mesh, rules))


def replicated(mesh) -> tuple:
    return ()


def _batch_spec(shape: tuple[int, ...], sizes: dict[str, int]) -> tuple:
    axes = tuple(a for a in _DATA_AXES if a in sizes)
    if not shape or not axes:
        return ()
    total = math.prod(sizes[a] for a in axes)
    if shape[0] % max(total, 1):
        return ()
    return (axes if len(axes) > 1 else axes[0],)


def batch_sharding(mesh, batch_spec):
    """Batch tree (tensors) -> specs that shard the leading (batch) dim
    over the pure-data axes."""
    sizes = _mesh_sizes(mesh)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return _batch_spec(tuple(node.shape), sizes)
    return walk(batch_spec)


def placements(spec: tuple, tensor_ndim: int, mesh) -> tuple:
    """A spec as one ``torch.distributed.tensor`` placement a mesh dim,
    in the mesh's axis order: ``Shard(d)`` where tensor dim ``d`` names
    that axis (a joint entry such as ``("pod", "data")`` shards dim
    ``d`` over each of its axes), else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    if len(spec) > tensor_ndim:
        raise ValueError(f"spec {spec} has more entries than the "
                         f"tensor's {tensor_ndim} dims")
    names = tuple(_mesh_sizes(mesh))
    dim_of: dict[str, int] = {}
    for d, entry in enumerate(spec):
        for name in ((entry,) if isinstance(entry, str) else entry or ()):
            if name not in names:
                raise ValueError(f"spec {spec} names {name!r}, not an axis "
                                 f"of the mesh {names}")
            if name in dim_of:
                raise ValueError(f"spec {spec} names {name!r} twice")
            dim_of[name] = d
    return tuple(Shard(dim_of[n]) if n in dim_of else Replicate()
                 for n in names)


# ---------------------------------------------------------------------------
# In-graph constraints
# ---------------------------------------------------------------------------

def constrain_batch(x, extra: tuple = ()):
    """Identity: the JAX package's ``constrain_batch`` is one when no
    mesh is active, and the port runs a model on one device."""
    return x


def constrain_seq_scores(scores):
    """Identity (see :func:`constrain_batch`)."""
    return scores


def constrain_rows_model(table):
    """Identity (see :func:`constrain_batch`)."""
    return table


# ---------------------------------------------------------------------------
# Program-spine axis policy (GEMM rank -> array-mesh axis)
# ---------------------------------------------------------------------------

#: Which GEMM rank to split across an array mesh, in preference order.
GEMM_AXIS_RULES: tuple[str, ...] = ("n", "m", "k")


def gemm_shard_axis(m: int, k: int, n: int, n_arrays: int,
                    tiles: dict[str, int] | None = None) -> str:
    """Pick the host GEMM rank ('m' | 'n' | 'k') to split over
    ``n_arrays`` arrays.

    ``tiles`` optionally gives the lowered Program's tile count along
    each host rank.  Splitting a rank the tile loop barely iterates
    (e.g. N when the whole N extent fits one tile) *replicates* the
    other ranks' instruction and load traffic on every array instead of
    partitioning it, so ranks with at least ``n_arrays`` tiles are
    preferred -- that is what keeps per-array MINISA traffic summing to
    the single-array total.  Within the surviving candidates: an exactly
    divisible rank first, then any rank wide enough to occupy every
    array, then the widest rank."""
    if n_arrays < 2:
        return GEMM_AXIS_RULES[0]
    dims = {"m": m, "k": k, "n": n}
    order = list(GEMM_AXIS_RULES)
    if tiles is not None:
        partitioning = [ax for ax in order
                        if tiles.get(ax, 0) >= n_arrays]
        if partitioning:
            order = partitioning
        elif max(tiles.values(), default=0) > 1:
            # no rank has a tile per array: the most-tiled rank still
            # partitions the largest share of the instruction stream
            # (ties resolve in GEMM_AXIS_RULES order)
            best = max(tiles.values())
            order = [ax for ax in order if tiles.get(ax, 0) == best]
    for ax in order:
        if dims[ax] >= n_arrays and dims[ax] % n_arrays == 0:
            return ax
    for ax in order:
        if dims[ax] >= n_arrays:
            return ax
    return max(order, key=lambda ax: dims[ax])
