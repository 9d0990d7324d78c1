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
twin of the JAX package's ``abstract_mesh``, or a real ``DeviceMesh``
of the same axes (``launch.mesh.device_mesh``); :func:`placements`
turns a spec into ``torch.distributed.tensor`` placements, and
:func:`distribute` makes a DTensor by them.

Training on a mesh runs the models' plain eager code on DTensors: their
sharding propagation plays the part XLA's partitioner plays for the JAX
package's ``jax.jit`` over shardings.  :func:`like` puts a tensor a
model makes itself (positions, masks, zero states) on the mesh of the
DTensor it meets, and the ``constrain_*`` anchors redistribute a
DTensor to the JAX package's specs; on plain tensors all three are
identities, so a model off the mesh runs exactly as before.

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


def mesh_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of an :class:`AbstractMesh` or a named
    ``DeviceMesh``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {str(k): int(v) for k, v in zip(names, mesh.shape)}
    return {str(k): int(v) for k, v in dict(mesh.shape).items()}


def spec_for(axes: tuple[str, ...], shape: tuple[int, ...], mesh,
             rules: dict | None = None) -> tuple:
    """Logical axes + concrete shape -> spec on ``mesh``."""
    rules = RULES if rules is None else rules
    sizes = mesh_sizes(mesh)
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


def leading_spec(shape: tuple[int, ...], sizes: dict[str, int]) -> tuple:
    """The spec that shards the leading (batch) dim of ``shape`` over the
    pure-data axes of a mesh of ``sizes`` ({axis: size}), jointly, where
    it divides them; ``()`` (replicated) where it does not."""
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
    sizes = mesh_sizes(mesh)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return leading_spec(tuple(node.shape), sizes)
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
    names = tuple(mesh_sizes(mesh))
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


def distribute(t, spec: tuple, device_mesh):
    """``t``, the same whole tensor on every rank, as a DTensor on
    ``device_mesh`` placed by ``spec``: each rank keeps its own shard of
    it, with no collective."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, device_mesh,
                             placements(spec, t.ndim, device_mesh),
                             src_data_rank=None)


def shard_like(t, ref):
    """``t``, a whole tensor the same on every rank, as a DTensor placed
    as the DTensor ``ref`` is (each rank keeps its shard, on ``ref``'s
    device; no collective); ``t`` itself when ``ref`` is a plain tensor
    (or ``t`` a DTensor)."""
    if not is_dtensor(ref) or is_dtensor(t):
        return t
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t.to(ref.device), ref.device_mesh,
                             ref.placements, src_data_rank=None)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def like(t, ref):
    """``t``, a tensor a model made itself (the same on every rank), on
    the mesh of the DTensor ``ref`` it meets, replicated on every axis;
    ``t`` itself when ``ref`` is a plain tensor or ``t`` a DTensor."""
    if not is_dtensor(ref) or is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate

    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim,
                              run_check=False)


def row_local(fn, *args, n_out: int, whole: tuple = ()):
    """``fn(*args)``, where each batch row (dim 0) of every output depends
    only on the same rows of the inputs (a MoE layer's routing, dispatch
    and combine; an embedding gather).  On DTensors it runs in a
    ``local_map`` region on each rank's rows (over the data axes where
    the batch divides them, every row where it does not), every other
    dim whole; its ``n_out`` outputs come back as DTensors placed so.
    The args at the indices ``whole`` (a table every row reads) go in
    whole, replicated, and their gradients come back partial over the
    data axes (each rank's rows' part).  On plain tensors it is ``fn``."""
    ref = next((a for a in args if is_dtensor(a)), None)
    if ref is None:
        return fn(*args)
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = ref.device_mesh
    spec = leading_spec(tuple(ref.shape), mesh_sizes(mesh))
    place = placements(spec, 1, mesh)
    rep = (Replicate(),) * mesh.ndim
    part = tuple(Partial() if p.is_shard() else r for p, r in zip(place, rep))
    args = tuple(like(a, ref) if hasattr(a, "ndim") else a for a in args)
    ins = tuple(None if not hasattr(a, "ndim") else rep if i in whole
                else place for i, a in enumerate(args))
    grads = tuple(part if i in whole else p for i, p in enumerate(ins))
    return local_map(fn, out_placements=((place,) * n_out if n_out > 1
                                         else list(place)),
                     in_placements=ins, in_grad_placements=grads,
                     device_mesh=mesh, redistribute_inputs=True)(*args)


# ---------------------------------------------------------------------------
# In-graph constraints
# ---------------------------------------------------------------------------

def _constrain(x, spec_fn):
    """``x`` redistributed to ``spec_fn({axis: size})`` on its mesh when
    it is a DTensor, the twin of the JAX package's
    ``with_sharding_constraint`` under a mesh; ``x`` itself otherwise,
    as the JAX package's is with no mesh active."""
    if not is_dtensor(x):
        return x
    mesh = x.device_mesh
    want = placements(spec_fn(mesh_sizes(mesh)), x.ndim, mesh)
    return x if tuple(x.placements) == want else x.redistribute(mesh, want)


def constrain_batch(x, extra: tuple = ()):
    """Anchor dim 0 to the data axes; ``extra`` names trailing dims after
    the batch dim ('' / None = unsharded)."""
    def spec_fn(sizes):
        bspec = leading_spec(tuple(x.shape), sizes)
        entries = [bspec[0] if bspec else None]
        for i, name in enumerate(extra):
            dim = 1 + i
            entries.append(name if (name and name in sizes and dim < x.ndim
                                    and x.shape[dim] % sizes[name] == 0)
                           else None)
        return tuple(entries)
    return _constrain(x, spec_fn)


def constrain_seq_scores(scores):
    """Attention-score anchor: batch over data, KV-sequence (last dim)
    over 'model'."""
    def spec_fn(sizes):
        entries: list = [None] * scores.ndim
        bspec = leading_spec(tuple(scores.shape), sizes)
        if bspec:
            entries[0] = bspec[0]
        if ("model" in sizes and scores.ndim > 1
                and scores.shape[-1] % sizes["model"] == 0):
            entries[-1] = "model"
        return tuple(entries)
    return _constrain(scores, spec_fn)


def constrain_rows_model(table):
    """Anchor a (rows, feature) table to rows over 'model', features
    replicated, before the embedding gather and the tied head."""
    def spec_fn(sizes):
        if "model" in sizes and table.shape[0] % sizes["model"] == 0:
            return ("model",)
        return ()
    return _constrain(table, spec_fn)


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
