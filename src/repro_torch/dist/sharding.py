"""The Program spine's axis policy: which GEMM rank a lowered Program is
split along across an :class:`~repro_torch.dist.mesh.ArrayMesh`.

It is the JAX package's logical-axis policy (``repro/dist/sharding.py``)
projected onto the one contraction every lowered Program is: N is the
weight's free rank (ffn / heads / vocab -> tensor parallelism, each
array holds a weight column slice), M is the streamed token rank (batch
-> data parallelism), and K is the contraction (splittable only with a
reduction epilogue, so it is the last resort).  The PartitionSpec half
of that module serves the models world and is not here.
"""

from __future__ import annotations

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
