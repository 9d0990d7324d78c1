"""ArrayMesh: N logical FEATHER+ arrays as a first-class axis.

The MINISA results are per-array; production serving runs many arrays.
An :class:`ArrayMesh` names that scale-out dimension for everything a
``Program`` flows through:

  * ``core/program.shard_program`` splits a lowered Program's tile space
    into one sub-Program per array (axis policy from ``dist/sharding``);
  * ``backends`` execute the shards -- one sub-backend per array, each
    with its own buffers and committed state, run one after another on
    the backend's device; or, on ranks of a process group, the CUDA
    backend runs each array's shard on its own rank (one launch a rank)
    and gathers the output over :meth:`ArrayMesh.device_mesh`;
  * the runtime (``ProgramCache`` keys, ``ModelExecutable``,
    ``Scheduler``) carries the mesh shape so per-array traffic, stall and
    load-imbalance numbers are reported everywhere.

Logical vs physical: an ArrayMesh is meaningful without ranks -- per-
array accounting and per-shard execution only need the *logical* count.
:meth:`ArrayMesh.device_mesh` names the ranks that back the arrays, the
twin of the JAX package's ``jax_mesh()``: JAX backs a mesh by the
devices of one process (faked on a CPU by ``XLA_FLAGS``), the port by
ranks of a ``torch.distributed`` process group (``dist.ranks.spawn``
starts them: gloo ranks on the CPU or sharing one card).  Without a
group it is ``None``, and the shards run one after another in one
process, with identical numerics.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.dist import ranks


@dataclasses.dataclass(frozen=True)
class ArrayMesh:
    """N logical FEATHER+ arrays, optionally backed by CUDA devices."""

    n_arrays: int = 1
    axis_name: str = "array"

    def __post_init__(self):
        if self.n_arrays < 1:
            raise ValueError(f"n_arrays must be >= 1, got {self.n_arrays}")

    @property
    def shape(self) -> tuple[int, ...]:
        return (self.n_arrays,)

    def device_mesh(self):
        """A one-dimensional ``torch.distributed`` ``DeviceMesh`` named
        ``axis_name`` over ranks 0..n_arrays-1 of the default process
        group, or ``None`` when no group is up, the group has fewer ranks
        than arrays, or the mesh has one array (callers then run the
        shards one after another).  Ranks past ``n_arrays`` (a degraded
        mesh) get the mesh too, with no coordinate on it."""
        if self.n_arrays < 2 or ranks.world_size() < self.n_arrays:
            return None
        return ranks.device_mesh(self.n_arrays, self.axis_name)

    def degraded(self, n_down: int = 1) -> "ArrayMesh":
        """The mesh that survives ``n_down`` arrays going unhealthy --
        the failover target the scheduler re-lowers onto (never below
        one array: a fully-degraded mesh serves unsharded)."""
        return ArrayMesh(n_arrays=max(1, self.n_arrays - max(0, n_down)),
                         axis_name=self.axis_name)

    @classmethod
    def host(cls) -> "ArrayMesh":
        """One logical array per rank of the default process group, the
        twin of one per device of a multi-controller JAX; without a group
        one per visible CUDA device (one where there is none)."""
        if ranks.world_size() > 1:
            return cls(n_arrays=ranks.world_size())
        return cls(n_arrays=max(1, torch.cuda.device_count()))

    def __repr__(self) -> str:
        return f"ArrayMesh(n_arrays={self.n_arrays})"
