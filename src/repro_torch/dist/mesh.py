"""ArrayMesh: N logical FEATHER+ arrays as a first-class axis.

The MINISA results are per-array; production serving runs many arrays.
An :class:`ArrayMesh` names that scale-out dimension for everything a
``Program`` flows through:

  * ``core/program.shard_program`` splits a lowered Program's tile space
    into one sub-Program per array (axis policy from ``dist/sharding``);
  * ``backends`` execute the shards -- one sub-backend per array, each
    with its own buffers and committed state, run one after another on
    the backend's device;
  * the runtime (``ProgramCache`` keys, ``ModelExecutable``,
    ``Scheduler``) carries the mesh shape so per-array traffic, stall and
    load-imbalance numbers are reported everywhere.

Logical vs physical: an ArrayMesh is meaningful without one CUDA device
per array -- per-array accounting and per-shard execution only need the
*logical* count.  :meth:`ArrayMesh.device_mesh` names the devices that
could back the arrays, or ``None`` where there are fewer than arrays
(one card, or the CPU); the backends run the shards on one device either
way.
"""

from __future__ import annotations

import dataclasses

import torch


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

    def device_mesh(self) -> tuple[torch.device, ...] | None:
        """One CUDA device per array, or ``None`` when the mesh has one
        array or this host has fewer CUDA devices than arrays (the
        shards then run one after another on one device)."""
        if self.n_arrays < 2 or torch.cuda.device_count() < self.n_arrays:
            return None
        return tuple(torch.device("cuda", i) for i in range(self.n_arrays))

    def degraded(self, n_down: int = 1) -> "ArrayMesh":
        """The mesh that survives ``n_down`` arrays going unhealthy --
        the failover target the scheduler re-lowers onto (never below
        one array: a fully-degraded mesh serves unsharded)."""
        return ArrayMesh(n_arrays=max(1, self.n_arrays - max(0, n_down)),
                         axis_name=self.axis_name)

    @classmethod
    def host(cls) -> "ArrayMesh":
        """One logical array per visible CUDA device (one where there is
        none)."""
        return cls(n_arrays=max(1, torch.cuda.device_count()))

    def __repr__(self) -> str:
        return f"ArrayMesh(n_arrays={self.n_arrays})"
