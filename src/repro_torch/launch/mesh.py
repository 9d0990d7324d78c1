"""Production and host meshes (counterpart of ``repro/launch/mesh.py``).

Single pod: 16 x 16 = 256 cards (data, model).
Multi-pod:  2 x 16 x 16 = 512 cards (pod, data, model); the 'pod' axis
carries pure data parallelism (and is the gradient-compression hop).

The meshes are :class:`~repro_torch.dist.sharding.AbstractMesh` es, named
axis sizes with no devices behind them: what the dry run and the
sharding rules read.  :func:`device_mesh` makes the real
``torch.distributed`` ``DeviceMesh`` of one, and only when a process
group of its size exists: ``launch.train`` trains on it.
"""

from __future__ import annotations

import torch

from repro_torch.dist.sharding import AbstractMesh, abstract_mesh


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return abstract_mesh(shape, axes)


def make_host_mesh(device="cuda") -> AbstractMesh:
    """The (1, n) ``(data, model)`` mesh of what this program has, the
    twin of the JAX package's ``len(jax.devices())``: with a process
    group up, n is its size (one rank a device); without one, n is the
    visible CUDA devices (raising without one), or 1 for
    ``device="cpu"``."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return abstract_mesh((1, dist.get_world_size()), ("data", "model"))
    if torch.device(device).type == "cpu":
        return abstract_mesh((1, 1), ("data", "model"))
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("make_host_mesh: no CUDA device; pass "
                           "device='cpu' for the CPU's mesh")
    return abstract_mesh((1, n), ("data", "model"))


def device_mesh(mesh: AbstractMesh, device_type: str = "cuda"):
    """``mesh`` as a ``torch.distributed.device_mesh.DeviceMesh`` over
    ranks 0..size-1 with its axis names.  Raises unless a process group
    of exactly ``mesh.size`` ranks is initialised."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(f"device_mesh: no process group; a "
                           f"{mesh.axis_sizes} mesh needs {mesh.size} ranks")
    if dist.get_world_size() != mesh.size:
        raise RuntimeError(f"device_mesh: the process group has "
                           f"{dist.get_world_size()} ranks, the "
                           f"{mesh.axis_sizes} mesh {mesh.size}")
    ranks = torch.arange(mesh.size).reshape(mesh.axis_sizes)
    return DeviceMesh(device_type, ranks, mesh_dim_names=mesh.axis_names)
