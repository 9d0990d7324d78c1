"""What each rank runs in ``tests/test_torch_dryrun_mesh.py``: a dry-run
cell's partitioned step run for real on a mesh of the ranks of a
process group (CPU tensors, gloo), counted by
``launch.graph_analysis.analyze`` as the dry run counts its ``meta``
trace over a fake group.

The ranks start by the ``spawn`` method, so the functions they run live
in a module they can import by name, one that imports neither JAX nor
the JAX package.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ShapeConfig, reduced
from repro_torch.configs.registry import get_config
from repro_torch.dist.sharding import abstract_mesh
from repro_torch.launch import dryrun, graph_analysis
from repro_torch.launch.mesh import device_mesh
from repro_torch.models.api import build_model

#: the reduced cells: (arch, kind), each at ``SEQ`` tokens (the decode
#: cache's slots) and a batch of ``BATCH``, on a (2, 2) mesh
CELLS = [(arch, kind) for arch in ("gemma-7b", "zamba2-1.2b")
         for kind in ("train", "prefill", "decode")]
SEQ, BATCH = 16, 4
MESH = (2, 2)
KEYS = ("dot_flops", "tensor_bytes", "collectives", "collectives_by_axis")


def cell(arch: str, kind: str):
    """(the reduced config, the cell's shape)."""
    return (reduced(get_config(arch)),
            ShapeConfig(f"{kind}_{SEQ}", SEQ, BATCH, kind))


def _real(t: torch.Tensor) -> torch.Tensor:
    """A ``meta`` input as a CPU tensor: integers zero (token 0, position
    0), floats seeded normals."""
    if t.dtype.is_floating_point:
        g = torch.Generator().manual_seed(0)
        return torch.randn(t.shape, generator=g).to(t.dtype)
    return torch.zeros(t.shape, dtype=t.dtype)


def counts(rank: int, n: int) -> dict | None:
    """Every cell's step on the ranks, counted: rank 0's counts by cell."""
    amesh = abstract_mesh(MESH, ("data", "model"))
    dmesh = device_mesh(amesh, "cpu")
    out = {}
    for arch, kind in CELLS:
        cfg, shape = cell(arch, kind)
        model = build_model(cfg, device="cpu")
        fn, args, kwargs, _ = dryrun._step(model, shape, amesh, dmesh,
                                           make=_real)
        r = graph_analysis.analyze(
            fn, *args, axes=graph_analysis.mesh_axes(dmesh), **kwargs)
        out[f"{arch}|{kind}"] = {k: r[k] for k in KEYS}
    return out if rank == 0 else None
