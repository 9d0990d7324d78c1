"""Pluggable execution backends for lowered MINISA Programs.

    from repro_torch import backends

    be = backends.get_backend("cuda", cfg)            # on the card
    out = be.run_program(plan.program, {"I": i, "W": w})["O"]

Every backend consumes the same tiled Program IR the mapper lowers once
(``core/program.py``), so the cross-backend equivalence check

    interpreter == cuda == einsum oracle

ties the functional machine, the compiled kernels and the analytical
model to one artifact.  Both backends run on the card by default and take
``device="cpu"`` (the interpreter's PyTorch operations, the kernels'
plain versions) for the tests.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np
import torch

from repro_torch.backends.base import Backend
from repro_torch.backends.cuda_backend import (CompiledProgram,
                                               CompiledSegment, CudaBackend,
                                               compile_program,
                                               compile_segment)
from repro_torch.backends.interpreter import InterpreterBackend

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.configs.feather import FeatherConfig
    from repro_torch.core.program import Program

__all__ = [
    "Backend", "InterpreterBackend", "CudaBackend", "CompiledProgram",
    "CompiledSegment", "compile_program", "compile_segment", "BACKENDS",
    "get_backend", "run", "cross_check", "run_sharded",
]

BACKENDS: dict[str, type[Backend]] = {
    InterpreterBackend.name: InterpreterBackend,
    CudaBackend.name: CudaBackend,
}


def get_backend(backend: str | Backend, cfg: "FeatherConfig",
                **kwargs) -> Backend:
    """Resolve a backend name (or pass an instance through)."""
    if isinstance(backend, Backend):
        return backend
    try:
        cls = BACKENDS[backend]
    except KeyError:
        raise ValueError(f"unknown backend {backend!r}; "
                         f"available: {sorted(BACKENDS)}") from None
    return cls(cfg, **kwargs)


def run(program: "Program", tensors, backend: str | Backend = "cuda",
        **backend_kwargs) -> dict[str, torch.Tensor]:
    """One-shot execution of a single Program on a fresh backend."""
    be = get_backend(backend, program.cfg, **backend_kwargs)
    return be.run_program(program, tensors)


def run_sharded(program: "Program", tensors, mesh,
                backend: str | Backend = "cuda", axis: str | None = None,
                **backend_kwargs) -> dict[str, torch.Tensor]:
    """One-shot sharded execution: partition ``program`` over ``mesh``'s
    arrays (``core/program.shard_program``) and run on a fresh backend."""
    from repro_torch.core import program as programlib
    sharded = programlib.shard_program(program, mesh, axis=axis)
    be = get_backend(backend, program.cfg, **backend_kwargs)
    return be.run_sharded(sharded, tensors)


def cross_check(program: "Program", tensors,
                backends: tuple[str, ...] = ("interpreter", "cuda"),
                rtol: float = 2e-4, atol: float = 2e-4,
                mesh=None, axis: str | None = None,
                **backend_kwargs) -> dict[str, float]:
    """Run ``program`` on every named backend and compare each output to
    the einsum oracle (fp32-accumulate tolerance); returns the max abs
    error per backend and raises on mismatch.

    With ``mesh`` (a ``dist.ArrayMesh``), each backend executes the
    Program *sharded* across the mesh's arrays instead (``axis`` forces
    the split rank) -- the oracle is unchanged, which is exactly the
    sharded-equivalence contract."""
    g = program.gemm
    i = np.asarray(tensors["I"], np.float32)
    w = np.asarray(tensors["W"], np.float32)
    oracle = torch.from_numpy(i @ w)
    if program.activation is not None:
        oracle = program.activation(oracle)
    oracle = oracle.numpy()
    errs: dict[str, float] = {}
    for name in backends:
        if mesh is not None:
            res = run_sharded(program, tensors, mesh, backend=name,
                              axis=axis, **backend_kwargs)
        else:
            res = run(program, tensors, backend=name, **backend_kwargs)
        out = res[program.out_name].cpu().numpy()
        np.testing.assert_allclose(out, oracle, rtol=rtol,
                                   atol=atol + rtol * g.k,
                                   err_msg=f"backend {name!r} diverged from "
                                           f"oracle on {g}")
        errs[name] = float(np.abs(out - oracle).max())
    return errs
