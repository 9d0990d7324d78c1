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
    "get_backend", "run", "cross_check",
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


def cross_check(program: "Program", tensors,
                backends: tuple[str, ...] = ("interpreter", "cuda"),
                rtol: float = 2e-4, atol: float = 2e-4,
                **backend_kwargs) -> dict[str, float]:
    """Run ``program`` on every named backend and compare each output to
    the einsum oracle (fp32-accumulate tolerance); returns the max abs
    error per backend and raises on mismatch."""
    g = program.gemm
    i = np.asarray(tensors["I"], np.float32)
    w = np.asarray(tensors["W"], np.float32)
    oracle = torch.from_numpy(i @ w)
    if program.activation is not None:
        oracle = program.activation(oracle)
    oracle = oracle.numpy()
    errs: dict[str, float] = {}
    for name in backends:
        out = run(program, tensors, backend=name, **backend_kwargs)[
            program.out_name].cpu().numpy()
        np.testing.assert_allclose(out, oracle, rtol=rtol,
                                   atol=atol + rtol * g.k,
                                   err_msg=f"backend {name!r} diverged from "
                                           f"oracle on {g}")
        errs[name] = float(np.abs(out - oracle).max())
    return errs
