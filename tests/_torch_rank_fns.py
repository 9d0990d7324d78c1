"""What each rank runs in ``tests/test_torch_ranks.py``.

The ranks start by the ``spawn`` method, so the functions they run live
in a module they can import by name, and one that imports neither JAX
nor the JAX package (a rank is the port alone).  Every function here
takes ``(rank, n)`` first and returns picklable numpy and Python values.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.backends import CudaBackend
from repro_torch.configs.feather import feather_config
from repro_torch.core import isa, mapper, program
from repro_torch.dist import ArrayMesh, compressed_dp_allreduce
from repro_torch.dist.sharding import abstract_mesh
from repro_torch.faults import FaultInjector, FaultPlan
from repro_torch.launch.mesh import device_mesh
from repro_torch.obs import metrics as obs_metrics
from repro_torch.runtime import ModelExecutable, ProgramCache, Scheduler

CFG = feather_config(4, 16)
#: (m, k, n): even splits on 2 and 4 arrays (tests/test_sharded.py's
#: GEMM), and ragged ones whose N split leaves a fourth array no shard
SHAPES = ((24, 16, 20), (13, 10, 5))
DATAFLOWS = ("WOS", "IOS")
AXES = ("m", "n", "k")
#: the serves: flat-free mesh serve, chaos with an array going down,
#: and one request whose deadline only rank 0 is given
SERVES = ("mesh", "chaos", "deadline")
_LAUNCHES = obs_metrics.counter("backend_launches_total")


def lowered(shape, df: str) -> program.Program:
    """tests/test_sharded.py's forced lowering of ``shape``."""
    m, k, n = shape
    choice = mapper.MappingChoice(df=getattr(isa.Dataflow, df), vn=4, m_t=8,
                                  k_t=8, n_t=8, n_kg=1, n_nb=1, dup=4)
    return program.lower(mapper.Gemm(m=m, k=k, n=n), choice, CFG)


def gemm_inputs(shape, seed: int = 7) -> dict[str, np.ndarray]:
    m, k, n = shape
    rng = np.random.default_rng(seed)
    return {"I": rng.standard_normal((m, k)).astype(np.float32),
            "W": rng.standard_normal((k, n)).astype(np.float32)}


def grads(seed: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((32, 8)).astype(np.float32),
            "b": (3 * rng.standard_normal(8)).astype(np.float32)}


def shard_map_label() -> float:
    return _LAUNCHES.value(kernel="nest_gemm_shard_map")


def run_gemm(n: int, shape, df: str, axis: str) -> dict:
    """One sharded GEMM on a fresh cpu CudaBackend over ``ArrayMesh(n)``:
    its output, the backend's launches, the ``nest_gemm_shard_map``
    label's and the per-array sub-backends'."""
    be = CudaBackend(CFG, device="cpu")
    prog = lowered(shape, df)
    sharded = program.shard_program(prog, ArrayMesh(n), axis=axis)
    label = shard_map_label()
    out = be.run_sharded(sharded, gemm_inputs(shape))[prog.out_name]
    return {"out": out.numpy(), "n_launches": be.n_launches,
            "label": shard_map_label() - label,
            "sub_launches": sum(s.n_launches
                                for s in be._shard_subs.values()),
            "n_shards": sharded.n_shards}


def serve(rank: int, n: int, kind: str) -> dict:
    """The reduced cell (gemma-7b, 4x16) served by the cuda Scheduler on
    ``ArrayMesh(n)``: 3 requests of 4 steps, seed 7 (tests/test_faults.py).
    ``chaos`` runs the standard fault plan, whose ``array_down`` degrades
    the mesh at tick 2; ``deadline`` gives request 1 a deadline of 0 s on
    rank 0 alone."""
    cache = ProgramCache()
    prefill, decode = (ModelExecutable.for_cell(
        "gemma-7b", s, CFG, cache=cache, mesh=ArrayMesh(n))
        for s in ("prefill_tiny", "decode_tiny"))
    injector = (FaultInjector(FaultPlan.standard(0, n_arrays=n))
                if kind == "chaos" else None)
    sched = Scheduler(prefill, decode, device="cpu", max_concurrent=2,
                      seed=7, faults=injector)
    marks = []
    if injector is not None:
        degrade = sched._degrade_mesh

        def degrade_and_mark(site):
            degrade(site)
            marks.append(shard_map_label())
        sched._degrade_mesh = degrade_and_mark
    for i in range(3):
        late = kind == "deadline" and i == 1 and rank == 0
        sched.submit(decode_steps=4, deadline_s=0.0 if late else None)
    rep = sched.run()
    res = rep.summary().get("resilience", {})
    return {"sums": [r.state_checksum for r in rep.requests],
            "status": [r.status for r in rep.requests],
            "n_arrays": rep.n_arrays,
            "mesh_degraded": res.get("mesh_degraded", 0),
            "injected": dict(injector.injected) if injector else {},
            "unrecovered": injector.unrecovered() if injector else 0,
            "label_after_degrade": (shard_map_label() - marks[0]
                                    if marks else None)}


def compress(rank: int, n: int) -> dict:
    """``compressed_dp_allreduce`` over a one-rank ``"data"`` dimension
    and a two-rank one, every rank given the same gradients (bf16 among
    them), and over all ``n`` ranks with each rank's own gradients."""
    def same():
        g = {k: torch.from_numpy(v) for k, v in grads(11).items()}
        g["h"] = torch.from_numpy(grads(12)["w"]).to(torch.bfloat16)
        return g

    def host(d):
        return {k: v.float().numpy() for k, v in d.items()} | {
            "dtypes": {k: str(v.dtype) for k, v in d.items()}}

    one = device_mesh(abstract_mesh((1, n), ("data", "model")), "cpu")
    two = device_mesh(abstract_mesh((2, n // 2), ("data", "model")), "cpu")
    full = device_mesh(abstract_mesh((n,), ("data",)), "cpu")
    own = {k: torch.from_numpy(v) for k, v in grads(100 + rank).items()}
    return {"one": host(compressed_dp_allreduce(same(), one)),
            "two": host(compressed_dp_allreduce(same(), two)),
            "own": host(compressed_dp_allreduce(own, full))}


def run_all(rank: int, n: int) -> dict:
    """Everything one rank of an ``n``-rank group checks, in one spawn."""
    assert ArrayMesh(n).device_mesh() is not None
    assert ArrayMesh.host().n_arrays == n
    return {"gemm": {(shape, df, axis): run_gemm(n, shape, df, axis)
                     for shape in SHAPES for df in DATAFLOWS
                     for axis in AXES},
            "serve": {kind: serve(rank, n, kind) for kind in SERVES},
            "compress": compress(rank, n),
            "coordinate": ArrayMesh(n).device_mesh().get_coordinate()}


def fail_on_rank_1(rank: int, n: int) -> None:
    """Rank 1 raises while rank 0 waits for it in a collective."""
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier()


def outlive_the_deadline(rank: int, n: int) -> None:
    time.sleep(600)
