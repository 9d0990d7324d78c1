"""Ranks of a process group: the port's twin of the JAX package's devices.

The JAX package runs a mesh of arrays in one process, over the devices
``jax.devices()`` lists (on a CPU, host devices faked by ``XLA_FLAGS``).
PyTorch's idiom for several devices is SPMD instead: the same program
runs once per rank of a ``torch.distributed`` process group, and a
``DeviceMesh`` names the ranks.  This module holds what that needs:

  spawn        start ``n`` ranks, run ``fn(rank, n, *args)`` on each and
               return their results in rank order (the tests and
               ``chip_smoke.py`` start their ranks through it)
  world_size   the default group's size, 1 without a group
  device_mesh  the cached one-dimensional ``DeviceMesh`` of ``n`` ranks
               (``dist.ArrayMesh.device_mesh`` reads it)
  all_gather / broadcast
               the collectives the sharded launch and the gradient
               all-reduce use, staged through host memory over gloo

Transport: gloo wherever ranks run on the CPU or share a card, nccl only
where every rank has a card of its own (nccl refuses two ranks on one
device).  Over gloo each collective copies its tensor to the host before
the call and back after it, so the CPU and a shared card run one code
path.
"""

from __future__ import annotations

import datetime
import os
import pickle
import queue as queue_mod
import time
import traceback
import uuid

import torch
import torch.distributed as dist

from repro_torch.obs import metrics as obs_metrics

#: host wall seconds inside the collectives, staging copies included
#: (the tensor's stream is synchronised first, so a kernel still running
#: is not counted), by collective
_COLLECTIVE_S = obs_metrics.counter(
    "collective_seconds_total", "wall seconds in rank collectives by op")


class RankFailed(RuntimeError):
    """A spawned rank raised, or exited without a result."""

    def __init__(self, rank: int, detail: str):
        super().__init__(f"rank {rank} failed:\n{detail}")
        self.rank = rank


def world_size() -> int:
    """The default process group's size, or 1 when none is up."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _host_staged(group=None) -> bool:
    return dist.get_backend(group) == "gloo"


def collective_seconds() -> float:
    """Wall seconds this process has spent in the collectives below."""
    return sum(v for _, v in _COLLECTIVE_S.items())


def _timed(op: str, t: torch.Tensor, fn):
    if t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()
    t0 = time.perf_counter()
    out = fn()
    _COLLECTIVE_S.inc(time.perf_counter() - t0, op=op)
    return out


def all_gather(t: torch.Tensor, group=None) -> list[torch.Tensor]:
    """Every rank's ``t`` (one shape and dtype on all) in rank order, on
    ``t``'s device."""
    def run():
        src = (t.cpu() if _host_staged(group) else t).contiguous()
        parts = [torch.empty_like(src)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, src, group=group)
        return [p.to(t.device) for p in parts]
    return _timed("all_gather", t, run)


def broadcast(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank (the others pass a tensor of
    the same shape and dtype, whose values are ignored), on ``t``'s
    device."""
    def run():
        buf = (t.cpu() if _host_staged(group) else t).contiguous()
        if buf is t:
            buf = t.clone()
        dist.broadcast(buf, src=src, group=group)
        return buf.to(t.device)
    return _timed("broadcast", t, run)


def broadcast_object(obj, src: int = 0):
    """Rank ``src``'s picklable ``obj`` on every rank of the default
    group."""
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


# the DeviceMesh of each (size, axis name), made once per default group
_MESHES: dict = {}


def device_mesh(n: int, axis_name: str):
    """The one-dimensional ``DeviceMesh`` named ``axis_name`` over ranks
    0..n-1 of the default group.

    Making a ``DeviceMesh`` is collective: every rank of the default
    group takes part, those outside the mesh too.  So one is made per
    size and name and kept, and an SPMD program, which reaches each mesh
    in the same order on every rank, makes it once everywhere.  A mesh
    smaller than the group (one degraded by a failed array) is built on
    the ranks outside it as well, where ``get_coordinate()`` is None:
    that is how such a rank learns that it launches nothing.  Its device
    type is the transport's: ``"cpu"`` for gloo, ``"cuda"`` for nccl."""
    from torch.distributed.device_mesh import DeviceMesh

    world = dist.group.WORLD
    if _MESHES.get("world") is not world:
        _MESHES.clear()
        _MESHES["world"] = world
    mesh = _MESHES.get((n, axis_name))
    if mesh is None:
        mesh = DeviceMesh("cpu" if _host_staged() else "cuda",
                          list(range(n)), mesh_dim_names=(axis_name,))
        _MESHES[(n, axis_name)] = mesh
    return mesh


def _rank_main(rank, n, store, backend, device, timeout_s, fn, args,
               results):
    """One rank: join the group, run ``fn``, report its result (or its
    exception and traceback) on ``results``.  The report is in the pipe
    before the group is torn down, so a peer that fails because this
    rank went away cannot report first."""
    try:
        if device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        else:
            torch.set_num_threads(1)
        dist.init_process_group(
            backend, store=dist.FileStore(store, n), rank=rank,
            world_size=n, timeout=datetime.timedelta(seconds=timeout_s))
        msg = (rank, "ok", fn(rank, n, *args))
    except BaseException as e:  # reported to the parent, which re-raises
        try:
            pickle.dumps(e)
        except Exception:  # an exception that does not pickle: its text
            e = None
        msg = (rank, "error", (e, traceback.format_exc()))
    results.put(msg)
    results.close()
    results.join_thread()
    if dist.is_initialized():
        dist.destroy_process_group()
    if msg[1] == "error":
        raise SystemExit(1)


def spawn(fn, n: int, store_dir: str, *, args: tuple = (),
          device: str = "cpu", timeout_s: float = 60.0,
          deadline_s: float = 600.0) -> list:
    """Run ``fn(rank, n, *args)`` on ``n`` new ranks; their results (which
    must pickle) in rank order.

    ``fn`` must be importable by name (a module-level function), as the
    ranks start by the ``spawn`` method.  ``args`` are pickled by
    ``torch.multiprocessing``, so CUDA tensors among them reach the
    ranks by IPC, without a copy (keep them alive until this returns).
    The ranks meet at a ``FileStore`` in ``store_dir``, never on a TCP
    port.  ``device="cuda"`` sets each rank's card to ``rank % cards``
    and takes nccl only when there are at least ``n`` cards (else gloo:
    the ranks share a card); ``"cpu"`` runs gloo on one thread a rank.
    ``timeout_s`` bounds each collective, so a rank left waiting by a
    peer fails in seconds.  The parent waits ``deadline_s`` at most; a
    rank that raises or outlives the deadline ends the others (killed)
    and its exception is raised here from a :class:`RankFailed` that
    carries its traceback."""
    import torch.multiprocessing as mp

    if device not in ("cpu", "cuda"):
        raise ValueError(f"device must be 'cpu' or 'cuda', got {device!r}")
    backend = ("nccl" if device == "cuda"
               and torch.cuda.device_count() >= n else "gloo")
    store = os.path.join(store_dir, f"store-{uuid.uuid4().hex}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, n, store, backend, device, timeout_s, fn,
                               args, results)) for r in range(n)]
    for p in procs:
        p.start()
    got: dict[int, object] = {}
    end = time.monotonic() + deadline_s
    try:
        while len(got) < n:
            left = end - time.monotonic()
            if left <= 0:
                missing = [r for r in range(n) if r not in got]
                raise TimeoutError(f"ranks {missing} of {n} did not finish "
                                   f"within {deadline_s} s")
            try:
                rank, kind, out = results.get(timeout=min(left, 2.0))
            except queue_mod.Empty:
                # a rank that died without a word (killed, crashed): its
                # last message, if any, had time to arrive above
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode is not None]
                if dead:
                    raise RankFailed(dead[0], f"exited with code "
                                     f"{procs[dead[0]].exitcode} and no "
                                     f"result") from None
                continue
            if kind == "error":
                exc, tb = out
                if exc is None:
                    raise RankFailed(rank, tb)
                raise exc from RankFailed(rank, tb)
            got[rank] = out
        for p in procs:
            p.join(timeout=max(1.0, end - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        results.close()
        results.join_thread()
        if os.path.exists(store):
            os.remove(store)
    return [got[r] for r in range(n)]
