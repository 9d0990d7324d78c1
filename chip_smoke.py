#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's serving and training main paths on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase catches its own):

  1. environment: the card, CUDA, nvcc, and the kernel build (one nvcc
     per source under src/repro_torch/kernels/csrc, all started together);
  2. every kernel against its plain PyTorch version on the card, at the
     shapes its path gives it, with times (median, min and max of the
     reps) beside the least time the card could take (bound) and one
     PyTorch library call (yardstick); the card's clocks are read before,
     during and after.  nest_gemm's shapes are totalled per decode tick
     and per prefill pass, and the rows of M = 16 and M = 32 launches are
     held bit-equal to the same rows at M = 1; each fused_chain case
     prints its plan (clusters x ranks, placement, shared memory);
     flash_decode runs its case and the serves' shapes beside an empty
     kernel's time (``csrc/empty.cu``, the launch floor), its bf16 route
     at the model zoo's decode shape beside SDPA in bf16 (each bf16 row
     with its cut and grid logged and gated first on a request's rows
     being torch.equal alone and in the batch, and across two calls),
     and its fp32 route bit-equal to the kernel before the bf16 route
     (recorded output digests on exact inputs);
     flash_attention holds fp32 to 1e-4 of its plain version (three TF32
     products on the tensor cores, bound at 495/3 TFLOP/s), logs a bf16
     run at the same shape and times its bf16 route at the model zoo's
     prefill shape, each beside SDPA in bf16, and full (non-causal) at
     whisper-base's encoder shape; flash_decode at whisper-base's cross
     attention (one query against 1500 frames); mamba_scan at falcon-mamba-7b's width
     and at zamba2-1.2b's folded Mamba-2 scan (N = 64), the state
     bit-equal to the plain version's in both.  The attention kernels'
     library call is SDPA on 4-D inputs, every route that takes them
     timed, the fastest kept.  The backward kernels at phase 11's
     shapes: flash_attention with its log-sum-exp (o bit-equal to the
     call without) and flash_attention_bwd, bf16 and fp32, at zamba2's
     [2 * 32, 1024, 64] causal, the backward's library call the backward
     of SDPA (every route, the fastest kept), its bound the five
     products; at [2 * 64, 1024, 64, 64] mamba_scan storing its states
     every 16 steps (y and h_last bit-equal to the call without, the
     states to the plain version's; timed with and without) and
     mamba_scan_bwd given those states (dda, ddbx and dh0 bit-equal to
     the plain version, dc within fp32 tolerance); each backward run
     twice, torch.equal;
  3. the kernel ops entry point: ``ops.flash_attention`` over gemma-7b's
     heads at 4096 tokens and ``ops.mamba_scan`` at falcon-mamba-7b's
     width, bit-equal to the kernels checked in phase 2;
  4. full-width gemma-7b (FEATHER+ 16x256) served by the Scheduler: 9
     launches per decode tick through nest_gemm and flash_decode,
     deterministic checksums, batched == sequential decode;
  5. block-fused decode attention at full width: one
     ``run_batched_attention_proj`` launch (flash_decode_proj) for 4
     requests, equal to the base oracle (attention + adapt + Wo); phase 2
     holds each request's rows of that kernel bit-equal between a
     4-request and a 1-request launch;
  6. the reduced gemma-7b cell (4x16): batched fused decode on the card
     (fused_chain launched) with checksums bit-equal to the CPU path;
  7. the functional interpreter on the card: the reduced cell served by
     ``Scheduler(..., backend="interpreter")`` (no kernel launched) twice,
     checksums equal to each other and to phase 6's (so to the CPU
     path's); a decode stream run twice, torch.equal; one
     ``backends.cross_check`` of interpreter == cuda == oracle;
  8. autotune: every fused segment of the reduced cells measured on the
     card, a warm second pass doing no work, the tuned serve's checksums
     equal to the untuned serve's, and no segment legal to tune at full
     width.
  9. the multi-array path (``dist.ArrayMesh``; one card, so the arrays'
     shards run one after another): ``backends.cross_check`` of
     interpreter == cuda == oracle sharded on 2 and 4 arrays, every axis,
     both dataflows; nest_gemm at every full-width shard shape against
     its plain version; full-width gemma-7b on 4 arrays served by the
     Scheduler on phase 4's resident weights (nest_gemm launches equal to the shards the path runs,
     repeat-identical checksums, weight slices copied once, a checked
     decode stream, per-array bytes summing to the total); the reduced
     cell on 4 and 2 arrays (each array's fused segment against its plain
     version; checksums equal to the CPU path's and the flat serve's, one
     fused_chain launch an array for each sharded fused segment); chaos on
     the card, flat and with an array going down; a serve resumed from a
     snapshot file.
 10. the model zoo: gemma-7b (28 layers), falcon-mamba-7b (64),
     granite-moe-3b-a800m (32), zamba2-1.2b (38 Mamba-2 blocks, a shared
     attention block after every 6) and whisper-base (6 + 6) at full
     width and depth, and deepseek-v2-236b at full width cut to 4 layers
     (1 dense, 3 MoE: the whole model is 472 GB in bf16), in bf16, built
     and served as ``python -m repro_torch.launch.serve --arch ARCH``
     does (batch 4, prompt 32, 16 greedy steps, weights drawn on the card
     from a seeded generator, whisper's frames drawn after the prompts):
     exact launches (``zoo_launches``: attention once a layer, the
     hybrid's once an application, encdec's once an encoder layer and
     twice a decoder layer; mamba_scan once a Mamba block a step; no
     other kernel), tokens identical over two serves, each kernel's first
     and last call of the prefill and of the last decode step held
     against their plain versions, the logits of a prefill and a decode
     step held against the same model on the plain versions (and shown
     to move past the tolerance when each kernel's last call is dropped:
     seeded weights make greedy tokens repeat, so tokens alone see no
     kernel fault; an MoE model, which amplifies a ulp chaotically, over
     16 requests with the plain versions fed each layer's input and
     experts from the kernel run, every layer's contribution held too,
     and the share of routes the plain versions would choose alike on
     their own logged), the decode step beside the bound of the bytes it
     must move (``decode_step_bytes``), the peak memory and the
     device's idle share over 4 traced decode steps, with no dry run
     beside (a stage line counts their processes); then every model at
     depth 2
     (zamba2 at 7: one application and a tail block) in fp32 (the MoE
     models at capacity factor experts / top-k, which drops nothing):
     decode after a prefill equal to the longer prefill (rtol and atol
     2e-3).  Phase 2 also times flash_attention and flash_decode at
     MLA's shapes (rows flash_attention_mla and flash_decode_mla).
 11. training: ``python -m repro_torch.launch.train`` 's main path
     (``launch.train.Run``) for zamba2-1.2b at full width and depth, bf16
     weights and fp32 AdamW state, batch 2 x 1024 tokens, peak lr 1e-3,
     30 steps on ``SyntheticLM`` (the peak memory reckoned first, then
     read): every loss finite and the mean of the last 5 at least 0.2
     below the first 5's; launches exact (``train_launches``: a step runs
     flash_attention and flash_attention_bwd once an application of the
     shared block, mamba_scan twice a Mamba block, forward and the
     remat's recompute, and mamba_scan_bwd once); ms a step, tokens/s,
     peak GiB, and one more step traced by ``torch.profiler`` (the
     device's idle share, the operators by device time).  Then at full
     width and depth 7, one step's gradients on the kernels, twice
     (torch.equal), against the same step on the plain versions
     differentiated by autograd, per parameter relative L2 within
     ``TRAIN_GRAD_TOL`` (bf16 and fp32); and two steps straight against
     one step, a checkpoint, a new run resumed from it (``--resume
     auto``) and one step: every parameter and optimizer tensor
     torch.equal.
 12. the examples and the dry run: ``examples/torch_quickstart.py``
     (both backends within 1e-3 of the oracle; nest_gemm launched);
     ``examples/torch_serve_lm.py`` on cuda (fused_chain, flash_decode
     and nest_gemm launched) and on the interpreter on the card, the
     per-request checksums bit-equal; ``examples/torch_minisa_plan.py
     --check-backends`` for gemma-7b and deepseek-v2-236b at 16x256
     (nest_gemm at their decode_32k GEMM shapes; worst |err| and the
     GEMMs run logged); ``examples/torch_train_lm.py`` (gemma-7b cut to
     8 layers at d 512, batch 8 x 256) for 20 steps and resumed to 30,
     launches exact and the loss falling, and a straight 30-step run
     against the same run resumed from its checkpoint of 20, every
     parameter and optimizer tensor torch.equal; then ``launch.dryrun
     --all`` on the 16 x 16 and the 2 x 16 x 16 meshes (started after
     phase 11, each in a process of its own beside phases 12, 14 and
     15: it needs no card; read at the script's end): each exits 0 with 32 cells OK and 8 SKIP, each
     step traced whole and partitioned over a fake process group of
     256 or 512 ranks, on ``meta``, in a process that never initialised
     CUDA and left no group behind, each cell's numbers logged
     (per-device flops, collective bytes, t_collective), the five
     largest t_compute and t_collective, and each dense prefill cell's
     products outside the kernel ops against ``core.model_gemms``.
     Each example's launches go on a line of their own.

 13. the array mesh as ranks (``dist.ranks``; it runs right after phase
     9, on phase 4's weights): ranks sharing the card over gloo, spawned
     (``dist.ranks.spawn``) 2 and then 4 at a time, each loading the
     kernels phase 1 built.  On each: phase 9's sharded programs
     (``MESH_CHECK_GEMMS``, both dataflows, axes m, n and k) through
     ``CudaBackend.run_sharded`` over the ranks, torch.equal on every
     rank to the sequential path in this process and within rtol 2e-4,
     atol 2e-4 + 2e-4·k of the oracle, one nest_gemm a rank a program
     by the counters; phase 9's chaos serve (an array goes down at tick
     2), its checksums, one degrade, and nothing sharded launched after
     it by the rank left outside.  On 4 ranks also full-width gemma-7b
     on ``ArrayMesh(4)`` served by the Scheduler on every rank (phase
     4's weights mapped into each rank from the parent's card memory),
     checksums equal on every rank and to phases 9 and 4, launches
     equal to the rank's shards, each rank's peak card memory beside
     phase 9's, rank 0's ms a tick and its collectives' share; and
     ``compressed_dp_allreduce`` over data = 4 on the card, torch.equal
     to the ordered mean of the ranks' round trips, identical on all.

 14. training on a mesh (``launch.train.Run`` under a process group,
     its parameters, fp32 master weights and moments DTensors placed by
     ``dist.sharding``'s rules): zamba2-1.2b at full width and depth 7
     (six Mamba-2 blocks, one application of the shared block, a tail
     block), global batch 4 x 1024, on 4 ranks sharing the card over
     ``dist.ranks.HOST_STAGED`` (every collective staged through host
     memory over gloo), on the (2, 2) ``("data", "model")`` mesh and on
     the (1, 4) one ``make_host_mesh`` gives 4 ranks.  First one process
     without a mesh: one step's gradients in bf16 and in fp32 (kept on
     the card, mapped into the ranks), and ``Run``'s 2 fp32 steps.  On
     each mesh every rank: the same step's gradients, gathered, within
     ``TRAIN_GRAD_TOL`` (relative L2) of one process's; ``Run``'s 2 fp32
     steps, the losses within ``MESH_LOSS_RTOL`` of one process's and
     falling, each rank launching flash_attention, flash_attention_bwd,
     mamba_scan and mamba_scan_bwd on its local shard exactly as often
     as ``train_launches`` says for one process, each step's exactly;
     rank 0's ms a step, its collectives a step and their share, each
     rank's peak card memory (logged, no limit: ranks sharing one card
     say nothing of a mesh of cards).  The (2, 2) run's checkpoint
     (gathered by every rank, written by rank 0) restored on (1, 4) and
     in one process: every array torch.equal to the file.

 15. serving on a mesh (``Model.prefill`` and ``Model.decode_step`` with
     the weights DTensors placed by the inference rules, the cache at
     ``cache_axes``): gemma-7b and zamba2-1.2b at full width, on 4 ranks
     sharing the card over ``dist.ranks.HOST_STAGED``, on the (2, 2)
     and (1, 4) meshes, a batch of 4 prompts of 32 tokens, a prefill and
     8 greedy decode steps.  One process serves each first without a
     mesh (bf16 at full depth, fp32 at ``MESH_SERVE_DEPTH``); its
     weights stay on the card and reach the ranks by CUDA IPC, each
     rank taking its shards.  On every rank: the gathered logits of the
     prefill and each step within 2e-2 (bf16, fed one process's tokens)
     and 1e-4 (fp32) relative L2 of one process's, the fp32 greedy
     tokens equal; flash_attention, flash_decode and mamba_scan
     launched on the rank's local shard exactly as often as one
     process launches them; rank 0's first flash_decode held to its
     plain version.  Logged: rank 0's ms a decode step, its collectives
     a step (count, MiB, share of the step), each rank's peak card
     memory.

Phases 10 to 12, 14 and 15 run last, after phase 9's weights are freed,
and free what they make.  Ends with the ``kernels`` JSON line (a row per
route, each with its own path's launches and what its times were taken at), the card's
name and power limit, and the result line ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import gc
import hashlib
import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch import backends  # noqa: E402
from repro_torch.backends import (Backend, CudaBackend,  # noqa: E402
                                  compile_program, compile_segment)
from repro_torch.configs.feather import feather_config  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.configs.registry import ARCH_IDS, get_config  # noqa: E402
from repro_torch.core import isa, mapper, workloads  # noqa: E402
from repro_torch.core import program as programlib  # noqa: E402
from repro_torch.dist import ArrayMesh  # noqa: E402
from repro_torch.dist import compressed_dp_allreduce  # noqa: E402
from repro_torch.dist import ranks as dist_ranks  # noqa: E402
from repro_torch.dist.compression import fake_quantize_int8  # noqa: E402
from repro_torch.dist.sharding import abstract_mesh  # noqa: E402
from repro_torch.dist.elastic import (load_serving_snapshot,  # noqa: E402
                                      save_serving_snapshot)
from repro_torch.faults import FaultInjector, FaultPlan  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import fused_chain as fc  # noqa: E402
from repro_torch.kernels import mamba_scan as ms  # noqa: E402
from repro_torch.kernels import nest_gemm as ng  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.core.model_gemms import gemm_workloads  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch.mesh import device_mesh as launch_device_mesh  # noqa: E402,E501
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.transformer import DecoderLayer  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402
from repro_torch.serve import expand_cache  # noqa: E402
from repro_torch.train import optimizer as optlib  # noqa: E402
from repro_torch.runtime import (ModelExecutable, ProgramCache,  # noqa: E402
                                 Scheduler, autotune_segment, segment_key)
from repro_torch.runtime.autotune import _segment_tensors  # noqa: E402

#: H100 SXM data-sheet peaks (at the 700 W limit): HBM bytes/s, and the
#: flop/s of each kernel's route: fp32 FFMA outside the tensor cores, fp32
#: on the tensor cores by three TF32 products (495 TFLOP/s / 3), bf16
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
PEAK_3XTF32 = 495e12 / 3
PEAK_BF16 = 989e12
RTOL = 2e-4                      # the reference's cross_check tolerance
REPS = 10
#: the reduced cell's submissions (tests/test_batched_decode.py)
SUBMISSIONS = [(3, None), (1, None), (2, 64), (4, 32), (2, None)]


_T0 = time.perf_counter()


def log(*args) -> None:
    print(*args, flush=True)


def stage(name: str) -> None:
    """Log the seconds since the script started, as ``name`` begins."""
    log(f"-- {name} at {time.perf_counter() - _T0:.1f} s")


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def clocks(when: str) -> None:
    """The card's clocks, temperature and draw, beside the timings."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,clocks.max.sm,"
         "temperature.gpu,power.draw", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"clocks {when}: {out.splitlines()[0]} (sm, mem, max sm, "
        f"temperature, draw)")


def bound(nbytes: float, flops: float,
          rate: float = PEAK_FP32) -> tuple[float, str]:
    """Least time (ms) the card could take at the route's flop ``rate``,
    and what bounds it."""
    tb, tf = nbytes / PEAK_BYTES, flops / rate
    return (max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations")


_EMPTY = None


def launch_floor() -> None:
    """One launch of ``csrc/empty.cu``'s empty kernel: timed like the
    kernels, the floor a launch cannot go under."""
    global _EMPTY
    if _EMPTY is None:
        fn = build.load("empty").empty_launch
        fn.argtypes = [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _EMPTY = fn
    build.raise_on_error(_EMPTY(build.stream_handle()), "empty kernel")


class Timer:
    """Device ms of ``fn`` by CUDA events over ``reps`` calls: their
    median (``ms``), min and max, and every rep.  L2 is flushed before
    each call (the main path finds its weights cold: a decode tick reads
    4.25 GB) and the stream held busy while the host enqueues ``fn``, so
    host launch overhead is not timed."""

    def __init__(self):
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
        self.start = torch.cuda.Event(enable_timing=True)
        self.end = torch.cuda.Event(enable_timing=True)

    def __call__(self, fn, reps: int = REPS) -> dict:
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            self.clear_l2()
            torch.cuda._sleep(1_000_000)    # ~0.5 ms of device spin
            self.start.record()
            fn()
            self.end.record()
            self.end.synchronize()
            times.append(self.start.elapsed_time(self.end))
        return {"ms": statistics.median(times), "ms_min": min(times),
                "ms_max": max(times), "reps": times}

    def clear_l2(self) -> None:
        """Evict L2 (50 MB) by writing 256 MB."""
        self.flush.zero_()


def spread(t: dict) -> str:
    return f"{t['ms']:.4f} [{t['ms_min']:.4f}..{t['ms_max']:.4f}]"


def row_stats(t: dict, plain: dict, lib: dict | None, nbytes: float,
              flops: float, err: float, rate: float = PEAK_FP32) -> dict:
    """A kernel's row: the medians, the kernel's spread, its work and the
    flop rate of its route."""
    return {"ms": t["ms"], "ms_min": t["ms_min"], "ms_max": t["ms_max"],
            "plain_ms": plain["ms"],
            "library_ms": None if lib is None else lib["ms"],
            "bytes": nbytes, "flops": flops, "err": err, "rate": rate}


def check(name: str, got, want, k: int, rtol: float = RTOL) -> float:
    """Hold ``got`` against ``want`` at rtol 2e-4 (or ``rtol``), atol
    2e-4*k.  The inputs are drawn so that the plain result's RMS is at
    least 10x the atol: a kernel that returned zeros, or dropped part of
    K, would fail."""
    atol = RTOL * k
    rms = float(want.pow(2).mean().sqrt())
    assert atol < 0.1 * rms, (f"{name}: atol {atol} is not small against "
                              f"the result (RMS {rms})")
    err = (got - want).abs()
    tol = atol + rtol * want.abs()
    if not bool(torch.isfinite(got).all()) or bool((err > tol).any()):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (max |err| {float(err.max())}, "
                             f"atol {atol})")
    return float(err.max())


def sdpa_library(timer, name: str, want, then, q, k, v, **kw) -> dict:
    """An attention kernel's library call: ``then(SDPA(q, k, v, **kw))`` on
    4-D [batch, heads, S, d] inputs (SDPA's fused routes take no other
    rank).  Every route that takes the inputs (one that does not raises
    at its first call) is timed and its result held against ``want``;
    the route the dispatcher picks, each route's time and error are
    logged, and the fastest route's timing is returned."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    sdpa = torch.nn.functional.scaled_dot_product_attention
    picked = SDPBackend(torch._fused_sdp_choice(q, k, v, **kw)).name.lower()
    best, parts = None, []
    for route in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                  SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        route_name = route.name.lower()

        def call(route=route):
            with sdpa_kernel([route]):
                return then(sdpa(q, k, v, **kw))
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                got = call()
        except RuntimeError:        # the route does not take these inputs
            parts.append(f"{route_name} -")
            continue
        err = float((got.float() - want.float()).abs().max())
        t = timer(call)
        parts.append(f"{route_name} {spread(t)} (max_err {err:.3g})")
        if best is None or t["ms"] < best["ms"]:
            best = {**t, "route": route_name}
    assert best is not None, f"{name}: no SDPA route takes the inputs"
    log(f"  {name} library, SDPA on 4-D inputs: the dispatcher picks "
        f"{picked}; {'; '.join(parts)}; fastest {best['route']}")
    return best


def reset_counts() -> None:
    ng.launches = fc.launches = fa.launches = 0
    fa.proj_launches = fa.attention_launches = ms.launches = 0
    fa.attention_bwd_launches = ms.bwd_launches = 0


def counts() -> dict:
    return {"nest_gemm": ng.launches, "fused_chain": fc.launches,
            "flash_decode": fa.launches,
            "flash_decode_proj": fa.proj_launches,
            "flash_attention": fa.attention_launches,
            "flash_attention_bwd": fa.attention_bwd_launches,
            "mamba_scan": ms.launches,
            "mamba_scan_bwd": ms.bwd_launches}


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def nest_gemm_shapes(decode, prefill, bucket: int) -> list[tuple]:
    """Distinct (M, K, N, out_block_t, act, bk) the decode plan at
    ``bucket`` and a prefill pass launch on nest_gemm, with how many
    times one decode tick and one prefill pass launch each."""
    shapes: dict[tuple, list[int]] = {}

    def add(prog, tick: int, pas: int) -> None:
        comp = compile_program(prog)
        g = prog.gemm
        key = (g.m, g.k, g.n, comp.out_block_t, comp.fused_act, comp.bk)
        n = shapes.setdefault(key, [0, 0])
        n[0] += tick
        n[1] += pas

    for seg in decode.batch_plan(bucket).segments:
        if seg.kind != "static" or seg.fused is not None:
            continue
        for prog in seg.programs:
            add(prog, 1, 0)
    for step in prefill.steps:
        add(step.program, 0, 1)
    return [(*key, *n) for key, n in shapes.items()]


def _total() -> dict:
    return {"ms": 0.0, "ms_min": 0.0, "ms_max": 0.0, "plain_ms": 0.0,
            "library_ms": 0.0, "bytes": 0.0, "flops": 0.0, "err": 0.0,
            "rate": PEAK_FP32}


def check_nest_gemm(shapes, timer, gen) -> tuple[dict, dict]:
    """Every shape against the plain version, timed; returns the decode
    tick's total and one prefill pass's total.  A call on the wide-weight
    path is two kernel launches (X laid out group-major, then the GEMM):
    its time holds both, and the prefill pass's bound also counts the
    relayout's bytes (X read, the group-major copy written)."""
    log("K1 nest_gemm: M K N out_t act | calls/tick calls/prefill "
        "launches/call | max_err | ms [min..max] plain_ms library_ms "
        "bound_ms | reps")
    tick, pre = _total(), _total()
    pre["relayout_bytes"] = 0.0
    for m, k, n, out_t, act, bk, per_tick, per_pass in shapes:
        # unit-normal X and W: outputs of RMS sqrt(k), against an atol of
        # 2e-4*k (0.031 of the RMS at the widest K, 24576)
        x = torch.randn(m, k, device="cuda", generator=gen)
        w = torch.randn(k, n, device="cuda", generator=gen)
        got = ng.nest_gemm(x, w, out_block_t=out_t, act=act)
        want = ref.nest_gemm_ref(x, w, bk=bk, out_block_t=out_t, act=act)
        err = check(f"nest_gemm {(m, k, n, out_t, act)}", got, want, k)
        ms = timer(lambda: ng.nest_gemm(x, w, out_block_t=out_t, act=act))
        plain = timer(lambda: ref.nest_gemm_ref(x, w, bk=bk,
                                                out_block_t=out_t, act=act))
        wt, xt = w.t(), x.t()
        lib = timer((lambda: torch.matmul(wt, xt)) if out_t
                    else (lambda: torch.matmul(x, w)))
        nbytes, flops = 4.0 * (m * k + k * n + m * n), 2.0 * m * k * n
        b_ms, b_by = bound(nbytes, flops)
        relayout = ng.scratch_floats(m, k, n, w.data_ptr())
        log(f"  {m} {k} {n} {out_t} {act} | {per_tick} {per_pass} "
            f"{2 if relayout else 1} | {err:.3g} | {spread(ms)} "
            f"{plain['ms']:.4f} {lib['ms']:.4f} {b_ms:.4f} ({b_by}) | "
            f"{[round(r, 4) for r in ms['reps']]}")
        pre["relayout_bytes"] += per_pass * 4.0 * (m * k + relayout)
        del got, want
        for tot, count in ((tick, per_tick), (pre, per_pass)):
            for key, val in (("ms", ms["ms"]), ("ms_min", ms["ms_min"]),
                             ("ms_max", ms["ms_max"]),
                             ("plain_ms", plain["ms"]),
                             ("library_ms", lib["ms"]), ("bytes", nbytes),
                             ("flops", flops)):
                tot[key] += count * val
            if count:
                tot["err"] = max(tot["err"], err)
    for label, tot in (("decode tick", tick), ("prefill pass", pre)):
        b_ms, b_by = bound(tot["bytes"], tot["flops"])
        log(f"K1 nest_gemm {label} total: {tot['ms']:.4f} "
            f"[{tot['ms_min']:.4f}..{tot['ms_max']:.4f}] ms, library "
            f"{tot['library_ms']:.4f}, bound {b_ms:.4f} ({b_by}), plain "
            f"{tot['plain_ms']:.4f}")
    b_ms, b_by = bound(pre["bytes"] + pre["relayout_bytes"], pre["flops"])
    log(f"K1 nest_gemm prefill pass bound with the X relayout's "
        f"{pre['relayout_bytes'] / 1e6:.3f} MB: {b_ms:.4f} ({b_by})")
    return tick, pre


def check_rows_alone(shapes, gen) -> None:
    """The rows of an M = 16 and an M = 32 launch are bit-equal to the
    same rows launched one at a time (M = 1), at lm_head's and
    mlp.down's prefill shapes: the K order depends on K alone."""
    for m, k, n, out_t, act, *_ in shapes:
        if m != 32 or (k, n) not in ((3072, 256000), (24576, 3072)):
            continue
        x = torch.randn(m, k, device="cuda", generator=gen)
        w = torch.randn(k, n, device="cuda", generator=gen)
        alone = torch.cat([ng.nest_gemm(x[i:i + 1].contiguous(), w,
                                        act=act) for i in range(m)])
        for rows in (16, 32):
            got = ng.nest_gemm(x[:rows].contiguous(), w, out_block_t=out_t,
                               act=act)
            got = got.t() if out_t else got
            assert torch.equal(got, alone[:rows]), \
                (m, k, n, rows, float((got - alone[:rows]).abs().max()))
        log(f"K1 nest_gemm ({k}, {n}): rows of M = 16 and M = 32 launches "
            f"torch.equal to the same rows at M = 1")
        del x, w, alone, got
    torch.cuda.empty_cache()


#: flash_decode's cases (B, sq, skv, d, lengths): the timed row's (lengths
#: from 1 to skv), then the full-width and reduced serves' shapes
DECODE_CASES = [(4, 1, 16, 256, (16, 1, 9, 5)), (4, 1, 16, 256, (16,) * 4),
                (5, 1, 16, 16, (16,) * 5)]


def check_flash_decode(timer, gen) -> dict:
    """Each case against the plain version and timed, beside the empty
    kernel's launch floor; the first case is the kernels JSON row."""
    floor = timer(launch_floor)
    log(f"K3 launch floor (empty kernel, 1 block of 32 threads): ms "
        f"{spread(floor)}")
    row = None
    for b, sq, skv, d, lengths in DECODE_CASES:
        q = torch.randn(b, sq, d, device="cuda", generator=gen)
        k = torch.randn(b, skv, d, device="cuda", generator=gen) * 0.5
        v = torch.randn(b, skv, d, device="cuda", generator=gen)
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        got = fa.flash_decode(q, k, v, lens)
        want = ref.flash_decode_ref(q, k, v, lens)
        name = f"flash_decode {(b, sq, skv, d)}"
        err = check(name, got, want, d)
        mask = (torch.arange(skv, device="cuda")[None, :] < lens[:, None])
        ms = timer(lambda: fa.flash_decode(q, k, v, lens))
        plain = timer(lambda: ref.flash_decode_ref(q, k, v, lens))
        lib = sdpa_library(timer, name, want, lambda o: o[:, 0], q[:, None],
                           k[:, None], v[:, None],
                           attn_mask=mask[:, None, None, :], scale=1.0)
        used = int(lens.sum())       # the KV rows this run's lengths need
        nbytes = 4.0 * (2 * b * sq * d + 2 * used * d) + 4 * b
        flops = 4.0 * sq * used * d
        log(f"K3 flash_decode: B {b} sq {sq} skv {skv} d {d} lengths "
            f"{list(lengths)} | max_err {err:.3g} | ms {spread(ms)} plain "
            f"{plain['ms']:.4f} sdpa {lib['ms']:.4f} ({lib['route']}) bound "
            f"{bound(nbytes, flops)[0]:.6f} launch floor {floor['ms']:.4f}")
        if row is None:
            row = row_stats(ms, plain, lib, nbytes, flops, err)
        row["err"] = max(row["err"], err)
    row["floor_ms"] = floor["ms"]
    return row


#: flash_decode's bf16 route at the model zoo's decode shape: gemma-7b's
#: [B * KVH, g, D] = [4 * 16, 1, 256] against a cache of 49 positions, the
#: last decode step's length (32 prompt + 15 steps), scale 256**-0.5
DECODE_BF16_CASE = (64, 1, 49, 256, 47)


def decode_bf16_case(name: str) -> tuple:
    """(B, sq, skv, d, dv, length, scale, v's scale) of a bf16 row."""
    if name == "flash_decode_bf16":
        b, sq, skv, d, length = DECODE_BF16_CASE
        return b, sq, skv, d, d, length, d ** -0.5, 1.0
    if name == "flash_decode_mla":
        # v at 2x: an output RMS ~2, over 10x check()'s atol at k = d
        return (*MLA_DECODE_CASE, 192 ** -0.5, 2.0)
    b, sq, skv, d = CROSS_DECODE_CASE
    return b, sq, skv, d, d, skv, d ** -0.5, 1.0


def decode_bf16_inputs(name: str, gen) -> tuple:
    """(q, k, v, lengths, scale) of a bf16 row, drawn on the card: q at
    1/scale (scores of std 4-8, a peaked softmax whose output RMS is far
    above check()'s atol, as at the fp32 cases), k at 0.5."""
    b, sq, skv, d, dv, length, scale, v_scale = decode_bf16_case(name)
    q = (torch.randn(b, sq, d, device="cuda", generator=gen) / scale
         ).to(torch.bfloat16)
    k = (torch.randn(b, skv, d, device="cuda", generator=gen) * 0.5
         ).to(torch.bfloat16)
    v = (torch.randn(b, skv, dv, device="cuda", generator=gen) * v_scale
         ).to(torch.bfloat16)
    lens = torch.full((b,), length, dtype=torch.int32, device="cuda")
    return q, k, v, lens, scale


#: check()'s rtol for each bf16 row: the cross row one bf16 ulp more, as
#: flash_attention_enc (1500 keys in a sum)
DECODE_BF16_RTOL = {"flash_decode_bf16": RTOL, "flash_decode_mla": RTOL,
                    "flash_decode_cross": RTOL + 2 ** -7}


def check_flash_decode_bf16(name: str, timer, gen) -> dict:
    """The bf16 route at one of its rows (``decode_bf16_case``: the zoo's
    GQA decode, MLA's absorbed decode with d 576 and dv 512 and 128 query
    rows, whisper's cross attention over 1500 frames) against its plain
    version (p rounded to bf16 before P V, output in bf16); gated, before
    any timing, on the last request's rows being the same bits launched
    alone as in the batch, and on the built kernel's cut (``decode_plan``)
    being the one the wrapper reckons; then timed beside SDPA on the same
    bf16 inputs (every route, the fastest kept) and its bound: the
    kernels JSON row ``name``."""
    b, sq, skv, d, dv, length, _, _ = decode_bf16_case(name)
    q, k, v, lens, scale = decode_bf16_inputs(name, gen)
    got = fa.flash_decode(q, k, v, lens, scale=scale)
    want = ref.flash_decode_ref(q, k, v, lens, scale=scale)
    assert got.dtype == want.dtype == torch.bfloat16
    label = f"{name} {(b, sq, skv, d, dv)}"
    err = check(label, got.float(), want.float(), d, DECODE_BF16_RTOL[name])
    alone = fa.flash_decode(q[-1:], k[-1:], v[-1:], lens[-1:], scale=scale)
    assert torch.equal(alone[0], got[-1]), f"{label}: a row depends on B"
    assert torch.equal(fa.flash_decode(q, k, v, lens, scale=scale), got)
    plan = fa.decode_plan_on_card(skv, d, dv, sq)
    assert plan == fa.decode_plan(skv, d, dv, sq), plan
    grid = (plan["n_split"], -(-sq // 16) * plan["strips"], b)
    log(f"K3 {label}: {plan['n_split']} range(s) of {plan['split']} keys "
        f"(a cluster of {plan['n_split']}), chunks of {plan['chunk']}, "
        f"{plan['stages']} in flight, {plan['smem']} B of shared memory a "
        f"block, grid {grid} = {grid[0] * grid[1] * grid[2]} blocks; the "
        f"last request's rows torch.equal alone and in the batch of {b}, "
        f"and across two calls")
    masked = length < skv
    mask = (torch.arange(skv, device="cuda")[None, :] < lens[:, None])
    ms_ = timer(lambda: fa.flash_decode(q, k, v, lens, scale=scale))
    plain = timer(lambda: ref.flash_decode_ref(q, k, v, lens, scale=scale))
    kw = {"attn_mask": mask[:, None, None, :]} if masked else {}
    lib = sdpa_library(timer, label, want, lambda o: o[:, 0], q[:, None],
                       k[:, None], v[:, None], scale=scale, **kw)
    used = b * length                # the KV rows these lengths need
    nbytes = 2.0 * (b * sq * d + used * (d + dv) + b * sq * dv) + 4 * b
    flops = 2.0 * sq * used * (d + dv)
    b_ms, b_by = bound(nbytes, flops, PEAK_BF16)
    log(f"K3 {label}: lengths {length} | max_err {err:.3g} | ms "
        f"{spread(ms_)} plain {plain['ms']:.4f} sdpa {lib['ms']:.4f} "
        f"({lib['route']}) bound {b_ms:.6f} ({b_by})")
    return row_stats(ms_, plain, lib, nbytes, flops, err, PEAK_BF16)


#: (B, sq, skv, d, dv, lengths) of the fp32 route's bit-equality gate:
#: the full-width serve's shape with ragged lengths, two row groups and a
#: part strip, d and dv off the float4 grid (element copies), and the
#: model zoo's decode shape
DIGEST_CASES = [(4, 1, 16, 256, 256, (16, 1, 9, 5)),
                (3, 20, 37, 64, 96, (0, 37, 16)),
                (2, 3, 19, 20, 28, (19, 4)),
                (64, 1, 49, 256, 256, tuple(33 + i % 15 for i in range(64)))]
#: sha256 (first 16 hex digits) of the fp32 route's output bytes at each
#: DIGEST_CASES case, as the kernel gave them before its bf16 route was
#: added, on an H100 with nvcc 12.8 (compare_kernels.py prints both
#: kernels' digests)
DECODE_F32_DIGESTS = {(4, 1, 16, 256, 256): "c52e55c1bfd33aaf",
                      (3, 20, 37, 64, 96): "8d469ce2f2b520d6",
                      (2, 3, 19, 20, 28): "f0dffe674325e183",
                      (64, 1, 49, 256, 256): "57cd3b9f346f3d56"}


def exact_inputs(shape, salt: int, scale: float) -> torch.Tensor:
    """fp32 values on the card from integer arithmetic alone (every value
    exact), the same on every run and every torch: a multiple of 1/1024
    in [-2, 2) times ``scale`` (a power of two)."""
    n = 1
    for x in shape:
        n *= x
    i = torch.arange(n, dtype=torch.int64, device="cuda")
    vals = ((i * 2654435761 + salt * 40503) % 4099).float() - 2049.0
    return (vals / 1024.0 * scale).reshape(shape)


def decode_digests(flash_decode) -> list[str]:
    """``flash_decode(q, k, v, lengths)``'s fp32 output at each
    DIGEST_CASES case, as sha256 digests of its bytes."""
    import hashlib
    out = []
    for b, sq, skv, d, dv, lengths in DIGEST_CASES:
        q = exact_inputs((b, sq, d), 1, 1.0)
        k = exact_inputs((b, skv, d), 2, 0.5)
        v = exact_inputs((b, skv, dv), 3, 1.0)
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        o = flash_decode(q, k, v, lens)
        torch.cuda.synchronize()
        out.append(hashlib.sha256(o.cpu().numpy().tobytes()).hexdigest()[:16])
    return out


def check_decode_f32_digests() -> None:
    """The fp32 route is bit-equal to the kernel before the bf16 route:
    its output's digest at each DIGEST_CASES case is the recorded one."""
    got = decode_digests(fa.flash_decode)
    for case, digest in zip(DIGEST_CASES, got):
        want = DECODE_F32_DIGESTS.get(case[:5])
        log(f"K3 flash_decode fp32 digest {case[:5]}: {digest} "
            f"(recorded {want})")
        assert digest == want, (case, digest, want)


def fused_cases(decode, prefill, bucket: int) -> list[tuple]:
    """(label, dims, bm, bks, acts, adapts): the reduced cell's fused
    segments, synthetic ones with an adapt and the row-wise acts and with
    a 64-row slab, and the bucket-8 prefill plan's greedy geometry (256
    rows), whose slab fits no block: every placement the plan has."""
    cases = []
    segs = [("decode@%d" % bucket, s.fused)
            for s in decode.batch_plan(bucket).segments
            if s.fused is not None]
    segs += [("prefill", s.fused) for s in prefill.segments
             if s.fused is not None]
    for label, seg in segs:
        comp = compile_segment(seg)
        cases.append((label, comp.dims, comp.bm, comp.layer_bks,
                      comp.acts, comp.adapts))
    cases.append(("synthetic adapt+row-wise",
                  ((8, 64, 64), (4, 128, 96), (4, 96, 80), (4, 80, 48)), 8,
                  (32, 64, 32, 16), (None, "softmax", "rmsnorm",
                                     "layernorm"),
                  (False, True, False, False)))
    cases.append(("synthetic 64-row",
                  ((64, 256, 512), (64, 512, 512), (64, 512, 128)), 64,
                  (128, 128, 128), ("relu", "gelu", "silu"),
                  (False, False, False)))
    seg = next(s.fused for s in prefill.batch_plan(8).segments
               if s.fused is not None and len(s.fused.programs) == 3)
    comp = compile_segment(seg)
    cases.append(("prefill@8 greedy", comp.dims, comp.bm, comp.layer_bks,
                  comp.acts, comp.adapts))
    return cases


def check_fused_chain(cases, timer, gen, floor_ms: float) -> dict:
    log(f"K2 fused_chain: case | dims | cluster placement smem_KB | max_err "
        f"| ms [min..max] plain_ms library_ms bound_ms | launch floor "
        f"{floor_ms:.4f} ms")
    main = None
    for label, dims, bm, bks, acts, adapts in cases:
        x = torch.randn(*dims[0][:2], device="cuda", generator=gen)
        ws = [torch.randn(d[1], d[2], device="cuda", generator=gen)
              for d in dims]
        kw = dict(bm=bm, bks=bks, acts=acts, adapts=adapts, dims=dims)
        got = fc.fused_chain(x, ws, **kw)
        want = ref.fused_chain_ref(x, ws, bks=bks, acts=acts, adapts=adapts,
                                   dims=dims)
        err = check(f"fused_chain {label}", got, want,
                    max(d[1] for d in dims))
        ms = timer(lambda: fc.fused_chain(x, ws, **kw))
        plain = timer(lambda: ref.fused_chain_ref(
            x, ws, bks=bks, acts=acts, adapts=adapts, dims=dims))

        def library():
            h = x
            for layer, w in enumerate(ws):
                if layer and adapts[layer]:
                    h = ref.adapt_rows(h, dims[layer - 1][0],
                                       *dims[layer][:2])
                h = torch.matmul(h, w)
                if acts[layer] is not None:
                    h = ref.FUSED_ACT_FNS[acts[layer]](h)
            return h
        lib = timer(library)
        nbytes = 4.0 * (dims[0][0] * dims[0][1]
                        + sum(d[1] * d[2] for d in dims)
                        + dims[-1][0] * dims[-1][2])
        flops = sum(2.0 * d[0] * d[1] * d[2] for d in dims)
        b_ms, _ = bound(nbytes, flops)
        p = fc.plan(dims, bm, bks, adapts, acts)
        log(f"  {label} | {dims} bm {p.bm} | {p.n_m}x{p.cs} {p.placement} "
            f"{p.smem_bytes / 1024:.1f} | {err:.3g} | {spread(ms)} "
            f"{plain['ms']:.4f} {lib['ms']:.4f} {b_ms:.6f}")
        row = row_stats(ms, plain, lib, nbytes, flops, err)
        if main is None:          # the decode tick's fused segment
            main = row
        main["err"] = max(main["err"], err)
    return main


def attention_proj_inputs(decode, gen, bucket: int = 4) -> dict:
    """The full-width decode plan's attention segment at ``bucket`` and
    the wo step's adapt geometry (tests/test_batched_decode.py), with
    unit-normal q, v and wo and keys at half scale (peaked softmax, so the
    projected rows have RMS ~sqrt(k_out))."""
    bseg = next(s for s in decode.batch_plan(bucket).segments
                if s.kind == "attention")
    nxt = decode.steps[bseg.indices[-1] + 1]
    assert nxt.input_mode == "adapt", nxt.input_mode
    g = nxt.op.gemm
    qk, pv = bseg.programs
    b, sq, d, skv, dv = bucket, qk.gemm.m, qk.gemm.k, qk.gemm.n, pv.gemm.n
    lens = torch.tensor([skv, 1, 9, 5][:b], dtype=torch.int32,
                        device="cuda")
    return {"programs": (qk, pv), "m_out": g.m, "k_out": g.k, "n_out": g.n,
            "q": torch.randn(b, sq, d, device="cuda", generator=gen),
            "k": torch.randn(b, skv, d, device="cuda", generator=gen) * 0.5,
            "v": torch.randn(b, skv, dv, device="cuda", generator=gen),
            "wo": torch.randn(g.k, g.n, device="cuda", generator=gen),
            "lens": lens}


def check_flash_decode_proj(decode, timer, gen) -> dict:
    a = attention_proj_inputs(decode, gen)
    q, k, v, wo, lens = a["q"], a["k"], a["v"], a["wo"], a["lens"]
    m_out, k_out = a["m_out"], a["k_out"]
    got = fa.flash_decode_proj(q, k, v, lens, wo, m_out=m_out, k_out=k_out)
    want = ref.flash_decode_proj_ref(q, k, v, lens, wo, m_out=m_out,
                                     k_out=k_out)
    err = check("flash_decode_proj", got, want, k_out)
    b, sq = q.shape[:2]
    mask = (torch.arange(k.shape[1], device="cuda")[None, :]
            < lens[:, None])

    def adapt_wo(ctx):
        h = torch.stack([ref.adapt_rows(c, sq, m_out, k_out)
                         for c in ctx[:, 0]])
        return torch.matmul(h, wo)
    ms_ = timer(lambda: fa.flash_decode_proj(q, k, v, lens, wo, m_out=m_out,
                                             k_out=k_out))
    plain = timer(lambda: ref.flash_decode_proj_ref(
        q, k, v, lens, wo, m_out=m_out, k_out=k_out))
    lib = sdpa_library(timer, "flash_decode_proj", want, adapt_wo,
                       q[:, None], k[:, None], v[:, None],
                       attn_mask=mask[:, None, None, :], scale=1.0)
    used = int(lens.sum())
    d, dv = q.shape[2], v.shape[2]
    nbytes = 4.0 * (b * sq * d + used * (d + dv) + k_out * a["n_out"]
                    + b * m_out * a["n_out"]) + 4 * b
    flops = 2.0 * sq * used * (d + dv) + 2.0 * b * m_out * k_out * a["n_out"]
    # each request's rows alone: bit-equal, the K split depends on k_out
    for r in range(b):
        alone = fa.flash_decode_proj(
            q[r:r + 1].contiguous(), k[r:r + 1].contiguous(),
            v[r:r + 1].contiguous(), lens[r:r + 1].contiguous(), wo,
            m_out=m_out, k_out=k_out)
        assert torch.equal(alone[0], got[r]), \
            (r, float((alone[0] - got[r]).abs().max()))
    log(f"K4 flash_decode_proj: each request's rows of the {b}-request "
        f"launch torch.equal to the request launched alone")
    log(f"K4 flash_decode_proj: B {b} sq {sq} skv {k.shape[1]} d {d} "
        f"lengths {lens.tolist()} adapt ({m_out}, {k_out}) @ wo "
        f"{tuple(wo.shape)} | shared-memory group "
        f"{fa.proj_group(b, sq, d, dv)} | max_err {err:.3g} | ms "
        f"{spread(ms_)} plain {plain['ms']:.4f} sdpa+adapt+matmul "
        f"{lib['ms']:.4f} ({lib['route']}) bound "
        f"{bound(nbytes, flops)[0]:.6f}")
    return row_stats(ms_, plain, lib, nbytes, flops, err)


#: gemma-7b's attention (16 heads of 256) at the repo's train_4k length
ATTN_SHAPE = (1, 4096, 16, 256)
#: falcon-mamba-7b's selective scan: d_inner 8192, d_state 16, 4096 tokens
SCAN_SHAPE = (1, 4096, 8192, 16)


#: the largest |kernel - plain| flash_attention may show in fp32 at
#: ATTN_SHAPE: three TF32 products keep it near the FFMA kernel's ~1e-5,
#: where one TF32 pass would read ~1e-3
ATTN_FP32_MAX_ERR = 1e-4


def attention_inputs(gen) -> tuple:
    """fp32 q, k, v [BH, S, d] at ATTN_SHAPE: q at 8x scale gives scores of
    std ~8, a peaked softmax whose output RMS (~0.8) is over 10x the
    2e-4 * d atol."""
    b, s, h, d = ATTN_SHAPE
    q = torch.randn(b * h, s, d, device="cuda", generator=gen) * 8.0
    k = torch.randn(b * h, s, d, device="cuda", generator=gen)
    v = torch.randn(b * h, s, d, device="cuda", generator=gen)
    return q, k, v


def check_flash_attention(timer, gen) -> tuple[dict, tuple]:
    """fp32 (the row: 3xTF32 on the tensor cores, max |err| at most
    ATTN_FP32_MAX_ERR), then bf16 inputs at the same shape (logged beside
    SDPA in bf16), each against its plain version."""
    b, s, h, d = ATTN_SHAPE
    q, k, v = attention_inputs(gen)
    flops = 4.0 * b * h * d * s * (s + 1) / 2     # causal pairs only
    row = None
    for dtype, rate in ((torch.float32, PEAK_3XTF32),
                        (torch.bfloat16, PEAK_BF16)):
        qt, kt, vt = (x.to(dtype) for x in (q, k, v))
        got = fa.flash_attention(qt, kt, vt, causal=True)
        want = ref.flash_attention_ref(qt, kt, vt, causal=True)
        name = f"flash_attention {str(dtype).split('.')[1]}"
        err = check(name, got.float(), want.float(), d)
        if dtype == torch.float32:
            assert err <= ATTN_FP32_MAX_ERR, (name, err)
        ms_ = timer(lambda: fa.flash_attention(qt, kt, vt, causal=True))
        plain = timer(lambda: ref.flash_attention_ref(qt, kt, vt,
                                                      causal=True))
        lib = sdpa_library(timer, name, want, lambda o: o[0], qt[None],
                           kt[None], vt[None], is_causal=True)
        del want
        nbytes = 4.0 * b * h * s * d * qt.element_size()
        b_ms, b_by = bound(nbytes, flops, rate)
        extra = ""
        if dtype == torch.float32:
            extra = f" (FFMA bound {bound(nbytes, flops)[0]:.4f})"
        log(f"K5 {name}: BH {b * h} S {s} d {d} causal | max_err {err:.3g} "
            f"| ms {spread(ms_)} plain {plain['ms']:.4f} sdpa "
            f"{lib['ms']:.4f} ({lib['route']}) bound {b_ms:.4f} ({b_by})"
            f"{extra}")
        if row is None:
            row = row_stats(ms_, plain, lib, nbytes, flops, err, rate)
            kept = (q, k, v, got)
        del qt, kt, vt
    return row, kept


#: flash_attention's bf16 route at the model zoo's prefill: gemma-7b's
#: [B * H, S, D] = [4 * 16, 32, 256], causal
ZOO_ATTN_CASE = (64, 32, 256)


def check_flash_attention_bf16(timer, gen) -> dict:
    """The bf16 route at ``ZOO_ATTN_CASE`` against its plain version,
    timed beside SDPA in bf16 (every route, the fastest kept) and its
    bound: the kernels JSON row of the route."""
    bh, s, d = ZOO_ATTN_CASE
    # q at 8x scale: a peaked softmax, as at ATTN_SHAPE
    q = (torch.randn(bh, s, d, device="cuda", generator=gen) * 8.0
         ).to(torch.bfloat16)
    k, v = (torch.randn(bh, s, d, device="cuda", generator=gen
                        ).to(torch.bfloat16) for _ in range(2))
    got = fa.flash_attention(q, k, v, causal=True)
    want = ref.flash_attention_ref(q, k, v, causal=True)
    assert got.dtype == want.dtype == torch.bfloat16
    name = f"flash_attention bf16 {ZOO_ATTN_CASE}"
    err = check(name, got.float(), want.float(), d)
    ms_ = timer(lambda: fa.flash_attention(q, k, v, causal=True))
    plain = timer(lambda: ref.flash_attention_ref(q, k, v, causal=True))
    lib = sdpa_library(timer, name, want, lambda o: o[0], q[None],
                       k[None], v[None], is_causal=True)
    nbytes = 4.0 * bh * s * d * q.element_size()
    flops = 4.0 * bh * d * s * (s + 1) / 2         # causal pairs only
    b_ms, b_by = bound(nbytes, flops, PEAK_BF16)
    log(f"K5 {name}: causal | max_err {err:.3g} | ms {spread(ms_)} plain "
        f"{plain['ms']:.4f} sdpa {lib['ms']:.4f} ({lib['route']}) bound "
        f"{b_ms:.6f} ({b_by})")
    return row_stats(ms_, plain, lib, nbytes, flops, err, PEAK_BF16)


#: MLA's prefill attention in deepseek-v2-236b's serve: [B * H, S, D] =
#: [4 * 128, 32, 192] causal, values 128 wide (zero-padded to 192 by
#: ``ops.flash_attention``, as the path runs it)
MLA_ATTN_CASE = (512, 32, 192, 128)
#: MLA's absorbed decode at the serve's last step: a request's 128 heads
#: as its query rows, q [4, 128, 512 + 64] against K [4, 49, 576] and V
#: (the latent) [4, 49, 512], lengths 47, scale 192**-0.5
MLA_DECODE_CASE = (4, 128, 49, 576, 512, 47)


def check_flash_attention_mla(timer, gen) -> dict:
    """The bf16 route at ``MLA_ATTN_CASE`` (v zero-padded, as the path
    calls it) against its plain version, timed beside SDPA in bf16 on the
    unpadded 128-wide values (every route that takes them, the fastest
    kept) and its bound (the function's true widths): the kernels JSON
    row ``flash_attention_mla``."""
    bh, s, d, dv = MLA_ATTN_CASE
    q = (torch.randn(bh, s, d, device="cuda", generator=gen) * 8.0
         ).to(torch.bfloat16)
    k = torch.randn(bh, s, d, device="cuda", generator=gen
                    ).to(torch.bfloat16)
    v = torch.randn(bh, s, dv, device="cuda", generator=gen
                    ).to(torch.bfloat16)
    vp = torch.cat([v, v.new_zeros(bh, s, d - dv)], -1)
    got = fa.flash_attention(q, k, vp, causal=True)
    want = ref.flash_attention_ref(q, k, vp, causal=True)
    assert not got[..., dv:].any()
    name = f"flash_attention bf16 MLA {MLA_ATTN_CASE}"
    err = check(name, got.float(), want.float(), d)
    ms_ = timer(lambda: fa.flash_attention(q, k, vp, causal=True))
    plain = timer(lambda: ref.flash_attention_ref(q, k, vp, causal=True))
    lib = sdpa_library(timer, name, want[..., :dv],
                       lambda o: o[0], q[None], k[None], v[None],
                       is_causal=True)
    pairs = bh * s * (s + 1) / 2                  # causal pairs only
    nbytes = 2.0 * bh * s * (2 * d + 2 * dv)
    flops = 2.0 * pairs * (d + dv)
    b_ms, b_by = bound(nbytes, flops, PEAK_BF16)
    log(f"K5 {name}: causal | max_err {err:.3g} | ms {spread(ms_)} plain "
        f"{plain['ms']:.4f} sdpa {lib['ms']:.4f} ({lib['route']}) bound "
        f"{b_ms:.6f} ({b_by})")
    return row_stats(ms_, plain, lib, nbytes, flops, err, PEAK_BF16)


#: whisper-base's cross attention at a decode step: a request's 8 heads
#: of 64, each one query against its 1500 encoder frames (lengths 1500),
#: scale 64**-0.5: q [32, 1, 64], K and V [32, 1500, 64]
CROSS_DECODE_CASE = (32, 1, 1500, 64)


#: zamba2-1.2b's Mamba-2 scan as ``models.ssm.Mamba2`` calls it for one
#: request of 4096 tokens: its 64 heads folded into the batch, P 64, N 64
SCAN_MAMBA2_SHAPE = (64, 4096, 64, 64)


def check_mamba_scan(timer, gen, shape=SCAN_SHAPE,
                     per_head=False) -> tuple[dict, tuple]:
    """The kernel at ``shape`` against its plain version: y within
    ``check()``'s tolerance, the state bit-equal; timed beside its bound
    (no library call computes the scan).  ``per_head``: da is one scalar
    a (batch row, step), expanded over (D, N) and made dense, as Mamba-2
    gives it."""
    b, seq, d, n = shape
    if per_head:
        da = (0.7 + 0.299 * torch.rand(b, seq, device="cuda", generator=gen)
              )[..., None, None].expand(b, seq, d, n).contiguous()
    else:
        da = 0.7 + 0.299 * torch.rand(b, seq, d, n, device="cuda",
                                      generator=gen)
    dbx = torch.randn(b, seq, d, n, device="cuda", generator=gen) * 0.1
    c = torch.randn(b, seq, n, device="cuda", generator=gen)
    h0 = torch.randn(b, d, n, device="cuda", generator=gen) * 0.1
    y, h = ms.mamba_scan(da, dbx, c, h0)
    y_ref, h_ref = ref.mamba_scan_ref(da, dbx, c, h0)
    name = f"mamba_scan {shape}" + (" (Mamba-2, da per head)" if per_head
                                    else "")
    err = check(name, y, y_ref, n)
    # the state is a rounded multiply then a rounded add in both versions
    assert torch.equal(h, h_ref), float((h - h_ref).abs().max())
    ms_ = timer(lambda: ms.mamba_scan(da, dbx, c, h0))
    plain = timer(lambda: ref.mamba_scan_ref(da, dbx, c, h0))
    nbytes = 4.0 * (2 * b * seq * d * n + b * seq * n + 2 * b * d * n
                    + b * seq * d)
    flops = 4.0 * b * seq * d * n
    log(f"K6 {name}: B {b} L {seq} D {d} N {n} | max_err {err:.3g}, "
        f"h_last bit-equal | ms {spread(ms_)} plain {plain['ms']:.4f} "
        f"library none | bound {bound(nbytes, flops)[0]:.4f}")
    return (row_stats(ms_, plain, None, nbytes, flops, err),
            (da, dbx, c, h0, y, h))


#: whisper-base's encoder attention in the zoo's serve: [B * H, frames,
#: D] = [4 * 8, 1500, 64], full, bf16; ``ops.flash_attention`` pads the
#: frames to 1536 (blocks of 128) and masks keys past 1500
ENC_ATTN_CASE = (32, 1500, 64)


def check_flash_attention_enc(timer, gen) -> dict:
    """The bf16 route, full (non-causal), at ``ENC_ATTN_CASE`` as the path
    launches it (padded, ``kv_len`` 1500) against its plain version, timed
    beside SDPA in bf16 on the unpadded inputs (every route, the fastest
    kept) and its bound at the true length: the kernels JSON row
    ``flash_attention_enc``."""
    bh, s, d = ENC_ATTN_CASE
    # q at 4x: scores of std 4 over 1500 keys, an output RMS of ~0.5
    q = (torch.randn(bh, s, d, device="cuda", generator=gen) * 4.0
         ).to(torch.bfloat16)
    k, v = (torch.randn(bh, s, d, device="cuda", generator=gen
                        ).to(torch.bfloat16) for _ in range(2))
    qp, kp, vp = (ops._pad_rows(x, 128) for x in (q, k, v))
    got = fa.flash_attention(qp, kp, vp, causal=False, kv_len=s)[:, :s]
    want = ref.flash_attention_ref(qp, kp, vp, causal=False,
                                   kv_len=s)[:, :s]
    name = f"flash_attention bf16 full {ENC_ATTN_CASE}"
    # both round their fp32 sums to bf16, where another sum order can
    # flip a rounding: one bf16 ulp (at most 2^-7 of |want|) more than
    # check()'s tolerance, which at d 64 is below an ulp past |2|
    err = check(name, got.float(), want.float(), d, RTOL + 2 ** -7)
    ms_ = timer(lambda: fa.flash_attention(qp, kp, vp, causal=False,
                                           kv_len=s))
    plain = timer(lambda: ref.flash_attention_ref(qp, kp, vp, causal=False,
                                                  kv_len=s))
    lib = sdpa_library(timer, name, want, lambda o: o[0], q[None], k[None],
                       v[None])
    nbytes = 4.0 * bh * s * d * q.element_size()
    flops = 4.0 * bh * d * s * s
    b_ms, b_by = bound(nbytes, flops, PEAK_BF16)
    log(f"K5 {name}: padded to {qp.shape[1]}, kv_len {s} | max_err "
        f"{err:.3g} | ms {spread(ms_)} plain {plain['ms']:.4f} sdpa "
        f"{lib['ms']:.4f} ({lib['route']}) bound {b_ms:.6f} ({b_by})")
    return row_stats(ms_, plain, lib, nbytes, flops, err, PEAK_BF16)


# ---------------------------------------------------------------------------
# phase 3: the kernel ops entry point
# ---------------------------------------------------------------------------

def ops_entry_point(attn, scan) -> dict:
    """``ops.flash_attention`` on [B, S, H, D] and ``ops.mamba_scan``, as a
    user calls them, on phase 2's inputs: bit-equal to the kernels'
    results that phase 2 held against the plain versions."""
    b, s, h, d = ATTN_SHAPE
    q, k, v, kernel_out = attn
    heads = [x.reshape(b, h, s, d).transpose(1, 2) for x in (q, k, v)]
    da, dbx, c, h0, y_kernel, h_kernel = scan
    reset_counts()
    out = ops.flash_attention(*heads, causal=True)
    y, h_last = ops.mamba_scan(da, dbx, c, h0)
    torch.cuda.synchronize()
    launched = counts()
    log(f"ops entry point: launches {launched}")
    assert launched["flash_attention"] == 1 and launched["mamba_scan"] == 1
    assert out.shape == (b, s, h, d) and bool(torch.isfinite(out).all())
    assert torch.equal(out.transpose(1, 2).reshape(b * h, s, d),
                       kernel_out)
    assert y.shape == SCAN_SHAPE[:3] and bool(torch.isfinite(y).all())
    assert torch.equal(y, y_kernel) and torch.equal(h_last, h_kernel)
    log(f"ops entry point: flash_attention {tuple(out.shape)} and "
        f"mamba_scan {tuple(y.shape)}, {tuple(h_last.shape)} bit-equal to "
        f"the checked kernels")
    return launched


# ---------------------------------------------------------------------------
# phases 4 to 7: serving, block-fused decode attention, autotune
# ---------------------------------------------------------------------------

def serve(sched, requests) -> tuple[dict, object]:
    for steps, prompt, seed in requests:
        sched.submit(decode_steps=steps, prompt_tokens=prompt, seed=seed)
    rep = sched.run()
    torch.cuda.synchronize()
    # a scheduler's report keeps every request it retired: take this serve's
    done = sorted(rep.requests, key=lambda r: r.rid)[-len(requests):]
    assert len(done) == len(requests), rep.requests
    assert all(r.status == "ok" and r.state_checksum for r in done)
    return {i: r.state_checksum for i, r in enumerate(done)}, rep


def full_width(gen) -> dict:
    cfg = feather_config(16, 256)
    cache = ProgramCache()
    t0 = time.perf_counter()
    prefill = ModelExecutable.for_cell("gemma-7b", "prefill_tiny", cfg,
                                       cache=cache, reduce_model=False)
    decode = ModelExecutable.for_cell("gemma-7b", "decode_tiny", cfg,
                                      cache=cache, reduce_model=False)
    per_tick = decode.batch_plan(1).launches_per_tick
    assert per_tick == 9, per_tick
    plan = decode.batch_plan(4)   # lowered before the serve, as a warm-up
    log(f"full width: executables built in {time.perf_counter() - t0:.2f} s;"
        f" decode plan {[(s.kind, s.indices) for s in plan.segments]}")
    t0 = time.perf_counter()
    sched = Scheduler(prefill, decode, max_concurrent=4)
    log(f"full width: scheduler init (seeded weights drawn on the host, "
        f"moved to the card) {time.perf_counter() - t0:.1f} s; device "
        f"memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    requests = [(8, None, seed) for seed in range(4)]
    reset_counts()
    sums, rep = serve(sched, requests)
    launched = counts()
    log(f"full width: launches in the serve {launched}")
    assert rep.launches_per_decode_tick == per_tick, \
        rep.launches_per_decode_tick
    assert launched["nest_gemm"] > 0 and launched["flash_decode"] > 0
    n_prefill = launched["nest_gemm"] - rep.decode_ticks * (per_tick - 1)
    log(f"full width: {n_prefill} prefill nest_gemm launches in the serve "
        f"(a call on the wide-weight path is two; "
        f"{launched['nest_gemm'] - n_prefill} in {rep.decode_ticks} decode "
        f"ticks)")
    sums2, rep2 = serve(sched, requests)     # the same serve, repeated
    assert sums == sums2, (sums, sums2)
    s = rep.summary()
    tick_ms = rep.decode_wall_s / max(rep.decode_ticks, 1) * 1e3
    weight_bytes = 4.0 * sum(s_.op.gemm.k * s_.op.gemm.n for s_ in
                             decode.steps if not s_.op.dynamic)
    bound_ms = weight_bytes / PEAK_BYTES * 1e3
    log(f"full width: decode {s['decode_tokens_per_sec']:.1f} tok/s, "
        f"{tick_ms:.3f} ms/tick over {rep.decode_ticks} ticks (bound "
        f"{bound_ms:.3f} ms: {weight_bytes / 1e9:.3f} GB of weights), "
        f"TTFT p50 {s['ttft_p50_s']:.3f} s, wall {rep.wall_s:.1f} s, "
        f"prefill wall {rep.prefill_wall_s:.1f} s; repeat tick "
        f"{rep2.decode_wall_s / max(rep2.decode_ticks, 1) * 1e3:.3f} ms")
    log(f"full width: checksums {sums} (repeat identical)")

    # batched == sequential decode on identical inputs: bit-equal, since
    # each kernel's K order depends on K alone, never on the batch
    envs = []
    for _ in range(4):
        env = dict(sched.decode_weights)
        for name, (shape, kind) in decode.tensor_specs().items():
            if kind != "weight":
                env[name] = torch.randn(*shape, device="cuda",
                                        generator=gen)
        envs.append(env)
    batched = decode.run_batch(sched.backend, envs)
    seq = [decode.run(sched.backend, tensors=e).final for e in envs]
    for b_, s_ in zip(batched, seq):
        assert b_.shape == s_.shape and bool(torch.isfinite(b_).all())
        assert torch.equal(b_, s_), float((b_ - s_).abs().max())
    log(f"full width: run_batch bit-equal to sequential run over "
        f"{len(seq)} requests, finals of shape {tuple(seq[0].shape)}")
    weights = (sched.prefill_weights, sched.decode_weights)
    del sched, envs, batched, seq
    torch.cuda.empty_cache()
    return launched, sums, tick_ms, weights


def attention_proj_full_width(decode, gen) -> dict:
    """``CudaBackend.run_batched_attention_proj`` on the full-width decode
    plan's attention segment at 4 requests: one launch, equal to the base
    oracle (the attention launch, then adapt and Wo per request)."""
    a = attention_proj_inputs(decode, gen)
    be = decode.make_backend("cuda")
    kT = a["k"].transpose(1, 2)
    lengths = a["lens"].cpu().numpy()
    reset_counts()
    n0 = be.n_launches
    out = be.run_batched_attention_proj(
        a["programs"], a["q"], kT, a["v"], a["wo"], m_out=a["m_out"],
        k_out=a["k_out"], lengths=lengths)
    torch.cuda.synchronize()
    launched = counts()
    log(f"attention proj: launches {launched}, backend n_launches delta "
        f"{be.n_launches - n0}")
    assert be.n_launches - n0 == 1
    assert launched["flash_decode_proj"] == 1
    assert sum(launched.values()) == 1, launched
    oracle = Backend.run_batched_attention_proj(
        be, a["programs"], a["q"], kT, a["v"], a["wo"], m_out=a["m_out"],
        k_out=a["k_out"], lengths=lengths)
    err = check("run_batched_attention_proj", out, oracle, a["k_out"])
    log(f"attention proj: [{tuple(out.shape)}] one launch, equal to the "
        f"base oracle (max |err| {err:.3g}, atol {RTOL * a['k_out']:.3g})")
    return launched


def reduced_width() -> tuple[dict, dict]:
    cfg = feather_config(4, 16)
    cache = ProgramCache()
    prefill = ModelExecutable.for_cell("gemma-7b", "prefill_tiny", cfg,
                                       cache=cache)
    decode = ModelExecutable.for_cell("gemma-7b", "decode_tiny", cfg,
                                      cache=cache)
    per_tick = decode.batch_plan(1).launches_per_tick
    assert per_tick == 7, per_tick
    requests = [(steps, prompt, rid) for rid, (steps, prompt)
                in enumerate(SUBMISSIONS)]
    sched = Scheduler(prefill, decode, max_concurrent=5)
    reset_counts()
    sums, rep = serve(sched, requests)
    launched = counts()
    assert rep.launches_per_decode_tick == per_tick, \
        rep.launches_per_decode_tick
    assert launched["fused_chain"] >= 1, launched
    cpu_sums, _ = serve(Scheduler(prefill, decode, max_concurrent=5,
                                  device="cpu"), requests)
    assert sums == cpu_sums, (sums, cpu_sums)
    log(f"reduced width: launches in the serve {launched}, "
        f"{rep.launches_per_decode_tick} per decode tick; checksums equal "
        f"to the CPU path: {sums}")
    return launched, sums


def interpreter_phase(cuda_sums: dict) -> dict:
    """The reduced cell served by the functional interpreter on the card,
    twice; its checksums against each other and the cuda serve's (equal
    to the CPU path's); a decode stream run twice on it, torch.equal;
    one cross_check of interpreter == cuda == oracle."""
    cfg = feather_config(4, 16)
    cache = ProgramCache()
    prefill = ModelExecutable.for_cell("gemma-7b", "prefill_tiny", cfg,
                                       cache=cache)
    decode = ModelExecutable.for_cell("gemma-7b", "decode_tiny", cfg,
                                      cache=cache)
    requests = [(steps, prompt, rid) for rid, (steps, prompt)
                in enumerate(SUBMISSIONS)]
    walls, runs = [], []
    reset_counts()
    for _ in range(2):
        t0 = time.perf_counter()
        sched = Scheduler(prefill, decode, backend="interpreter",
                          max_concurrent=5)
        assert sched.backend.device.type == "cuda"
        sums, _ = serve(sched, requests)
        walls.append(time.perf_counter() - t0)
        runs.append(sums)
    launched = counts()
    assert runs[0] == runs[1] == cuda_sums, (runs, cuda_sums)
    assert sum(launched.values()) == 0, launched
    log(f"interpreter: reduced cell served on the card twice in "
        f"{walls[0]:.2f} s and {walls[1]:.2f} s (no kernel launched), "
        f"checksums equal to each other and to the cuda serve's and the "
        f"CPU path's: {runs[0]}")
    env = {name: torch.from_numpy(arr).cuda()
           for name, arr in decode.make_tensors(3).items()}
    finals = [decode.run("interpreter", tensors=env).final
              for _ in range(2)]
    assert torch.equal(finals[0], finals[1])
    assert bool(torch.isfinite(finals[0]).all())
    log(f"interpreter: a decode stream run twice on the card, finals "
        f"{tuple(finals[0].shape)} torch.equal")
    gemm = workloads.ci_suite()[0]
    prog = mapper.search(gemm, cfg).program
    gen = torch.Generator().manual_seed(5)
    t = {"I": torch.randn(gemm.m, gemm.k, generator=gen).numpy(),
         "W": torch.randn(gemm.k, gemm.n, generator=gen).numpy()}
    errs = backends.cross_check(prog, t)
    log(f"interpreter: cross_check {gemm} interpreter == cuda == oracle, "
        f"max |err| {errs}")
    return launched


def fused_runs(cells) -> list[tuple]:
    """(label, programs, adapts, greedy FusedSegment) of every distinct
    fused segment the cells build: their segments and their decode
    batch plans at buckets 1..5 (the reduced serve's)."""
    runs, seen = [], set()
    for label, ex in cells:
        segs = [(label, s.fused) for s in ex.segments if s.fused is not None]
        segs += [(f"{label}@{n}", b.fused) for n in range(1, 6)
                 for b in ex.batch_plan(n).segments if b.fused is not None]
        for lab, seg in segs:
            progs, adapts = list(seg.programs), tuple(seg.adapts)
            key = segment_key(progs, adapts=adapts)
            if key not in seen:
                seen.add(key)
                runs.append((lab, progs, adapts, programlib.fuse_segment(
                    progs, adapts=adapts)))
    return runs


def autotune_phase(untuned_sums: dict, fw_cells) -> dict:
    """Autotune every fused segment of the reduced cells on the card, then
    check the warm pass does no work and the tuned serve's checksums."""
    cfg = feather_config(4, 16)
    cache = ProgramCache()
    cells = [(shape, ModelExecutable.for_cell("gemma-7b", shape, cfg,
                                              cache=cache))
             for shape in ("prefill_tiny", "decode_tiny")]
    be = CudaBackend(cfg, compile_cache=cache)
    runs = fused_runs(cells)
    reset_counts()
    n0 = be.n_launches
    reports = []
    for label, progs, adapts, greedy in runs:
        rep = autotune_segment(progs, be, cache=cache, adapts=adapts,
                               top_k=4, iters=3)
        assert rep is not None and not rep.cached, label
        w = rep.winner
        trials = [(t["bm"], tuple(t["layer_bks"]),
                   round(t["median_s"] * 1e6, 1)) for t in rep.trials]
        greedy_us = next((us for bm, bks, us in trials
                          if (bm, bks) == (greedy.bm, greedy.layer_bks)),
                         None)
        log(f"autotune {label} {[p.gemm.name for p in progs]}: trials "
            f"(bm, layer_bks, median us) {trials}; winner ({w.bm}, "
            f"{w.layer_bks}) {w.measured_s * 1e6:.1f} us vs greedy "
            f"({greedy.bm}, {greedy.layer_bks}) {greedy_us} us")
        reports.append((label, progs, adapts, greedy, w))
    launched = counts()
    assert launched["fused_chain"] == be.n_launches - n0 > 0, launched

    snap = cache.stats.snapshot()
    n1 = be.n_launches
    for _, progs, adapts, _, w in reports:
        again = autotune_segment(progs, be, cache=cache, adapts=adapts,
                                 top_k=4, iters=3)
        assert again.cached and again.winner == w
    delta = cache.stats.delta(snap)
    assert (delta["frontier_misses"], delta["fused_misses"],
            delta["compile_misses"]) == (0, 0, 0), delta
    assert be.n_launches == n1 and counts() == launched
    log(f"autotune: second pass over {len(reports)} segments: "
        f"{delta['tuned_hits']} tuned hits, 0 frontier/fused/compile "
        f"misses, 0 launches")

    # does the fused kernel's sum order follow bk?  the same inputs at the
    # tuned and the greedy geometry
    for label, progs, adapts, greedy, w in reports:
        if (w.bm, w.layer_bks) == (greedy.bm, tuple(greedy.layer_bks)):
            continue
        tuned = programlib.fuse_segment(progs, adapts=adapts, bm=w.bm,
                                        layer_bks=w.layer_bks)
        t = {name: be.to_device(arr)
             for name, arr in _segment_tensors(progs).items()}
        out_t = be.run_segment(tuned, t)[tuned.out_name].clone()
        out_g = be.run_segment(greedy, t)[greedy.out_name]
        log(f"autotune {label}: tuned vs greedy output bit-equal "
            f"{torch.equal(out_t, out_g)}, max |diff| "
            f"{float((out_t - out_g).abs().max()):.3g}")

    t_pre = ModelExecutable.for_cell("gemma-7b", "prefill_tiny", cfg,
                                     cache=cache)
    t_dec = ModelExecutable.for_cell("gemma-7b", "decode_tiny", cfg,
                                     cache=cache)
    built = [s.fused for ex in (t_pre, t_dec) for s in ex.segments
             if s.fused is not None]
    built += [b.fused for n in range(1, 6) for b in t_dec.batch_plan(n).segments
              if b.fused is not None]
    n_off_greedy = 0
    for seg in built:
        g = programlib.fuse_segment(list(seg.programs),
                                    adapts=tuple(seg.adapts))
        n_off_greedy += (seg.bm, seg.layer_bks) != (g.bm, g.layer_bks)
    requests = [(steps, prompt, rid) for rid, (steps, prompt)
                in enumerate(SUBMISSIONS)]
    sums, _ = serve(Scheduler(t_pre, t_dec, max_concurrent=5), requests)
    assert sums == untuned_sums, (sums, untuned_sums)
    log(f"autotune: tuned serve ({n_off_greedy} of {len(built)} fused "
        f"segments built at a geometry other than the greedy one) "
        f"checksums equal to the untuned serve and the CPU path: {sums}")

    fw_cache = ProgramCache()
    fw_be = CudaBackend(feather_config(16, 256), compile_cache=fw_cache)
    n_chained = 0
    for ex in fw_cells:
        for seg in ex.segments:
            if len(seg.indices) < 2:
                continue
            steps = [ex.steps[i] for i in seg.indices]
            adapts = (False,) + tuple(st.input_mode == "adapt"
                                      for st in steps[1:])
            assert autotune_segment([st.program for st in steps], fw_be,
                                    cache=fw_cache, adapts=adapts) is None
            n_chained += 1
    assert n_chained > 0 and fw_be.n_launches == 0
    log(f"autotune: full width, {n_chained} chained runs, none legal to "
        f"fuse or tune")
    return launched


# ---------------------------------------------------------------------------
# phase 9: the multi-array path
# ---------------------------------------------------------------------------

#: ci_suite GEMMs the sharded cross_check runs: a bconv and an NTT whose
#: searched Programs are WO-S, a gpt-oss projection and the conv whose
#: searched Programs are IO-S
MESH_CHECK_GEMMS = (0, 41, 54, 58)


def mesh_check_programs():
    """(ci_suite index, {name: Program}, host operands) of each
    ``MESH_CHECK_GEMMS`` GEMM: its searched Program and a forced WO-S and
    IO-S lowering, on seeded numpy inputs."""
    cfg = feather_config(4, 16)
    suite = workloads.ci_suite()
    for idx in MESH_CHECK_GEMMS:
        g = suite[idx]
        progs = {"searched": mapper.search(g, cfg).program} | {
            df.name: programlib.lower(g, mapper.MappingChoice(
                df=df, vn=4, m_t=8, k_t=8, n_t=8, n_kg=1, n_nb=1, dup=4),
                cfg) for df in (isa.Dataflow.WOS, isa.Dataflow.IOS)}
        gen = torch.Generator().manual_seed(idx)
        t = {"I": torch.randn(g.m, g.k, generator=gen).numpy(),
             "W": torch.randn(g.k, g.n, generator=gen).numpy()}
        yield idx, progs, t


def mesh_cross_check() -> None:
    """``backends.cross_check`` sharded on the card: interpreter == cuda
    == oracle on 2 and 4 arrays along every axis, for each GEMM's
    searched Program and a forced WO-S and IO-S lowering.  The inputs are
    numpy arrays, so every N split cuts columns of a host array and
    moves them to the card (a contiguous copy) for nest_gemm."""
    worst: dict[str, float] = {}
    n_runs = 0
    t0 = time.perf_counter()
    for _, progs, t in mesh_check_programs():
        for prog in progs.values():
            for n in (2, 4):
                for axis in ("m", "n", "k"):
                    errs = backends.cross_check(prog, t, mesh=ArrayMesh(n),
                                                axis=axis)
                    for name, err in errs.items():
                        worst[name] = max(worst.get(name, 0.0), err)
                    n_runs += 1
    log(f"mesh cross_check: {n_runs} sharded programs ({len(MESH_CHECK_GEMMS)}"
        f" ci_suite GEMMs x searched, forced WO-S and IO-S x 2 and 4 arrays "
        f"x m, n, k) interpreter == cuda == oracle on the card in "
        f"{time.perf_counter() - t0:.1f} s, max |err| {worst}")


def shard_shapes(prefill, decode) -> list[tuple]:
    """Distinct (M, K, N, out_block_t, act, bk) the shards of the mesh
    streams launch on nest_gemm, with how many times one decode step and
    one prefill pass launch each."""
    shapes: dict[tuple, list[int]] = {}
    for ex, col in ((decode, 0), (prefill, 1)):
        for step in ex.steps:
            for shard in step.sharded.shards:
                comp = compile_program(shard.program)
                g = shard.program.gemm
                key = (g.m, g.k, g.n, comp.out_block_t, comp.fused_act,
                       comp.bk)
                shapes.setdefault(key, [0, 0])[col] += 1
    return [(*key, *n) for key, n in shapes.items()]


def check_shard_shapes(shapes, timer, gen) -> None:
    """nest_gemm at every shard shape of the 4-array full-width streams
    against its plain version, timed; the decode step's shards summed."""
    log("K1 nest_gemm at the 4-array shard shapes: M K N out_t act | "
        "calls/step calls/prefill | max_err | ms [min..max] plain_ms "
        "library_ms bound_ms")
    step = {"ms": 0.0, "bytes": 0.0, "flops": 0.0, "plain": 0.0, "lib": 0.0}
    for m, k, n, out_t, act, bk, per_step, per_pass in shapes:
        x = torch.randn(m, k, device="cuda", generator=gen)
        w = torch.randn(k, n, device="cuda", generator=gen)
        got = ng.nest_gemm(x, w, out_block_t=out_t, act=act)
        want = ref.nest_gemm_ref(x, w, bk=bk, out_block_t=out_t, act=act)
        err = check(f"nest_gemm shard {(m, k, n, out_t, act)}", got, want, k)
        ms = timer(lambda: ng.nest_gemm(x, w, out_block_t=out_t, act=act))
        plain = timer(lambda: ref.nest_gemm_ref(x, w, bk=bk,
                                                out_block_t=out_t, act=act))
        wt, xt = w.t(), x.t()
        lib = timer((lambda: torch.matmul(wt, xt)) if out_t
                    else (lambda: torch.matmul(x, w)))
        nbytes, flops = 4.0 * (m * k + k * n + m * n), 2.0 * m * k * n
        log(f"  {m} {k} {n} {out_t} {act} | {per_step} {per_pass} | "
            f"{err:.3g} | {spread(ms)} {plain['ms']:.4f} {lib['ms']:.4f} "
            f"{bound(nbytes, flops)[0]:.4f}")
        for key, val in (("ms", ms["ms"]), ("bytes", nbytes),
                         ("flops", flops), ("plain", plain["ms"]),
                         ("lib", lib["ms"])):
            step[key] += per_step * val
        del x, w, got, want
    log(f"K1 nest_gemm: a 4-array decode step's shards, one after another: "
        f"{step['ms']:.4f} ms (plain {step['plain']:.4f}, library "
        f"{step['lib']:.4f}), bound "
        f"{bound(step['bytes'], step['flops'])[0]:.4f}")
    torch.cuda.empty_cache()


def shard_launches(ex, fused: bool) -> tuple[int, int]:
    """(nest_gemm, fused_chain) launches one pass of the mesh stream
    ``ex`` makes: one fused_chain an array for each sharded fused segment
    (when ``fused``), one nest_gemm a shard of every other step, two on
    the wide-weight path.  An N split's W is a fresh contiguous copy and
    an M split's the whole weight; a K split's is the row slice at k0
    rows, whose alignment the wide path checks."""
    n_ng = n_fc = 0
    for seg in ex.segments:
        if fused and seg.fused is not None:
            n_fc += seg.fused.n_arrays
            continue
        for i in seg.indices:
            sharded = ex.steps[i].sharded
            n_ng += sum(shard_ng_launches(sharded, shard)
                        for shard in sharded.shards)
    return n_ng, n_fc


def shard_ng_launches(sharded, shard) -> int:
    """nest_gemm kernel launches of one shard's call: two on the
    wide-weight path, which checks the alignment of a K split's row
    slice of W at k0 rows."""
    g = shard.program.gemm
    w_offset = 4 * shard.k0 * sharded.base.gemm.n
    return 2 if ng.scratch_floats(g.m, g.k, g.n, w_offset) else 1


def mesh_full_width(gen, flat_sums: dict, flat_tick_ms: float,
                    weights: tuple) -> dict:
    """Full-width gemma-7b on 4 arrays, served by the cuda Scheduler on
    the resident weights of phase 4's flat one."""
    cfg = feather_config(16, 256)
    cache = ProgramCache()
    mesh = ArrayMesh(4)
    t0 = time.perf_counter()
    prefill = ModelExecutable.for_cell("gemma-7b", "prefill_tiny", cfg,
                                       cache=cache, reduce_model=False,
                                       mesh=mesh)
    decode = ModelExecutable.for_cell("gemma-7b", "decode_tiny", cfg,
                                      cache=cache, reduce_model=False,
                                      mesh=mesh)
    for ex in (prefill, decode):
        assert ex.describe()["n_sharded"] == len(ex.steps), ex.describe()
    log(f"mesh full width: executables built on {mesh} in "
        f"{time.perf_counter() - t0:.2f} s; split axes (prefill | decode) "
        + ", ".join(f"{p.op.gemm.name} {p.sharded.axis}|{d.sharded.axis}"
                    for p, d in zip(prefill.steps, decode.steps)))
    timer = Timer()
    check_shard_shapes(shard_shapes(prefill, decode), timer, gen)
    del timer
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sched = Scheduler(prefill, decode, max_concurrent=4, weights=weights)
    assert sched.use_fused and not sched.batch_decode
    log(f"mesh full width: scheduler init on phase 4's weights "
        f"{time.perf_counter() - t0:.1f} s")
    be = sched.backend
    requests = [(8, None, seed) for seed in range(4)]
    reset_counts()
    sums, rep = serve(sched, requests)
    launched = counts()
    (pre_ng, pre_fc), (dec_ng, dec_fc) = (shard_launches(ex, sched.use_fused)
                                          for ex in (prefill, decode))
    passes = len(requests)          # one prompt chunk a request
    want = {"nest_gemm": passes * pre_ng + rep.decode_steps_total * dec_ng,
            "fused_chain": passes * pre_fc + rep.decode_steps_total * dec_fc}
    log(f"mesh full width: launches in the serve {launched}; worked out "
        f"from the shards: {want} ({passes} prefill passes of {pre_ng}, "
        f"{rep.decode_steps_total} decode steps of {dec_ng})")
    assert launched["nest_gemm"] == want["nest_gemm"] > 0, (launched, want)
    assert launched["fused_chain"] == want["fused_chain"], (launched, want)
    assert sum(launched.values()) == sum(want.values()), launched
    held, copies = be.held_slices(), be.n_slice_copies
    mem = torch.cuda.memory_allocated()
    sums2, rep2 = serve(sched, requests)
    assert sums == sums2, (sums, sums2)
    again = be.held_slices()
    assert again.keys() == held.keys() and all(
        again[k] is held[k] for k in held), "a weight slice was copied again"
    tick_ms = rep.decode_wall_s / max(rep.decode_ticks, 1) * 1e3
    tick2 = rep2.decode_wall_s / max(rep2.decode_ticks, 1) * 1e3
    log(f"mesh full width: {rep.decode_ticks} decode ticks of "
        f"{rep.decode_steps_total / rep.decode_ticks:.1f} requests (each "
        f"request's step on its own: no batched decode on a mesh), "
        f"{tick_ms:.3f} ms a tick (repeat {tick2:.3f}) against the flat "
        f"serve's {flat_tick_ms:.3f} (phase 4); TTFT p50 "
        f"{rep.summary()['ttft_p50_s']:.3f} s; launches_per_decode_tick as "
        f"reported {rep.launches_per_decode_tick} (the JAX package's "
        f"count, which leaves out a plain sharded step's launches)")
    log(f"mesh full width: {len(held)} weight slices held "
        f"({sum(c.numel() for c in held.values()) * 4 / 2**30:.2f} GiB), "
        f"each copied once ({copies} copies in the first serve, KV "
        f"operands' included; {be.n_slice_copies - copies} in the repeat, "
        f"all KV); device memory after the serve "
        f"{mem / 2**30:.2f} GiB allocated, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"mesh full width: checksums {sums} (repeat identical); equal to "
        f"the flat serve's (phase 4): {sums == flat_sums}")
    env = dict(sched.decode_weights)
    for name, (shape, kind) in decode.tensor_specs().items():
        if kind != "weight":
            env[name] = torch.randn(*shape, device="cuda", generator=gen)
    res = decode.run(be, tensors=env, check=True)
    assert res.checked and bool(torch.isfinite(res.final).all())
    stats = decode.perf_stats()
    per = stats["per_array_minisa_bytes"]
    assert len(per) == 4 and all(b > 0 for b in per), per
    assert abs(sum(per) - stats["minisa_bytes"]) <= \
        1e-9 * stats["minisa_bytes"], (per, stats["minisa_bytes"])
    log(f"mesh full width: decode stream run(check=True) on the card held "
        f"every step to the CPU oracle; per-array MINISA bytes {per} sum "
        f"to {stats['minisa_bytes']} (load imbalance "
        f"{stats['load_imbalance']:.3f})")
    peak = torch.cuda.max_memory_allocated()
    del sched, be, env, res, held, again
    torch.cuda.empty_cache()
    return {"sums": sums, "tick_ms": tick_ms, "peak_bytes": peak}


def mesh_reduced(gen, flat_sums: dict, floor_ms: float) -> dict:
    """The reduced cell on 4 and 2 arrays: each array's fused segment
    against its plain version, then the serve: checksums equal to the
    CPU path's and the flat serve's, fused_chain once an array for each
    sharded fused segment."""
    cfg = feather_config(4, 16)
    cache = ProgramCache()
    requests = [(steps, prompt, rid) for rid, (steps, prompt)
                in enumerate(SUBMISSIONS)]
    launched = {}
    timer = Timer()
    for n in (4, 2):
        mesh = ArrayMesh(n)
        prefill = ModelExecutable.for_cell("gemma-7b", "prefill_tiny", cfg,
                                           cache=cache, mesh=mesh)
        decode = ModelExecutable.for_cell("gemma-7b", "decode_tiny", cfg,
                                          cache=cache, mesh=mesh)
        fused = [s.fused for s in prefill.segments
                 if isinstance(s.fused, programlib.ShardedFusedSegment)]
        assert fused and all(f.n_arrays == n for f in fused), fused
        cases = {}
        for seg in fused:
            for fseg in seg.array_segments:
                c = compile_segment(fseg)
                cases.setdefault((c.dims, c.bm, c.layer_bks), (
                    f"{mesh} array segment", c.dims, c.bm, c.layer_bks,
                    c.acts, c.adapts))
        check_fused_chain(list(cases.values()), timer, gen, floor_ms)
        sched = Scheduler(prefill, decode, max_concurrent=5)
        reset_counts()
        sums, rep = serve(sched, requests)
        launched = counts()
        chunk = prefill.tokens
        chunks = sum(-(-(prompt or chunk) // chunk)
                     for _, prompt, _ in requests)
        (pre_ng, pre_fc), (dec_ng, dec_fc) = (
            shard_launches(ex, sched.use_fused) for ex in (prefill, decode))
        want = {"nest_gemm": chunks * pre_ng + rep.decode_steps_total * dec_ng,
                "fused_chain": chunks * pre_fc
                + rep.decode_steps_total * dec_fc}
        assert launched["fused_chain"] == want["fused_chain"] >= n, \
            (launched, want)
        assert launched["nest_gemm"] == want["nest_gemm"], (launched, want)
        assert sum(launched.values()) == sum(want.values()), launched
        cpu_sums, _ = serve(Scheduler(prefill, decode, max_concurrent=5,
                                      device="cpu"), requests)
        assert sums == cpu_sums == flat_sums, (sums, cpu_sums, flat_sums)
        log(f"mesh reduced on {mesh}: launches {launched} (worked out "
            f"{want}: {chunks} prompt chunks, {len(fused)} sharded fused "
            f"segment(s) of {n} arrays, {rep.decode_steps_total} decode "
            f"steps); checksums equal to the CPU path's and the flat "
            f"serve's: {sums}")
    return launched


def chaos_and_resume() -> dict:
    """The standard fault plans on the cuda backend at reduced width
    (flat, and on 2 arrays with one going down), then a serve stopped
    after 2 ticks, saved, loaded and resumed.  Returns the checksums of
    the serve with an array going down."""
    cfg = feather_config(4, 16)
    requests = [(4, None, None)] * 3

    def scheduler(cache, mesh=None, faults=None):
        prefill, decode = (ModelExecutable.for_cell(
            "gemma-7b", shape, cfg, cache=cache, mesh=mesh)
            for shape in ("prefill_tiny", "decode_tiny"))
        return Scheduler(prefill, decode, max_concurrent=2, seed=7,
                         faults=faults)

    with tempfile.TemporaryDirectory() as tmp:
        for n in (1, 2):
            mesh = ArrayMesh(n) if n > 1 else None
            cache = (ProgramCache(path=os.path.join(tmp, "cache.bin"))
                     if n == 1 else ProgramCache())
            base, base_rep = serve(scheduler(cache, mesh), requests)
            injector = FaultInjector(FaultPlan.standard(0, n_arrays=n))
            sums, rep = serve(scheduler(cache, mesh, injector), requests)
            res = rep.summary()["resilience"]
            assert sums == base, (sums, base)
            assert injector.unrecovered() == 0 and res["retries_total"] > 0
            if n == 1:
                assert set(injector.injected) == {
                    "launch_transient", "launch_nan", "kv_exhaust",
                    "cache_corrupt"}, injector.injected
            else:
                assert injector.injected.get("array_down") == 1
                assert (base_rep.n_arrays, rep.n_arrays) == (2, 1)
                assert res["mesh_degraded"] == 1
                mesh_chaos_sums = sums
            log(f"chaos on the card ({n} array{'s' if n > 1 else ''}): "
                f"injected {injector.injected}, 0 unrecovered, "
                f"{res['retries_total']} retries, mesh degraded "
                f"{res['mesh_degraded']} time(s); checksums equal to the "
                f"fault-free serve's: {sums}")

        cache = ProgramCache()
        full, _ = serve(scheduler(cache), requests + [(4, None, None)])
        first = scheduler(cache)
        for _ in range(4):
            first.submit(decode_steps=4)
        first.run(max_ticks=2)
        path = os.path.join(tmp, "serve.snap")
        save_serving_snapshot(path, first.snapshot())
        assert [p for p in os.listdir(tmp) if p.endswith(".tmp")] == []
        resumed = scheduler(cache)
        assert resumed.restore(load_serving_snapshot(path)) > 0
        rep = resumed.run()
        torch.cuda.synchronize()
        sums = {i: r.state_checksum for i, r in
                enumerate(sorted(rep.requests, key=lambda r: r.rid))}
        assert sums == full, (sums, full)
        log(f"snapshot: a serve stopped after 2 ticks, saved (no .tmp left),"
            f" loaded and resumed in a fresh Scheduler finishes with the "
            f"uninterrupted checksums {sums}")
    return mesh_chaos_sums


def mesh_phase(gen, flat_sums: dict, flat_tick_ms: float, weights: tuple,
               reduced_sums: dict, floor_ms: float) -> dict:
    """Phase 9; returns what phase 13 holds its ranks against: the
    full-width mesh serve's checksums, tick and peak memory, and the
    chaos serve's checksums."""
    stage("phase 9: sharded cross_checks")
    mesh_cross_check()
    stage("phase 9: full width on 4 arrays")
    full = mesh_full_width(gen, flat_sums, flat_tick_ms, weights)
    stage("phase 9: reduced cell on 4 and 2 arrays")
    mesh_reduced(gen, reduced_sums, floor_ms)
    stage("phase 9: chaos and resume")
    return full | {"chaos_sums": chaos_and_resume()}


# ---------------------------------------------------------------------------
# phase 13: the array mesh as ranks sharing the card
# ---------------------------------------------------------------------------

#: a collective's time limit on the ranks, and the parent's deadline for
#: each spawn's ranks to finish
RANK_TIMEOUT_S = 120
RANK_DEADLINE_S = 480
#: phase 9's full-width mesh serve: 4 requests of 8 decode steps
FW_REQUESTS = [(8, None, seed) for seed in range(4)]
#: phase 9's chaos serve (``chaos_and_resume``): 3 requests of 4 steps
CHAOS_REQUESTS = [(4, None, None)] * 3
#: the gradients phase 13's compressed all-reduce averages, each rank
#: its own: gemma-7b's d_model^2 projection in fp32 and in bf16, a bias
GRADS = {"w": ((3072, 3072), torch.float32),
         "h": ((3072, 3072), torch.bfloat16),
         "b": ((3072,), torch.float32)}


def shard_map_launches() -> float:
    """The sharded launches this process counted (one a rank a sharded
    program, ``CudaBackend.run_sharded`` over a mesh of ranks)."""
    return obs_metrics.counter("backend_launches_total").value(
        kernel="nest_gemm_shard_map")


def rank_launches(ex, rank: int, fused: bool) -> tuple[int, int]:
    """(nest_gemm kernel launches, sharded programs launched) one pass of
    the mesh stream ``ex`` makes on ``rank``: its own shard of each
    sharded step (none past a narrow step's shards); a fused segment
    (when ``fused``) runs whole on every rank, by fused_chain."""
    n_ng = n_sm = 0
    for seg in ex.segments:
        if fused and seg.fused is not None:
            continue
        for i in seg.indices:
            sharded = ex.steps[i].sharded
            if rank < sharded.n_shards:
                n_ng += shard_ng_launches(sharded, sharded.shards[rank])
                n_sm += 1
    return n_ng, n_sm


def rank_gemms(rank: int, n: int, device: str) -> dict:
    """Phase 9's sharded cross_check programs on this rank of ``n``: the
    output, and nest_gemm's launches by the kernel's count and the
    sharded path's, beside what this rank's shard should launch."""
    out = {}
    for idx, progs, t in mesh_check_programs():
        for name, prog in progs.items():
            for axis in ("m", "n", "k"):
                sharded = programlib.shard_program(prog, ArrayMesh(n),
                                                   axis=axis)
                be = CudaBackend(prog.cfg, device=device)
                k0, l0 = ng.launches, shard_map_launches()
                res = be.run_sharded(sharded, t)[prog.out_name]
                mine = rank < sharded.n_shards
                out[(idx, name, axis)] = {
                    "out": res.cpu().numpy(), "ng": ng.launches - k0,
                    "label": shard_map_launches() - l0,
                    "want_ng": (shard_ng_launches(
                        sharded, sharded.shards[rank]) if mine else 0),
                    "want_label": int(mine)}
    return out


def rank_full_width(rank: int, n: int, weights: tuple, device: str) -> dict:
    """Full-width gemma-7b on ``ArrayMesh(n)`` served by the Scheduler on
    this rank, on phase 4's weights (mapped from the parent's card
    memory): checksums, launches against this rank's shards, peak card
    memory of this rank's own allocations, decode ms a tick and the
    collectives' part of it."""
    cfg = feather_config(16, 256)
    cache = ProgramCache()
    prefill, decode = (ModelExecutable.for_cell(
        "gemma-7b", shape, cfg, cache=cache, reduce_model=False,
        mesh=ArrayMesh(n)) for shape in ("prefill_tiny", "decode_tiny"))
    torch.cuda.reset_peak_memory_stats()
    sched = Scheduler(prefill, decode, max_concurrent=4, weights=weights,
                      device=device)
    in_decode = [0.0]
    step = sched._decode_step

    def timed_step(a):
        c0 = dist_ranks.collective_seconds()
        step(a)
        in_decode[0] += dist_ranks.collective_seconds() - c0
    sched._decode_step = timed_step
    k0, l0 = ng.launches, shard_map_launches()
    sums, rep = serve(sched, FW_REQUESTS)
    (pre_ng, pre_sm), (dec_ng, dec_sm) = (
        rank_launches(ex, rank, sched.use_fused) for ex in (prefill, decode))
    passes = len(FW_REQUESTS)      # one prompt chunk a request
    ticks = max(rep.decode_ticks, 1)
    out = {"sums": sums, "ng": ng.launches - k0,
           "label": shard_map_launches() - l0,
           "want_ng": passes * pre_ng + rep.decode_steps_total * dec_ng,
           "want_label": passes * pre_sm + rep.decode_steps_total * dec_sm,
           "tick_ms": rep.decode_wall_s / ticks * 1e3,
           "collective_ms": in_decode[0] / ticks * 1e3,
           "ticks": rep.decode_ticks,
           "peak_bytes": torch.cuda.max_memory_allocated()}
    # the parent's weights go before the rank exits, or the parent finds
    # its shared tensors never released
    del sched
    for w in weights:
        w.clear()
    gc.collect()
    out["gather_floor_ms"] = gather_floor(device)
    return out


def gather_floor(device: str, reps: int = 20) -> dict:
    """ms of one all-gather with nothing else running on the ranks, for
    the full-width decode step's smallest and largest piece (qk's [1, 4]
    and lm_head's [1, 64000] N slices, fp32): what the collective costs
    without waiting for a peer, staged from ``device`` and from host
    memory (gloo alone)."""
    out = {}
    for where in (device, "cpu"):
        for width in (4, 64000):
            piece = torch.zeros((1, width), device=where)
            dist_ranks.all_gather(piece)
            torch.distributed.barrier()
            t0 = time.perf_counter()
            for _ in range(reps):
                dist_ranks.all_gather(piece)
            out[f"{where} {width}"] = (time.perf_counter() - t0) / reps * 1e3
    return out


def rank_chaos(rank: int, n: int, device: str) -> dict:
    """Phase 9's chaos serve of the reduced cell on ``ArrayMesh(n)``
    with the standard fault plan, whose ``array_down`` at tick 2 leaves
    rank n - 1 outside the mesh: checksums, the degrade, and the sharded
    launches after it."""
    cache = ProgramCache()
    prefill, decode = (ModelExecutable.for_cell(
        "gemma-7b", shape, feather_config(4, 16), cache=cache,
        mesh=ArrayMesh(n)) for shape in ("prefill_tiny", "decode_tiny"))
    injector = FaultInjector(FaultPlan.standard(0, n_arrays=n))
    sched = Scheduler(prefill, decode, max_concurrent=2, seed=7,
                      faults=injector, device=device)
    marks = []
    degrade = sched._degrade_mesh

    def degrade_and_mark(site):
        degrade(site)
        marks.append((ng.launches, shard_map_launches()))
    sched._degrade_mesh = degrade_and_mark
    sums, rep = serve(sched, CHAOS_REQUESTS)
    res = rep.summary()["resilience"]
    return {"sums": sums, "mesh_degraded": res["mesh_degraded"],
            "n_arrays": rep.n_arrays, "injected": dict(injector.injected),
            "unrecovered": injector.unrecovered(),
            "ng_after": ng.launches - marks[0][0],
            "label_after": shard_map_launches() - marks[0][1]}


def rank_grads(rank: int, device: str) -> dict:
    gen = torch.Generator(device=device).manual_seed(100 + rank)
    return {name: torch.randn(shape, device=device,
                              generator=gen).to(dtype)
            for name, (shape, dtype) in GRADS.items()}


def rank_compress(rank: int, n: int, device: str) -> dict:
    """``compressed_dp_allreduce`` over a data = n ``DeviceMesh`` (gloo:
    the ranks share the card), each rank on its own gradients on the
    card: held torch.equal to the mean of every rank's round trip summed
    in rank order (this rank draws the others' gradients from their
    seeds); a digest of the result, and its ms."""
    mesh = launch_device_mesh(abstract_mesh((n,), ("data",)), "cpu")
    mine = rank_grads(rank, device)
    got = compressed_dp_allreduce(mine, mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = compressed_dp_allreduce(mine, mesh)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    acc = {name: torch.zeros(shape, device=device)
           for name, (shape, _) in GRADS.items()}
    for r in range(n):
        for name, g in rank_grads(r, device).items():
            acc[name] += fake_quantize_int8(g).float()
    equal = all(torch.equal(got[name], (acc[name] / n).to(dtype))
                and got[name].dtype == dtype
                and got[name].device == mine[name].device
                and torch.equal(again[name], got[name])
                for name, (_, dtype) in GRADS.items())
    digest = hashlib.sha256(b"".join(
        got[name].contiguous().view(torch.uint8).cpu().numpy().tobytes()
        for name in GRADS)).hexdigest()
    return {"equal": equal, "digest": digest, "ms": ms,
            "bytes": sum(g.numel() * g.element_size()
                         for g in mine.values())}


def rank_main(rank: int, n: int, weights, device: str) -> dict:
    """What each rank of phase 13 runs, in one spawn a world size."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"gemms": rank_gemms(rank, n, device),
           "chaos": rank_chaos(rank, n, device)}
    if weights is not None:
        out["full"] = rank_full_width(rank, n, weights, device)
        out["compress"] = rank_compress(rank, n, device)
    return out


def sequential_gemms(device: str) -> dict:
    """Phase 9's sharded programs in this process, where no group is up
    (the shards one after another): each output and the oracle."""
    seq = {}
    for idx, progs, t in mesh_check_programs():
        for name, prog in progs.items():
            oracle = torch.from_numpy(t["I"] @ t["W"])
            if prog.activation is not None:
                oracle = prog.activation(oracle)
            for n in (2, 4):
                for axis in ("m", "n", "k"):
                    sharded = programlib.shard_program(prog, ArrayMesh(n),
                                                       axis=axis)
                    res = CudaBackend(prog.cfg, device=device).run_sharded(
                        sharded, t)[prog.out_name]
                    seq[(n, idx, name, axis)] = (res.cpu(), oracle,
                                                 prog.gemm.k)
    return seq


def check_rank_gemms(n: int, results: list, seq: dict) -> None:
    worst = 0.0
    for rank, res in enumerate(results):
        for (idx, name, axis), r in res["gemms"].items():
            got = torch.from_numpy(r["out"])
            want, oracle, k = seq[(n, idx, name, axis)]
            where = f"rank {rank} of {n}: GEMM {idx} {name} axis {axis}"
            assert torch.equal(got, want), f"{where}: not the sequential output"
            err = (got - oracle).abs()
            assert bool((err <= RTOL + RTOL * k + RTOL * oracle.abs()).all()), \
                f"{where}: max |err| {float(err.max())} against the oracle"
            worst = max(worst, float(err.max()))
            assert (r["ng"], r["label"]) == (r["want_ng"], r["want_label"]), \
                (where, r["ng"], r["label"], r["want_ng"], r["want_label"])
    per = sum(r["label"] for r in results[0]["gemms"].values())
    log(f"ranks: {len(results[0]['gemms'])} sharded programs on each of {n} "
        f"ranks sharing the card (gloo): every rank's output torch.equal to "
        f"the sequential path's in one process, max |err| {worst:.3g} "
        f"against the oracle; nest_gemm launched once a rank a program "
        f"(rank 0: {per}), by the kernel's count and the sharded path's")


def check_rank_chaos(n: int, results: list, chaos_sums: dict) -> None:
    for rank, r in enumerate(results):
        assert r["sums"] == chaos_sums, (rank, r["sums"], chaos_sums)
        assert (r["mesh_degraded"], r["n_arrays"], r["unrecovered"]) == (
            1, n - 1, 0), (rank, r)
        assert r["injected"].get("array_down") == 1, r["injected"]
    outside = results[-1]
    assert outside["label_after"] == 0, outside
    if n - 1 > 1:
        assert outside["ng_after"] == 0, outside
        assert all(r["label_after"] > 0 for r in results[:-1]), results
    log(f"ranks: chaos on {n} ranks (the reduced cell, array_down at tick "
        f"2): checksums equal to phase 9's chaos serve on every rank, mesh "
        f"degraded once to {n - 1} array(s); after it rank {n - 1} launched "
        f"{outside['label_after']:.0f} sharded programs and "
        f"{outside['ng_after']} nest_gemm kernels (ranks inside: "
        f"{[r['label_after'] for r in results[:-1]]} sharded programs"
        + ("; one array left serves unsharded on every rank" if n == 2
           else "") + ")")


def check_rank_full_width(results: list, mesh: dict, flat_sums: dict,
                          name_limit: str) -> None:
    for rank, r in enumerate(results):
        assert r["sums"] == mesh["sums"] == flat_sums, (rank, r["sums"])
        assert (r["ng"], r["label"]) == (r["want_ng"], r["want_label"]) \
            and r["label"] > 0, (rank, r)
    r0 = results[0]
    share = r0["collective_ms"] / r0["tick_ms"]
    log(f"ranks: full-width gemma-7b on 4 ranks sharing the card "
        f"({name_limit}): checksums equal on every rank, to phase 9's mesh "
        f"serve in one process and to phase 4's flat serve; nest_gemm per "
        f"rank {[r['ng'] for r in results]} kernel launches, "
        f"{[int(r['label']) for r in results]} sharded programs, each its "
        f"rank's shards exactly")
    log(f"ranks: peak card memory of each rank's own allocations "
        f"{[round(r['peak_bytes'] / 2**30, 2) for r in results]} GiB (the "
        f"weights are phase 4's, mapped from the parent) against "
        f"{mesh['peak_bytes'] / 2**30:.2f} GiB for phase 9's mesh serve "
        f"in one process; {name_limit}")
    log(f"ranks: rank 0 decode {r0['tick_ms']:.3f} ms a tick over "
        f"{r0['ticks']} ticks (phase 9 in one process: "
        f"{mesh['tick_ms']:.3f}), {r0['collective_ms']:.3f} ms of it "
        f"({100 * share:.1f}%) in collectives, waiting for the peers "
        f"included; ranks {[round(r['tick_ms'], 3) for r in results]} ms a "
        f"tick; an all-gather with the ranks otherwise idle, ms by source "
        f"and piece width: "
        f"{({w: round(v, 4) for w, v in r0['gather_floor_ms'].items()})}"
        f"; {name_limit}")


def check_rank_compress(results: list, name_limit: str) -> None:
    assert all(r["equal"] for r in results), [r["equal"] for r in results]
    assert len({r["digest"] for r in results}) == 1, results
    log(f"ranks: compressed_dp_allreduce over data = {len(results)} on the "
        f"card: torch.equal to the ordered mean of every rank's int8 round "
        f"trip, identical on every rank (digest "
        f"{results[0]['digest'][:12]}); {results[0]['bytes'] / 2**20:.1f} "
        f"MiB a rank, {[round(r['ms'], 2) for r in results]} ms a call; "
        f"{name_limit}")


def rank_phase(weights: tuple, mesh: dict, flat_sums: dict,
               name_limit: str, device: str = "cuda") -> None:
    """Phase 13: 2 and 4 ranks sharing the card over gloo, each spawn
    one process a rank (the kernels are built: the ranks load them)."""
    stage("phase 13: the array mesh as ranks sharing the card")
    seq = sequential_gemms(device)
    with tempfile.TemporaryDirectory() as tmp:
        for n in (2, 4):
            t0 = time.perf_counter()
            results = dist_ranks.spawn(
                rank_main, n, tmp, args=(weights if n == 4 else None, device),
                device=device, timeout_s=RANK_TIMEOUT_S,
                deadline_s=RANK_DEADLINE_S)
            log(f"ranks: {n} ranks spawned, ran and joined in "
                f"{time.perf_counter() - t0:.1f} s")
            check_rank_gemms(n, results, seq)
            check_rank_chaos(n, [r["chaos"] for r in results],
                             mesh["chaos_sums"])
            if n == 4:
                check_rank_full_width([r["full"] for r in results], mesh,
                                      flat_sums, name_limit)
                check_rank_compress([r["compress"] for r in results],
                                    name_limit)


# ---------------------------------------------------------------------------
# phase 10: the model zoo on the card
# ---------------------------------------------------------------------------

#: the serving CLI's defaults: batch 4, prompt 32, 16 greedy steps
ZOO_ARGV = ["--batch", "4", "--prompt-len", "32", "--steps", "16"]
#: the largest |kernel - plain| of a captured bf16 attention call (outputs
#: of about unit RMS; the bf16 flash_attention row reads ~1.6e-2), and of
#: a captured scan (fp32)
ZOO_ATTN_TOL = 3e-2
ZOO_SCAN_TOL = 2e-4


class Swap:
    """While installed, replaces the kernel wrapper ``module.name`` by
    ``fn`` (its plain version) and, at the calls numbered in ``zero``,
    zeroes the first output: a layer's kernel result dropped."""

    def __init__(self, module, name: str, fn, zero=()):
        self.module, self.name, self.fn = module, name, fn
        self.zero, self.calls = set(zero), 0

    def __enter__(self):
        self.orig = getattr(self.module, self.name)
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)

    def __call__(self, *args, **kw):
        out = self.fn(*args, **kw)
        if self.calls in self.zero:
            out = ((torch.zeros_like(out[0]), *out[1:])
                   if isinstance(out, tuple) else torch.zeros_like(out))
        self.calls += 1
        return out


class Capture(Swap):
    """While installed, replaces the kernel wrapper ``module.name`` by one
    that calls it and keeps the inputs and output of its calls numbered
    in ``keep`` (cloned), so they can be held against the plain version.
    The wrapper's own launch count is untouched."""

    def __init__(self, module, name: str, keep):
        super().__init__(module, name, None)
        self.keep, self.kept = set(keep), {}

    def __call__(self, *args, **kw):
        i = self.calls
        self.calls += 1
        out = self.orig(*args, **kw)
        if i in self.keep:
            def clone(x):
                return x.clone() if isinstance(x, torch.Tensor) else x
            self.kept[i] = ([clone(a) for a in args],
                            {k: clone(v) for k, v in kw.items()},
                            [clone(o) for o in (out if isinstance(out, tuple)
                                                else (out,))])
        return out


class Routes:
    """While installed, wraps ``models.moe.choose`` and ``models.moe.route``
    and keeps each MoE layer call's routes: every token's own choice of
    experts [B, S, k] and whether each routed choice kept its slot.  With
    ``replay`` (another run's Routes) each call routes its tokens to the
    experts that run chose at the same call, weighted by this run's
    probabilities, and keeps its own choice beside them."""

    def __init__(self, replay: "Routes | None" = None):
        self.replay = replay

    def __enter__(self):
        self.chosen, self.kept = [], []
        self.orig = moe_mod.choose, moe_mod.route
        moe_mod.choose, moe_mod.route = self.choose, self.route
        return self

    def __exit__(self, *exc):
        moe_mod.choose, moe_mod.route = self.orig

    def choose(self, probs, top_k):
        idx = self.orig[0](probs, top_k)
        self.chosen.append(idx.clone())
        return idx if self.replay is None else \
            self.replay.chosen[len(self.chosen) - 1]

    def route(self, gate_idx, num_experts, cap):
        out = self.orig[1](gate_idx, num_experts, cap)
        order, keep = out[0], out[3]
        keep = torch.gather(keep, 1, torch.argsort(order, dim=1))
        self.kept.append(keep.view_as(gate_idx))
        return out

    def dropped(self) -> int:
        return sum(int((~keep).sum()) for keep in self.kept)


def zoo_kernel_checks(arch: str, caps: list) -> None:
    """Each captured call (of the first and the last layer) against its
    plain version on the same card tensors."""
    for cap in caps:
        for i, (args, kw, outs) in sorted(cap.kept.items()):
            if cap.name == "flash_attention":
                want = [ref.flash_attention_ref(*args, **kw)]
                tol = ZOO_ATTN_TOL
            elif cap.name == "flash_decode":
                q, k, v, lens = args
                want = [ref.flash_decode_ref(q, k, v, lens, **kw)]
                tol = ZOO_ATTN_TOL
            else:
                want = list(ref.mamba_scan_ref(*args))
                tol = ZOO_SCAN_TOL
            errs = [float((o.float() - w.float()).abs().max())
                    for o, w in zip(outs, want)]
            rms = float(want[0].float().pow(2).mean().sqrt())
            shapes = [tuple(a.shape) for a in args[:2]]
            log(f"zoo {arch}: {cap.name} call {i} {shapes} "
                f"{str(args[0].dtype).split('.')[1]} | max_err "
                f"{', '.join(f'{e:.3g}' for e in errs)} (tolerance {tol}), "
                f"output RMS {rms:.3f}"
                + ("" if cap.name != "mamba_scan" else
                   f", h_last bit-equal {torch.equal(outs[1], want[1])}"))
            assert all(e <= tol for e in errs) and all(
                bool(torch.isfinite(o).all()) for o in outs), (arch, i, errs)


#: each kernel wrapper's module, where ``Swap`` and ``Capture`` install
KERNEL_MODULES = {"flash_attention": fa, "flash_decode": fa,
                  "mamba_scan": ms}


def zoo_launches(cfg) -> tuple[dict, dict]:
    """The kernels a model of the zoo launches: (at prefill, a decode
    step).  Attention once a layer (the hybrid's once an application of
    its shared block; encdec's once an encoder layer and twice a decoder
    layer, self and cross), the scan once a Mamba block."""
    n = cfg.num_layers
    if cfg.family == "ssm":
        return {"mamba_scan": n}, {"mamba_scan": n}
    if cfg.family == "hybrid":
        apps = n // cfg.attn_every
        return ({"mamba_scan": n, "flash_attention": apps},
                {"mamba_scan": n, "flash_decode": apps})
    if cfg.family == "encdec":
        return ({"flash_attention": cfg.encoder_layers + 2 * n},
                {"flash_decode": 2 * n})
    return {"flash_attention": n}, {"flash_decode": n}


def zoo_plan(cfg, steps: int) -> tuple[dict, dict]:
    """A serve of ``steps`` tokens (a prefill and ``steps - 1`` decode
    steps): every kernel's exact launches, and the calls to capture, each
    kernel's first and last of the prefill and of the last decode step."""
    pre, step = zoo_launches(cfg)
    expect = {k: pre.get(k, 0) + step.get(k, 0) * (steps - 1)
              for k in counts()}
    keep = {}
    for k, n in pre.items():
        keep[k] = (0, n - 1)
    for k, n in step.items():
        first = pre.get(k, 0) + n * (steps - 2)
        keep[k] = keep.get(k, ()) + (first, first + n - 1)
    return expect, keep


def _named_leaves(tree, key=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, k)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _named_leaves(v, key)
    else:
        yield key, tree


def decode_step_bytes(model, batch: int, attended: int) -> tuple[int, int]:
    """The bytes a decode step must move: (weights, cache).  Every weight
    the step uses read once (the hybrid's shared block once an
    application: its 100 MB does not stay in the 50 MB L2; an encdec
    model's encoder not at all), the decode cache read at ``attended``
    positions (encdec's cross K/V at all its frames), the recurrent
    states (``conv``, ``ssm``) read and written."""
    net = model.net

    def size(params):
        return sum(p.numel() * p.element_size() for p in params)
    weights = size(p for name, p in net.named_parameters()
                   if not name.startswith("enc_"))
    if model.cfg.family == "hybrid":
        weights += (len(net.app_norms) - 1) * size(net.shared.parameters())
    cache = sum(t.numel() * t.element_size() * (2 if key in ("conv", "ssm")
                                                else 1)
                for key, t in _named_leaves(model.cache_spec(batch,
                                                             attended)))
    return weights, cache


def zoo_serve(arch: str, name_limit: str, device="cuda",
              depth: int | None = None) -> dict:
    """``arch`` at full width and depth (or cut to ``depth`` layers) in
    its published dtype, built and served as ``python -m
    repro_torch.launch.serve --arch ARCH`` builds and serves it (the
    CLI's defaults): launches exact (``zoo_plan``), two serves' tokens
    identical, each kernel's first and last call of the prefill and of
    the last decode step held against their plain versions (in the
    second serve), the logits held against the plain versions'
    (``zoo_logits_gate``), the decode step beside the bound of the bytes
    it must move (``decode_step_bytes``), the peak device memory, then
    the device's idle share over a few traced steps (``zoo_busy``).
    Returns the first serve's launches."""
    args = launch_serve.parse(["--arch", arch, *ZOO_ARGV, "--device",
                               str(device)])
    full = get_config(arch)
    cfg = None if depth is None else dataclasses.replace(full,
                                                         num_layers=depth)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine, prompts, kw = launch_serve.setup(args, cfg)
    torch.cuda.synchronize()
    model, cfg = engine.model, engine.model.cfg
    wbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    cut = ("" if depth is None else
           f" (depth cut from {full.num_layers}: the whole model, "
           f"{build_model(full, device='meta').param_count() * 2 / 1e9:.0f}"
           f" GB in bf16, fits no card)")
    log(f"zoo {arch}: {cfg.num_layers} layers{cut}, "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B "
        f"parameters, {wbytes / 1e9:.2f} GB {cfg.dtype}, drawn on the card "
        f"in {time.perf_counter() - t0:.1f} s")
    steps = args.steps
    expect, keep = zoo_plan(cfg, steps)
    mods = {n: KERNEL_MODULES[n] for n in keep}

    reset_counts()
    tokens = engine.generate(prompts, steps, **kw)
    launched = counts()
    st = engine.stats
    log(f"zoo {arch}: launches {launched}")
    assert launched == expect, (launched, expect)
    assert tokens.shape == (args.batch, steps)
    assert ((tokens >= 0) & (tokens < cfg.vocab_size)).all()

    caps = [Capture(mods[n], n, idx) for n, idx in keep.items()]
    with contextlib.ExitStack() as stack:
        for c in caps:
            stack.enter_context(c)
        reset_counts()
        tokens2 = engine.generate(prompts, steps, **kw)
        again = counts()
    assert again == expect, (again, expect)
    assert (tokens == tokens2).all(), (tokens, tokens2)
    zoo_kernel_checks(arch, caps)
    zoo_logits_gate(arch, model, prompts, kw, mods)

    step_ms = st["decode_s"] / st["decode_steps"] * 1e3
    # the mean decode step attends to prompt + steps / 2 keys
    weights, cache = decode_step_bytes(model, args.batch,
                                       args.prompt_len + steps // 2)
    bound_ms = (weights + cache) / PEAK_BYTES * 1e3
    cli_tok_s = args.batch * steps / (st["prefill_s"] + st["decode_s"])
    rep_ms = engine.stats["decode_s"] / engine.stats["decode_steps"] * 1e3
    log(f"zoo {arch}: decode {step_ms:.3f} ms a step over "
        f"{st['decode_steps']} steps ({args.batch / step_ms * 1e3:.1f} "
        f"tok/s decoding, {cli_tok_s:.1f} tok/s with prefill, the CLI's "
        f"measure) against the bound {bound_ms:.3f} ms ({weights / 1e9:.3f} "
        f"GB of weights and {cache / 1e9:.3f} GB of cache and states a step "
        f"at {PEAK_BYTES / 1e12:.2f} TB/s); "
        f"prefill of {args.batch} x {args.prompt_len} tokens "
        f"{st['prefill_s'] * 1e3:.1f} ms; the repeat serve (capturing "
        f"calls) {rep_ms:.3f} ms a step "
        f"({args.batch / rep_ms * 1e3:.1f} tok/s decoding), prefill "
        f"{engine.stats['prefill_s'] * 1e3:.1f} ms; tokens identical across "
        f"the two serves")
    gib = 2 ** 30
    log(f"zoo {arch}: device memory {torch.cuda.memory_allocated() / gib:.2f}"
        f" GiB allocated, {torch.cuda.max_memory_allocated() / gib:.2f} GiB "
        f"peak; card {name_limit}")
    log(f"zoo {arch}: tokens[:, :12] {tokens[:, :12].tolist()}")
    traced_ms, busy_ms = zoo_busy(engine, prompts, kw)
    log(f"zoo {arch}: {ZOO_TRACED_STEPS} decode steps traced by "
        f"torch.profiler: {traced_ms:.3f} ms a step, the card busy "
        f"{busy_ms:.3f} ms of it; device idle share "
        f"{1 - busy_ms / traced_ms:.3f} of the traced step, "
        f"{max(0.0, 1 - busy_ms / step_ms):.3f} of the untraced "
        f"{step_ms:.3f} ms")
    del engine, model
    torch.cuda.empty_cache()
    return launched


#: decode steps of a zoo model traced for its device idle share
ZOO_TRACED_STEPS = 4


def zoo_busy(engine, prompts, kw) -> tuple[float, float]:
    """(wall ms, the card's busy ms) a decode step over ZOO_TRACED_STEPS
    greedy steps after a prefill, traced by ``torch.profiler``
    (``profile_zoo.py``'s steps; the profiler's host cost lengthens the
    traced step)."""
    from torch.profiler import ProfilerActivity, profile

    from profile_zoo import decode_steps, start
    dev = engine.model.device
    state = start(engine, torch.as_tensor(prompts, device=dev),
                  {k: torch.as_tensor(v, device=dev) for k, v in kw.items()})
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = decode_steps(engine, state, ZOO_TRACED_STEPS)[0]
    n = ZOO_TRACED_STEPS
    return wall / n * 1e3, busy_seconds(prof) / n * 1e3


#: the largest relative L2 distance (a row's) between the zoo's logits on
#: the kernels and on their plain versions, bf16 at full depth
ZOO_LOGITS_TOL = 2e-2
#: requests the logits gate runs for an MoE model (the served 4 and more
#: drawn from a seed): a request routes its tokens on its own, so each is
#: a row whose routes may agree at every layer between the two runs
ZOO_MOE_GATE_ROWS = 16

#: each kernel wrapper's plain version
PLAIN = {"flash_attention": ref.flash_attention_ref,
         "flash_decode": ref.flash_decode_ref,
         "mamba_scan": ref.mamba_scan_ref}


def zoo_logits(model, prompts, kw) -> torch.Tensor:
    """[2, B, V] fp32: the prefill's logits (last position) and those of
    one decode step after it, fed each prompt's last token."""
    b, p = prompts.shape
    pre, cache = model.prefill(prompts, **kw)
    cache = expand_cache(model, cache, b, p + 1)
    step, _ = model.decode_step(prompts[:, -1:], cache,
                                torch.full((b,), p, dtype=torch.int32,
                                           device=prompts.device))
    return torch.stack([pre.float(), step.float()])


def route_agreement(a: Routes, b: Routes) -> tuple[float, torch.Tensor]:
    """The share of (token, layer, choice) experts two runs choose alike,
    and which batch rows choose alike at every one of theirs."""
    same = [x == y for x, y in zip(a.chosen, b.chosen, strict=True)]
    share = sum(int(x.sum()) for x in same) / sum(x.numel() for x in same)
    return share, torch.stack([x.flatten(1).all(1) for x in same]).all(0)


class Layers:
    """While installed, keeps every decoder layer call's input and output
    hidden states, in call order.  With ``forced`` (another run's Layers)
    each call takes the input that run's same call had: a teacher-forced
    run, in which a layer's output differs from that run's only by what
    the layer itself computes differently."""

    def __init__(self, model, forced: "Layers | None" = None):
        self.layers = [m for m in model.modules()
                       if isinstance(m, DecoderLayer)]
        self.forced = forced

    def __enter__(self):
        self.ins, self.outs = [], []
        self.hooks = [h for m in self.layers for h in (
            m.register_forward_pre_hook(self.pre),
            m.register_forward_hook(self.post))]
        return self

    def __exit__(self, *exc):
        for h in self.hooks:
            h.remove()

    def pre(self, module, args):
        if self.forced is not None:
            return (self.forced.ins[len(self.ins)], *args[1:])

    def post(self, module, args, out):
        self.ins.append(args[0].clone())
        self.outs.append(out[0].clone())

    def contributions(self) -> list[torch.Tensor]:
        """Each call's output minus its input: what the layer added."""
        return [o.float() - i.float() for i, o in zip(self.ins, self.outs)]


def _rel(a, b) -> float:
    """The largest relative L2 distance of a row (the last axis)."""
    return float(((a - b).norm(dim=-1) / b.norm(dim=-1)).max())


def zoo_logits_gate(arch: str, model, prompts, kw, mods) -> None:
    """The served model's logits on the kernels against the same model
    with every kernel wrapper swapped for its plain version, within
    ZOO_LOGITS_TOL (a row's relative L2 distance).  Seeded weights make
    greedy tokens repeat the prompt's last token (the tied table is drawn
    at scale 1.0), so tokens alone could not see a wrong kernel; the gate
    is shown to see one: dropping the last layer's kernel results (the
    plain versions, the last layer's outputs zeroed) must move the logits
    by more than the tolerance.  An MoE model has a gate of its own
    (``zoo_moe_gate``)."""
    if model.cfg.moe_enabled:
        return zoo_moe_gate(arch, model, prompts, kw, mods)
    pre, step = zoo_launches(model.cfg)
    prompts = torch.as_tensor(prompts, device=model.device)

    def swapped(zero):
        with contextlib.ExitStack() as stack:
            for n, mod in mods.items():
                stack.enter_context(Swap(mod, n, PLAIN[n], zero(n)))
            return zoo_logits(model, prompts, kw)

    got = zoo_logits(model, prompts, kw)
    plain = swapped(lambda n: ())
    # each kernel's last call at prefill and at the decode step (a
    # wrapper's calls are counted over both)
    fault = swapped(lambda n: tuple(c - 1 for c in (
        pre.get(n, 0), pre.get(n, 0) + step.get(n, 0)) if c))
    err, moved = _rel(got, plain), _rel(fault, plain)
    log(f"zoo {arch}: logits on the kernels against the plain versions: "
        f"relative L2 {err:.3g} (tolerance {ZOO_LOGITS_TOL}; prefill "
        f"{_rel(got[0], plain[0]):.3g}, decode "
        f"{_rel(got[1], plain[1]):.3g}), max |diff| "
        f"{float((got - plain).abs().max()):.3g} on logits of max "
        f"{float(plain.abs().max()):.1f}; the last layer's kernel results "
        f"dropped move them {moved:.3g}")
    assert bool(torch.isfinite(got).all()), arch
    assert err <= ZOO_LOGITS_TOL < moved, (arch, err, moved)


def zoo_moe_gate(arch: str, model, prompts, kw, mods) -> None:
    """``zoo_logits_gate`` for an MoE model, over ``ZOO_MOE_GATE_ROWS``
    requests.  A seeded MoE model amplifies a ulp: one bf16 ulp added to
    one element after the first layer moves granite-moe-3b-a800m's
    logits by ~5e-2 (logged here, on the kernel run's experts), and its
    top-k choices flip with it, so the plain versions run as they are
    (logged: their logits' distance, the share of (token, layer, choice)
    experts they choose as the kernel run does, and the requests that
    agree at every layer) cannot be held to the kernels at
    ZOO_LOGITS_TOL.  The gate runs them teacher-forced
    (``Layers(forced=)``: every layer call fed the kernel run's input) on
    the kernel run's experts (``Routes(replay=)``): each layer's
    contribution (output minus input) and the logits must be within
    ZOO_LOGITS_TOL, and dropping the last layer's kernel results must
    move that layer's contribution past it (the logits' move is logged:
    at granite's depth the last layer's attention is a small part of
    them)."""
    layers = model.cfg.num_layers
    prompts = torch.as_tensor(prompts, device=model.device)
    more = torch.randint(0, model.cfg.vocab_size,
                         (ZOO_MOE_GATE_ROWS - prompts.shape[0],
                          prompts.shape[1]), device=model.device,
                         generator=torch.Generator(
                             model.device).manual_seed(3))
    prompts = torch.cat([prompts, more.to(prompts.dtype)])

    def nudge(module, args, out):
        """One bf16 ulp more at one element of the layer's output."""
        x = out[0].clone()
        x.view(-1)[0] *= 1 + 2 ** -7
        return (x, *out[1:])

    def run(zero=None, teacher=(None, None), nudged=False):
        with contextlib.ExitStack() as stack:
            routes = stack.enter_context(Routes(teacher[0]))
            calls = stack.enter_context(Layers(model.net, teacher[1]))
            for n, mod in (mods.items() if zero else ()):
                stack.enter_context(Swap(mod, n, PLAIN[n], zero(n)))
            if nudged:
                hook = calls.layers[0].register_forward_hook(nudge)
                stack.callback(hook.remove)
            return zoo_logits(model, prompts, kw), routes, calls

    got, routes, calls = run()
    free, free_routes, _ = run(lambda n: ())
    # the kernel run's experts, each layer's input the run's own; then
    # the same with one ulp added after the first layer
    replayed = run(lambda n: (), (routes, None))[0]
    ulp = run(lambda n: (), (routes, None), nudged=True)[0]
    plain, _, plain_calls = run(lambda n: (), (routes, calls))
    # the last layer's attention call at prefill and at the decode step
    fault, _, fault_calls = run(lambda n: (layers - 1,), (routes, calls))
    share, agree = route_agreement(routes, free_routes)
    err, moved = _rel(got, plain), _rel(fault, plain)
    parts = [_rel(a, b) for a, b in zip(calls.contributions(),
                                        plain_calls.contributions())]
    worst = max(range(len(parts)), key=parts.__getitem__)
    # the last layer's calls: at prefill and at the decode step
    last = (layers - 1, 2 * layers - 1)
    dropped = max(_rel(fault_calls.contributions()[i],
                       plain_calls.contributions()[i]) for i in last)
    log(f"zoo {arch}: on their own, the plain versions' logits are "
        f"{_rel(got, free):.3g} (relative L2) from the kernels', and "
        f"{share:.6f} of {sum(x.numel() for x in routes.chosen)} (token, "
        f"layer, choice) experts agree; {int(agree.sum())} of "
        f"{len(agree)} requests agree at every layer; {routes.dropped()} "
        f"choices dropped by capacity; on the kernel run's experts "
        f"{_rel(got, replayed):.3g}, and one bf16 ulp added to one element "
        f"after the first layer moves those {_rel(ulp, replayed):.3g}")
    log(f"zoo {arch}: teacher-forced on the kernel run's inputs and "
        f"experts, logits relative L2 {err:.3g} (tolerance "
        f"{ZOO_LOGITS_TOL}; prefill {_rel(got[0], plain[0]):.3g}, decode "
        f"{_rel(got[1], plain[1]):.3g}), max |diff| "
        f"{float((got - plain).abs().max()):.3g} on logits of max "
        f"{float(plain.abs().max()):.1f}; a layer's contribution at most "
        f"{parts[worst]:.3g} (call {worst} of {len(parts)}); the last "
        f"layer's kernel results dropped move its contribution "
        f"{dropped:.3g} and the logits {moved:.3g}")
    assert bool(torch.isfinite(got).all()), arch
    assert max(err, parts[worst]) <= ZOO_LOGITS_TOL < dropped, (
        arch, err, parts[worst], dropped)


#: the depth of the decode-vs-prefill check where 2 is not enough:
#: zamba2's shared block runs after every 6 blocks, so 7 runs one
#: application and a tail block
DECODE_CHECK_DEPTH = {"zamba2-1.2b": 7}


def zoo_decode_matches_prefill(arch: str, device="cuda") -> None:
    """``tests/test_arch_smoke.py``'s decode-vs-prefill check at full width,
    depth 2 (or ``DECODE_CHECK_DEPTH``), fp32: prefill(t[:n]) then
    decode(t[n]) against prefill(t[:n+1]), rtol and atol 2e-3: the
    kernels' prefill path against their decode path through whole models
    (an encdec model's frames drawn at the CLI's scale).  Capacity depends on
    the tokens a row, so at the published 1.25 a prefill of n + 1 tokens
    and a decode after n may drop different tokens, in the JAX package as
    here: an MoE model runs at capacity factor experts / top-k, at which
    an expert has a slot for every token of a row and nothing is dropped
    (``configs.base.reduced``'s 4.0 drops choices at granite's full
    width: its seeded router sends most tokens to a few experts)."""
    depth = DECODE_CHECK_DEPTH.get(arch, 2)
    cfg = dataclasses.replace(get_config(arch), num_layers=depth,
                              dtype="float32")
    if cfg.moe_enabled:
        cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.num_experts / cfg.experts_per_token)
    model = build_model(cfg, device=device,
                        generator=torch.Generator(device).manual_seed(1))
    b, n = 4, 32
    gen = torch.Generator(device).manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (b, n + 1), device=device,
                         generator=gen)
    kw = {}
    if cfg.family == "encdec":
        kw["frames"] = torch.randn(b, cfg.frontend_len, cfg.d_model,
                                   device=device, generator=gen) * 0.02
    reset_counts()
    with Routes() as routes:
        full, _ = model.prefill(toks, **kw)
        _, cache = model.prefill(toks[:, :n], **kw)
        cache = expand_cache(model, cache, b, n + 1)
        step, _ = model.decode_step(toks[:, n:], cache,
                                    torch.full((b,), n, dtype=torch.int32,
                                               device=device))
    torch.cuda.synchronize()
    launched = {k: v for k, v in counts().items() if v}
    err = float((step - full).abs().max())
    dropped = (f"; choices dropped by capacity {routes.dropped()}"
               if cfg.moe_enabled else "")
    log(f"zoo {arch} fp32 depth {depth}: decode after prefill of {n} "
        f"against prefill of {n + 1}: max |diff| {err:.3g} on logits of max "
        f"{float(full.abs().max()):.1f}; launches {launched}{dropped}")
    assert routes.dropped() == 0, routes.dropped()
    torch.testing.assert_close(step, full, rtol=2e-3, atol=2e-3)
    del model, cache
    torch.cuda.empty_cache()


#: the zoo's serves: (arch, depth; None serves every layer)
ZOO = [("gemma-7b", None), ("falcon-mamba-7b", None),
       ("granite-moe-3b-a800m", None), ("deepseek-v2-236b", 4),
       ("zamba2-1.2b", None), ("whisper-base", None)]


def zoo_phase(name_limit: str, device="cuda") -> tuple[dict, dict]:
    """Phase 10; returns the kernels' launches in the models' first
    serves, summed and by arch."""
    zoo, by_arch = {}, {}
    for arch, depth in ZOO:
        stage(f"phase 10: {arch} served at full width"
              + ("" if depth is None else f", depth {depth}"))
        by_arch[arch] = zoo_serve(arch, name_limit, device, depth)
        for k, v in by_arch[arch].items():
            zoo[k] = zoo.get(k, 0) + v
    stage("phase 10: decode against prefill, fp32, depth 2 (zamba2 7)")
    for arch, _ in ZOO:
        zoo_decode_matches_prefill(arch, device)
    return zoo, by_arch



# ---------------------------------------------------------------------------
# phase 2, the backward kernels; phase 11: training
# ---------------------------------------------------------------------------

#: zamba2-1.2b's shared attention in phase 11's training step: batch 2 x
#: 32 heads of 64, 1024 tokens, causal
TRAIN_ATTN_CASE = (64, 1024, 64)
#: zamba2-1.2b's folded Mamba-2 scan in phase 11's training step: batch 2
#: x 64 heads folded into the batch, 1024 tokens, P 64, N 64
TRAIN_SCAN_SHAPE = (128, 1024, 64, 64)
#: the gradient kernels against their plain versions: |err| within
#: RTOL * |want| + ATOL_FRAC * RMS(want).  bf16: both round an fp32 sum
#: to bf16, which another sum order can move by one bf16 ulp (2^-8 of
#: |want|, 2^-7 at the bottom of a binade); fp32: sums of up to 1024
#: terms in another order
GRAD_TOL = {torch.bfloat16: (2 ** -7, 1e-3), torch.float32: (2e-4, 2e-4)}


def check_grads(name: str, got, want, dtype) -> float:
    """Each of ``got`` against ``want`` within ``GRAD_TOL[dtype]``, all
    finite; returns the largest |err|."""
    rtol, frac = GRAD_TOL[dtype]
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        g, w = g.float(), w.float()
        rms = float(w.pow(2).mean().sqrt())
        err = (g - w).abs()
        assert rms > 0, f"{name}[{i}]: the plain result is all zeros"
        if not bool(torch.isfinite(g).all()) or bool(
                (err > rtol * w.abs() + frac * rms).any()):
            raise AssertionError(f"{name}[{i}]: kernel disagrees with its "
                                 f"plain version (max |err| "
                                 f"{float(err.max())}, RMS {rms})")
        worst = max(worst, float(err.max()))
    return worst


def sdpa_backward_library(timer, name: str, want, q, k, v, do) -> dict:
    """The attention backward's library call: the backward of SDPA on 4-D
    inputs, causal, for every route that takes them (the forward run once
    under the route, its graph kept; one ``torch.autograd.grad`` timed);
    each route's error against ``want`` (dq, dk, dv) logged, the fastest
    route's timing returned."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    sdpa = torch.nn.functional.scaled_dot_product_attention
    leaves = [x[None].detach().requires_grad_() for x in (q, k, v)]
    best, parts = None, []
    for route in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                  SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        route_name = route.name.lower()
        try:
            with warnings.catch_warnings(), sdpa_kernel([route]):
                warnings.simplefilter("ignore")
                out = sdpa(*leaves, is_causal=True)

                def call(out=out):
                    return torch.autograd.grad(out, leaves, do[None],
                                               retain_graph=True)
                got = call()
        except RuntimeError:        # the route does not take the inputs
            parts.append(f"{route_name} -")
            continue
        err = max(float((g[0].float() - w.float()).abs().max())
                  for g, w in zip(got, want))
        t = timer(call)
        parts.append(f"{route_name} {spread(t)} (max_err {err:.3g})")
        if best is None or t["ms"] < best["ms"]:
            best = {**t, "route": route_name}
        del out, got
    assert best is not None, f"{name}: no SDPA route takes the inputs"
    log(f"  {name} library, the backward of SDPA on 4-D inputs: "
        f"{'; '.join(parts)}; fastest {best['route']}")
    return best


def check_flash_attention_bwd(timer, gen, dtype) -> tuple[dict, dict]:
    """flash_attention's forward with its log-sum-exp (the training
    path's call: ``o`` bit-equal to the call without) and
    flash_attention_bwd at ``TRAIN_ATTN_CASE`` in ``dtype``, each against
    its plain version, the backward twice ``torch.equal``; timed beside
    their bounds and SDPA (forward; backward).  Returns the rows
    (forward, backward)."""
    bh, s, d = TRAIN_ATTN_CASE
    # q at 8x: a peaked softmax whose output RMS is over 10x check()'s
    # atol, as at ATTN_SHAPE
    q = (torch.randn(bh, s, d, device="cuda", generator=gen) * 8.0
         ).to(dtype)
    k, v, do = (torch.randn(bh, s, d, device="cuda", generator=gen
                            ).to(dtype) for _ in range(3))
    o, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    assert torch.equal(o, fa.flash_attention(q, k, v, causal=True))
    want_o, want_lse = ref.flash_attention_ref(q, k, v, causal=True,
                                               return_lse=True)
    rate = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_3XTF32
    tag = str(dtype).split(".")[1]
    name = f"flash_attention {tag} {TRAIN_ATTN_CASE} (training, lse)"
    # o as the forward rows hold it (one bf16 ulp more in bf16, as
    # flash_attention_enc), lse in fp32
    err_o = check(name, o.float(), want_o.float(), d,
                  RTOL + (2 ** -7 if dtype == torch.bfloat16 else 0))
    check_grads(name + " lse", [lse], [want_lse], torch.float32)
    pairs = bh * s * (s + 1) / 2                    # causal pairs only
    elt = q.element_size()
    f_bytes, f_flops = 4.0 * bh * s * d * elt + 4.0 * bh * s, 4.0 * pairs * d
    f_ms = timer(lambda: fa.flash_attention(q, k, v, causal=True,
                                            return_lse=True))
    f_plain = timer(lambda: ref.flash_attention_ref(q, k, v, causal=True,
                                                    return_lse=True))
    f_lib = sdpa_library(timer, name, want_o, lambda x: x[0], q[None],
                         k[None], v[None], is_causal=True)
    b_ms, b_by = bound(f_bytes, f_flops, rate)
    log(f"K5 {name}: max_err {err_o:.3g}, o bit-equal to the call without "
        f"lse | ms {spread(f_ms)} plain {f_plain['ms']:.4f} sdpa "
        f"{f_lib['ms']:.4f} ({f_lib['route']}) bound {b_ms:.6f} ({b_by})")
    fwd = row_stats(f_ms, f_plain, f_lib, f_bytes, f_flops, err_o, rate)

    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    assert all(torch.equal(a, b) for a, b in zip(got, again)), \
        "flash_attention_bwd: two runs differ"
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=True)
    name = f"flash_attention_bwd {tag} {TRAIN_ATTN_CASE}"
    err = check_grads(name, got, want, dtype)
    ms_ = timer(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do,
                                               causal=True))
    plain = timer(lambda: ref.flash_attention_bwd_ref(q, k, v, o, lse, do,
                                                      causal=True))
    lib = sdpa_backward_library(timer, name, want, q, k, v, do)
    nbytes = 8.0 * bh * s * d * elt + 4.0 * bh * s
    flops = 5 * 2.0 * pairs * d                     # the five products
    b_ms, b_by = bound(nbytes, flops, rate)
    log(f"K5b {name}: causal | max_err {err:.3g}, two runs torch.equal | "
        f"ms {spread(ms_)} plain {plain['ms']:.4f} sdpa backward "
        f"{lib['ms']:.4f} ({lib['route']}) bound {b_ms:.6f} ({b_by}) "
        f"(FFMA bound {bound(nbytes, flops)[0]:.4f})")
    return fwd, row_stats(ms_, plain, lib, nbytes, flops, err, rate)


def check_mamba_scan_bwd(timer, gen) -> tuple[dict, dict]:
    """At ``TRAIN_SCAN_SHAPE`` (da a head's scalar expanded, as Mamba-2
    gives it; dh_last zero, as the models give it), as training calls
    them: the forward storing its states, y and h_last torch.equal to the
    call without and the states to the plain version's; then
    mamba_scan_bwd given those states against its plain version (which
    replays from h0): dda, ddbx and dh0 bit-equal, dc within fp32
    tolerance, two runs ``torch.equal``.  Each timed beside its bound (no
    library call computes the scan), the forward also without states.
    Returns the rows (forward with states, backward)."""
    b, seq, d, n = TRAIN_SCAN_SHAPE
    da = (0.7 + 0.299 * torch.rand(b, seq, device="cuda", generator=gen)
          )[..., None, None].expand(b, seq, d, n).contiguous()
    dbx = torch.randn(b, seq, d, n, device="cuda", generator=gen) * 0.1
    c = torch.randn(b, seq, n, device="cuda", generator=gen)
    h0 = torch.randn(b, d, n, device="cuda", generator=gen) * 0.1
    dy = torch.randn(b, seq, d, device="cuda", generator=gen)
    y, h_last, states = ms.mamba_scan(da, dbx, c, h0, return_states=True)
    y0, h0_last = ms.mamba_scan(da, dbx, c, h0)
    name = (f"mamba_scan {TRAIN_SCAN_SHAPE} (Mamba-2, da per head), "
            f"states stored")
    assert torch.equal(y, y0) and torch.equal(h_last, h0_last), \
        f"{name}: y or h_last differs from the call without states"
    want_y, _, want_states = ref.mamba_scan_ref(da, dbx, c, h0,
                                                return_states=True)
    assert torch.equal(states, want_states), (
        name, float((states - want_states).abs().max()))
    err_y = check(name, y, want_y, n)
    del y0, h0_last, want_y, want_states
    f_ms = timer(lambda: ms.mamba_scan(da, dbx, c, h0, return_states=True))
    f_bare = timer(lambda: ms.mamba_scan(da, dbx, c, h0))
    f_plain = timer(lambda: ref.mamba_scan_ref(da, dbx, c, h0,
                                               return_states=True), 3)
    n_states = b * states.shape[1] * d * n
    f_bytes = 4.0 * (2 * b * seq * d * n + b * seq * n + 2 * b * d * n
                     + b * seq * d + n_states)
    f_flops = 4.0 * b * seq * d * n
    log(f"K6s {name}: y max_err {err_y:.3g}, y and h_last bit-equal to the "
        f"call without states, states bit-equal | ms {spread(f_ms)} "
        f"without states {spread(f_bare)} plain {f_plain['ms']:.4f} library "
        f"none | bound {bound(f_bytes, f_flops)[0]:.4f}")
    fwd = row_stats(f_ms, f_plain, None, f_bytes, f_flops, err_y)

    got = ms.mamba_scan_bwd(da, dbx, c, h0, dy, states=states)
    again = ms.mamba_scan_bwd(da, dbx, c, h0, dy, states=states)
    assert all(torch.equal(x, y) for x, y in zip(got, again)), \
        "mamba_scan_bwd: two runs differ"
    del again
    want = ref.mamba_scan_bwd_ref(da, dbx, c, h0, dy)
    name = f"mamba_scan_bwd {TRAIN_SCAN_SHAPE} (Mamba-2, da per head)"
    for i in (0, 1, 3):     # rounded multiplies and adds in both versions
        assert torch.equal(got[i], want[i]), (
            name, i, float((got[i] - want[i]).abs().max()))
    err = check_grads(name, [got[2]], [want[2]], torch.float32)
    del got, want
    ms_ = timer(lambda: ms.mamba_scan_bwd(da, dbx, c, h0, dy,
                                          states=states))
    plain = timer(lambda: ref.mamba_scan_bwd_ref(da, dbx, c, h0, dy,
                                                 states=states), 3)
    # read: da, dbx, c, the states, dy; written: dda, ddbx, dc, dh0
    nbytes = 4.0 * (4 * b * seq * d * n + 2 * b * seq * n + n_states
                    + b * d * n + b * seq * d)
    flops = 6.0 * b * seq * d * n
    log(f"K6b {name}, given the forward's states: dda, ddbx, dh0 "
        f"bit-equal, dc max_err {err:.3g}, two runs torch.equal | ms "
        f"{spread(ms_)} plain {plain['ms']:.4f} library none | bound "
        f"{bound(nbytes, flops)[0]:.4f}")
    return fwd, row_stats(ms_, plain, None, nbytes, flops, err)


#: phase 11's run: ``python -m repro_torch.launch.train`` with these flags
#: (the card, bf16, params drawn from a generator seeded 0)
TRAIN_ARGV = ["--arch", "zamba2-1.2b", "--batch", "2", "--seq", "1024",
              "--lr", "1e-3", "--steps", "30", "--log-every", "5"]
#: the depth of the gradient and checkpoint gates: six Mamba-2 blocks,
#: one application of the shared block, a tail block
TRAIN_GATE_DEPTH = 7
#: relative L2 of a parameter's gradient on the kernels against the same
#: step on the plain versions through autograd.  bf16: the plain
#: attention's autograd takes dV from its bf16-rounded probabilities and
#: D from its fp32 output, the kernel from fp32 P and the bf16 output, a
#: 2^-9 difference an element that the bf16 backward carries on (read
#: 7.6e-3 median, 1.5e-2 worst, on an H100).  fp32: only sum orders
#: differ (the forward's 3xTF32 products ~1e-6, the backward's and the
#: scan's fp32 sums; read 5e-6 worst)
TRAIN_GRAD_TOL = {"bfloat16": 2e-2, "float32": 1e-4}


def train_launches(cfg, steps: int) -> dict:
    """The kernels a training step of a hybrid model launches, times
    ``steps``: attention forward and backward once an application of the
    shared block (not rematerialised), the scan twice a Mamba block
    (forward, and again in the backward's recompute) and its backward
    once."""
    n, apps = cfg.num_layers, cfg.num_layers // cfg.attn_every
    step = {"flash_attention": apps, "flash_attention_bwd": apps,
            "mamba_scan": 2 * n, "mamba_scan_bwd": n}
    return {k: step.get(k, 0) * steps for k in counts()}


def reckon_training_memory(cfg, batch: int, seq: int) -> float:
    """GiB the step should peak at: 16 bytes a parameter (bf16 weights
    and gradients, fp32 master and moments), the saved activations (each
    block's input, the shared block's internals, the fp32 logits and
    their gradient) and one Mamba-2 block's recompute and backward, whose
    folded scan tensors [B * H, L, P, N] fp32 are the large ones: da, dbx
    and their gradients, the d(dt * x) and dB products of ddbx, the
    expand's copy and the kernel's checkpoints (about seven of them)."""
    params = param_count(cfg)
    tokens = batch * seq
    scan = 4.0 * tokens * cfg.ssm_heads * (cfg.ssm_d_inner // cfg.ssm_heads) \
        * cfg.ssm_state
    saved = 2.0 * tokens * cfg.d_model * (cfg.num_layers + 24) \
        + 3 * 4.0 * tokens * cfg.vocab_size
    return (16.0 * params + saved + 7 * scan) / 2 ** 30


def param_count(cfg) -> int:
    return build_model(cfg, device="meta").param_count()


def train_data(cfg) -> SyntheticLM:
    """The batches ``launch.train`` gives ``cfg`` at ``TRAIN_ARGV``'s
    shape."""
    args = launch_train.parse(TRAIN_ARGV)
    return SyntheticLM(DataConfig(vocab_size=min(cfg.vocab_size, 4096)),
                       cfg, ShapeConfig("cli", args.seq, args.batch,
                                        "train"))


def plain_attention_core(q, k, v, *, causal, bq, bkv, kv_len):
    """``ops.attention_core`` on the plain version, differentiated by
    autograd (no Function, no kernel)."""
    return ref.flash_attention_ref(q, k, v, causal=causal, bq=bq, bkv=bkv,
                                   kv_len=kv_len)


def step_grads(model, batch) -> dict:
    """One step's loss backward: {name: gradient as fp32}, the parameters'
    gradients cleared after."""
    for p in model.parameters():
        p.grad = None
    loss, _ = model.loss(batch)
    loss.backward()
    out = {n: p.grad.float() for n, p in model.net.named_parameters()}
    for p in model.parameters():
        p.grad = None
    return out


def training_grad_gate(dtype: str, device="cuda") -> dict:
    """At full width and ``TRAIN_GATE_DEPTH``, in ``dtype``: one step's
    gradients on the kernels, twice (``torch.equal``), against the same
    step with ``ops.attention_core`` and ``ops.scan_core`` swapped for the
    plain versions, differentiated by autograd (no kernel launched):
    every parameter's relative L2 within ``TRAIN_GRAD_TOL``.  Returns the
    kernels' launches in the first kernel run."""
    cfg = dataclasses.replace(get_config("zamba2-1.2b"),
                              num_layers=TRAIN_GATE_DEPTH, dtype=dtype)
    model = build_model(cfg, device=device,
                        generator=torch.Generator(device).manual_seed(0))
    model.requires_grad_(True)
    batch = train_data(cfg).batch(0)
    reset_counts()
    got = step_grads(model, batch)
    torch.cuda.synchronize()
    launched = {k: v for k, v in counts().items() if v}
    t0 = time.perf_counter()
    again = step_grads(model, batch)
    torch.cuda.synchronize()
    kernel_s = time.perf_counter() - t0
    assert all(torch.equal(got[n], again[n]) for n in got), \
        "a training step's gradients differ between two runs"
    del again
    reset_counts()
    t0 = time.perf_counter()
    with Swap(ops, "attention_core", plain_attention_core), \
            Swap(ops, "scan_core", ref.mamba_scan_ref):
        want = step_grads(model, batch)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    assert not any(counts().values()), counts()
    rel = {n: float((got[n] - want[n]).norm() / want[n].norm())
           for n in got if float(want[n].norm()) > 0}
    worst = max(rel, key=rel.get)
    tol = TRAIN_GRAD_TOL[dtype]
    log(f"train {dtype} depth {TRAIN_GATE_DEPTH}: gradients on the kernels "
        f"(launches {launched}, two runs torch.equal) against the plain "
        f"versions through autograd: relative L2 median "
        f"{statistics.median(rel.values()):.3g}, worst {rel[worst]:.3g} "
        f"({worst}) over {len(rel)} tensors; limit {tol}; loss and "
        f"backward {kernel_s * 1e3:.0f} ms on the kernels, "
        f"{plain_s * 1e3:.0f} ms on the plain versions")
    assert all(torch.isfinite(g).all() for g in got.values())
    assert rel[worst] <= tol, (worst, rel[worst])
    del model, got, want
    torch.cuda.empty_cache()
    return launched


def training_checkpoint_gate(device="cuda") -> None:
    """At full width and ``TRAIN_GATE_DEPTH``, bf16, through
    ``launch.train``'s save and ``--resume auto``: two steps straight
    against one step, a checkpoint, a new run resumed from it and one
    more step: every parameter and optimizer tensor ``torch.equal``."""
    cfg = dataclasses.replace(get_config("zamba2-1.2b"),
                              num_layers=TRAIN_GATE_DEPTH)
    base = TRAIN_ARGV + ["--steps", "2", "--device", device]
    straight = launch_train.Run(launch_train.parse(base), cfg)
    straight.train()
    want = {"params": dict(straight.model.net.named_parameters()),
            **{k: straight.opt_state[k] for k in ("master", "mu", "nu")}}
    with tempfile.TemporaryDirectory() as ckdir:
        argv = base + ["--ckpt-dir", ckdir, "--resume", "auto"]
        first = launch_train.Run(launch_train.parse(argv), cfg)
        first.step_fn(first.opt_state, first.data.batch(0))
        t0 = time.perf_counter()
        first.save(1)
        saved_s = time.perf_counter() - t0
        del first
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        resumed = launch_train.Run(launch_train.parse(argv), cfg)
        restored_s = time.perf_counter() - t0
        assert resumed.start == 1 and resumed.opt_state["step"] == 1
        resumed.train()
        size = sum(os.path.getsize(os.path.join(r, f))
                   for r, _, fs in os.walk(ckdir) for f in fs)
    got = {"params": dict(resumed.model.net.named_parameters()),
           **{k: resumed.opt_state[k] for k in ("master", "mu", "nu")}}
    for part in want:
        for n in want[part]:
            assert torch.equal(got[part][n], want[part][n]), (part, n)
    log(f"train checkpoint: 2 steps straight == 1 step, save ({saved_s:.1f}"
        f" s), resume ({restored_s:.1f} s, a new run), 1 step: every "
        f"parameter and optimizer tensor torch.equal; {size / 2 ** 30:.2f} "
        f"GiB on disk")
    del straight, resumed, want, got
    torch.cuda.empty_cache()


def device_idle_share(run, step: int) -> tuple[float, float]:
    """One more step of ``run`` traced by ``torch.profiler``: (its wall
    seconds, the share of them in which no kernel ran on the card); the
    operators that took the most device time are logged."""
    from torch.profiler import ProfilerActivity, profile
    batch = run.data.batch(step)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run.step_fn(run.opt_state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    table = prof.key_averages().table(sort_by="self_device_time_total",
                                      row_limit=20)
    log("train: a step's operators by device time")
    for line in table.splitlines():
        log("  " + line)
    return wall, 1.0 - busy_seconds(prof) / wall


def busy_seconds(prof) -> float:
    """Seconds in which some kernel ran on the card in a ``torch.profiler``
    trace: the union of the kernels' spans."""
    cuda = torch.autograd.DeviceType.CUDA
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == cuda)
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy * 1e-6


def training_phase(device="cuda") -> tuple[dict, dict]:
    """Phase 11; returns the kernels' launches in the main run (30 steps)
    and in the fp32 gradient gate's first kernel run."""
    stage("phase 11: training zamba2-1.2b at full width and depth")
    args = launch_train.parse(TRAIN_ARGV + ["--device", device])
    cfg = get_config(args.arch)
    log(f"train: {param_count(cfg) / 1e9:.3f} B parameters, batch "
        f"{args.batch} x seq {args.seq}; reckoned peak "
        f"{reckon_training_memory(cfg, args.batch, args.seq):.1f} GiB")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    run = launch_train.Run(args)
    losses, times = [], []
    last = [None, {k: 0 for k in counts()}]
    a_step = train_launches(run.cfg, 1)

    def on_step(step, metrics):
        torch.cuda.synchronize()
        now = time.perf_counter()
        times.append(now - last[0])
        now_counts = counts()
        step_counts = {k: v - last[1][k] for k, v in now_counts.items()}
        assert step_counts == a_step, (step, step_counts, a_step)
        last[0], last[1] = now, now_counts
        losses.append(float(metrics["loss"]))

    reset_counts()
    torch.cuda.synchronize()
    last[0] = time.perf_counter()
    run.train(on_step)
    torch.cuda.synchronize()
    launched = counts()
    expect = train_launches(run.cfg, args.steps)
    log(f"train: launches {launched}, each step's exactly "
        f"{ {k: v for k, v in a_step.items() if v} }")
    assert launched == expect, (launched, expect)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    first, last5 = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    assert all(map(lambda x: x == x and abs(x) != float("inf"), losses)), \
        losses
    steady = statistics.median(times[2:])
    tokens = args.batch * args.seq
    log(f"train: losses {[round(x, 4) for x in losses]}")
    log(f"train: mean loss of the first 5 steps {first:.4f}, of the last 5 "
        f"{last5:.4f} (drop {first - last5:.4f}, at least 0.2 required); "
        f"first step {times[0] * 1e3:.1f} ms, then median "
        f"{steady * 1e3:.1f} ms a step [{min(times[2:]) * 1e3:.1f}.."
        f"{max(times[2:]) * 1e3:.1f}], {tokens / steady:.0f} tokens/s; peak "
        f"{peak:.2f} GiB allocated")
    assert last5 < first - 0.2, (first, last5)
    wall, idle = device_idle_share(run, args.steps)
    log(f"train: a traced step {wall * 1e3:.1f} ms, device idle share "
        f"{idle:.3f}")
    del run
    torch.cuda.empty_cache()
    stage("phase 11: gradients against the plain versions, depth 7")
    training_grad_gate("bfloat16", device)
    f32 = training_grad_gate("float32", device)
    stage("phase 11: checkpoint and resume, depth 7")
    training_checkpoint_gate(device)
    return launched, f32


# ---------------------------------------------------------------------------
# phase 14: training on a mesh of ranks sharing the card
# ---------------------------------------------------------------------------

#: phase 14's run: ``launch.train`` with phase 11's flags at a global batch
#: of 4 x 1024 (each data replica of (2, 2) at phase 11's 2 x 1024), 2
#: steps, in fp32, at ``TRAIN_GATE_DEPTH``
MESH_TRAIN_ARGV = ["--arch", "zamba2-1.2b", "--batch", "4", "--seq", "1024",
                   "--lr", "1e-3", "--steps", "2", "--log-every", "1"]
#: the two meshes of 4 ranks: each data replica at phase 11's batch, and
#: the one ``make_host_mesh`` gives 4 ranks
MESH_TRAIN_SHAPES = ((2, 2), (1, 4))
#: the fp32 losses of the mesh run against one process's, relative
MESH_LOSS_RTOL = 1e-4


def mesh_train_cfg(dtype: str):
    return dataclasses.replace(get_config("zamba2-1.2b"),
                               num_layers=TRAIN_GATE_DEPTH, dtype=dtype)


def mesh_train_args(device: str, *extra):
    return launch_train.parse(MESH_TRAIN_ARGV + ["--device", device,
                                                 *extra])


def mesh_train_data(cfg) -> SyntheticLM:
    """The batches ``launch.train`` gives ``cfg`` at ``MESH_TRAIN_ARGV``."""
    args = mesh_train_args("cpu")
    return SyntheticLM(DataConfig(vocab_size=min(cfg.vocab_size, 4096)),
                       cfg, ShapeConfig("cli", args.seq, args.batch,
                                        "train"))


def sync(device: str) -> None:
    if device != "cpu":
        torch.cuda.synchronize()


def peak_gib(device: str) -> float:
    return (torch.cuda.max_memory_allocated() / 2 ** 30 if device != "cpu"
            else 0.0)


def reset_peak(device: str) -> None:
    if device != "cpu":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def leaves(tree, prefix: str = ""):
    """(``/``-joined path, leaf) of a checkpoint tree, as the checkpoint
    manager keys its arrays."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield prefix, tree
        return
    for key, val in items:
        yield from leaves(val, f"{prefix}/{key}" if prefix else str(key))


def equals_saved(tree, ckpt_dir: str, step: int) -> int:
    """How many arrays of ``tree`` (a ``state_tree``) are torch.equal to
    the checkpoint ``step`` in ``ckpt_dir``; raises on one that is not."""
    import numpy as np
    path = os.path.join(ckpt_dir, f"step_{step:08d}", "arrays.npz")
    n = 0
    with np.load(path) as saved:
        for key, leaf in leaves(tree):
            want = torch.from_numpy(saved[key])
            got = torch.as_tensor(leaf)
            assert torch.equal(got.to(want.dtype), want), key
            n += 1
        assert n == len(saved.files), (n, len(saved.files))
    return n


def mesh_step_grads(model, batch, mesh) -> dict:
    """One step's loss backward on ``mesh``: {name: the whole gradient in
    fp32} (gathered; every rank calls this)."""
    from repro_torch.train.trainer import place_batch
    for p in model.parameters():
        p.grad = None
    loss, _ = model.loss(place_batch(batch, mesh))
    loss.backward()
    out = {n: p.grad.full_tensor().float()
           for n, p in model.net.named_parameters()}
    for p in model.parameters():
        p.grad = None
    return out


def rel_l2(got: dict, want: dict) -> dict:
    return {n: float((got[n] - want[n]).norm() / want[n].norm())
            for n in got if float(want[n].norm()) > 0}


def mesh_train_rank(rank: int, n: int, shape, ref: dict, ckpt_dir: str,
                    resume_dir: str | None, device: str) -> dict:
    """What each rank of phase 14 runs on a ``shape`` mesh of the ranks:
    the transport's floor; one step's gradients in bf16 held to ``ref``'s
    (one process's, mapped from the parent); then ``launch.train.Run``'s
    2 fp32 steps on the mesh (the main path; the first step's gradients,
    gathered as the optimizer receives them, held to ``ref``'s fp32
    ones), launches counted by step, saving to ``ckpt_dir``; with
    ``resume_dir``, a run resumed from the checkpoint another mesh saved
    there, its state gathered and held to the file."""
    from repro_torch.train.trainer import place, state_tree
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    amesh = abstract_mesh(shape, ("data", "model"))
    dmesh = launch_device_mesh(amesh, device)
    out = {"floor": transport_floor(device), "grads": {}}
    cfg = mesh_train_cfg("bfloat16")
    model = build_model(cfg, device=device, generator=torch.Generator(
        device).manual_seed(0))
    place(model, dmesh)
    model.requires_grad_(True)
    got = mesh_step_grads(model, mesh_train_data(cfg).batch(0), dmesh)
    assert all(torch.isfinite(g).all() for g in got.values())
    out["grads"]["bfloat16"] = rel_l2(got, ref["grads"]["bfloat16"])
    out["bf16_to_f32"] = rel_l2(got, ref["grads"]["float32"])
    del model, got
    reset_peak(device)

    # the main path; its first step's gradients (every rank gathers them
    # as the optimizer receives them) are the fp32 gradient gate's
    cfg = mesh_train_cfg("float32")
    run = launch_train.Run(mesh_train_args(device, "--ckpt-dir", ckpt_dir),
                           cfg, mesh=amesh)
    first = {}

    def capture(opt_cfg, params, grads, state):
        if not first:
            first.update({n: g.full_tensor().float()
                          for n, g in grads.items()})
        return real_update(opt_cfg, params, grads, state)
    real_update = optlib.update
    a_step = train_launches(cfg, 1)
    times, coll_s, coll_n, losses = [], [], [], []
    last = [None, {k: 0 for k in counts()}, 0.0, 0]

    def on_step(step, metrics):
        sync(device)
        now = time.perf_counter()
        c = counts()
        step_counts = {k: v - last[1][k] for k, v in c.items()}
        assert step_counts == a_step, (rank, step, step_counts, a_step)
        cs, cn = dist_ranks.collective_seconds(), dist_ranks.collective_calls()
        times.append(now - last[0])
        coll_s.append(cs - last[2])
        coll_n.append(cn - last[3])
        last[:] = [now, c, cs, cn]
        losses.append(float(metrics["loss"]))

    reset_counts()
    sync(device)
    last[0] = time.perf_counter()
    last[2:] = [dist_ranks.collective_seconds(),
                dist_ranks.collective_calls()]
    before = dist_ranks.collective_totals()
    optlib.update = capture
    try:
        run.train(on_step)
    finally:
        optlib.update = real_update
    sync(device)
    out["grads"]["float32"] = rel_l2(first, ref["grads"]["float32"])
    del first
    by_op = {op: tuple(a - b for a, b in zip(v, before.get(op, (0, 0, 0))))
             for op, v in dist_ranks.collective_totals().items()}
    out.update(launched=counts(), losses=losses, times=times, coll_s=coll_s,
               coll_n=coll_n, by_op=by_op, peak_gib=peak_gib(device),
               placements={n: str(tuple(p.placements)) for n, p in
                           list(run.model.net.named_parameters())[:3]})
    del run
    reset_peak(device)
    if resume_dir is not None:
        resumed = launch_train.Run(mesh_train_args(
            device, "--ckpt-dir", resume_dir, "--resume", "auto"), cfg,
            mesh=amesh)
        tree = state_tree(resumed.model, resumed.opt_state)
        out["resumed"] = (resumed.start, equals_saved(tree, resume_dir,
                                                      resumed.start))
        del resumed, tree
    return out


def transport_floor(device: str, reps: int = 3) -> dict:
    """ms of one all-gather into a tensor and one all-reduce over every
    rank, by MiB a rank, with the ranks otherwise idle: the transport's
    floor, which every collective of the step pays."""
    import torch.distributed as tdist
    out = {}
    for mib in (1, 64):
        x = torch.ones(mib << 18, device=device)
        g = torch.empty(x.numel() * tdist.get_world_size(), device=device)
        for name, fn in (("all_gather", lambda: tdist.all_gather_into_tensor(
                g, x)), ("all_reduce", lambda: tdist.all_reduce(x))):
            fn()
            sync(device)
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            sync(device)
            out[f"{name} {mib} MiB"] = (time.perf_counter() - t0) / reps * 1e3
    return out


def mesh_reference(device: str) -> dict:
    """Phase 14's one process without a mesh: one step's gradients in bf16
    and fp32 (kept on the card, mapped into the ranks) and ``Run``'s 2 fp32
    steps (losses, ms a step, peak GiB)."""
    ref = {"grads": {}}
    for dtype in ("bfloat16", "float32"):
        cfg = mesh_train_cfg(dtype)
        model = build_model(cfg, device=device, generator=torch.Generator(
            device).manual_seed(0))
        model.requires_grad_(True)
        ref["grads"][dtype] = step_grads(model, mesh_train_data(cfg).batch(0))
        del model
    reset_peak(device)
    ref["bf16_to_f32"] = rel_l2(ref["grads"]["bfloat16"],
                                ref["grads"]["float32"])
    run = launch_train.Run(mesh_train_args(device), mesh_train_cfg("float32"))
    times, losses, last = [], [], [None]

    def on_step(step, metrics):
        sync(device)
        now = time.perf_counter()
        times.append(now - last[0])
        last[0] = now
        losses.append(float(metrics["loss"]))
    sync(device)
    last[0] = time.perf_counter()
    run.train(on_step)
    ref.update(losses=losses, times=times, peak_gib=peak_gib(device))
    del run
    reset_peak(device)
    return ref


def check_mesh_run(shape, results: list, ref: dict, cfg, n_steps: int,
                   name_limit: str) -> None:
    """Phase 14's gates on one mesh's ranks: (b) the gradients, (c) the
    losses, (d) the launches; then (f) the logs."""
    log(f"mesh {shape}: transport floor on 4 ranks, ms "
        f"{ {k: round(v, 2) for k, v in results[0]['floor'].items()} }")
    tol = TRAIN_GRAD_TOL["float32"]
    worst = [max(r["grads"]["float32"].items(), key=lambda kv: kv[1])
             for r in results]
    log(f"mesh {shape}: fp32 gradients of one step, gathered, against one "
        f"process without a mesh: relative L2 median "
        f"{statistics.median(results[0]['grads']['float32'].values()):.3g}, "
        f"worst by rank {[f'{w[1]:.3g} ({w[0]})' for w in worst]}; limit "
        f"{tol}")
    assert all(w[1] <= tol for w in worst), (shape, worst)
    # bf16: the mesh's gradients as close to the fp32 ones as one
    # process's bf16 gradients are (median and worst tensor), within
    # TRAIN_GRAD_TOL.  Held to one process's bf16 gradients directly they
    # differ by about bf16's own distance from fp32: two bf16 steps that
    # sum in other orders (the mesh's partial sums are rounded to bf16
    # before their reduction) part as far at this depth
    tol = TRAIN_GRAD_TOL["bfloat16"]
    one = ref["bf16_to_f32"]
    for rank, r in enumerate(results):
        mesh_ = r["bf16_to_f32"]
        got = (statistics.median(mesh_.values()), max(mesh_.values()))
        want = (statistics.median(one.values()), max(one.values()))
        if rank == 0:
            direct = r["grads"]["bfloat16"]
            log(f"mesh {shape}: bf16 gradients against one process's fp32 "
                f"ones, relative L2 median (worst tensor): the mesh "
                f"{got[0]:.3g} ({got[1]:.3g}), one process {want[0]:.3g} "
                f"({want[1]:.3g}); limit one process's + {tol}. Against one "
                f"process's bf16 ones: median "
                f"{statistics.median(direct.values()):.3g}, worst "
                f"{max(direct.values()):.3g} "
                f"({max(direct, key=direct.get)})")
        assert got[0] <= want[0] + tol and got[1] <= want[1] + tol, \
            (shape, rank, got, want)
    losses = results[0]["losses"]
    assert all(r["losses"] == losses for r in results), \
        [r["losses"] for r in results]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])]
    log(f"mesh {shape}: fp32 losses {[round(x, 5) for x in losses]} (one "
        f"process: {[round(x, 5) for x in ref['losses']]}), relative "
        f"{[f'{x:.2g}' for x in rel]}; limit {MESH_LOSS_RTOL}")
    assert len(losses) == n_steps and max(rel) <= MESH_LOSS_RTOL, rel
    assert losses[-1] < losses[0], losses
    want = train_launches(cfg, n_steps)
    for rank, r in enumerate(results):
        assert r["launched"] == want, (shape, rank, r["launched"], want)
    r0 = results[0]
    steady = statistics.median(r0["times"][1:])
    share = sum(r0["coll_s"][1:]) / sum(r0["times"][1:])
    log(f"mesh {shape}: launches on each rank "
        f"{ {k: v for k, v in want.items() if v} } ({n_steps} steps, as "
        f"train_launches says for one process), each step's exactly; "
        f"placements {r0['placements']}")
    log(f"mesh {shape}: rank 0's collectives over the {n_steps} steps by op "
        f"(calls, s, MiB): "
        f"{ {op: (c, round(t, 2), round(b / 2**20, 1)) for op, (c, t, b) in sorted(r0['by_op'].items())} }")
    log(f"mesh {shape}: rank 0 ms a step {[round(t * 1e3, 1) for t in r0['times']]}"
        f" (median after the first {steady * 1e3:.1f}; one process "
        f"{statistics.median(ref['times'][1:]) * 1e3:.1f}), collectives "
        f"{r0['coll_n']} a step, {100 * share:.1f}% of the step; peak card "
        f"memory by rank {[round(r['peak_gib'], 2) for r in results]} GiB "
        f"(one process {ref['peak_gib']:.2f}); {name_limit}")


def mesh_training_phase(name_limit: str, device: str = "cuda") -> None:
    """Phase 14: ``launch.train`` on 4 ranks sharing the card over
    ``dist.ranks.HOST_STAGED``, on the (2, 2) and (1, 4) meshes, held to
    one process without a mesh; a checkpoint saved on (2, 2) restored on
    (1, 4) and in one process."""
    stage("phase 14: training on a mesh of 4 ranks sharing the card")
    cfg = mesh_train_cfg("float32")
    n_steps = mesh_train_args(device).steps
    t0 = time.perf_counter()
    ref = mesh_reference(device)
    log(f"mesh: one process, zamba2-1.2b at full width and depth "
        f"{TRAIN_GATE_DEPTH} ({param_count(cfg) / 1e6:.1f} M parameters), "
        f"batch 4 x 1024: gradients in bf16 and fp32 and {n_steps} fp32 "
        f"steps in {time.perf_counter() - t0:.1f} s, ms a step "
        f"{[round(t * 1e3, 1) for t in ref['times']]}, peak "
        f"{ref['peak_gib']:.2f} GiB")
    with tempfile.TemporaryDirectory() as tmp:
        dirs = {s: os.path.join(tmp, f"ckpt_{s[0]}x{s[1]}")
                for s in MESH_TRAIN_SHAPES}
        saved_by = MESH_TRAIN_SHAPES[0]
        for shape in MESH_TRAIN_SHAPES:
            t0 = time.perf_counter()
            results = dist_ranks.spawn(
                mesh_train_rank, 4, tmp,
                args=(shape, ref, dirs[shape],
                      None if shape == saved_by else dirs[saved_by], device),
                device=device, timeout_s=RANK_TIMEOUT_S,
                deadline_s=RANK_DEADLINE_S, backend=dist_ranks.HOST_STAGED)
            log(f"mesh {shape}: 4 ranks spawned, ran and joined in "
                f"{time.perf_counter() - t0:.1f} s")
            check_mesh_run(shape, results, ref, cfg, n_steps, name_limit)
            if shape != saved_by:
                resumed = [r["resumed"] for r in results]
                arrays = resumed[0][1]
                assert resumed == [(n_steps, arrays)] * 4, resumed
        one = launch_train.Run(mesh_train_args(
            device, "--ckpt-dir", dirs[saved_by], "--resume", "auto"), cfg)
        from repro_torch.train.trainer import state_tree
        assert one.start == n_steps
        assert equals_saved(state_tree(one.model, one.opt_state),
                            dirs[saved_by], n_steps) == arrays
        del one
        reset_peak(device)
    log(f"mesh: the checkpoint saved on {saved_by} (gathered, written by "
        f"rank 0) restored on {MESH_TRAIN_SHAPES[1]} and in one process: "
        f"all {arrays} arrays torch.equal to the file")


# ---------------------------------------------------------------------------
# phase 15: serving on a mesh of ranks sharing the card
# ---------------------------------------------------------------------------

#: phase 15's models, at full width: gemma-7b (flash_attention at prefill,
#: flash_decode a step) and zamba2-1.2b (mamba_scan and its shared
#: block's attention), each on both meshes of 4 ranks
MESH_SERVE_ARCHS = ("gemma-7b", "zamba2-1.2b")
MESH_SERVE_SHAPES = ((2, 2), (1, 4))
#: the traffic: a batch of 4 prompts of 32 tokens, a prefill and 8 greedy
#: decode steps
MESH_SERVE_BATCH, MESH_SERVE_PROMPT, MESH_SERVE_STEPS = 4, 32, 8
#: the fp32 gate's depth (zamba2 at 7: one application of its shared
#: block and a tail block, as phase 10's decode gate cuts it)
MESH_SERVE_DEPTH = {"gemma-7b": 2, "zamba2-1.2b": 7}
#: a row's relative L2 distance from one process's logits: bf16 at full
#: depth (the zoo's gate), fp32 at ``MESH_SERVE_DEPTH``
MESH_SERVE_TOL = {"bfloat16": ZOO_LOGITS_TOL, "float32": 1e-4}
#: the models whose bf16 gate is held against one process's fp32 logits
#: at full depth (fed the same tokens): the mesh's bf16 logits as close
#: to them as one process's bf16 logits are, plus ``MESH_SERVE_TOL``.
#: zamba2-1.2b's bf16 logits sit ~5% from one process's bf16 logits on
#: a mesh, about as far as bf16 sits from fp32 at its depth (phase 14
#: finds the same of its gradients); gemma-7b in fp32 at full depth (34 GB)
#: fits beside nothing else, and its direct gate holds
MESH_SERVE_F32_REF = ("zamba2-1.2b",)


def mesh_serve_cfg(arch: str, dtype: str):
    cfg = dataclasses.replace(get_config(arch), dtype=dtype)
    if dtype == "float32":
        cfg = dataclasses.replace(cfg, num_layers=MESH_SERVE_DEPTH[arch])
    return cfg


def mesh_serve_steps(model, prompts, forced=None, on_step=None) -> dict:
    """The user's serving calls: ``Model.prefill``, the cache padded by
    ``serve.expand_cache``, then ``MESH_SERVE_STEPS`` decode steps, each
    fed the last step's greedy token (or ``forced``'s: one process's
    tokens, so that a bf16 run's logits stay comparable after a token
    that rounds the other way).  Returns each step's logits (gathered,
    fp32, on the host) and the greedy tokens; ``on_step(i)`` runs after
    each decode step's logits are back."""
    b, p = prompts.shape
    logits, cache = model.prefill(prompts)
    cache = expand_cache(model, cache, b, p + MESH_SERVE_STEPS + 1)
    out, tokens = [], []

    def keep(lg):
        lg = lg.full_tensor() if hasattr(lg, "full_tensor") else lg
        lg = lg.float()
        out.append(lg.cpu())
        tokens.append(lg.argmax(-1).cpu())
    keep(logits)
    pos = torch.full((b,), p, dtype=torch.int32, device=model.device)
    for i in range(MESH_SERVE_STEPS):
        tok = tokens[-1] if forced is None else forced[i]
        logits, cache = model.decode_step(
            tok.to(model.device)[:, None], cache, pos)
        keep(logits)
        pos = pos + 1
        if on_step is not None:
            on_step(i)
    return {"logits": torch.stack(out), "tokens": torch.stack(tokens)}


def mesh_serve_reference(device: str) -> dict:
    """Phase 15's one process: every (arch, dtype) served without a mesh,
    its weights kept on the card (mapped into the ranks by CUDA IPC), its
    logits and tokens on the host.  By (arch, dtype)."""
    import numpy as np
    out = {}
    for arch in MESH_SERVE_ARCHS:
        for dtype in ("bfloat16", "float32"):
            cfg = mesh_serve_cfg(arch, dtype)
            model = build_model(cfg, device=device, generator=torch.Generator(
                device).manual_seed(0))
            prompts = np.random.default_rng(0).integers(
                0, cfg.vocab_size, (MESH_SERVE_BATCH, MESH_SERVE_PROMPT))
            reset_peak(device)
            sync(device)
            t0 = time.perf_counter()
            got = mesh_serve_steps(model, prompts)
            sync(device)
            got.update(prompts=prompts, seconds=time.perf_counter() - t0,
                       peak_gib=peak_gib(device), values=dict(
                           model.net.named_parameters()))
            out[(arch, dtype)] = got
            del model
        if arch in MESH_SERVE_F32_REF:
            one = out[(arch, "bfloat16")]
            cfg = dataclasses.replace(get_config(arch), dtype="float32")
            model = build_model(cfg, device=device, generator=torch.Generator(
                device).manual_seed(0))
            one["f32_logits"] = mesh_serve_steps(
                model, one["prompts"], forced=one["tokens"])["logits"]
            one["f32_rel"] = max(_rel(a, b) for a, b in zip(
                one["logits"], one["f32_logits"]))
            del model
            reset_peak(device)
    return out


def mesh_serve_rank(rank: int, n: int, shape, ref: dict,
                    device: str) -> dict:
    """What each rank of phase 15 runs on a ``shape`` mesh of the ranks:
    for every (arch, dtype) of ``ref``, a model built on ``meta`` and
    placed by the inference rules from one process's weights (each rank
    takes its shards of them), served by ``mesh_serve_steps``: bf16
    teacher-forced by one process's tokens, fp32 on its own greedy
    tokens; launches counted; rank 0's first flash_decode call captured
    for the kernel check, its decode steps timed with their
    collectives."""
    from repro_torch.train.trainer import place
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dmesh = launch_device_mesh(abstract_mesh(shape, ("data", "model")),
                               device)
    out = {}
    for (arch, dtype), one in ref.items():
        cfg = mesh_serve_cfg(arch, dtype)
        model = build_model(cfg, device="meta")
        place(model, dmesh, inference=True, values=one["values"])
        captured = []
        real = fa.flash_decode

        def capture(q, k, v, lengths, **kw):
            o = real(q, k, v, lengths, **kw)
            if not captured:
                captured.append(((q.clone(), k.clone(), v.clone(),
                                  lengths.clone()), kw, o.clone()))
            return o
        times, coll = [], []
        last = [0.0, dist_ranks.collective_totals()]

        def on_step(i):
            sync(device)
            now = time.perf_counter()
            totals = dist_ranks.collective_totals()
            times.append(now - last[0])
            coll.append({op: tuple(a - b for a, b in zip(
                v, last[1].get(op, (0, 0, 0)))) for op, v in totals.items()})
            last[:] = [time.perf_counter(), dist_ranks.collective_totals()]
        reset_counts()
        reset_peak(device)
        sync(device)
        last[0] = time.perf_counter()
        fa.flash_decode = capture
        try:
            got = mesh_serve_steps(
                model, one["prompts"],
                forced=one["tokens"] if dtype == "bfloat16" else None,
                on_step=on_step)
        finally:
            fa.flash_decode = real
        sync(device)
        launched = counts()
        want = one["logits"]
        rel = max(_rel(g, w) for g, w in zip(got["logits"], want))
        rec = {"launched": launched, "rel": rel,
               "f32_rel": None if "f32_logits" not in one else max(
                   _rel(g, w) for g, w in zip(got["logits"],
                                              one["f32_logits"])),
               "tokens_equal": bool(torch.equal(got["tokens"],
                                                one["tokens"])),
               "finite": bool(torch.isfinite(got["logits"]).all()),
               "times": times[1:], "coll": coll[1:],
               "peak_gib": peak_gib(device),
               "placements": {n: str(tuple(p.placements)) for n, p in list(
                   model.net.named_parameters())[:3]}}
        if rank == 0 and captured:
            (q, k, v, lens), kw, o = captured[0]
            plain = ref_flash_decode(q, k, v, lens, **kw)
            rec["kernel"] = (tuple(q.shape), tuple(k.shape), float(
                (o.float() - plain.float()).abs().max()), float(
                plain.float().pow(2).mean().sqrt()))
        out[(arch, dtype)] = rec
        del model, captured
        reset_peak(device)
    return out


def ref_flash_decode(q, k, v, lengths, **kw):
    return ref.flash_decode_ref(q, k, v, lengths, **kw)


def check_mesh_serve(shape, results: list, ref: dict,
                     name_limit: str) -> None:
    """Phase 15's gates on one mesh's ranks: logits, tokens, launches, the
    kernel on rank 0's shard; then the logs."""
    for (arch, dtype), one in ref.items():
        cfg = mesh_serve_cfg(arch, dtype)
        tol = MESH_SERVE_TOL[dtype]
        pre, step = zoo_launches(cfg)
        want = {k: pre.get(k, 0) + step.get(k, 0) * MESH_SERVE_STEPS
                for k in counts()}
        recs = [r[(arch, dtype)] for r in results]
        rels = [r["rel"] for r in recs]
        log(f"mesh serve {shape} {arch} {dtype} depth {cfg.num_layers}: "
            f"logits of the prefill and {MESH_SERVE_STEPS} steps (gathered "
            f"on every rank) against one process's, a row's relative L2 at "
            f"most {[f'{x:.3g}' for x in rels]} by rank (limit {tol}); "
            f"{'fed one process tokens' if dtype == 'bfloat16' else 'greedy'}"
            f", own tokens equal one process's on every rank: "
            f"{[r['tokens_equal'] for r in recs]}")
        assert all(r["finite"] for r in recs), (shape, arch, dtype)
        if "f32_rel" in one:
            f32 = [r["f32_rel"] for r in recs]
            log(f"mesh serve {shape} {arch} bfloat16: against one process's "
                f"fp32 logits at full depth (fed the same tokens): the mesh "
                f"{[f'{x:.3g}' for x in f32]} by rank, one process's bf16 "
                f"{one['f32_rel']:.3g}; limit one process's + {tol}")
            assert max(f32) <= one["f32_rel"] + tol, (shape, arch, f32,
                                                      one["f32_rel"])
        else:
            assert max(rels) <= tol, (shape, arch, dtype, rels)
        if dtype == "float32":
            assert all(r["tokens_equal"] for r in recs), (shape, arch)
        for rank, r in enumerate(recs):
            assert r["launched"] == want, (shape, arch, dtype, rank,
                                           r["launched"], want)
        log(f"mesh serve {shape} {arch} {dtype}: launches on each rank "
            f"{ {k: v for k, v in want.items() if v} } (one process's "
            f"count, each on the rank's local shard); placements "
            f"{recs[0]['placements']}")
        if "kernel" in recs[0]:
            qs, ks, err, rms = recs[0]["kernel"]
            kdtype = "bfloat16" if dtype == "bfloat16" else "float32"
            ktol = ZOO_ATTN_TOL if kdtype == "bfloat16" else 1e-4
            log(f"mesh serve {shape} {arch} {dtype}: rank 0's first "
                f"flash_decode on its local shard q {qs} k {ks}: max |err| "
                f"{err:.3g} against its plain version (tolerance {ktol}), "
                f"output RMS {rms:.3f}")
            assert err <= ktol, (shape, arch, dtype, err)
        if dtype != "bfloat16":
            continue
        r0 = recs[0]
        steady = statistics.median(r0["times"])
        calls = statistics.median(sum(c for c, _, _ in st.values())
                                  for st in r0["coll"])
        nbytes = statistics.median(sum(b for _, _, b in st.values())
                                   for st in r0["coll"])
        secs = statistics.median(sum(t for _, t, _ in st.values())
                                 for st in r0["coll"])
        log(f"mesh serve {shape} {arch}: rank 0 decode {steady * 1e3:.1f} ms"
            f" a step (median of {len(r0['times'])} after the first; one "
            f"process {one['seconds'] / (MESH_SERVE_STEPS + 1) * 1e3:.1f} ms"
            f" a call, prefill included), collectives {calls:.0f} a step, "
            f"{nbytes / 2**20:.2f} MiB of tensors, {1e3 * secs:.1f} ms "
            f"({100 * secs / steady:.1f}% of the step); peak card memory by "
            f"rank {[round(r['peak_gib'], 2) for r in recs]} GiB (one "
            f"process {one['peak_gib']:.2f}); {name_limit}")


def mesh_serve_phase(name_limit: str, device: str = "cuda") -> None:
    """Phase 15: ``Model.prefill`` and ``Model.decode_step`` on 4 ranks
    sharing the card over ``dist.ranks.HOST_STAGED``, on the (2, 2) and
    (1, 4) meshes, held to one process without a mesh."""
    stage("phase 15: serving on a mesh of 4 ranks sharing the card")
    t0 = time.perf_counter()
    ref = mesh_serve_reference(device)
    log(f"mesh serve: one process, {', '.join(MESH_SERVE_ARCHS)} at full "
        f"width (bf16 at full depth, fp32 at depth "
        f"{MESH_SERVE_DEPTH}), {MESH_SERVE_BATCH} x {MESH_SERVE_PROMPT} "
        f"prompts and {MESH_SERVE_STEPS} decode steps, in "
        f"{time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        for shape in MESH_SERVE_SHAPES:
            t0 = time.perf_counter()
            results = dist_ranks.spawn(
                mesh_serve_rank, 4, tmp, args=(shape, ref, device),
                device=device, timeout_s=RANK_TIMEOUT_S,
                deadline_s=RANK_DEADLINE_S, backend=dist_ranks.HOST_STAGED)
            log(f"mesh serve {shape}: 4 ranks spawned, served and joined "
                f"in {time.perf_counter() - t0:.1f} s")
            check_mesh_serve(shape, results, ref, name_limit)
    del ref
    reset_peak(device)


# ---------------------------------------------------------------------------
# phase 12: the examples, the planning example's backend check, the dry run
# ---------------------------------------------------------------------------

def example(name: str):
    """``examples/<name>.py`` loaded as a module."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def launched_line(name: str) -> dict:
    """The kernels launched since the counts were set to 0, logged."""
    launched = counts()
    log(f"{name}: launches { {k: v for k, v in launched.items() if v} }")
    return launched


def quickstart_example() -> dict:
    reset_counts()
    out = example("torch_quickstart").main([])
    launched = launched_line("torch_quickstart")
    assert max(out["errs"].values()) < 1e-3, out["errs"]
    assert launched["nest_gemm"] > 0 and \
        sum(launched.values()) == launched["nest_gemm"], launched
    return launched


def serve_example() -> dict:
    """On ``cuda`` (fused_chain, flash_decode and nest_gemm launched),
    then on the interpreter on the card (no kernel): the per-request
    checksums bit-equal."""
    mod = example("torch_serve_lm")
    reset_counts()
    cuda = mod.main([])
    launched = launched_line("torch_serve_lm")
    assert all(launched[k] > 0 for k in ("fused_chain", "flash_decode",
                                         "nest_gemm")), launched
    reset_counts()
    interp = mod.main(["--backend", "interpreter"])
    assert sum(counts().values()) == 0, counts()
    assert cuda["checksums"] == interp["checksums"], (cuda, interp)
    log(f"torch_serve_lm: {len(cuda['checksums'])} requests, checksums "
        f"bit-equal between cuda ({cuda['summary']['wall_s']:.2f} s) and "
        f"the interpreter ({interp['summary']['wall_s']:.2f} s) on the card")
    return launched


def plan_example() -> dict:
    reset_counts()
    rows = example("torch_minisa_plan").main(
        ["--arch", "gemma-7b", "deepseek-v2-236b", "--check-backends"])
    launched = launched_line("torch_minisa_plan --check-backends")
    for arch, row in rows.items():
        log(f"torch_minisa_plan: {arch} worst |err| {row['worst_err']:.3e} "
            f"over {len(row['checked'])}/{row['n_unique']} GEMMs "
            f"(m, k, n) {row['checked']}")
        assert row["checked"], arch
    assert launched["nest_gemm"] > 0 and \
        sum(launched.values()) == launched["nest_gemm"], launched
    return launched


def train_example() -> dict:
    """20 steps, then ``--resume auto`` to 30 (the loss falling over the
    30); and, as ``--steps`` sets the schedule, a straight 30-step run
    with a checkpoint after 20, resumed from that checkpoint to 30:
    every parameter and optimizer tensor torch.equal to the straight
    run's."""
    mod = example("torch_train_lm")
    with tempfile.TemporaryDirectory() as d:
        reset_counts()
        t0 = time.perf_counter()
        first = mod.main(["--steps", "20", "--ckpt-dir", f"{d}/a"])
        again = mod.main(["--steps", "30", "--ckpt-dir", f"{d}/a"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = launched_line("torch_train_lm")
        layers = first["run"].cfg.num_layers
        expect = {k: 0 for k in launched}
        expect.update(flash_attention=2 * layers * 30,
                      flash_attention_bwd=layers * 30)
        assert launched == expect, (launched, expect)
        assert again["start"] == 20, again["start"]
        losses = first["losses"] + again["losses"]
        assert len(losses) == 30 and all(
            x == x and abs(x) != float("inf") for x in losses), losses
        head, tail = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
        log(f"torch_train_lm: 20 steps, resumed from step 20 to 30 in "
            f"{wall:.1f} s; losses {[round(x, 4) for x in losses]}; mean of "
            f"the first 5 {head:.4f}, of the last 5 {tail:.4f}")
        assert tail < head, (head, tail)
        straight = mod.main(["--steps", "30", "--ckpt-every", "20",
                             "--ckpt-dir", f"{d}/b"])
        shutil.copytree(f"{d}/b/step_00000020", f"{d}/c/step_00000020")
        resumed = mod.main(["--steps", "30", "--ckpt-dir", f"{d}/c"])
    assert resumed["start"] == 20
    assert resumed["losses"] == straight["losses"][20:]
    a, b = straight["run"], resumed["run"]
    for (n, p), (m, q) in zip(a.model.net.named_parameters(),
                              b.model.net.named_parameters()):
        assert n == m and torch.equal(p, q), n
    for k in ("master", "mu", "nu"):
        for n in a.opt_state[k]:
            assert torch.equal(a.opt_state[k][n], b.opt_state[k][n]), (k, n)
    log("torch_train_lm: a straight 30-step run and the same run resumed "
        "from its checkpoint of 20: every parameter and optimizer tensor "
        "torch.equal, the last 10 losses equal")
    del first, again, straight, resumed, a, b
    torch.cuda.empty_cache()
    return launched


#: the dry run's process: ``launch.dryrun.main`` with the arguments
#: after the output path, then proof that it left no process group and
#: never initialised CUDA
DRYRUN_CODE = """
import sys, torch, torch.distributed as dist
from repro_torch.launch import dryrun
rc = dryrun.main(["--all", "--json", sys.argv[1], *sys.argv[2:]])
assert not dist.is_initialized(), "a process group was left behind"
assert not torch.cuda.is_initialized(), "the dry run initialised CUDA"
sys.exit(rc)
"""


def start_dryruns(tmp: str) -> dict:
    """``launch.dryrun --all`` on the 16 x 16 and the 2 x 16 x 16 meshes,
    each in a process of its own started now (after phase 11, so the
    host-bound phases 10 and 11 run alone), beside phases 12, 14 and 15:
    the dry run needs no card (its traces run on ``meta`` over a fake
    process group) and takes minutes of one CPU core.  Phase 12's last
    part reads them at the end (:func:`dryrun_phase`)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH"))
        if p), CUDA_VISIBLE_DEVICES="")
    out = {}
    for name, extra in (("16x16", []), ("2x16x16", ["--multi-pod"])):
        path = os.path.join(tmp, f"dryrun_{name}.jsonl")
        logf = open(os.path.join(tmp, f"dryrun_{name}.log"), "w")
        proc = subprocess.Popen([sys.executable, "-c", DRYRUN_CODE, path,
                                 *extra], env=env, stdout=logf,
                                stderr=subprocess.STDOUT)
        out[name] = (proc, path, logf, time.perf_counter())
    return out


def stop_dryruns(runs: dict) -> None:
    for proc, _, logf, _ in runs.values():
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        logf.close()


def dryrun_phase(runs: dict) -> None:
    """The two dry runs :func:`start_dryruns` started: each exits 0 with
    32 cells OK and 8 SKIP (``long_500k`` under full attention), each
    step traced whole and partitioned over a fake process group of the
    mesh's ranks, on ``meta``, in a process that never initialised CUDA
    and left no process group behind (so no kernel launched and no card
    memory allocated).  Each cell's numbers are logged; then every dense
    prefill cell's products outside the kernel ops against
    ``core.model_gemms``."""
    for name, (proc, path, logf, t0) in runs.items():
        rc = proc.wait(timeout=1200)
        wall = time.perf_counter() - t0
        logf.flush()
        with open(path) as f:
            records = [json.loads(line) for line in f]
        ok, skip, fail = dryrun.summary(records)
        mesh = records[0]["mesh"] if records else name
        log(f"dryrun {name}: {ok} OK, {skip} SKIP, {fail} FAIL / "
            f"{len(records)} cells, exit {rc}, {wall:.1f} s in a process "
            f"of its own beside phases 12, 14 and 15 (H100 constants: "
            f"{dryrun.PEAK_FLOPS:.3g} flop/s bf16, {dryrun.HBM_BW:.3g} B/s,"
            f" links {records[0].get('link_bw') if records else None} B/s)")
        assert rc == 0, (name, rc, open(logf.name).read()[-3000:])
        for r in records:
            if r["status"] != "OK":
                log(f"  {r['arch']:>22} {r['shape']:<12} {r['status']}")
                continue
            coll = r["collective_bytes_per_device"]
            log(f"  {r['arch']:>22} {r['shape']:<12} flops "
                f"{r['flops_global']:.4e} ({r['flops_per_device']:.4e} a "
                f"device) argument/device "
                f"{r['bytes_per_device']['argument'] / 1e9:.3f} GB "
                f"collectives/device {coll['total'] / 1e9:.3f} GB t_compute "
                f"{r['t_compute']:.4e} s t_memory {r['t_memory']:.4e} s "
                f"t_collective {r['t_collective']:.4e} s {r['bottleneck']};"
                f" traced in {r['trace_s']} + {r['partitioned_trace_s']} s")
        assert (ok, skip, fail) == (32, 8, 0), (name, ok, skip, fail)
        for term in ("t_compute", "t_collective"):
            top = sorted((r for r in records if r["status"] == "OK"),
                         key=lambda r: -r[term])[:5]
            log(f"dryrun {mesh}: largest {term}: " + "; ".join(
                f"{r['arch']} {r['shape']} {r[term]:.4f} s" for r in top))
        if name != "16x16":
            continue
        for r in records:
            cfg = get_config(r["arch"])
            if r["shape"] != "prefill_32k" or cfg.family != "dense":
                continue
            want = sum(2.0 * op.gemm.m * op.gemm.k * op.gemm.n
                       * op.gemm.count
                       for op in gemm_workloads(cfg, SHAPES["prefill_32k"])
                       if not op.dynamic)
            log(f"dryrun: {r['arch']} prefill_32k products outside the "
                f"kernel ops {r['aten_dot_flops']:.6e} flops, model_gemms "
                f"(non-dynamic) {want:.6e}, ratio "
                f"{r['aten_dot_flops'] / want:.6f}")


def examples_phase() -> dict:
    """Phase 12's examples; returns each example's launches."""
    stage("phase 12: the examples on the card")
    t0 = time.perf_counter()
    out = {"torch_quickstart": quickstart_example(),
           "torch_serve_lm": serve_example(),
           "torch_minisa_plan": plan_example(),
           "torch_train_lm": train_example()}
    log(f"phase 12 examples: {time.perf_counter() - t0:.1f} s")
    return out


def main(argv) -> int:
    if argv:
        print("usage: chip_smoke.py", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name_limit = card()
    log(f"card: {name_limit}; torch {torch.__version__} CUDA "
        f"{torch.version.cuda}")
    nvcc = subprocess.run([build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    log("nvcc:", nvcc.stdout.strip().splitlines()[-1])
    with tempfile.TemporaryDirectory() as tmp:
        dryruns: dict = {}
        try:
            return run_phases(name_limit, tmp, dryruns)
        finally:
            stop_dryruns(dryruns)


def dryruns_alive() -> int:
    """Processes of this machine running :data:`DRYRUN_CODE` (read from
    ``/proc``): phases 10 and 11 run with none beside them."""
    alive = 0
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                alive += DRYRUN_CODE.encode() in f.read()
        except OSError:
            continue
    return alive


def run_phases(name_limit: str, tmp: str, dryruns: dict) -> int:
    t0 = time.perf_counter()
    info = build.build()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s "
        f"({ {n: round(i['seconds'], 1) for n, i in info.items()} })")
    for n, i in info.items():
        entry = ""
        for line in i["log"].splitlines():
            if "Compiling entry function" in line:
                # the mangled name past its anonymous namespace
                entry = line.split("'")[1].split("_cu_")[-1][8:].lstrip(
                    "0123456789")
            elif "registers" in line or "spill" in line:
                log(f"  {n} {entry}: {line.strip()}")

    # phase 2
    stage("phase 2: kernels against their plain versions")
    clocks("before phase 2")
    gen = torch.Generator(device="cuda").manual_seed(0)
    timer = Timer()
    cfg = feather_config(16, 256)
    cache = ProgramCache()
    fw_pre = ModelExecutable.for_cell("gemma-7b", "prefill_tiny", cfg,
                                      cache=cache, reduce_model=False)
    fw_dec = ModelExecutable.for_cell("gemma-7b", "decode_tiny", cfg,
                                      cache=cache, reduce_model=False)
    shapes = nest_gemm_shapes(fw_dec, fw_pre, 4)
    k1, _ = check_nest_gemm(shapes, timer, gen)
    check_rows_alone(shapes, gen)
    clocks("after nest_gemm")
    k3 = check_flash_decode(timer, gen)
    k3b = check_flash_decode_bf16("flash_decode_bf16", timer, gen)
    check_decode_f32_digests()
    rcache = ProgramCache()
    r_pre = ModelExecutable.for_cell("gemma-7b", "prefill_tiny",
                                     feather_config(4, 16), cache=rcache)
    r_dec = ModelExecutable.for_cell("gemma-7b", "decode_tiny",
                                     feather_config(4, 16), cache=rcache)
    k2 = check_fused_chain(fused_cases(r_dec, r_pre, 4), timer, gen,
                           k3["floor_ms"])
    k4 = check_flash_decode_proj(fw_dec, timer, gen)
    k5, attn = check_flash_attention(timer, gen)
    k5b = check_flash_attention_bf16(timer, gen)
    k5m = check_flash_attention_mla(timer, gen)
    k3m = check_flash_decode_bf16("flash_decode_mla", timer, gen)
    k5e = check_flash_attention_enc(timer, gen)
    k3c = check_flash_decode_bf16("flash_decode_cross", timer, gen)
    k6, scan = check_mamba_scan(timer, gen)
    k6m = check_mamba_scan(timer, gen, SCAN_MAMBA2_SHAPE, per_head=True)[0]
    torch.cuda.empty_cache()
    k5t, k5tb = check_flash_attention_bwd(timer, gen, torch.bfloat16)
    _, k5tb32 = check_flash_attention_bwd(timer, gen, torch.float32)
    k6s, k6b = check_mamba_scan_bwd(timer, gen)
    torch.cuda.empty_cache()
    clocks("after phase 2")
    del timer
    torch.cuda.empty_cache()

    # phases 3 to 8, each with the counts set to 0 just before it
    stage("phase 3: ops entry point")
    op = ops_entry_point(attn, scan)
    del attn, scan
    torch.cuda.empty_cache()
    stage("phase 4: full-width serve")
    fw, fw_sums, fw_tick_ms, fw_weights = full_width(gen)
    stage("phase 5: full-width attention projection")
    fp = attention_proj_full_width(fw_dec, gen)
    stage("phase 6: reduced serve")
    rw, untuned_sums = reduced_width()
    stage("phase 7: interpreter on the card")
    interpreter_phase(untuned_sums)
    stage("phase 8: autotune")
    autotune_phase(untuned_sums, (fw_pre, fw_dec))
    mesh = mesh_phase(gen, fw_sums, fw_tick_ms, fw_weights, untuned_sums,
                      k3["floor_ms"])
    rank_phase(fw_weights, mesh, fw_sums, name_limit)
    del fw_weights
    torch.cuda.empty_cache()
    log(f"phase 10: dry-run processes alive {dryruns_alive()}")
    zoo, zoo_by_arch = zoo_phase(name_limit)
    train, train32 = training_phase()
    log(f"phase 11 done: dry-run processes alive {dryruns_alive()}")
    assert not dryruns
    # the dry runs need no card: they run from here on beside phases 12,
    # 14 and 15, and phase 12's part reads them at the end
    dryruns.update(start_dryruns(tmp))
    log(f"dry runs started: dry-run processes alive {dryruns_alive()}")
    ex = examples_phase()
    mesh_training_phase(name_limit)
    mesh_serve_phase(name_limit)
    stage("phase 12: the dry run")
    dryrun_phase(dryruns)
    mla = zoo_by_arch["deepseek-v2-236b"]
    falcon, zamba = zoo_by_arch["falcon-mamba-7b"], zoo_by_arch["zamba2-1.2b"]

    src = "src/repro_torch/kernels/csrc/"
    rows = []
    # (name, source file, the TPU kernel, phase 2's stats, what they time,
    # launches): one row per route, each with its own path's launches
    for name, file, replaces, stats, timed, launches in (
            ("nest_gemm", "nest_gemm", "src/repro/kernels/nest_gemm.py:97",
             k1, "fp32, a full-width decode tick's 8 calls",
             fw["nest_gemm"]),
            ("flash_decode", "flash_decode",
             "src/repro/kernels/flash_attention.py:256", k3,
             f"fp32 {DECODE_CASES[0][:4]}", fw["flash_decode"]),
            ("flash_decode_bf16", "flash_decode",
             "src/repro/kernels/flash_attention.py:256", k3b,
             f"bf16 {DECODE_BF16_CASE[:4]}", zoo["flash_decode"]),
            ("fused_chain", "fused_chain",
             "src/repro/kernels/fused_chain.py:240", k2,
             "fp32, the reduced decode tick's fused segment", rw["fused_chain"]),
            ("flash_decode_proj", "flash_decode_proj",
             "src/repro/kernels/flash_attention.py:218", k4,
             "fp32, 4 full-width requests with wo", fp["flash_decode_proj"]),
            ("flash_attention", "flash_attention",
             "src/repro/kernels/flash_attention.py:99", k5,
             f"fp32 {ATTN_SHAPE}", op["flash_attention"]),
            ("flash_attention_bf16", "flash_attention",
             "src/repro/kernels/flash_attention.py:99", k5b,
             f"bf16 {ZOO_ATTN_CASE}", zoo["flash_attention"]),
            ("flash_attention_mla", "flash_attention",
             "src/repro/kernels/flash_attention.py:99", k5m,
             f"bf16 {MLA_ATTN_CASE[:3]} causal, v {MLA_ATTN_CASE[3]} wide "
             f"zero-padded", mla["flash_attention"]),
            ("flash_decode_mla", "flash_decode",
             "src/repro/kernels/flash_attention.py:256", k3m,
             f"bf16 {MLA_DECODE_CASE[:5]}", mla["flash_decode"]),
            ("flash_attention_enc", "flash_attention",
             "src/repro/kernels/flash_attention.py:99", k5e,
             f"bf16 {ENC_ATTN_CASE} full, padded to 1536",
             zoo_by_arch["whisper-base"]["flash_attention"]),
            ("flash_decode_cross", "flash_decode",
             "src/repro/kernels/flash_attention.py:256", k3c,
             f"bf16 {CROSS_DECODE_CASE}",
             zoo_by_arch["whisper-base"]["flash_decode"]),
            ("mamba_scan", "mamba_scan", "src/repro/kernels/mamba_scan.py:61",
             k6, f"fp32 {SCAN_SHAPE}",
             op["mamba_scan"] + falcon["mamba_scan"]),
            ("mamba_scan_mamba2", "mamba_scan",
             "src/repro/kernels/mamba_scan.py:61", k6m,
             f"fp32 {SCAN_MAMBA2_SHAPE}, da a head's scalar; launches: "
             f"zamba2's serve", zamba["mamba_scan"]),
            ("mamba_scan_states", "mamba_scan",
             "src/repro/kernels/mamba_scan.py:61", k6s,
             f"fp32 {TRAIN_SCAN_SHAPE}, da a head's scalar, storing the "
             f"state every {ref.SCAN_CHUNK} steps (phase 11's forward and "
             f"remat calls)", train["mamba_scan"]),
            ("flash_attention_train", "flash_attention",
             "src/repro/kernels/flash_attention.py:99", k5t,
             f"bf16 {TRAIN_ATTN_CASE} causal, with lse (phase 11's call)",
             train["flash_attention"]),
            ("flash_attention_bwd", "flash_attention_bwd",
             "src/repro/kernels/flash_attention.py:99", k5tb,
             f"bf16 {TRAIN_ATTN_CASE} causal, the gradient of "
             f"flash_attention (phase 11)", train["flash_attention_bwd"]),
            ("flash_attention_bwd_f32", "flash_attention_bwd",
             "src/repro/kernels/flash_attention.py:99", k5tb32,
             f"fp32 {TRAIN_ATTN_CASE} causal; launches: phase 11's fp32 "
             f"gradient gate", train32["flash_attention_bwd"]),
            ("mamba_scan_bwd", "mamba_scan_bwd",
             "src/repro/kernels/mamba_scan.py:61", k6b,
             f"fp32 {TRAIN_SCAN_SHAPE}, da a head's scalar, the gradient "
             f"of mamba_scan given its states (phase 11)",
             train["mamba_scan_bwd"])):
        b_ms, b_by = bound(stats["bytes"], stats["flops"], stats["rate"])
        rows.append({"name": name, "route": "cuda",
                     "source": f"{src}{file}.cu", "replaces": replaces,
                     "timed": timed,
                     "launches": launches, "max_abs_err": stats["err"],
                     "ms": stats["ms"], "ms_min": stats["ms_min"],
                     "ms_max": stats["ms_max"],
                     "plain_ms": stats["plain_ms"], "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": stats["library_ms"]})
    stage("done")
    print(json.dumps({"kernels": rows}), flush=True)
    print(card(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
