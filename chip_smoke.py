#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's serving main path on one NVIDIA GPU.

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
     at the model zoo's decode shape beside SDPA in bf16, and its fp32
     route bit-equal to the kernel before the bf16 route (recorded output
     digests on exact inputs);
     flash_attention holds fp32 to 1e-4 of its plain version (three TF32
     products on the tensor cores, bound at 495/3 TFLOP/s), logs a bf16
     run at the same shape and times its bf16 route at the model zoo's
     prefill shape, each beside SDPA in bf16.  The attention kernels'
     library call is
     SDPA on 4-D inputs, every route that takes them timed, the fastest
     kept;
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
 10. the model zoo: gemma-7b (28 layers), falcon-mamba-7b (64) and
     granite-moe-3b-a800m (32) at full width and depth, and
     deepseek-v2-236b at full width cut to 4 layers (1 dense, 3 MoE: the
     whole model is 472 GB in bf16), in bf16, built and served as
     ``python -m repro_torch.launch.serve --arch ARCH`` does (batch 4,
     prompt 32, 16 greedy steps, weights drawn on the card from a seeded
     generator): exact launches (flash_attention once a layer at prefill,
     flash_decode once a layer a decode step, mamba_scan once a layer a
     step, no other kernel), tokens identical over two serves, the first
     and the last layer's kernel calls held against their plain versions,
     the logits of a prefill and a decode step held against the same
     model on the plain versions (and shown to move past the tolerance
     when the last layer's kernel results are dropped: seeded weights make
     greedy tokens repeat, so tokens alone see no kernel fault; an MoE
     model, which amplifies a ulp chaotically, over 16 requests with the
     plain versions fed each layer's input and experts from the kernel
     run, every layer's contribution held too, and the share of routes
     the plain versions would choose alike on their own logged),
     the decode step beside the bound of reading every weight once; then
     every model at depth 2 in fp32 (the MoE models at capacity factor
     experts / top-k, which drops nothing): decode after a prefill equal
     to the longer prefill (rtol and atol 2e-3).  Phase 2 also times flash_attention and flash_decode at
     MLA's shapes (rows flash_attention_mla and flash_decode_mla).

Phase 10 runs last, after phase 9's weights are freed, and frees what it
makes.  Ends with the ``kernels`` JSON line (a row per route, each with
its own path's launches and what its times were taken at), the card's
name and power limit, and the result line ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import json
import os
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
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import isa, mapper, workloads  # noqa: E402
from repro_torch.core import program as programlib  # noqa: E402
from repro_torch.dist import ArrayMesh  # noqa: E402
from repro_torch.dist.elastic import (load_serving_snapshot,  # noqa: E402
                                      save_serving_snapshot)
from repro_torch.faults import FaultInjector, FaultPlan  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import fused_chain as fc  # noqa: E402
from repro_torch.kernels import mamba_scan as ms  # noqa: E402
from repro_torch.kernels import nest_gemm as ng  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.transformer import DecoderLayer  # noqa: E402
from repro_torch.serve import expand_cache  # noqa: E402
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


def check(name: str, got, want, k: int) -> float:
    """Hold ``got`` against ``want`` at rtol 2e-4, atol 2e-4*k.  The
    inputs are drawn so that the plain result's RMS is at least 10x the
    atol: a kernel that returned zeros, or dropped part of K, would fail."""
    atol = RTOL * k
    rms = float(want.pow(2).mean().sqrt())
    assert atol < 0.1 * rms, (f"{name}: atol {atol} is not small against "
                              f"the result (RMS {rms})")
    err = (got - want).abs()
    tol = atol + RTOL * want.abs()
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


def counts() -> dict:
    return {"nest_gemm": ng.launches, "fused_chain": fc.launches,
            "flash_decode": fa.launches,
            "flash_decode_proj": fa.proj_launches,
            "flash_attention": fa.attention_launches,
            "mamba_scan": ms.launches}


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


def check_flash_decode_bf16(timer, gen) -> dict:
    """The bf16 route against its plain version (p rounded to bf16 before
    P V, output in bf16) at ``DECODE_BF16_CASE``, timed beside SDPA on the
    same bf16 inputs (every route, the fastest kept) and its bound: the
    kernels JSON row of the route."""
    b, sq, skv, d, length = DECODE_BF16_CASE
    scale = d ** -0.5
    # q at 1/scale: scores of std ~8, a peaked softmax whose output RMS
    # is far above check()'s atol, as at the fp32 cases
    q = (torch.randn(b, sq, d, device="cuda", generator=gen) / scale
         ).to(torch.bfloat16)
    k = (torch.randn(b, skv, d, device="cuda", generator=gen) * 0.5
         ).to(torch.bfloat16)
    v = torch.randn(b, skv, d, device="cuda", generator=gen
                    ).to(torch.bfloat16)
    lens = torch.full((b,), length, dtype=torch.int32, device="cuda")
    got = fa.flash_decode(q, k, v, lens, scale=scale)
    want = ref.flash_decode_ref(q, k, v, lens, scale=scale)
    assert got.dtype == want.dtype == torch.bfloat16
    name = f"flash_decode bf16 {(b, sq, skv, d)}"
    err = check(name, got.float(), want.float(), d)
    mask = (torch.arange(skv, device="cuda")[None, :] < lens[:, None])
    ms_ = timer(lambda: fa.flash_decode(q, k, v, lens, scale=scale))
    plain = timer(lambda: ref.flash_decode_ref(q, k, v, lens, scale=scale))
    lib = sdpa_library(timer, name, want, lambda o: o[:, 0], q[:, None],
                       k[:, None], v[:, None],
                       attn_mask=mask[:, None, None, :], scale=scale)
    used = b * length                # the KV rows these lengths need
    nbytes = 2.0 * (2 * b * sq * d + 2 * used * d) + 4 * b
    flops = 4.0 * sq * used * d
    b_ms, b_by = bound(nbytes, flops, PEAK_BF16)
    log(f"K3 {name}: lengths {length} | max_err {err:.3g} | ms "
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


def check_flash_decode_mla(timer, gen) -> dict:
    """The bf16 route at ``MLA_DECODE_CASE`` (d 576 and dv 512: shared
    memory past 48 KB; 128 query rows: 8 row groups) against its plain
    version, timed beside SDPA in bf16 and its bound: the kernels JSON row
    ``flash_decode_mla``."""
    b, sq, skv, d, dv, length = MLA_DECODE_CASE
    scale = 192 ** -0.5
    q = (torch.randn(b, sq, d, device="cuda", generator=gen) / scale
         ).to(torch.bfloat16)
    k = (torch.randn(b, skv, d, device="cuda", generator=gen) * 0.5
         ).to(torch.bfloat16)
    # v at 2x: an output RMS ~2, over 10x check()'s atol at k = d
    v = (torch.randn(b, skv, dv, device="cuda", generator=gen) * 2.0
         ).to(torch.bfloat16)
    lens = torch.full((b,), length, dtype=torch.int32, device="cuda")
    got = fa.flash_decode(q, k, v, lens, scale=scale)
    want = ref.flash_decode_ref(q, k, v, lens, scale=scale)
    name = f"flash_decode bf16 MLA {MLA_DECODE_CASE[:5]}"
    err = check(name, got.float(), want.float(), d)
    mask = (torch.arange(skv, device="cuda")[None, :] < lens[:, None])
    ms_ = timer(lambda: fa.flash_decode(q, k, v, lens, scale=scale))
    plain = timer(lambda: ref.flash_decode_ref(q, k, v, lens, scale=scale))
    lib = sdpa_library(timer, name, want, lambda o: o[:, 0], q[:, None],
                       k[:, None], v[:, None],
                       attn_mask=mask[:, None, None, :], scale=scale)
    used = b * length                # the KV rows these lengths need
    nbytes = 2.0 * (b * sq * d + used * (d + dv) + b * sq * dv) + 4 * b
    flops = 2.0 * sq * used * (d + dv)
    b_ms, b_by = bound(nbytes, flops, PEAK_BF16)
    log(f"K3 {name}: lengths {length} | max_err {err:.3g} | ms "
        f"{spread(ms_)} plain {plain['ms']:.4f} sdpa {lib['ms']:.4f} "
        f"({lib['route']}) bound {b_ms:.6f} ({b_by})")
    return row_stats(ms_, plain, lib, nbytes, flops, err, PEAK_BF16)


def check_mamba_scan(timer, gen) -> tuple[dict, tuple]:
    b, seq, d, n = SCAN_SHAPE
    da = 0.7 + 0.299 * torch.rand(b, seq, d, n, device="cuda",
                                  generator=gen)
    dbx = torch.randn(b, seq, d, n, device="cuda", generator=gen) * 0.1
    c = torch.randn(b, seq, n, device="cuda", generator=gen)
    h0 = torch.randn(b, d, n, device="cuda", generator=gen) * 0.1
    y, h = ms.mamba_scan(da, dbx, c, h0)
    y_ref, h_ref = ref.mamba_scan_ref(da, dbx, c, h0)
    err = check("mamba_scan", y, y_ref, n)
    # the state is a rounded multiply then a rounded add in both versions
    assert torch.equal(h, h_ref), float((h - h_ref).abs().max())
    ms_ = timer(lambda: ms.mamba_scan(da, dbx, c, h0))
    plain = timer(lambda: ref.mamba_scan_ref(da, dbx, c, h0))
    nbytes = 4.0 * (2 * b * seq * d * n + b * seq * n + 2 * b * d * n
                    + b * seq * d)
    flops = 4.0 * b * seq * d * n
    log(f"K6 mamba_scan: B {b} L {seq} D {d} N {n} | max_err {err:.3g}, "
        f"h_last bit-equal | ms {spread(ms_)} plain {plain['ms']:.4f} "
        f"library none | bound {bound(nbytes, flops)[0]:.4f}")
    return (row_stats(ms_, plain, None, nbytes, flops, err),
            (da, dbx, c, h0, y, h))


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


def mesh_cross_check() -> None:
    """``backends.cross_check`` sharded on the card: interpreter == cuda
    == oracle on 2 and 4 arrays along every axis, for each GEMM's
    searched Program and a forced WO-S and IO-S lowering.  The inputs are
    numpy arrays, so every N split cuts columns of a fresh device tensor
    (a view that is not contiguous) for nest_gemm."""
    cfg = feather_config(4, 16)
    suite = workloads.ci_suite()
    worst: dict[str, float] = {}
    n_runs = 0
    t0 = time.perf_counter()
    for idx in MESH_CHECK_GEMMS:
        g = suite[idx]
        progs = [mapper.search(g, cfg).program] + [
            programlib.lower(g, mapper.MappingChoice(
                df=df, vn=4, m_t=8, k_t=8, n_t=8, n_kg=1, n_nb=1, dup=4),
                cfg) for df in (isa.Dataflow.WOS, isa.Dataflow.IOS)]
        gen = torch.Generator().manual_seed(idx)
        t = {"I": torch.randn(g.m, g.k, generator=gen).numpy(),
             "W": torch.randn(g.k, g.n, generator=gen).numpy()}
        for prog in progs:
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
            for shard in sharded.shards:
                g = shard.program.gemm
                w_offset = 4 * shard.k0 * sharded.base.gemm.n
                n_ng += 2 if ng.scratch_floats(g.m, g.k, g.n, w_offset) else 1
    return n_ng, n_fc


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
    del sched, be, env, res, held, again
    torch.cuda.empty_cache()
    return launched


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


def chaos_and_resume() -> None:
    """The standard fault plans on the cuda backend at reduced width
    (flat, and on 2 arrays with one going down), then a serve stopped
    after 2 ticks, saved, loaded and resumed."""
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


def mesh_phase(gen, flat_sums: dict, flat_tick_ms: float, weights: tuple,
               reduced_sums: dict, floor_ms: float) -> None:
    stage("phase 9: sharded cross_checks")
    mesh_cross_check()
    stage("phase 9: full width on 4 arrays")
    mesh_full_width(gen, flat_sums, flat_tick_ms, weights)
    stage("phase 9: reduced cell on 4 and 2 arrays")
    mesh_reduced(gen, reduced_sums, floor_ms)
    stage("phase 9: chaos and resume")
    chaos_and_resume()


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


def zoo_serve(arch: str, name_limit: str, device="cuda",
              depth: int | None = None) -> dict:
    """``arch`` at full width and depth (or cut to ``depth`` layers) in
    its published dtype, built and served as ``python -m
    repro_torch.launch.serve --arch ARCH`` builds and serves it (the
    CLI's defaults): launches exact, two serves' tokens identical, the
    first and the last layer's kernel calls held against their plain
    versions (in the second serve), the logits held against the plain
    versions' (``zoo_logits_gate``), the decode step beside the bound of
    reading every weight once.  Returns the first serve's launches."""
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
    layers, steps = cfg.num_layers, args.steps
    # the calls captured: the first and the last layer's, at prefill and
    # at the last decode step
    if cfg.family == "ssm":
        expect = {"mamba_scan": layers * steps}
        keep = {"mamba_scan": (0, layers - 1, layers * (steps - 1),
                               layers * steps - 1)}
        mods = {"mamba_scan": ms}
    else:
        expect = {"flash_attention": layers,
                  "flash_decode": layers * (steps - 1)}
        keep = {"flash_attention": (0, layers - 1),
                "flash_decode": (layers * (steps - 2),
                                 layers * (steps - 1) - 1)}
        mods = {"flash_attention": fa, "flash_decode": fa}
    expect = {k: expect.get(k, 0) for k in counts()}

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
    bound_ms = wbytes / PEAK_BYTES * 1e3
    cli_tok_s = args.batch * steps / (st["prefill_s"] + st["decode_s"])
    rep_ms = engine.stats["decode_s"] / engine.stats["decode_steps"] * 1e3
    log(f"zoo {arch}: decode {step_ms:.3f} ms a step over "
        f"{st['decode_steps']} steps ({args.batch / step_ms * 1e3:.1f} "
        f"tok/s decoding, {cli_tok_s:.1f} tok/s with prefill, the CLI's "
        f"measure) against the bound {bound_ms:.3f} ms ({wbytes / 1e9:.2f} "
        f"GB of weights read once a step at {PEAK_BYTES / 1e12:.2f} TB/s); "
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
    del engine, model
    torch.cuda.empty_cache()
    return launched


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
    layers = model.cfg.num_layers
    prompts = torch.as_tensor(prompts, device=model.device)

    def swapped(zero):
        with contextlib.ExitStack() as stack:
            for n, mod in mods.items():
                stack.enter_context(Swap(mod, n, PLAIN[n], zero(n)))
            return zoo_logits(model, prompts, kw)

    got = zoo_logits(model, prompts, kw)
    plain = swapped(lambda n: ())
    # the last layer's call at prefill and at the decode step: the scan
    # runs once a layer in both; attention once a layer in each kernel
    fault = swapped(lambda n: (layers - 1, 2 * layers - 1)
                    if n == "mamba_scan" else (layers - 1,))
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


def zoo_decode_matches_prefill(arch: str, device="cuda") -> None:
    """``tests/test_arch_smoke.py``'s decode-vs-prefill check at full width,
    depth 2, fp32: prefill(t[:n]) then decode(t[n]) against
    prefill(t[:n+1]), rtol and atol 2e-3: the kernels' prefill path
    against their decode path through whole models.  Capacity depends on
    the tokens a row, so at the published 1.25 a prefill of n + 1 tokens
    and a decode after n may drop different tokens, in the JAX package as
    here: an MoE model runs at capacity factor experts / top-k, at which
    an expert has a slot for every token of a row and nothing is dropped
    (``configs.base.reduced``'s 4.0 drops choices at granite's full
    width: its seeded router sends most tokens to a few experts)."""
    cfg = dataclasses.replace(get_config(arch), num_layers=2,
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
    reset_counts()
    with Routes() as routes:
        full, _ = model.prefill(toks)
        _, cache = model.prefill(toks[:, :n])
        cache = expand_cache(model, cache, b, n + 1)
        step, _ = model.decode_step(toks[:, n:], cache,
                                    torch.full((b,), n, dtype=torch.int32,
                                               device=device))
    torch.cuda.synchronize()
    launched = {k: v for k, v in counts().items() if v}
    err = float((step - full).abs().max())
    dropped = (f"; choices dropped by capacity {routes.dropped()}"
               if cfg.moe_enabled else "")
    log(f"zoo {arch} fp32 depth 2: decode after prefill of {n} against "
        f"prefill of {n + 1}: max |diff| {err:.3g} on logits of max "
        f"{float(full.abs().max()):.1f}; launches {launched}{dropped}")
    assert routes.dropped() == 0, routes.dropped()
    torch.testing.assert_close(step, full, rtol=2e-3, atol=2e-3)
    del model, cache
    torch.cuda.empty_cache()


#: the zoo's serves: (arch, depth; None serves every layer)
ZOO = [("gemma-7b", None), ("falcon-mamba-7b", None),
       ("granite-moe-3b-a800m", None), ("deepseek-v2-236b", 4)]


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
    stage("phase 10: decode against prefill, fp32, depth 2")
    for arch, _ in ZOO:
        zoo_decode_matches_prefill(arch, device)
    return zoo, by_arch


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
    k3b = check_flash_decode_bf16(timer, gen)
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
    k3m = check_flash_decode_mla(timer, gen)
    k6, scan = check_mamba_scan(timer, gen)
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
    mesh_phase(gen, fw_sums, fw_tick_ms, fw_weights, untuned_sums,
               k3["floor_ms"])
    del fw_weights
    torch.cuda.empty_cache()
    zoo, zoo_by_arch = zoo_phase(name_limit)
    mla = zoo_by_arch["deepseek-v2-236b"]

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
            ("mamba_scan", "mamba_scan", "src/repro/kernels/mamba_scan.py:61",
             k6, f"fp32 {SCAN_SHAPE}", op["mamba_scan"] + zoo["mamba_scan"])):
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
