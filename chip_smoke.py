#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's serving main path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase catches its own):

  1. environment: the card, CUDA, nvcc, and the kernel build (one nvcc
     per source under src/repro_torch/kernels/csrc, all started together);
  2. every kernel against its plain PyTorch version on the card, at the
     shapes the main path gives it, with times beside the least time the
     card could take (bound) and one PyTorch library call (yardstick);
  3. full-width gemma-7b (FEATHER+ 16x256) served by the Scheduler: 9
     launches per decode tick through nest_gemm and flash_decode,
     deterministic checksums, batched == sequential decode;
  4. the reduced gemma-7b cell (4x16): batched fused decode on the card
     (fused_chain launched) with checksums bit-equal to the CPU path.

Ends with the ``kernels`` JSON line, the card's name and power limit, and
the result line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.backends import compile_program, compile_segment  # noqa: E402
from repro_torch.configs.feather import feather_config  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import fused_chain as fc  # noqa: E402
from repro_torch.kernels import nest_gemm as ng  # noqa: E402
from repro_torch.runtime import ModelExecutable, ProgramCache, Scheduler  # noqa: E402

#: H100 SXM data-sheet peaks (at the 700 W limit): HBM bytes/s and fp32
#: FFMA flop/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
RTOL = 2e-4                      # the reference's cross_check tolerance
REPS = 10
#: the reduced cell's submissions (tests/test_batched_decode.py)
SUBMISSIONS = [(3, None), (1, None), (2, 64), (4, 32), (2, None)]


def log(*args) -> None:
    print(*args, flush=True)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """Least time (ms) the card could take, and what bounds it."""
    tb, tf = nbytes / PEAK_BYTES, flops / PEAK_FP32
    return (max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations")


class Timer:
    """Mean device ms of ``fn`` by CUDA events, with L2 flushed before
    each call (the main path finds its weights cold: a decode tick reads
    4.25 GB) and the stream held busy while the host enqueues ``fn``, so
    host launch overhead is not timed."""

    def __init__(self):
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
        self.start = torch.cuda.Event(enable_timing=True)
        self.end = torch.cuda.Event(enable_timing=True)

    def __call__(self, fn, reps: int = REPS) -> float:
        fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(1_000_000)    # ~0.5 ms of device spin
            self.start.record()
            fn()
            self.end.record()
            self.end.synchronize()
            total += self.start.elapsed_time(self.end)
        return total / reps


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


def reset_counts() -> None:
    ng.launches = fc.launches = fa.launches = 0


def counts() -> dict:
    return {"nest_gemm": ng.launches, "fused_chain": fc.launches,
            "flash_decode": fa.launches}


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def nest_gemm_shapes(decode, prefill, bucket: int) -> list[tuple]:
    """Distinct (M, K, N, out_block_t, act, bk) the decode plan at
    ``bucket`` and a prefill pass launch on nest_gemm, with how many
    times one decode tick launches each."""
    shapes: dict[tuple, int] = {}
    for seg in decode.batch_plan(bucket).segments:
        if seg.kind != "static" or seg.fused is not None:
            continue
        for prog in seg.programs:
            comp = compile_program(prog)
            g = prog.gemm
            key = (g.m, g.k, g.n, comp.out_block_t, comp.fused_act, comp.bk)
            shapes[key] = shapes.get(key, 0) + 1
    for step in prefill.steps:
        comp = compile_program(step.program)
        g = step.program.gemm
        shapes.setdefault((g.m, g.k, g.n, comp.out_block_t, comp.fused_act,
                           comp.bk), 0)
    return [(*key, n) for key, n in shapes.items()]


def check_nest_gemm(shapes, timer, gen) -> dict:
    log("K1 nest_gemm: M K N out_t act | launches/tick | max_err | "
        "ms plain_ms library_ms bound_ms")
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
           "bytes": 0.0, "flops": 0.0, "err": 0.0}
    for m, k, n, out_t, act, bk, per_tick in shapes:
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
        log(f"  {m} {k} {n} {out_t} {act} | {per_tick} | {err:.3g} | "
            f"{ms:.4f} {plain:.4f} {lib:.4f} {b_ms:.4f} ({b_by})")
        del got, want
        if per_tick:
            for key, val in (("ms", ms), ("plain_ms", plain),
                             ("library_ms", lib), ("bytes", nbytes),
                             ("flops", flops)):
                tot[key] += per_tick * val
        tot["err"] = max(tot["err"], err)
    return tot


def check_flash_decode(timer, gen) -> dict:
    b, sq, skv, d = 4, 1, 16, 256
    q = torch.randn(b, sq, d, device="cuda", generator=gen)
    k = torch.randn(b, skv, d, device="cuda", generator=gen) * 0.5
    v = torch.randn(b, skv, d, device="cuda", generator=gen)
    lens = torch.tensor([16, 1, 9, 5], dtype=torch.int32, device="cuda")
    got = fa.flash_decode(q, k, v, lens)
    want = ref.flash_decode_ref(q, k, v, lens)
    err = check("flash_decode", got, want, d)
    mask = (torch.arange(skv, device="cuda")[None, :] < lens[:, None])
    mask = mask[:, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms = timer(lambda: fa.flash_decode(q, k, v, lens))
    plain = timer(lambda: ref.flash_decode_ref(q, k, v, lens))
    lib = timer(lambda: sdpa(q, k, v, attn_mask=mask, scale=1.0))
    used = int(lens.sum())           # the KV rows this run's lengths need
    nbytes = 4.0 * (2 * b * sq * d + 2 * used * d) + 4 * b
    flops = 4.0 * sq * used * d
    log(f"K3 flash_decode: B {b} sq {sq} skv {skv} d {d} lengths "
        f"{lens.tolist()} | max_err {err:.3g} | ms {ms:.4f} plain {plain:.4f}"
        f" sdpa {lib:.4f} bound {bound(nbytes, flops)[0]:.6f}")
    return {"ms": ms, "plain_ms": plain, "library_ms": lib, "bytes": nbytes,
            "flops": flops, "err": err}


def fused_cases(decode, prefill, bucket: int) -> list[tuple]:
    """(label, dims, bm, bks, acts, adapts): the reduced cell's fused
    segments plus synthetic ones with an adapt, the row-wise acts, and a
    slab too large for shared memory."""
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
    cases.append(("synthetic global-scratch",
                  ((64, 256, 512), (64, 512, 512), (64, 512, 128)), 64,
                  (128, 128, 128), ("relu", "gelu", "silu"),
                  (False, False, False)))
    return cases


def check_fused_chain(cases, timer, gen) -> dict:
    log("K2 fused_chain: case | dims | placement | max_err | ms plain_ms "
        "library_ms bound_ms")
    main = None
    for label, dims, bm, bks, acts, adapts in cases:
        x = torch.randn(*dims[0][:2], device="cuda", generator=gen)
        ws = [torch.randn(d[1], d[2], device="cuda", generator=gen)
              for d in dims]
        got = fc.fused_chain(x, ws, bm=bm, bks=bks, acts=acts,
                             adapts=adapts, dims=dims)
        want = ref.fused_chain_ref(x, ws, bks=bks, acts=acts, adapts=adapts,
                                   dims=dims)
        err = check(f"fused_chain {label}", got, want,
                    max(d[1] for d in dims))
        ms = timer(lambda: fc.fused_chain(x, ws, bm=bm, bks=bks, acts=acts,
                                          adapts=adapts, dims=dims))
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
        bm_, _, _, k_slab, n_max = fc.geometry(dims, bm, bks, adapts)
        where = fc.placement(bm_, k_slab, n_max)
        log(f"  {label} | {dims} | {where} | {err:.3g} | {ms:.4f} "
            f"{plain:.4f} {lib:.4f} {b_ms:.6f}")
        row = {"ms": ms, "plain_ms": plain, "library_ms": lib,
               "bytes": nbytes, "flops": flops, "err": err}
        if main is None:          # the decode tick's fused segment
            main = row
        main["err"] = max(main["err"], err)
    return main


# ---------------------------------------------------------------------------
# phases 3 and 4: serving
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
    del sched, envs, batched, seq
    torch.cuda.empty_cache()
    return launched


def reduced_width() -> dict:
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
    return launched


def main() -> int:
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
        for line in i["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {n}: {line.strip()}")

    # phase 2
    gen = torch.Generator(device="cuda").manual_seed(0)
    timer = Timer()
    cfg = feather_config(16, 256)
    cache = ProgramCache()
    fw_pre = ModelExecutable.for_cell("gemma-7b", "prefill_tiny", cfg,
                                      cache=cache, reduce_model=False)
    fw_dec = ModelExecutable.for_cell("gemma-7b", "decode_tiny", cfg,
                                      cache=cache, reduce_model=False)
    k1 = check_nest_gemm(nest_gemm_shapes(fw_dec, fw_pre, 4), timer, gen)
    k3 = check_flash_decode(timer, gen)
    rcache = ProgramCache()
    r_pre = ModelExecutable.for_cell("gemma-7b", "prefill_tiny",
                                     feather_config(4, 16), cache=rcache)
    r_dec = ModelExecutable.for_cell("gemma-7b", "decode_tiny",
                                     feather_config(4, 16), cache=rcache)
    k2 = check_fused_chain(fused_cases(r_dec, r_pre, 4), timer, gen)
    del timer
    torch.cuda.empty_cache()

    # phases 3 and 4, each with the counts set to 0 just before it
    fw = full_width(gen)
    rw = reduced_width()

    rows = []
    for name, route, src, replaces, stats, launches in (
            ("nest_gemm", "cuda", "src/repro_torch/kernels/csrc/nest_gemm.cu",
             "src/repro/kernels/nest_gemm.py:97", k1, fw["nest_gemm"]),
            ("flash_decode", "cuda",
             "src/repro_torch/kernels/csrc/flash_decode.cu",
             "src/repro/kernels/flash_attention.py:256", k3,
             fw["flash_decode"]),
            ("fused_chain", "cuda",
             "src/repro_torch/kernels/csrc/fused_chain.cu",
             "src/repro/kernels/fused_chain.py:240", k2,
             rw["fused_chain"])):
        b_ms, b_by = bound(stats["bytes"], stats["flops"])
        rows.append({"name": name, "route": route, "source": src,
                     "replaces": replaces, "launches": launches,
                     "max_abs_err": stats["err"], "ms": stats["ms"],
                     "plain_ms": stats["plain_ms"], "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": stats["library_ms"]})
    print(json.dumps({"kernels": rows}), flush=True)
    print(card(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
