#!/usr/bin/env python3
"""Where the time of a model-zoo decode step goes, on one NVIDIA GPU.

    python3 profile_zoo.py [--arch gemma-7b] [--steps 16]

Builds ``--arch`` at full width and depth as
``python -m repro_torch.launch.serve`` does (batch 4, prompt 32, bf16,
weights drawn on the card) and serves it twice untraced (a warm-up and
the steady serve).  Then it runs ``--steps - 1`` decode steps after a
prefill four more times: untraced, under ``torch.profiler`` (the
device's busy time a step, kernels by device time and count a step),
under cProfile (host functions by their own time), and once more
untraced, each step ended by a device synchronisation (its spread).
The device's idle share is printed against the traced step's wall time
and against the untraced step's: the profiler's own host cost lengthens
the traced step, so the first overstates it.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import os
import pstats
import statistics
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.serve import expand_cache  # noqa: E402


def start(engine, prompts, kw):
    """A prefill as ``Engine.generate`` runs it: (cache, token, positions)
    for the decode steps."""
    model = engine.model
    b, p = prompts.shape
    logits, cache = model.prefill(prompts, **kw)
    cache = expand_cache(model, cache, b, engine.scfg.max_len)
    pos = torch.full((b,), p, dtype=torch.int32, device=model.device)
    torch.cuda.synchronize()
    return cache, logits.argmax(-1), pos


def decode_steps(engine, state, n: int, sync_each=False) -> list:
    """``n`` greedy decode steps from ``state``; their wall seconds (each
    step's, when ``sync_each``, else the total)."""
    cache, tok, pos = state
    times, t0 = [], time.perf_counter()
    for _ in range(n):
        logits, cache = engine.model.decode_step(tok[:, None], cache, pos)
        tok = logits.argmax(-1)
        pos = pos + 1
        if sync_each:
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
    torch.cuda.synchronize()
    return times or [time.perf_counter() - t0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma-7b")
    ap.add_argument("--steps", type=int, default=16)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_zoo: no CUDA device", file=sys.stderr)
        return 2
    print(f"card: {torch.cuda.get_device_name(0)}; torch {torch.__version__}")
    sargs = launch_serve.parse(["--arch", args.arch, "--steps",
                                str(args.steps)])
    engine, prompts, kw = launch_serve.setup(sargs)
    cfg, n = engine.model.cfg, args.steps - 1
    print(f"model: {cfg.name}, {cfg.num_layers} layers, {cfg.dtype}; batch "
          f"{sargs.batch}, prompt {sargs.prompt_len}, {n} decode steps")
    for label in ("first", "repeat"):
        engine.generate(prompts, args.steps, **kw)
        st = engine.stats
        print(f"untraced serve, {label}: prefill {st['prefill_s'] * 1e3:.1f} "
              f"ms, decode {st['decode_s'] / st['decode_steps'] * 1e3:.3f} "
              f"ms a step")
    dev = engine.model.device
    prompts_t = torch.as_tensor(prompts, device=dev)
    kw = {k: torch.as_tensor(v, device=dev) for k, v in kw.items()}

    state = start(engine, prompts_t, kw)
    untraced = decode_steps(engine, state, n)[0]
    print(f"untraced decode: {untraced / n * 1e3:.3f} ms a step")

    from torch.profiler import ProfilerActivity, profile
    state = start(engine, prompts_t, kw)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = decode_steps(engine, state, n)[0]
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.events() if e.device_type == cuda]
    busy_s = sum(e.time_range.elapsed_us() for e in kernels) * 1e-6
    print(f"traced decode: {wall / n * 1e3:.3f} ms a step, "
          f"{len(kernels) / n:.1f} device kernels a step, device busy "
          f"{busy_s / n * 1e3:.3f} ms a step: idle share "
          f"{1 - busy_s / wall:.3f} of the traced step, "
          f"{1 - busy_s / untraced:.3f} of the untraced step "
          f"({untraced / n * 1e3:.3f} ms)")
    table = prof.key_averages().table(sort_by="self_device_time_total",
                                      row_limit=15)
    print(f"traced decode: operators by device time over {n} steps")
    for line in table.splitlines():
        print("  " + line)
    table = prof.key_averages().table(sort_by="self_cpu_time_total",
                                      row_limit=15)
    print(f"traced decode: operators by host time over {n} steps")
    for line in table.splitlines():
        print("  " + line)

    state = start(engine, prompts_t, kw)
    pr = cProfile.Profile()
    pr.enable()
    wall = decode_steps(engine, state, n)[0]
    pr.disable()
    out = io.StringIO()
    pstats.Stats(pr, stream=out).sort_stats("tottime").print_stats(18)
    print(f"cProfile decode: {wall / n * 1e3:.3f} ms a step (profiled); "
          f"host functions by own time over {n} steps")
    for line in out.getvalue().splitlines():
        if line.strip() and not line.startswith(("   Ordered", "   List")):
            print("  " + line.rstrip())

    state = start(engine, prompts_t, kw)
    ms = [t * 1e3 for t in decode_steps(engine, state, n, sync_each=True)]
    print(f"untraced decode, each step synchronised: median "
          f"{statistics.median(ms):.3f} ms [{min(ms):.3f}..{max(ms):.3f}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
