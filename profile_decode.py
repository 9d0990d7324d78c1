#!/usr/bin/env python3
"""Where the time of a decode tick goes, on one NVIDIA GPU.

    python3 profile_decode.py [--requests 4] [--steps 8] [--reduced]

Serves full-width gemma-7b (FEATHER+ 16x256) -- or, with ``--reduced``,
the reduced gemma-7b cell (FEATHER+ 4x16, the tests' cell, whose decode
tick runs fused_chain) -- through the PyTorch/CUDA port three times with
the same submissions: twice untraced (the first a warm-up, as
``chip_smoke.py`` serves it; the second the steady tick), then under the
span tracer, with cProfile around each decode tick's batch.  Each launch span ends in a device
sync, so the traced ticks are slower than untraced ones and the share
inside launch spans is an upper bound on the device's busy share.

Prints the traced tick's split between launch spans and the host, the
launch and batch-segment spans per tick, the prefill chunks, and the
host functions by their own time over the decode ticks.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import os
import pstats
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs.feather import feather_config  # noqa: E402
from repro_torch.obs import span_breakdown, trace  # noqa: E402
from repro_torch.runtime import ModelExecutable, ProgramCache, Scheduler  # noqa: E402


def serve(sched, n_requests: int, steps: int):
    for seed in range(n_requests):
        sched.submit(decode_steps=steps, seed=seed)
    rep = sched.run()
    torch.cuda.synchronize()
    return rep


def tick_breakdown(events) -> None:
    """Decode-tick time by span: kernel launches (synchronised) by kernel,
    batch segments by kind, and the host remainder."""
    ticks = [(e.t0_s, e.t1_s) for e in events if e.name == "decode_tick"]
    inside = [e for e in events
              if any(t0 <= e.t0_s and e.t1_s <= t1 + 1e-9 for t0, t1 in ticks)]
    by = {}
    for e in inside:
        if e.name in ("launch", "batch_segment"):
            key = f"{e.name}:{e.attrs.get('kernel', e.attrs.get('kind'))}"
            n, s = by.get(key, (0, 0.0))
            by[key] = (n + 1, s + e.dur_s)
    bd = span_breakdown("decode_tick", ["launch"], events)
    n = max(bd["n_parents"], 1)
    print(f"traced serve: {bd['parent_s'] / n * 1e3:.3f} ms per decode "
          f"tick over {bd['n_parents']} ticks, {bd['child_frac']:.3f} inside "
          f"launch spans, {bd['host_frac']:.3f} host")
    for key, (cnt, sec) in sorted(by.items()):
        print(f"  {key}: {cnt / n:.1f} per tick, {sec / n * 1e3:.3f} ms per "
              f"tick")
    chunks = [e.dur_s for e in events if e.name == "prefill_chunk"]
    print(f"  prefill_chunk (the stream run, seeded draws excluded): "
          f"{len(chunks)} chunks, "
          f"{sum(chunks) / max(len(chunks), 1) * 1e3:.3f} ms each")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--reduced", action="store_true",
                    help="serve the reduced cell (4x16) instead of full "
                         "width")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_decode: no CUDA device", file=sys.stderr)
        return 2
    print(f"card: {torch.cuda.get_device_name(0)}; torch {torch.__version__}")
    cfg = feather_config(4, 16) if args.reduced else feather_config(16, 256)
    cache = ProgramCache()
    prefill = ModelExecutable.for_cell("gemma-7b", "prefill_tiny", cfg,
                                       cache=cache,
                                       reduce_model=args.reduced)
    decode = ModelExecutable.for_cell("gemma-7b", "decode_tiny", cfg,
                                      cache=cache, reduce_model=args.reduced)
    width = "reduced, 4x16" if args.reduced else "full width, 16x256"
    print(f"cell: gemma-7b {width}, {args.requests} requests x "
          f"{args.steps} decode steps")
    decode.batch_plan(args.requests)
    t0 = time.perf_counter()
    sched = Scheduler(prefill, decode, max_concurrent=args.requests)
    print(f"scheduler init: {time.perf_counter() - t0:.1f} s")
    for label in ("first", "repeat"):
        rep = serve(sched, args.requests, args.steps)
        print(f"untraced serve, {label}: "
              f"{rep.decode_wall_s / max(rep.decode_ticks, 1) * 1e3:.3f} ms "
              f"per decode tick over {rep.decode_ticks} ticks")

    trace.clear()
    trace.enable()
    prof = cProfile.Profile()
    decode_batch = sched._decode_batch

    def profiled(batch):
        prof.enable()
        try:
            return decode_batch(batch)
        finally:
            prof.disable()
    sched._decode_batch = profiled
    rep = serve(sched, args.requests, args.steps)
    sched._decode_batch = decode_batch
    trace.disable()
    tick_breakdown(trace.events())
    out = io.StringIO()
    stats = pstats.Stats(prof, stream=out)
    stats.sort_stats("tottime").print_stats(14)
    print(f"profiled serve: host functions by own time over "
          f"{rep.decode_ticks} decode ticks")
    for line in out.getvalue().splitlines():
        if line.strip() and not line.startswith(("   Ordered", "   List")):
            print("  " + line.rstrip())
    print("profiled serve: kernel wrappers, host us per call (the C launch "
          "included, cProfile's overhead too)")
    for (path, line, name), (_, calls, own, cum, _) in sorted(
            stats.stats.items()):
        if os.path.join("repro_torch", "kernels") in path and calls:
            print(f"  {os.path.basename(path)}:{line}({name}) {calls} calls, "
                  f"{cum / calls * 1e6:.1f} us cumulative, "
                  f"{own / calls * 1e6:.1f} us own")
    return 0


if __name__ == "__main__":
    sys.exit(main())
