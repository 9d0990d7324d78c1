"""Batched serving through the MINISA model runtime on the PyTorch/CUDA
port (the port's twin of ``examples/serve_lm.py``).

    PYTHONPATH=src python examples/torch_serve_lm.py [--backend interpreter]
        [--device cpu]

The arch's prefill/decode GEMM streams are compiled once into chained
Programs via the shared ProgramCache, and a continuous-batching
Scheduler serves concurrent requests against them on an execution
backend -- reporting throughput, per-request MINISA vs
micro-instruction traffic, and the cache reuse that makes request #2
free of searches and compiles.

``--backend`` is ``cuda`` (the hand-written kernels: ``fused_chain``,
``flash_decode``, ``nest_gemm``) by default, where the JAX example
defaults to its interpreter; ``interpreter`` runs the functional
FEATHER+ machine.  Both run on the card unless ``--device cpu`` is
given (the kernels' plain versions there), and their per-request
``state_checksum``s are equal.  ``main(argv)`` returns what it printed
as a dict.
"""

import argparse

from repro_torch.configs.feather import feather_config
from repro_torch.runtime import ModelExecutable, ProgramCache, Scheduler


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minitron-4b")
    ap.add_argument("--backend", choices=("interpreter", "cuda"),
                    default="cuda")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--steps", type=int, default=4,
                    help="decode steps per request")
    ap.add_argument("--concurrent", type=int, default=2)
    args = ap.parse_args(argv)

    cfg = feather_config(4, 16)
    cache = ProgramCache()
    prefill = ModelExecutable.for_cell(args.arch, "prefill_tiny", cfg,
                                       cache=cache)
    decode = ModelExecutable.for_cell(args.arch, "decode_tiny", cfg,
                                      cache=cache)
    print(f"compiled {prefill.name}: {prefill.describe()}")
    print(f"compiled {decode.name}:  {decode.describe()}")
    print(f"cache after build: {cache.stats.summary()}")

    sched = Scheduler(prefill, decode, backend=args.backend,
                      device=args.device, max_concurrent=args.concurrent)
    for _ in range(args.requests):
        sched.submit(decode_steps=args.steps)
    report = sched.run()

    s = report.summary()
    print(f"\nserved {s['n_requests']} requests, {s['total_tokens']} tokens "
          f"in {s['wall_s']:.2f}s ({s['tokens_per_sec']:.1f} tok/s) "
          f"on {s['backend']} ({args.device})")
    print(f"cache hit rate {s['cache_hit_rate']:.1%} "
          f"(searches {s['cache_searches']}, compiles {s['cache_compiles']})")
    for r in report.requests:
        print(f"  req {r.rid}: {r.tokens} tok, "
              f"minisa {r.minisa_bytes:.0f} B vs micro "
              f"{r.micro_bytes:.3g} B ({r.instr_reduction:.0f}x), "
              f"stall {r.stall_minisa:.1%} vs {r.stall_micro:.1%}, "
              f"state {r.state_checksum}")
    return {"summary": s,
            "requests": [r.summary() for r in report.requests],
            "checksums": {r.rid: r.state_checksum for r in report.requests}}


if __name__ == "__main__":
    main()
