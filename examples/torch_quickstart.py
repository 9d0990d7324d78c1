"""Quickstart on the PyTorch/CUDA port: the MINISA pipeline end-to-end
on one GEMM (the port's twin of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

1. mapper searches (mapping, layout) for a GEMM on FEATHER+ 8x8;
2. the plan lowers to a tiled Program (8-instruction MINISA ISA);
3. the Program executes on BOTH backends: the interpreter (functional
   FEATHER+ machine, tile by tile) and the compiled backend (one
   hand-written ``nest_gemm`` launch derived from the Program's tiling;
   its plain PyTorch version with ``--device cpu``);
4. both results are checked against the einsum oracle (max |err| < 1e-3);
5. the analytical model reports cycles/stalls vs the micro-instruction
   baseline.

Runs on the card by default (raising without one).  ``main(argv)``
returns what it printed as a dict.
"""

import argparse

import numpy as np

from repro_torch import backends
from repro_torch.configs.feather import feather_config
from repro_torch.core import mapper
from repro_torch.core.isa import trace_summary

BACKENDS = ("interpreter", "cuda")
TOL = 1e-3


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = feather_config(8, 8)
    gemm = mapper.Gemm(m=96, k=40, n=88, name="quickstart")

    plan = mapper.search(gemm, cfg)
    ch = plan.choice
    print(f"chosen mapping: df={ch.df.name} vn={ch.vn} "
          f"tile=({ch.m_t},{ch.k_t},{ch.n_t}) "
          f"groups=({ch.n_kg},{ch.n_nb}) dup={ch.dup}")

    prog = plan.program
    trace = trace_summary(prog.instructions(), cfg)
    lowering = backends.compile_program(prog).describe()
    print("\ntrace:", trace)
    print("cuda lowering:", lowering)

    rng = np.random.default_rng(0)
    i = rng.standard_normal((gemm.m, gemm.k)).astype(np.float32)
    w = rng.standard_normal((gemm.k, gemm.n)).astype(np.float32)
    oracle = i @ w
    errs = {}
    for backend in BACKENDS:
        out = plan.execute({"I": i, "W": w}, backend=backend,
                           device=args.device)["O"]
        err = float(np.abs(out.cpu().numpy() - oracle).max())
        errs[backend] = err
        print(f"functional check [{backend:>11}] on {args.device} vs "
              f"oracle: max |err| = {err:.2e}")
        assert err < TOL, (backend, err)

    s = plan.summary()
    print(f"\nanalytical model: {s['cycles_minisa']:.0f} cycles (MINISA) vs "
          f"{s['cycles_micro']:.0f} (micro) -> {s['speedup']:.2f}x speedup")
    print(f"utilization {s['util_minisa']:.1%}, instruction bytes "
          f"{s['instr_bytes_minisa']:.0f} vs {s['instr_bytes_micro']:.2e} "
          f"({s['instr_reduction']:.0f}x reduction)")
    return {"choice": {"df": ch.df.name, "vn": ch.vn,
                       "tile": (ch.m_t, ch.k_t, ch.n_t),
                       "groups": (ch.n_kg, ch.n_nb), "dup": ch.dup},
            "trace": trace, "lowering": lowering, "errs": errs,
            "summary": s}


if __name__ == "__main__":
    main()
