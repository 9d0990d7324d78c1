"""Plan FEATHER+ offload for every assigned architecture (decode_32k)
and print the instruction-traffic table -- the framework-level integration
of the paper (core/planner + core/model_gemms), on the PyTorch/CUDA port
(the port's twin of ``examples/minisa_plan.py``).

    PYTHONPATH=src python examples/torch_minisa_plan.py [--check-backends]
        [--arch gemma-7b ...] [--device cpu]

``--check-backends`` additionally executes each architecture's planned
Programs (the ones small enough to run functionally) on both execution
backends -- the interpreter and the compiled ``nest_gemm`` launches --
against the einsum oracle (``core.planner.cross_check``), on the card
unless ``--device cpu`` is given.  ``--arch`` limits the loop (every
arch by default: minutes on a CPU).  ``main(argv)`` returns each arch's
row as a dict.
"""

import argparse

from repro_torch.configs.base import SHAPES
from repro_torch.configs.feather import feather_config
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.core.model_gemms import gemm_workloads
from repro_torch.core.planner import cross_check, plan_model


def arch_row(arch: str, cfg, check_backends: bool = False,
             max_check_macs: float = 2e8, device="cuda") -> dict:
    """One arch's plan at decode_32k on ``cfg``, printed as a table row
    (and its backend check's line)."""
    ops = gemm_workloads(get_config(arch), SHAPES["decode_32k"])
    plan = plan_model(arch, "decode_32k", ops, cfg)
    s = plan.summary()
    # every per-shape plan carries its lowered Program: the same tiled
    # artifact drives the backends, the perf model and these byte counts
    n_tiles = sum(p.program.n_tiles for p in plan.plans.values())
    print(f"{arch:>22} {s['speedup']:8.2f} {s['utilization']:7.1%} "
          f"{s['instr_reduction']:10.2e} {n_tiles:6d} "
          f"{s['elided_bytes']:9.1f}")
    row = {"arch": arch, "summary": s, "n_tiles": n_tiles}
    if check_backends:
        errs = cross_check(plan, max_macs=max_check_macs, device=device)
        worst = max((e for d in errs.values() for e in d.values()),
                    default=0.0)
        print(f"{'':>22} backends OK on {len(errs)}/{len(plan.plans)} "
              f"unique GEMMs (max |err| {worst:.2e})")
        row.update(checked=sorted(errs), n_unique=len(plan.plans),
                   worst_err=worst)
    return row


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check-backends", action="store_true",
                    help="cross-validate planned Programs on the interpreter "
                         "and cuda backends against the einsum oracle")
    ap.add_argument("--max-check-macs", type=float, default=2e8,
                    help="skip functional execution of GEMMs above this size")
    ap.add_argument("--arch", nargs="+", choices=ARCH_IDS, default=ARCH_IDS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = feather_config(16, 256)
    print(f"{'arch':>22} {'speedup':>8} {'util':>7} {'instr-red':>10} "
          f"{'tiles':>6} {'elided-B':>9}")
    return {arch: arch_row(arch, cfg, args.check_backends,
                           args.max_check_macs, args.device)
            for arch in args.arch}


if __name__ == "__main__":
    main()
