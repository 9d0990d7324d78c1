"""Standalone (mapping, layout) co-search CLI for GEMM/conv workloads —
the artifact's ``python -m minisa search [--layout-constrained]``
(counterpart of ``repro/launch/search.py``, the same flags and output).

    PYTHONPATH=src python -m repro_torch.launch.search --m 2048 --k 2880 --n 4096
    PYTHONPATH=src python -m repro_torch.launch.search \
        --conv 1,224,224,3,7,7,64,2 --ah 16 --aw 64
    PYTHONPATH=src python -m repro_torch.launch.search --m 64 --k 40 --n 88 \
        --layout-constrained --ah 8 --aw 8 --fixed-vn 8 --fixed-order 4

It runs the numpy mapper only, so it needs no card.  ``main(argv)``
returns the plan's summary.  A constraint no mapping meets raises
``ValueError: no feasible mapping`` (``--fixed-vn 8`` at the default
16x64 does).
"""

from __future__ import annotations

import argparse
import json

from repro_torch.configs.feather import feather_config
from repro_torch.core import mapper
from repro_torch.core.conv import Conv2D


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int)
    ap.add_argument("--k", type=int)
    ap.add_argument("--n", type=int)
    ap.add_argument("--conv", help="N,H,W,Cin,KH,KW,Cout[,stride]")
    ap.add_argument("--ah", type=int, default=16)
    ap.add_argument("--aw", type=int, default=64)
    ap.add_argument("--layout-constrained", action="store_true")
    ap.add_argument("--fixed-vn", type=int, default=None)
    ap.add_argument("--fixed-order", type=int, default=None)
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    if args.conv:
        parts = [int(x) for x in args.conv.split(",")]
        conv = Conv2D(n=parts[0], h=parts[1], w=parts[2], c_in=parts[3],
                      kh=parts[4], kw=parts[5], c_out=parts[6],
                      stride=parts[7] if len(parts) > 7 else 1)
        gemm = conv.to_gemm()
        print(f"conv lowered to GEMM {gemm.m}x{gemm.k}x{gemm.n} "
              f"({gemm.name})")
    else:
        assert args.m and args.k and args.n, "--m/--k/--n or --conv"
        gemm = mapper.Gemm(m=args.m, k=args.k, n=args.n)

    cfg = feather_config(args.ah, args.aw)
    kwargs = {}
    if args.layout_constrained:
        kwargs["fixed_input_vn"] = args.fixed_vn or cfg.ah
        if args.fixed_order is not None:
            kwargs["fixed_input_order"] = args.fixed_order
    plan = mapper.search(gemm, cfg, **kwargs)
    s = plan.summary()
    if args.json:
        print(json.dumps(s, indent=1, default=str))
        return s
    ch = plan.choice
    print(f"best mapping: df={ch.df.name} vn={ch.vn} "
          f"tiles=({ch.m_t},{ch.k_t},{ch.n_t}) "
          f"groups=({ch.n_kg},{ch.n_nb}) dup={ch.dup} "
          f"orders=(W:{ch.order_w} I:{ch.order_i} O:{ch.order_o})")
    print(f"cycles {s['cycles_minisa']:.4g} | speedup vs micro "
          f"{s['speedup']:.2f}x | utilization {s['util_minisa']:.1%} | "
          f"instr reduction {s['instr_reduction']:.3g}x")
    return s


if __name__ == "__main__":
    main()
