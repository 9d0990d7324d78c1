"""MINISA planning CLI: plan FEATHER+ offload for an (arch x shape) cell
(counterpart of ``repro/launch/plan.py``, the same flags and output).

    PYTHONPATH=src python -m repro_torch.launch.plan --arch gemma-7b \
        --shape decode_32k --ah 16 --aw 256 [--json]

It runs the numpy planner only, so it needs no card.  ``main(argv)``
returns the plan's summary.
"""

from __future__ import annotations

import argparse
import json

from repro_torch.configs.base import SHAPES
from repro_torch.configs.feather import feather_config
from repro_torch.configs.registry import ARCH_IDS, get_config, get_shape
from repro_torch.core.model_gemms import gemm_workloads
from repro_torch.core.planner import plan_model


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="gemma-7b")
    ap.add_argument("--shape", choices=list(SHAPES), default="decode_32k")
    ap.add_argument("--ah", type=int, default=16)
    ap.add_argument("--aw", type=int, default=256)
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    shape = get_shape(args.shape)
    fcfg = feather_config(args.ah, args.aw)
    ops = gemm_workloads(cfg, shape)
    plan = plan_model(args.arch, args.shape, ops, fcfg)
    s = plan.summary()
    if args.json:
        print(json.dumps(s, indent=1))
        return s
    print(f"== MINISA plan: {args.arch} x {args.shape} on FEATHER+ "
          f"{args.ah}x{args.aw} ==")
    print(f" GEMMs                {s['n_gemms']:>14,} ({s['n_unique']} unique shapes)")
    print(f" MACs                 {s['macs']:>14.3e}")
    print(f" cycles (MINISA)      {s['cycles_minisa']:>14.3e}")
    print(f" cycles (micro-inst)  {s['cycles_micro']:>14.3e}")
    print(f" end-to-end speedup   {s['speedup']:>14.2f}x")
    print(f" compute utilization  {s['utilization']:>14.1%}")
    print(f" instr bytes MINISA   {s['instr_bytes_minisa']:>14.3e}"
          f"  (instr:data = {s['instr_to_data_minisa']:.2e})")
    print(f" instr bytes micro    {s['instr_bytes_micro']:>14.3e}"
          f"  (instr:data = {s['instr_to_data_micro']:.2e})")
    print(f" instruction reduction{s['instr_reduction']:>14.1f}x")
    print(f" bytes saved by inter-layer layout elision "
          f"{s['elided_bytes']:.3e}")
    return s


if __name__ == "__main__":
    main()
