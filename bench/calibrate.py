#!/usr/bin/env python3
"""The readings the check's limits are set from, for one cell, in one
process: for each seed, the program's numbers (set-up and a short window
at the cell's own load, then the check's comparison) and, with
``--control``, the control's: the reference put in the program's place
and computed in fp8 (``bench.reference.numerics``), read against the
cell's reference on the same requests.  ``--fault`` plants one of the
faults the check has to catch in the program first (``faults``);
``--witness`` reads the TF32 reference against the fp32 one.  Not run by
the benchmark's own runs.

    python3 bench/calibrate.py --workload <cell> --seeds 11 12 13 \\
        --seconds 5 [--control] [--fault half_batch] [--witness 8] \\
        [--out calibrate.jsonl]

One JSON line a seed, on standard output and appended to ``--out``.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from bench import faults, harness  # noqa: E402


def serve_readings(runner, doc, limits, seed, control: bool,
                   witness: int) -> dict:
    from bench.checks import serve

    t = time.perf_counter()
    out = {c["name"]: c["value"]
           for c in serve.compare(runner, doc, limits, seed)}
    out["check_s"] = time.perf_counter() - t
    if control:
        out.update({f"control_{k}": v for k, v in
                    serve.control(runner, doc, limits, seed).items()})
    if witness:
        out.update(tf32_witness(runner, doc, limits, seed, witness))
    return out


def tf32_witness(runner, doc, limits, seed, n: int) -> dict:
    """The reference with its fp32 products as TF32 against the one in
    fp32, on ``n`` requests drawn as the check draws them (the program's
    routing followed): the widest difference of a served token's
    logits, and the served gap by each."""
    from bench.checks import serve

    prompts, served, routing = next(serve.passes(
        runner, {**limits, "sample": n}, seed))
    out, logits = {}, {}
    for tf32 in (False, True):
        got, _ = serve.reference_logits(runner.weights, doc, prompts, served,
                                        routing=routing, tf32=tf32)
        name = "tf32" if tf32 else "fp32"
        logits[name] = got
        out[f"witness_served_gap_{name}"] = float(
            serve.gaps(got, served).max())
    out["witness_logit_diff"] = float(
        (logits["tf32"] - logits["fp32"]).abs().max())
    out["witness_logit_std"] = float(logits["fp32"].std())
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", choices=sorted(faults.FAULTS), default=None)
    ap.add_argument("--witness", type=int, default=0,
                    help="requests on which to read the TF32 reference "
                    "against the fp32 one")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    harness.cache_dirs()
    import torch

    from bench import adapters, runners

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    files = harness.cell_files(args.workload)
    doc, traffic, limits = files["doc"], files["traffic"], files["limits"]
    cfg = adapters.model_config(doc)
    read = {"serve": serve_readings}[traffic["kind"]]
    for seed in args.seeds:
        t = time.perf_counter()
        runner = runners.for_traffic(traffic).Runner(
            cfg, doc, traffic, seed, "cuda:0", limits.get("pool_calls"))
        with faults.planted(args.fault):
            runner.setup()
            if traffic["kind"] == "serve":
                runner.window(args.seconds)
        runner.release()
        gc.collect()
        line = {"workload": args.workload, "seed": seed,
                "fault": args.fault,
                **read(runner, doc, limits, seed, args.control,
                       args.witness),
                "seconds": time.perf_counter() - t}
        del runner
        gc.collect()
        torch.cuda.empty_cache()
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
