"""One run of one cell: set-up, the measured window, the traced slice
(``--trace 1``), the check, the result line.

Everything a cell needs is found by name: its entry in ``BENCHMARK.json``
(configuration, traffic, chips), the configuration file the entry names,
``bench/traffic/<traffic>.json``, ``bench/workloads/<cell>.json`` (what
the check samples and its limits) and, for each metric the cell reports,
``bench/metrics/<metric>.py``.  The mapping of a configuration onto the
port (``bench/adapters/<model_type>.py``), its plain reference
(``bench/reference/<model_type>.py``), its work counts
(``bench/work/<model_type>.py``), the traffic's runner
(``bench/runners/<kind>.py``) and its check (``bench/checks/<kind>.py``)
are found by the files' own keys.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "bench"
#: top-level modules no run may hold: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def parse(argv):
    ap = argparse.ArgumentParser(description="one run of one cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(name: str, spec: dict | None = None) -> dict:
    """The cell's entry and files: {"cell", "doc", "traffic", "limits",
    "metrics": [metric entries it reports, end-to-end then per-layer]}."""
    spec = spec or load_json(ROOT / "BENCHMARK.json")
    cells = {c["name"]: c for c in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no cell {name!r} in BENCHMARK.json")
    cell = cells[name]
    config = next(c for c in spec["configs"] if c["name"] == cell["config"])

    def mine(m):
        return "workloads" not in m or name in m["workloads"]
    return {"cell": cell, "doc": load_json(ROOT / config["file"]),
            "traffic": load_json(BENCH / "traffic"
                                 / f"{cell['traffic']}.json"),
            "limits": load_json(BENCH / "workloads" / f"{name}.json"),
            "end_to_end": [m for m in spec["end_to_end"] if mine(m)],
            "per_layer": [m for m in spec["per_layer"] if mine(m)]}


def metric_module(metric: str):
    """``bench/metrics/<metric>.py``: its ``read``, and the module ranges
    (``MODULES``) and kernel ops (``OPS``) a traced slice needs for it."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench.metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """``bench/metrics/<metric>.py``'s ``read``."""
    return metric_module(metric).read


def forbidden_modules(names=None) -> list[str]:
    """Top-level names of ``names`` (the loaded modules by default) that
    no run may hold, each compared whole."""
    return sorted({m.split(".")[0] for m in (sys.modules if names is None
                                              else names)}
                  & set(FORBIDDEN))


def cache_dirs() -> None:
    """The build and kernel caches at fixed paths inside the checkout
    (the port builds its kernels into ``src/repro_torch/kernels/_build``
    itself)."""
    cache = BENCH / ".cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def card_info(log) -> None:
    """The card's name, power limit and clocks (``nvidia-smi``)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,temperature.gpu,power.draw",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        out = f"nvidia-smi: {exc}"
    log(f"card: {out} (name, power limit, sm clock, max sm clock, "
        f"temperature, draw)")


def measure(files: dict, seed: int, seconds: float, trace: bool, device,
            t0: float, log=print) -> dict:
    """One run of the cell in ``files`` on ``device``; returns the
    result's fields and the numbers compared (``checks``)."""
    import torch

    from bench import adapters, checks, runners
    from bench import trace as tr

    doc, traffic, limits = files["doc"], files["traffic"], files["limits"]
    cfg = adapters.model_config(doc)
    runner = runners.for_traffic(traffic).Runner(
        cfg, doc, traffic, seed, device, limits.get("pool_calls"))
    runner.setup()
    sync(device)
    setup_s = time.perf_counter() - t0
    window_s = runner.window(seconds)
    sync(device)
    records = list(runner.records)
    on_card = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    traced = None
    if trace:
        wanted = [metric_module(m["name"]) for m in files["per_layer"]]
        modules = {k: v for mod in wanted
                   for k, v in getattr(mod, "MODULES", {}).items()}
        ops = {op for mod in wanted for op in getattr(mod, "OPS", ())}
        with tr.Spans(runner.model, modules, ops) as spans, \
                tr.profiled() as prof:
            ta = time.perf_counter()
            runner.traced_slice()
            sync(device)
            tb = time.perf_counter()
        tc = time.perf_counter()
        traced = tr.reduce(prof, spans)
        traced["window_s"] = tb - ta
        del prof
        log(f"traced slice {tb - ta:.3f} s, the profiler stopped in "
            f"{tc - tb:.3f} s, read in {time.perf_counter() - tc:.3f} s "
            f"({traced['device_events']} device operations)")
    runner.records = records
    attempted, failed = runner.counts()
    run = types.SimpleNamespace(doc=doc, traffic=traffic, records=records,
                                window_s=window_s, setup_s=setup_s,
                                trace=traced)
    metrics = {}
    for m in files["per_layer" if trace else "end_to_end"]:
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    log(f"window: {window_s:.3f} s, {attempted} attempted, {failed} "
        f"failed; set-up {setup_s:.3f} s; peak {peak / 2**30:.2f} GiB")
    for line in runner.notes():
        log(line)
    runner.release()
    gc.collect()
    tc = time.perf_counter()
    compared = checks.for_traffic(traffic).compare(runner, doc, limits, seed)
    log(f"check: {time.perf_counter() - tc:.3f} s")
    out = {"correct": bool(attempted > 0 and failed == 0 and all(
               c["value"] <= c["limit"] for c in compared)),
           "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": {"platform": "gpu" if on_card else "cpu",
                      "kind": (torch.cuda.get_device_name(device)
                               if on_card else "cpu"),
                      "count": files["cell"]["chips"],
                      "memory_peak_bytes": peak}}
    if traced is not None:
        out["device"]["busy_s"] = traced["busy_s"]
        out["device"]["window_s"] = traced["window_s"]
        out["breakdown"] = traced["breakdown"]
        log(f"trace: {json.dumps({k: traced[k] for k in ('ops', 'backward', 'range_s')})}")
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                     for c in compared}
    return out


def main(argv, t0: float) -> int:
    args = parse(argv)

    def log(line):
        print(line, file=sys.stderr, flush=True)
    cache_dirs()
    files = cell_files(args.workload)
    import torch

    chips = files["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"{args.workload}: needs {chips} CUDA device(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
            f"{torch.cuda.device_count()} found: no measurement")
        return 3
    card_info(log)
    out = measure(files, args.seed, args.seconds, bool(args.trace), "cuda:0",
                  t0, log)
    bad = forbidden_modules()
    if bad:
        log(f"these modules were loaded and may not be: {bad}")
        return 4
    card_info(log)
    for name, c in out["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(out), flush=True)
    return 0
