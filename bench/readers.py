"""What the metric readers under ``bench/metrics/`` share.  A reader is
``read(run) -> float | None``: None where the run holds nothing for it
(the harness then leaves the metric out).  ``run`` holds the cell's
configuration file (``doc``), traffic file (``traffic``), the window's
records and seconds, ``setup_s``, and in a traced run ``trace``
(``bench.trace.reduce``'s numbers plus ``window_s``, the traced slice's
length)."""

from __future__ import annotations

import importlib
import statistics

from bench.work import peaks


def model_work(run):
    """The work-count module of the run's configuration."""
    return importlib.import_module(f"bench.work.{run.doc['model_type']}")


def range_share(run, module: str):
    """Device seconds under a module's ranges over the traced slice's
    device busy seconds, in %."""
    tr = run.trace
    if tr is None or tr["busy_s"] <= 0:
        return None
    got = tr["range_s"].get(f"bench.module.{module}")
    return None if got is None else 100.0 * got / tr["busy_s"]


def idle_share(run):
    """The traced slice's seconds with no device operation running, in
    % of its length."""
    tr = run.trace
    if tr is None or tr["window_s"] <= 0 or not tr["device_events"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def roofline(run, op: str, forward=True, backward=False):
    """Sum of the bound seconds of the op's calls over the device seconds
    they took, in %: the forward calls, the backward nodes, or both."""
    tr = run.trace
    if tr is None:
        return None
    parts = ([tr["ops"].get(op)] if forward else []) \
        + ([tr["backward"].get(op)] if backward else [])
    if any(p is None or p["calls"] == 0 for p in parts):
        return None
    device = sum(p["device_s"] for p in parts)
    if device <= 0:
        return None
    return 100.0 * sum(p["bound_s"] for p in parts) / device


def serve_mfu(run):
    """The published model's operations for every request served in the
    window over the window's seconds, in % of the bf16 peak."""
    t = run.traffic
    if not run.records:
        return None
    per = model_work(run).request_flops(run.doc, t["prompt"], t["output"])
    n = sum(r["tokens"].shape[0] for r in run.records)
    return 100.0 * per * n / run.window_s / peaks.BF16_FLOPS


def quantile(values, q: float) -> float:
    """The ``q`` quantile (0 < q < 1) as ``statistics.quantiles`` with
    100 cut points gives it (inclusive)."""
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=100,
                                method="inclusive")[round(q * 100) - 1]
