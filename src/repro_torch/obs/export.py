"""Exporters: Chrome/Perfetto trace.json, Prometheus snapshot, breakdowns.

Chrome trace format (the subset Perfetto/chrome://tracing read):

  * one ``"X"`` (complete) event per finished span -- ``ts``/``dur`` in
    microseconds, ``args`` carrying the span attributes;
  * ``"i"`` (instant) events for zero-duration markers (request submit,
    first token, retire);
  * ``"M"`` metadata events naming the lanes: every distinct span track
    kind becomes a *process* row (``host``, ``request``, ...) and every
    distinct track id a named *thread* lane inside it -- so a serving
    run renders as per-request swimlanes (arrival -> TTFT -> per-tick
    decode spans) under the scheduler's host lane.

``span_breakdown`` post-processes events into "fraction of X inside Y"
numbers (e.g. the share of a decode tick spent inside kernel launches vs
host scheduling) -- the measurement substrate the fusion-aware mapper
autotuning (ROADMAP item 3) consumes.
"""

from __future__ import annotations

import json
from typing import Iterable, Sequence

from repro_torch.obs.trace import SpanEvent, trace


def _lane_ids(events: Sequence[SpanEvent]) -> dict[tuple, tuple[int, int]]:
    """track -> (pid, tid): one pid per track kind, one tid per track."""
    kinds: dict[str, int] = {}
    lanes: dict[tuple, tuple[int, int]] = {}
    tids: dict[str, int] = {}
    for ev in events:
        kind = str(ev.track[0]) if ev.track else "host"
        if kind not in kinds:
            kinds[kind] = len(kinds) + 1
            tids[kind] = 0
        if ev.track not in lanes:
            tids[kind] += 1
            lanes[ev.track] = (kinds[kind], tids[kind])
    return lanes


def _json_safe(attrs: dict) -> dict:
    out = {}
    for k, v in attrs.items():
        if isinstance(v, (str, int, float, bool)) or v is None:
            out[k] = v
        elif isinstance(v, (list, tuple)):
            out[k] = [x if isinstance(x, (str, int, float, bool))
                      else str(x) for x in v]
        else:
            out[k] = str(v)
    return out


def chrome_trace(events: Sequence[SpanEvent] | None = None) -> dict:
    """Build the ``trace.json`` document for a list of span events
    (defaults to the shared tracer's)."""
    if events is None:
        events = trace.events()
    lanes = _lane_ids(events)
    out: list[dict] = []
    # lane naming metadata first: process = track kind, thread = track id
    named_pids: set[int] = set()
    for track, (pid, tid) in sorted(lanes.items(),
                                    key=lambda kv: kv[1]):
        if pid not in named_pids:
            named_pids.add(pid)
            out.append({"ph": "M", "name": "process_name", "pid": pid,
                        "tid": 0, "args": {"name": str(track[0])}})
        label = " ".join(str(p) for p in track)
        out.append({"ph": "M", "name": "thread_name", "pid": pid,
                    "tid": tid, "args": {"name": label}})
    for ev in events:
        pid, tid = lanes[ev.track]
        rec = {"name": ev.name, "cat": str(ev.track[0]),
               "pid": pid, "tid": tid,
               "ts": round(ev.t0_s * 1e6, 3),
               "args": _json_safe({**ev.attrs, "seq": ev.seq,
                                   "depth": ev.depth})}
        if ev.instant:
            rec.update(ph="i", s="t")       # thread-scoped instant
        else:
            rec.update(ph="X", dur=round(ev.dur_s * 1e6, 3))
        out.append(rec)
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str,
                       events: Sequence[SpanEvent] | None = None) -> str:
    with open(path, "w") as f:
        json.dump(chrome_trace(events), f, indent=1)
    return path


def write_metrics_snapshot(path: str, registry=None) -> str:
    """Write the Prometheus text exposition of a registry (defaults to
    the shared ``obs.metrics`` registry)."""
    from repro_torch.obs import metrics as metricslib
    reg = registry if registry is not None else metricslib.REGISTRY
    with open(path, "w") as f:
        f.write(reg.render_prometheus())
    return path


def fault_events(events: Sequence[SpanEvent] | None = None) -> list[dict]:
    """Every event on the ``("fault", kind)`` swimlanes -- injections,
    recoveries, breaker transitions -- as serialisable dicts in time
    order: the chaos-run artifact CI uploads next to the full trace."""
    if events is None:
        events = trace.events()
    out = []
    for ev in sorted(events, key=lambda e: (e.t0_s, e.seq)):
        if ev.track and str(ev.track[0]) == "fault":
            out.append({"name": ev.name,
                        "kind": str(ev.track[1]) if len(ev.track) > 1
                        else "", "t_s": ev.t0_s,
                        **_json_safe(ev.attrs)})
    return out


def write_fault_events(path: str,
                       events: Sequence[SpanEvent] | None = None) -> str:
    with open(path, "w") as f:
        json.dump({"fault_events": fault_events(events)}, f, indent=1)
    return path


def span_breakdown(parent: str, children: Iterable[str],
                   events: Sequence[SpanEvent] | None = None) -> dict:
    """Time inside ``children`` spans as a fraction of ``parent`` spans.

    A child interval counts when it lies inside some parent interval
    (span nesting guarantees containment for genuinely nested work).
    Returns totals plus ``child_frac`` (kernel share) and ``host_frac``
    (the remainder: host scheduling, assembly, bookkeeping).

    A run with nothing to measure -- no parent spans, zero parent time,
    or no child (launch) spans inside them, e.g. an interpreter-only
    trace that never launched a kernel -- returns an *explicit empty
    breakdown*: ``empty=True`` with both fractions 0.0, never a divide
    by zero, a NaN, or a phantom ``host_frac == 1.0`` that would read
    as "the whole window was host time" when nothing was measured.
    """
    if events is None:
        events = trace.events()
    children = set(children)
    parents = [(ev.t0_s, ev.t1_s) for ev in events if ev.name == parent]
    parent_s = sum(t1 - t0 for t0, t1 in parents)
    child_s = 0.0
    n_children = 0
    for ev in events:
        if ev.name not in children:
            continue
        if any(t0 <= ev.t0_s and ev.t1_s <= t1 + 1e-9
               for t0, t1 in parents):
            child_s += ev.dur_s
            n_children += 1
    empty = not parents or parent_s <= 0.0 or n_children == 0
    frac = 0.0 if empty else child_s / parent_s
    return {"parent": parent, "n_parents": len(parents),
            "parent_s": parent_s, "child_s": child_s,
            "n_children": n_children, "empty": empty,
            "child_frac": frac,
            "host_frac": 0.0 if empty else max(0.0, 1.0 - frac)}
