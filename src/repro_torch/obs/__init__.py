"""Telemetry spine: structured tracing, a metrics registry, exporters.

One observability layer shared by the scheduler, the executables, the
ProgramCache, both backends and the kernel launch sites:

  trace     the process span tracer (``repro_torch.obs.trace``) -- off by
            default, near-zero overhead when disabled, nestable and
            thread-safe; spans carry a *track* that becomes a
            Chrome/Perfetto swimlane (per-request lanes for serving)
  metrics   the process counter/gauge registry (``repro_torch.obs.metrics``)
            -- MINISA vs micro instruction bytes, fetch-stall fractions,
            cache tier hits, KV pool high-water, kernel launches, all
            behind one labelled namespace with a Prometheus-style text
            snapshot
  export    ``chrome_trace``/``write_chrome_trace`` (Perfetto
            timelines), ``write_metrics_snapshot`` (Prometheus text),
            ``span_breakdown`` (fraction-of-tick-inside-kernels numbers
            for the mapper-autotuning work)

Quick start::

    from repro_torch import obs
    obs.trace.enable()
    report = scheduler.run()              # spans + metrics accumulate
    obs.write_chrome_trace("trace.json")
    obs.write_metrics_snapshot("metrics.prom")
    report.timeline()                     # spans joined to requests

Tracing never feeds back into computation: a traced run's per-request
``state_checksum``s are bit-identical to an untraced run on every
backend (CI gates on this).
"""

from repro_torch.obs import metrics  # noqa: F401
from repro_torch.obs.export import (chrome_trace, span_breakdown,  # noqa: F401
                              write_chrome_trace,
                              write_metrics_snapshot)
from repro_torch.obs.metrics import Registry  # noqa: F401
from repro_torch.obs.trace import SpanEvent, Tracer, trace  # noqa: F401

__all__ = [
    "trace", "Tracer", "SpanEvent", "metrics", "Registry",
    "chrome_trace", "write_chrome_trace", "write_metrics_snapshot",
    "span_breakdown",
]
