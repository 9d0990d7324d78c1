"""Counter/gauge registry: the repo's ad-hoc stats behind one namespace.

Before this module every layer kept its own dict: ``SchedulerReport``
summaries, ``CacheStats``, ``KVPool.stats()``, ``Backend.n_launches``,
``perf.PerfResult`` breakdowns.  The registry gives them one shared,
labelled home -- ``obs.metrics`` -- with a Prometheus-style text
exposition, so a serving run's MINISA/micro byte counters, fetch-stall
fractions, cache tier hits and KV pool high-water all scrape from one
snapshot.

Two instrument kinds (deliberately minimal -- this is a reproduction's
telemetry spine, not a client library):

  Counter   monotonically accumulating (``inc``); bytes, launches, hits
  Gauge     last-write-wins (``set``; ``high`` keeps the max); stall
            fractions, high-water marks, entry counts

Both are labelled: ``counter("cache_events_total").inc(1, tier="plan",
kind="hit")`` keeps one value per label set.  Metric updates are a dict
lookup plus an add under a lock -- sub-microsecond, so even the kernel
launch sites count unconditionally (a launch costs milliseconds); the
bulk ``publish_metrics`` bridges run at report granularity.

The module-level functions operate on :data:`REGISTRY`, the process
default that ``obs.metrics`` exposes.
"""

from __future__ import annotations

import threading


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


def _label_str(key: tuple) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}"


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._values: dict[tuple, float] = {}

    def value(self, **labels) -> float:
        return self._values.get(_label_key(labels), 0.0)

    def items(self) -> list[tuple[tuple, float]]:
        with self._lock:
            return sorted(self._values.items())

    def clear(self) -> None:
        with self._lock:
            self._values = {}


class Counter(_Metric):
    kind = "counter"

    def inc(self, value: float = 1.0, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[_label_key(labels)] = float(value)

    def high(self, value: float, **labels) -> None:
        """High-water semantics: keep the maximum seen."""
        key = _label_key(labels)
        with self._lock:
            self._values[key] = max(self._values.get(key, float("-inf")),
                                    float(value))


class Registry:
    """Named metrics; registration is idempotent per (name, kind)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}

    def _get(self, cls, name: str, help: str) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help)
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{m.kind}, not {cls.kind}")
            if help and not m.help:
                m.help = help
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def set_many(self, mapping: dict, *, prefix: str = "",
                 **labels) -> None:
        """Bulk-publish a stats dict as gauges (non-numeric values are
        skipped) -- the bridge from the existing ``.stats()`` /
        ``.summary()`` dicts into the registry."""
        for key, value in mapping.items():
            if isinstance(value, bool) or not isinstance(value,
                                                         (int, float)):
                continue
            self.gauge(prefix + key).set(float(value), **labels)

    def snapshot(self) -> dict[str, dict[str, float]]:
        """name -> {label string ('' for unlabelled) -> value}."""
        with self._lock:
            metrics = list(self._metrics.values())
        return {m.name: {_label_str(k): v for k, v in m.items()}
                for m in metrics}

    def render_prometheus(self) -> str:
        """Prometheus text exposition format, deterministic order."""
        with self._lock:
            metrics = sorted(self._metrics.values(),
                             key=lambda m: m.name)
        lines: list[str] = []
        for m in metrics:
            items = m.items()
            if not items:
                continue
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for key, value in items:
                lines.append(f"{m.name}{_label_str(key)} {value:g}")
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        """Zero every metric, KEEPING registrations: instrumented
        modules hold their Counter/Gauge handles at import time (e.g.
        the backend's launch counter), so dropping the objects would
        silently detach them from future snapshots."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            m.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._metrics)


#: The process-wide registry ``obs.metrics`` exposes.
REGISTRY = Registry()


def counter(name: str, help: str = "") -> Counter:
    return REGISTRY.counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return REGISTRY.gauge(name, help)


def set_many(mapping: dict, *, prefix: str = "", **labels) -> None:
    REGISTRY.set_many(mapping, prefix=prefix, **labels)


def snapshot() -> dict[str, dict[str, float]]:
    return REGISTRY.snapshot()


def render_prometheus() -> str:
    return REGISTRY.render_prometheus()


def reset() -> None:
    REGISTRY.reset()
