"""Structured span tracer: where inside a tick time actually goes.

The paper's headline numbers are *observability* claims (fetch-stall
fractions, traffic reductions, end-to-end speedups), and ROADMAP item 3
wants to autotune the mapper against *measured* wall clock -- both need
a way to see inside a serving tick.  This tracer is that substrate:

  * **zero-dep**: stdlib only (``time``, ``threading``, ``json`` via the
    exporter) -- importable from every layer without dragging anything
    in;
  * **off by default, near-zero overhead**: ``trace.span(...)`` performs
    one attribute check and returns a shared no-op singleton when
    disabled, so the instrumentation compiled into the scheduler, the
    backends and the kernel launch sites costs nanoseconds per call on
    the untraced hot path (``tests/test_obs.py`` bounds it against a
    decode tick);
  * **nestable + thread-safe**: spans keep a per-thread stack (depth and
    track inherit from the enclosing span) and finished events append
    under one lock with a global sequence number, so the event order is
    deterministic for a deterministic workload;
  * **tracks** give every span a swimlane identity: ``("host", <thread>)``
    by default, ``("request", rid)`` for per-request lifecycle spans --
    the Chrome/Perfetto exporter (``obs.export``) turns tracks into
    pid/tid lanes.

Timestamps are ``time.perf_counter`` seconds relative to the tracer's
origin; they never feed back into any computation, so a traced run's
numerics are bit-identical to an untraced one (asserted end-to-end via
the scheduler's ``state_checksum``).

Usage::

    from repro_torch.obs import trace
    trace.enable()
    with trace.span("decode_tick", n_ready=4) as sp:
        ...
        sp.set(launches=7)
    trace.export_chrome("trace.json")     # via obs.export
"""

from __future__ import annotations

import dataclasses
import threading
import time


@dataclasses.dataclass(frozen=True)
class SpanEvent:
    """One finished span (or instant, when ``dur_s == 0`` and
    ``instant`` is True)."""
    name: str
    track: tuple                      # ("host", <thread name>) | ("request", rid) | ...
    t0_s: float                       # seconds since tracer origin
    dur_s: float
    depth: int                        # nesting depth at entry (0 == top)
    seq: int                          # global completion order
    attrs: dict
    instant: bool = False

    @property
    def t1_s(self) -> float:
        return self.t0_s + self.dur_s

    def key(self) -> tuple:
        """Timing-free identity -- the determinism-regression surface
        (two seeded runs must produce identical key sequences)."""
        return (self.name, self.track, self.depth)


class _NullSpan:
    """Shared disabled-mode span: every method is a no-op."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> "_NullSpan":
        return self

    def __bool__(self) -> bool:
        return False


NULL_SPAN = _NullSpan()


class _Span:
    """A live span; records a SpanEvent on ``__exit__``."""

    __slots__ = ("_tracer", "name", "track", "attrs", "_t0", "_depth")

    def __init__(self, tracer: "Tracer", name: str, track: tuple | None,
                 attrs: dict):
        self._tracer = tracer
        self.name = name
        self.track = track
        self.attrs = attrs

    def set(self, **attrs) -> "_Span":
        """Attach attributes discovered mid-span (wall clock, launch
        counts, VMEM high-water...)."""
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "_Span":
        tracer = self._tracer
        stack = tracer._stack()
        if self.track is None:
            # inherit the enclosing span's lane; top-level spans land on
            # the host lane of their thread
            self.track = (stack[-1].track if stack
                          else ("host", threading.current_thread().name))
        self._depth = len(stack)
        stack.append(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter()
        tracer = self._tracer
        stack = tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        tracer._record(SpanEvent(
            name=self.name, track=self.track,
            t0_s=self._t0 - tracer._origin, dur_s=t1 - self._t0,
            depth=self._depth, seq=0, attrs=self.attrs))
        return False


class Tracer:
    """Process tracer; the module-level :data:`trace` instance is the
    one every instrumented layer shares."""

    def __init__(self):
        self.enabled = False
        self._lock = threading.Lock()
        self._events: list[SpanEvent] = []
        self._seq = 0
        self._origin = time.perf_counter()
        self._tls = threading.local()

    # -- lifecycle ----------------------------------------------------------
    def enable(self) -> "Tracer":
        self.enabled = True
        return self

    def disable(self) -> "Tracer":
        self.enabled = False
        return self

    def clear(self) -> "Tracer":
        with self._lock:
            self._events = []
            self._seq = 0
            self._origin = time.perf_counter()
        return self

    def __enter__(self) -> "Tracer":          # `with trace:` == enable
        return self.enable()

    def __exit__(self, *exc) -> bool:
        self.disable()
        return False

    # -- recording ----------------------------------------------------------
    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _record(self, ev: SpanEvent) -> None:
        with self._lock:
            self._events.append(dataclasses.replace(ev, seq=self._seq))
            self._seq += 1

    def span(self, name: str, track: tuple | None = None, **attrs):
        """Context manager timing a region.  ``track`` pins the span to
        a swimlane (defaults to the enclosing span's lane)."""
        if not self.enabled:
            return NULL_SPAN
        return _Span(self, name, track, attrs)

    def instant(self, name: str, track: tuple | None = None,
                **attrs) -> None:
        """A zero-duration marker (request submit / first token /
        retire)."""
        if not self.enabled:
            return
        stack = self._stack()
        if track is None:
            track = (stack[-1].track if stack
                     else ("host", threading.current_thread().name))
        self._record(SpanEvent(
            name=name, track=track,
            t0_s=time.perf_counter() - self._origin, dur_s=0.0,
            depth=len(stack), seq=0, attrs=attrs, instant=True))

    def record(self, name: str, track: tuple, t0: float, t1: float,
               depth: int = 0, **attrs) -> None:
        """Inject a span with explicit ``perf_counter`` endpoints -- used
        where one collective measurement covers several lanes (a batched
        decode launch recorded onto every participating request's
        swimlane)."""
        if not self.enabled:
            return
        self._record(SpanEvent(
            name=name, track=track, t0_s=t0 - self._origin,
            dur_s=max(0.0, t1 - t0), depth=depth, seq=0, attrs=attrs))

    # -- consumption --------------------------------------------------------
    def events(self) -> list[SpanEvent]:
        with self._lock:
            return list(self._events)

    def keys(self) -> list[tuple]:
        """Timing-free event identities in completion order."""
        return [ev.key() for ev in self.events()]

    def export_chrome(self, path: str) -> str:
        """Write the Chrome/Perfetto ``trace.json`` (see
        :func:`repro_torch.obs.export.write_chrome_trace`)."""
        from repro_torch.obs.export import write_chrome_trace
        return write_chrome_trace(path, self.events())


#: The process-wide tracer every instrumented layer shares.
trace = Tracer()
