"""Runtime fault injection + the tolerance primitives the scheduler uses.

Three pieces:

  :class:`FaultInjector`   executes a :class:`~repro_torch.faults.plan.FaultPlan`
                           against a live run: the scheduler drives it
                           tick by tick (``begin_tick`` returns the due
                           scheduler-level events; launch windows arm
                           internally) and every injected / recovered /
                           skipped fault is counted, metered
                           (``faults_injected_total`` /
                           ``recoveries_total`` counters) and traced
                           onto a dedicated ``("fault", kind)`` swimlane.
  :class:`FaultyBackend`   a transparent wrapper over any ``Backend``:
                           each scheduler-visible launch entry point
                           consults the injector once and either raises
                           :class:`TransientLaunchError` (the launch
                           never happened) or poisons the finished
                           output with NaNs (the silent-corruption
                           case).  With no armed window the wrapper is a
                           delegating no-op.
  :class:`CircuitBreaker`  closed -> open after ``threshold`` consecutive
                           failures; half-open probe after ``cooldown``
                           ticks; one success closes it again.  The
                           scheduler consults it before admitting work
                           to the backend.

Everything here is deterministic: the injector consumes the plan's
windows in tick/launch order, so a seeded chaos run replays exactly.
"""

from __future__ import annotations

import dataclasses
import hashlib
import pickle

import numpy as np
import torch

from repro_torch.faults.plan import LAUNCH_KINDS, FaultEvent, FaultPlan
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.trace import trace


class FaultError(RuntimeError):
    """Base class of every injected (and injector-recognised) fault."""


class TransientLaunchError(FaultError):
    """An injected launch failure: the kernel never ran, no state was
    committed, and an identical retry is expected to succeed."""


class PoisonedOutputError(FaultError):
    """A launch completed but produced non-finite values (caught by the
    scheduler's finite guard before anything reaches the KV cache)."""


def check_finite(arr) -> bool:
    """True when every element of ``arr`` (a tensor or an array) is
    finite (the post-launch numeric guard; NaN/Inf mean the output must
    not be committed)."""
    if isinstance(arr, torch.Tensor):
        return bool(torch.isfinite(arr).all())
    return bool(np.isfinite(np.asarray(arr, np.float32)).all())


class CircuitBreaker:
    """Consecutive-failure breaker over one site (the serving backend).

    closed     everything flows.
    open       ``allow`` is False until ``cooldown`` ticks after the trip
               -- the scheduler stops re-admitting work to the site.
    half-open  one probe is allowed; success closes, failure re-opens.
    """

    def __init__(self, threshold: int = 4, cooldown: int = 8):
        self.threshold = max(1, threshold)
        self.cooldown = max(1, cooldown)
        self.state = "closed"
        self.failures = 0            # consecutive
        self.opened_at = 0
        self.opens = 0

    def allow(self, tick: int) -> bool:
        if self.state == "closed":
            return True
        if tick - self.opened_at >= self.cooldown:
            self.state = "half_open"   # one probe through
            return True
        return False

    def record_failure(self, tick: int) -> None:
        self.failures += 1
        if self.state == "half_open" or self.failures >= self.threshold:
            if self.state != "open":
                self.opens += 1
                trace.instant("breaker_open", ("fault", "breaker"),
                              tick=tick, failures=self.failures)
            self.state = "open"
            self.opened_at = tick

    def record_success(self) -> None:
        self.failures = 0
        if self.state != "closed":
            trace.instant("breaker_close", ("fault", "breaker"))
        self.state = "closed"

    def stats(self) -> dict:
        return {"state": self.state, "opens": self.opens,
                "consecutive_failures": self.failures}


@dataclasses.dataclass
class _Window:
    """One armed launch-fault window (fires once per tick while active)."""
    event: FaultEvent
    fired_tick: int = -1

    def active(self, tick: int) -> bool:
        return (self.event.at_tick <= tick
                < self.event.at_tick + self.event.duration)


class FaultInjector:
    """Executes a FaultPlan against a live serving run."""

    def __init__(self, plan: FaultPlan, registry=None):
        self.plan = plan
        self.registry = (registry if registry is not None
                         else obs_metrics.REGISTRY)
        self.tick = 0
        self.injected: dict[str, int] = {}
        self.recovered: dict[str, int] = {}
        self.skipped: dict[str, int] = {}
        self._windows = [_Window(e) for e in plan.events
                         if e.kind in LAUNCH_KINDS]

    # -- the scheduler's tick hook -------------------------------------------
    def begin_tick(self, tick: int) -> tuple[FaultEvent, ...]:
        """Advance the injector clock; launch windows arm internally,
        scheduler-level events (array_down / kv_exhaust / cache_corrupt)
        are returned for the caller to apply."""
        self.tick = tick
        return tuple(e for e in self.plan.due(tick)
                     if e.kind not in LAUNCH_KINDS)

    # -- the backend wrapper's per-launch hook -------------------------------
    def launch_outcome(self) -> str | None:
        """Consulted once per guarded backend call: ``"transient"`` /
        ``"nan"`` while an armed window covers the current tick, None
        otherwise.  EVERY guarded launch of a covered tick gets the
        outcome -- the seam models "the backend is bad this tick", and
        chained streams keep interior state on-chip, so corrupting only
        one interior transfer would be invisible to the host.  The
        injection ledger still counts once per window per tick."""
        for w in self._windows:
            if w.active(self.tick):
                if w.fired_tick != self.tick:
                    w.fired_tick = self.tick
                    self.mark_injected(w.event.kind)
                return ("transient" if w.event.kind == "launch_transient"
                        else "nan")
        return None

    def wrap(self, backend) -> "FaultyBackend":
        return FaultyBackend(backend, self)

    # -- accounting ----------------------------------------------------------
    def mark_injected(self, kind: str, **attrs) -> None:
        self.injected[kind] = self.injected.get(kind, 0) + 1
        self.registry.counter(
            "faults_injected_total", "injected faults by kind").inc(
                1, kind=kind)
        trace.instant("fault", ("fault", kind), tick=self.tick, **attrs)

    def mark_recovered(self, kind: str, **attrs) -> None:
        self.recovered[kind] = self.recovered.get(kind, 0) + 1
        self.registry.counter(
            "recoveries_total", "recovered faults by kind").inc(
                1, kind=kind)
        trace.instant("recovery", ("fault", kind), tick=self.tick, **attrs)

    def mark_skipped(self, kind: str) -> None:
        """An event that was due but not applicable (e.g. ``array_down``
        on a single-array run) -- recorded, never counted as injected."""
        self.skipped[kind] = self.skipped.get(kind, 0) + 1

    def unrecovered(self) -> int:
        """Injected faults with no matching recovery (per kind, clamped
        -- extra recoveries never mask another kind's miss).  The chaos
        gate requires this to be zero."""
        kinds = set(self.injected) | set(self.recovered)
        return sum(max(0, self.injected.get(k, 0)
                       - self.recovered.get(k, 0)) for k in kinds)

    def summary(self) -> dict:
        return {"plan": self.plan.name, "seed": self.plan.seed,
                "injected": dict(self.injected),
                "recovered": dict(self.recovered),
                "skipped": dict(self.skipped),
                "unrecovered": self.unrecovered()}

    # -- disk corruption (the cache_corrupt seam) ----------------------------
    def corrupt_cache_file(self, path: str) -> bool:
        """Corrupt one persisted ProgramCache entry in place.

        The persisted payload keeps each entry as (pickled blob, sha256);
        flipping bytes inside a seeded entry's blob leaves the outer
        payload readable, so the next load exercises the *per-entry*
        integrity path: checksum mismatch -> quarantine -> miss.  Falls
        back to truncating the file (the torn-write shape) when the
        payload doesn't parse.  Returns True when something was
        corrupted."""
        rng = np.random.default_rng(self.plan.seed * 7_919 + self.tick)
        try:
            with open(path, "rb") as f:
                payload = pickle.load(f)
            tiers = payload.get("tiers", {})
            candidates = [(t, i) for t, entries in sorted(tiers.items())
                          for i in range(len(entries))]
            if not candidates:
                raise ValueError("no entries to corrupt")
            tier, idx = candidates[int(rng.integers(0, len(candidates)))]
            blob, digest = tiers[tier][idx]
            flipped = bytearray(blob)
            pos = int(rng.integers(0, max(1, len(flipped))))
            flipped[pos] ^= 0xFF
            tiers[tier][idx] = (bytes(flipped), digest)
            with open(path, "wb") as f:
                pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
            return True
        except FaultError:
            raise
        except Exception:
            try:   # torn-write shape: drop the tail of the file
                with open(path, "rb") as f:
                    data = f.read()
                if not data:
                    return False
                with open(path, "wb") as f:
                    f.write(data[:max(1, len(data) // 2)])
                return True
            except OSError:
                return False


def _entry_digest(blob: bytes) -> str:
    """The per-entry content checksum the disk tier carries (shared with
    ``runtime.cache`` so inject/verify can never drift apart)."""
    return hashlib.sha256(blob).hexdigest()


class FaultyBackend:
    """Injection wrapper over any Backend: delegates everything, guarding
    the scheduler-visible launch entry points.

    One guard per call (a fused segment is one launch, a batched
    attention sweep is one launch), matching what ``Backend.n_launches``
    counts on the compiled backend.  Attribute access (``outputs``,
    ``n_launches``, ``reset`` ...) passes through, so schedulers and
    executables treat the wrapper exactly like the wrapped instance.
    """

    def __init__(self, inner, injector: FaultInjector):
        self._inner = inner
        self._injector = injector

    # -- guard ---------------------------------------------------------------
    def _guard(self, fn, out_name, *args, **kwargs):
        outcome = self._injector.launch_outcome()
        if outcome == "transient":
            raise TransientLaunchError(
                f"injected transient launch failure at tick "
                f"{self._injector.tick}")
        out = fn(*args, **kwargs)
        if outcome == "nan":
            out = self._poison(out, out_name)
        return out

    @staticmethod
    def _poison(out, out_name):
        """NaN-poison the launch's result (dict entry or raw array) --
        the injected copy never aliases backend state, mirroring a
        corrupted transfer of the real output."""
        if isinstance(out, dict):
            if out_name is not None and out_name in out:
                out = dict(out)
                out[out_name] = torch.full_like(out[out_name], float("nan"))
            return out
        return torch.full_like(out, float("nan"))

    # -- guarded launch entry points -----------------------------------------
    def run_program(self, program, tensors=None):
        return self._guard(self._inner.run_program,
                           getattr(program, "out_name", None),
                           program, tensors)

    def run_segment(self, segment, tensors=None):
        return self._guard(self._inner.run_segment,
                           getattr(segment, "out_name", None),
                           segment, tensors)

    def run_batched_attention(self, programs, q, kT, v, lengths=None):
        return self._guard(self._inner.run_batched_attention, None,
                           programs, q, kT, v, lengths=lengths)

    def run_batched_attention_proj(self, programs, q, kT, v, wo, *,
                                   m_out, k_out, lengths=None):
        return self._guard(self._inner.run_batched_attention_proj, None,
                           programs, q, kT, v, wo, m_out=m_out,
                           k_out=k_out, lengths=lengths)

    def run_sharded(self, sharded, tensors=None):
        return self._guard(self._inner.run_sharded,
                           getattr(sharded, "out_name", None),
                           sharded, tensors)

    # -- passthrough ---------------------------------------------------------
    def __getattr__(self, name):
        return getattr(self._inner, name)

    def __repr__(self) -> str:  # pragma: no cover
        return f"FaultyBackend({self._inner!r})"
