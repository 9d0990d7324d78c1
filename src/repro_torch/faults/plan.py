"""FaultPlan: a seeded, deterministic script of what fails, and when.

MINISA's thesis is that the *hardware* control path stops being the
fragile part; this package makes the *serving* stack prove the same
property under injected failure.  A :class:`FaultPlan` is a value object
-- a tuple of :class:`FaultEvent` entries pinned to scheduler ticks --
so a chaos run is exactly as reproducible as a fault-free one: the same
(plan seed, scheduler seed) pair replays the identical failure sequence,
and the recovery machinery can be regression-tested bit-for-bit
(``RequestReport.state_checksum`` against the fault-free trajectory).

Fault kinds, one per seam the runtime exposes:

  ``launch_transient``  a backend launch raises (the kernel never ran);
                        armed for ``duration`` ticks from ``at_tick``,
                        failing the first guarded launch of each tick in
                        the window.  A long window models a wedged
                        backend (deadline/timeout territory).
  ``launch_nan``        a backend launch *completes* but its output is
                        NaN/Inf-poisoned -- the silent-corruption case
                        the scheduler's finite guard must catch before
                        anything reaches the KV cache.
  ``array_down``        logical array ``site`` of the ArrayMesh goes
                        unhealthy: the scheduler fails over to a
                        degraded mesh (re-lowering in-flight programs).
  ``kv_exhaust``        a page-pressure spike: ``pages`` KV pages vanish
                        from the pool for ``duration`` ticks (admission
                        must stall, never crash).
  ``cache_corrupt``     the ProgramCache's persisted disk tier is
                        corrupted in place (one entry's bytes flipped);
                        the next load must quarantine, count a miss and
                        re-derive -- never raise mid-serve.

The module holds no injection machinery -- see ``faults.inject`` for the
runtime side (injector, backend wrapper, circuit breaker).
"""

from __future__ import annotations

import dataclasses

#: Every fault kind a plan may carry (order is the display order).
FAULT_KINDS = ("launch_transient", "launch_nan", "array_down",
               "kv_exhaust", "cache_corrupt")

#: Kinds armed as per-tick launch windows (consumed by the backend
#: wrapper) rather than applied once by the scheduler.
LAUNCH_KINDS = ("launch_transient", "launch_nan")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scripted failure.

    ``at_tick`` is the scheduler tick the event becomes due (tick
    numbering starts at 1, matching ``SchedulerReport.ticks``).
    ``site`` is the array index for ``array_down`` and unused otherwise;
    ``duration`` is the window length in ticks for launch faults and
    ``kv_exhaust``; ``pages`` the spike size for ``kv_exhaust`` (0 ==
    "everything free", the worst case)."""

    kind: str
    at_tick: int
    site: int = 0
    duration: int = 1
    pages: int = 0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(one of {FAULT_KINDS})")
        if self.at_tick < 1:
            raise ValueError(f"at_tick must be >= 1, got {self.at_tick}")
        if self.duration < 1:
            raise ValueError(f"duration must be >= 1, got {self.duration}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An immutable, seeded failure script.

    Equality is structural, so two plans built from the same seed compare
    equal -- the determinism surface ``tests/test_faults.py`` regresses.
    """

    events: tuple[FaultEvent, ...] = ()
    seed: int = 0
    name: str = "faultplan"

    def __post_init__(self):
        # events sort by (tick, kind) so iteration order never depends on
        # construction order
        object.__setattr__(
            self, "events",
            tuple(sorted(self.events,
                         key=lambda e: (e.at_tick, FAULT_KINDS.index(e.kind),
                                        e.site))))

    def due(self, tick: int) -> tuple[FaultEvent, ...]:
        """Events that become due exactly at ``tick``."""
        return tuple(e for e in self.events if e.at_tick == tick)

    def counts(self) -> dict[str, int]:
        out = {k: 0 for k in FAULT_KINDS}
        for e in self.events:
            out[e.kind] += 1
        return out

    @property
    def last_tick(self) -> int:
        return max((e.at_tick + e.duration for e in self.events), default=0)

    def summary(self) -> dict:
        return {"name": self.name, "seed": self.seed,
                "n_events": len(self.events), "counts": self.counts(),
                "last_tick": self.last_tick,
                "events": [dataclasses.asdict(e) for e in self.events]}

    # -- constructors --------------------------------------------------------
    @staticmethod
    def from_seed(seed: int, *, n_events: int = 6, n_ticks: int = 12,
                  n_arrays: int = 1, kinds: tuple[str, ...] | None = None,
                  name: str | None = None) -> "FaultPlan":
        """A random-but-reproducible plan: ``n_events`` draws over
        ``kinds`` (defaults to every kind applicable to ``n_arrays``)
        spread over ticks ``[1, n_ticks]``.  Same seed, same plan --
        byte-for-byte."""
        import numpy as np

        if kinds is None:
            kinds = tuple(k for k in FAULT_KINDS
                          if k != "array_down" or n_arrays > 1)
        rng = np.random.default_rng(seed)
        events = []
        for _ in range(n_events):
            kind = kinds[int(rng.integers(0, len(kinds)))]
            tick = int(rng.integers(1, max(2, n_ticks + 1)))
            dur = int(rng.integers(1, 4)) if kind != "cache_corrupt" else 1
            site = (int(rng.integers(1, n_arrays))
                    if kind == "array_down" and n_arrays > 1 else 0)
            pages = int(rng.integers(0, 4)) if kind == "kv_exhaust" else 0
            events.append(FaultEvent(kind=kind, at_tick=tick, site=site,
                                     duration=dur, pages=pages))
        return FaultPlan(events=tuple(events), seed=seed,
                         name=name or f"seeded-{seed}")

    @staticmethod
    def standard(seed: int = 0, *, n_arrays: int = 2) -> "FaultPlan":
        """The CI chaos plan: at least one of every fault kind, early
        enough that a short serving run exercises every recovery path
        (array failover at tick 2, a transient launch window at 3, a KV
        page spike over 4-6, a NaN-poisoned launch at 5 and a disk-tier
        corruption at 6)."""
        events = [
            FaultEvent("launch_transient", at_tick=3, duration=1),
            FaultEvent("launch_nan", at_tick=5, duration=1),
            FaultEvent("kv_exhaust", at_tick=4, duration=3, pages=0),
            FaultEvent("cache_corrupt", at_tick=6),
        ]
        if n_arrays > 1:
            events.append(FaultEvent("array_down", at_tick=2, site=1))
        return FaultPlan(events=tuple(events), seed=seed,
                         name=f"standard-{seed}")
