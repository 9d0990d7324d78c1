"""Fault injection + fault tolerance for the serving runtime.

``plan``    the seeded, deterministic failure script (value objects).
``inject``  the runtime side: injector, backend wrapper, breaker.

See the README's "Resilience" section for the fault model and how the
scheduler recovers from each kind.
"""

from repro_torch.faults.inject import (CircuitBreaker, FaultError, FaultInjector,
                                 FaultyBackend, PoisonedOutputError,
                                 TransientLaunchError, check_finite)
from repro_torch.faults.plan import (FAULT_KINDS, LAUNCH_KINDS, FaultEvent,
                               FaultPlan)

__all__ = [
    "FAULT_KINDS", "LAUNCH_KINDS", "FaultEvent", "FaultPlan",
    "FaultInjector", "FaultyBackend", "CircuitBreaker",
    "FaultError", "TransientLaunchError", "PoisonedOutputError",
    "check_finite",
]
