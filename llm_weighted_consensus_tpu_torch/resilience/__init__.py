"""Tail-tolerant fan-out and the serving path's overload guards.

The port's copy of ``llm_weighted_consensus_tpu/resilience/``, each
mechanism its own module with a pure, clock-injectable core:

* ``breaker``   — per-upstream circuit breakers (closed/open/half-open
  over a sliding failure-rate window, keyed by ``api_base|model``);
* ``budget``    — a shared retry budget (token bucket) so the N judges
  of one score request cannot collectively retry-storm an upstream;
* ``hedge``     — hedged requests: after a delay (static, or an
  observed-latency quantile) a backup attempt races the primary and the
  loser is cancelled;
* ``deadline``  — a per-request deadline that flows from the gateway
  through the score fan-out into every chat attempt via a contextvar;
* ``quorum``    — weight-quorum graceful degradation: once enough panel
  weight has voted that the stragglers cannot flip the argmax, they are
  cancelled and the final frame ships with ``degraded: true``;
* ``faults``    — the seeded fault-injection ``Transport`` (``FAULT_PLAN``)
  and the per-judge vote perturbation (``JUDGE_BIAS_PLAN``);
* ``memguard``  — the host memory governor: soft pressure shrinks the
  cache, trace and AIMD budgets, hard pressure sheds new work
  (``shed_reason: "memory"``) and flags ``degraded_mem`` on /readyz;
* ``admission`` — the gateway's admission gate (hard cap, AIMD limit);
* ``watchdog``  — the device dispatch watchdog;
* ``meshfault`` — device fault domains: dispatch-failure
  classification for CUDA errors (transient / persistent / not a device
  fault), the transient-streak and watchdog-overdue escalations, the
  downsize ladder over a mesh (dp halving, tp and sp kept, every rung's
  model and graphs built once at warmup) whose exhaustion hands the work
  to the CPU twin, the recovery probe's upsize, and the seeded
  ``DEVICE_FAULT_PLAN`` injection seam at the batcher's dispatch
  boundary.

Everything is opt-in: a ``ResiliencePolicy`` of ``None`` (the default
everywhere) keeps the clients on their pre-resilience code paths, byte
for byte.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .admission import AdmissionConfig, AdmissionController  # noqa: F401
from .breaker import BreakerConfig, BreakerRegistry, CircuitBreaker  # noqa: F401
from .budget import RetryBudget, current_retry_budget  # noqa: F401
from .deadline import Deadline, current_deadline  # noqa: F401
from .faults import (  # noqa: F401
    FaultInjectionTransport,
    FaultPlan,
    JudgeBiasPlan,
)
from .hedge import HedgePolicy, LatencyTracker  # noqa: F401
from .memguard import MemGuard  # noqa: F401
from .meshfault import (  # noqa: F401
    DeviceFaultPlan,
    InjectedHangError,
    InjectedPersistentError,
    InjectedTransientError,
    MeshFaultManager,
    classify_dispatch_error,
)
from .quorum import QuorumTracker  # noqa: F401
from .watchdog import DeviceWatchdog  # noqa: F401


@dataclass
class ResiliencePolicy:
    """One bundle wired through the client and serving layers.

    Every member defaults to "off"; each feature is gated on its own so
    e.g. breakers can run without hedging.  Counters are plain ints
    mutated only from the chat routes' loop thread; ``snapshot()`` (the
    ``/metrics`` provider, read from a handler thread) copies them.
    """

    breakers: Optional[BreakerRegistry] = None
    hedge: Optional[HedgePolicy] = None
    # retries each score request's fan-out may spend collectively;
    # 0 = unlimited (no budget attached)
    retry_budget_tokens: int = 0
    # fraction of total panel weight that must settle before the
    # quorum early-exit is considered; 0 = disabled
    quorum_fraction: float = 0.0
    # default per-request deadline the gateway applies when the client
    # sends no x-deadline-ms header; 0 = none
    deadline_ms: float = 0.0
    counters: dict = field(default_factory=dict)

    def inc(self, name: str, by: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + by

    def snapshot(self) -> dict:
        out = {"counters": dict(self.counters)}
        if self.breakers is not None:
            out["breakers"] = self.breakers.snapshot()
        if self.hedge is not None and self.hedge.tracker is not None:
            delay = self.hedge.delay_ms_effective()
            # None = quantile config still cold, hedging suppressed
            out["hedge_delay_ms"] = None if delay is None else round(delay, 2)
        return out


__all__ = [
    "AdmissionConfig",
    "AdmissionController",
    "BreakerConfig",
    "BreakerRegistry",
    "CircuitBreaker",
    "Deadline",
    "DeviceFaultPlan",
    "DeviceWatchdog",
    "FaultInjectionTransport",
    "FaultPlan",
    "HedgePolicy",
    "InjectedHangError",
    "InjectedPersistentError",
    "InjectedTransientError",
    "JudgeBiasPlan",
    "LatencyTracker",
    "MemGuard",
    "MeshFaultManager",
    "QuorumTracker",
    "ResiliencePolicy",
    "RetryBudget",
    "classify_dispatch_error",
    "current_deadline",
    "current_retry_budget",
]
