"""Per-upstream circuit breakers (Nygard, *Release It!*).

One breaker per (api_base, model) pair — the unit the chat client's
attempt matrix iterates — with the classic three states:

* CLOSED     — requests flow; outcomes land in a sliding window of the
  last ``window`` attempts.  When the window holds at least
  ``min_samples`` outcomes and the failure rate reaches ``threshold``,
  the breaker opens.
* OPEN       — requests are refused without touching the upstream until
  ``cooldown_ms`` has elapsed, at which point the next ``allow()``
  transitions to half-open.
* HALF_OPEN  — a bounded number of probe requests (``half_open_probes``)
  is let through; one success closes the breaker (window reset), one
  failure re-opens it for a fresh cooldown.  A probe whose attempt is
  cancelled or ends without a verdict must hand its slot back via
  ``release_probe()`` so the breaker can probe again.

The clock is injectable so the state machine is testable without
sleeping; nothing here is async — callers sequence ``allow`` /
``record_*`` from the event loop.

The port's copy of ``llm_weighted_consensus_tpu/resilience/breaker.py``
(the chat routes' one loop thread is the only caller).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, Optional

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


@dataclass
class BreakerConfig:
    # failure-rate in (0, 1] that opens the breaker; <= 0 disables
    threshold: float = 0.5
    # sliding window size (attempt outcomes remembered)
    window: int = 20
    # outcomes required before the rate is meaningful (Nygard's
    # "volume threshold": 1 failure out of 1 must not open anything)
    min_samples: int = 5
    # how long an open breaker refuses before probing
    cooldown_ms: float = 5000.0
    # concurrent probes admitted while half-open
    half_open_probes: int = 1


class CircuitBreaker:
    def __init__(
        self,
        config: BreakerConfig,
        *,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.config = config
        self.clock = clock
        self.state = CLOSED
        self._outcomes: deque = deque(maxlen=max(1, config.window))
        self._opened_at = 0.0
        self._probes_in_flight = 0
        self.opened_total = 0

    # -- gating ---------------------------------------------------------------

    def allow(self) -> bool:
        """May an attempt proceed?  Transitions OPEN -> HALF_OPEN once the
        cooldown has elapsed; the admitting call claims a probe slot."""
        if self.state == CLOSED:
            return True
        if self.state == OPEN:
            elapsed_ms = (self.clock() - self._opened_at) * 1000.0
            if elapsed_ms < self.config.cooldown_ms:
                return False
            self.state = HALF_OPEN
            self._probes_in_flight = 0
        # HALF_OPEN: bounded probes
        if self._probes_in_flight >= self.config.half_open_probes:
            return False
        self._probes_in_flight += 1
        return True

    # -- outcome recording ----------------------------------------------------

    def record_success(self) -> None:
        if self.state == HALF_OPEN:
            # one healthy probe closes the breaker with a fresh window
            self.state = CLOSED
            self._outcomes.clear()
            self._probes_in_flight = 0
            return
        self._outcomes.append(True)

    def record_failure(self) -> None:
        if self.state == HALF_OPEN:
            self._trip()
            return
        self._outcomes.append(False)
        if self.state == CLOSED and self._failure_rate_trips():
            self._trip()

    def force_close(self) -> None:
        """Close the breaker on out-of-band evidence of recovery (the
        fleet's liveness probe answered while the breaker was open).
        Fresh window — the failures that opened it belong to the
        incident that just ended, not to the recovered peer.  Named
        ``force_close`` (not ``reset``) so the concurrency auditor's
        name-based call resolution can't conflate it with other
        ``reset`` methods (QualityAggregator.reset is lock-guarded)."""
        self.state = CLOSED
        self._outcomes.clear()
        self._probes_in_flight = 0

    def release_probe(self) -> None:
        """Return a probe slot claimed by ``allow()`` without recording an
        outcome — the attempt was cancelled (hedge loser, quorum early-exit,
        client disconnect) or ended neutrally (our deadline expired before
        the upstream answered).  Without this, a cancelled half-open probe
        would strand its slot and the breaker would reject forever."""
        if self.state == HALF_OPEN and self._probes_in_flight > 0:
            self._probes_in_flight -= 1

    def _failure_rate_trips(self) -> bool:
        cfg = self.config
        if cfg.threshold <= 0:
            return False
        n = len(self._outcomes)
        if n < max(1, cfg.min_samples):
            return False
        failures = sum(1 for ok in self._outcomes if not ok)
        return failures / n >= cfg.threshold

    def _trip(self) -> None:
        self.state = OPEN
        self._opened_at = self.clock()
        self._outcomes.clear()
        self._probes_in_flight = 0
        self.opened_total += 1

    # -- observability --------------------------------------------------------

    def snapshot(self) -> dict:
        return {
            "state": self.state,
            "window": list(self._outcomes).count(False),
            "samples": len(self._outcomes),
            "opened_total": self.opened_total,
        }

    def describe(self) -> str:
        """One-token state summary for trace attributes — cheap enough to
        stamp on every attempt span (``snapshot()`` walks the window)."""
        if self.state == HALF_OPEN:
            return f"half_open:{self._probes_in_flight}"
        return self.state


class BreakerRegistry:
    """Breakers keyed by ``api_base|model`` — the attempt-matrix unit.

    Unknown keys lazily create a CLOSED breaker, so the registry needs no
    upfront knowledge of the endpoint list (ctx handlers may rewrite it
    per request)."""

    def __init__(
        self,
        config: BreakerConfig,
        *,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.config = config
        self.clock = clock
        self._breakers: Dict[str, CircuitBreaker] = {}

    @staticmethod
    def key(api_base: str, model: str) -> str:
        return f"{api_base}|{model}"

    def get(self, api_base: str, model: str) -> CircuitBreaker:
        key = self.key(api_base, model)
        breaker = self._breakers.get(key)
        if breaker is None:
            breaker = CircuitBreaker(self.config, clock=self.clock)
            self._breakers[key] = breaker
        return breaker

    def snapshot(self) -> dict:
        return {
            key: breaker.snapshot()
            for key, breaker in sorted(self._breakers.items())
        }

    def peek(self, api_base: str, model: str) -> Optional[str]:
        """The breaker's current state, or None when no attempt ever
        touched this key.  Read-only: an observer (e.g. the fleet's
        lease-liveness check asking "is the holder's breaker open?")
        must not lazily materialize breakers it never drives."""
        breaker = self._breakers.get(self.key(api_base, model))
        return breaker.state if breaker is not None else None
