"""Hedged requests (Dean & Barroso, *The Tail at Scale*).

The chat client fires its primary attempt; if no first chunk has
arrived after the hedge delay, a single backup attempt is launched
against the *next* endpoint in the attempt matrix and the two race.
The first stream to commit (deliver a good first chunk) wins; the
loser is cancelled and closed.  The delay is either a static
millisecond value or an observed-latency quantile: a ``LatencyTracker``
records every committed attempt's time-to-first-chunk, and once it
holds enough samples the hedge fires at e.g. the p95 — "hedge only
the requests that are already slower than 95 % of their peers", the
paper's 'hedged request' recipe, which bounds extra load at ~(1-q).

The port's copy of ``llm_weighted_consensus_tpu/resilience/hedge.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional


class LatencyTracker:
    """Bounded reservoir of recent latencies with an exact quantile.

    A plain ring of the last ``capacity`` observations: the serving
    path records one sample per committed attempt, so even a busy
    gateway writes a few hundred floats per second — no need for
    P² or t-digest approximations at this volume.
    """

    def __init__(self, capacity: int = 512) -> None:
        self.capacity = max(1, int(capacity))
        self._samples: List[float] = []
        self._next = 0
        self.total = 0

    def record(self, latency_ms: float) -> None:
        if len(self._samples) < self.capacity:
            self._samples.append(float(latency_ms))
        else:
            self._samples[self._next] = float(latency_ms)
            self._next = (self._next + 1) % self.capacity
        self.total += 1

    def __len__(self) -> int:
        return len(self._samples)

    def quantile(self, q: float) -> Optional[float]:
        """Nearest-rank quantile of the reservoir; None when empty."""
        if not self._samples:
            return None
        ordered = sorted(self._samples)
        q = min(1.0, max(0.0, q))
        rank = min(len(ordered) - 1, max(0, int(q * len(ordered) + 0.5) - 1))
        return ordered[rank]


@dataclass
class HedgePolicy:
    """When (and whether) to launch the backup attempt.

    ``delay_ms`` is the static floor; when ``quantile`` is set and the
    tracker has at least ``min_samples`` observations, the observed
    quantile replaces it.  ``delay_ms_effective()`` is what the chat
    client actually waits before hedging.
    """

    delay_ms: float = 0.0
    quantile: float = 0.0  # 0 = static delay only
    min_samples: int = 20
    tracker: LatencyTracker = field(default_factory=LatencyTracker)

    @property
    def enabled(self) -> bool:
        return self.delay_ms > 0 or self.quantile > 0

    def delay_ms_effective(self) -> Optional[float]:
        """Delay before the backup launches, or ``None`` when hedging is
        off for this attempt: a quantile-only config whose reservoir is
        still cold must not fall back to 0 ms — that would hedge *every*
        request (2x upstream load) until the tracker warms up."""
        if self.quantile > 0:
            if len(self.tracker) >= max(1, self.min_samples):
                observed = self.tracker.quantile(self.quantile)
                if observed is not None:
                    return observed
            if self.delay_ms <= 0:
                return None
        return self.delay_ms

    def observe(self, first_chunk_latency_ms: float) -> None:
        self.tracker.record(first_chunk_latency_ms)

    def explain(self) -> dict:
        """Why the hedge fired when it did — stamped on trace spans so a
        surprising backup launch is attributable to the reservoir state
        at decision time."""
        delay = self.delay_ms_effective()
        return {
            "delay_ms_effective": round(delay, 3) if delay is not None else None,
            "quantile": self.quantile,
            "static_delay_ms": self.delay_ms,
            "observations": self.tracker.total,
        }
