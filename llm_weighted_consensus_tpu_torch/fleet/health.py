"""Peer health scoring: quarantine a flapping replica, re-admit by probe.

The per-peer circuit breaker (fleet/client.py) already stops *calls*
to a dead peer, but a breaker-open peer still OWNS its ring segment —
every request for its keys pays a shed-and-fallback round trip, and a
flapping peer (up just long enough to half-open the breaker, down
again by the next call) is worse: it oscillates between costing a
timeout and costing nothing.  This module decides *membership*, not
admission: a peer whose recent outcome window shows either a run of
consecutive failures or too many up/down transitions is QUARANTINED —
``FleetMembership.set_quarantined`` removes it from the active ring,
so its keys re-home to healthy replicas and the sick peer costs
nothing per request.

Re-admission is by probe, not by traffic: while quarantined, the peer
receives a liveness GET at most once per ``FLEET_PROBE_MILLIS``; one
success re-admits it (consistent hashing moves only its own keys
back).  Probes are the coordinator's job — this table only says who is
due (``probes_due``) and scores the result (``record_probe``).

Disabled (``FLEET_QUARANTINE_FAILURES=0``) the table is inert: nothing
is ever quarantined and the ring never shrinks, which is exactly the
pre-quarantine fleet.

Single event loop, no locks: every method is synchronous bookkeeping
(on the chat routes' loop).  The port's copy of
``llm_weighted_consensus_tpu/fleet/health.py``.
"""

from __future__ import annotations

import time
from typing import Dict, List

# outcome window per peer: transitions are counted over this many
# most-recent call outcomes
WINDOW = 16

# ok<->fail transitions within the window at or above which the peer is
# declared flapping (even if it never hits the consecutive-failure bar)
FLAP_TRANSITIONS = 6


class PeerHealth:
    def __init__(
        self,
        fail_threshold: int = 3,
        probe_interval_ms: float = 1000.0,
        *,
        clock=time.monotonic,
    ) -> None:
        self.fail_threshold = max(0, int(fail_threshold))
        self.probe_interval_sec = max(0.001, probe_interval_ms / 1000.0)
        self.clock = clock
        self._window: Dict[str, List[bool]] = {}
        self._consecutive_failures: Dict[str, int] = {}
        self._quarantined: Dict[str, float] = {}  # peer -> last probe time
        self.quarantines = 0
        self.readmissions = 0
        self.probes = 0

    @property
    def enabled(self) -> bool:
        return self.fail_threshold > 0

    def record(self, peer: str, ok: bool) -> None:
        """Score one call outcome for ``peer`` (transport-level: did the
        peer answer at all — HTTP status is the breaker's business)."""
        if not self.enabled or peer in self._quarantined:
            return
        window = self._window.setdefault(peer, [])
        window.append(ok)
        if len(window) > WINDOW:
            del window[: len(window) - WINDOW]
        if ok:
            self._consecutive_failures[peer] = 0
        else:
            self._consecutive_failures[peer] = (
                self._consecutive_failures.get(peer, 0) + 1
            )
        transitions = sum(
            1 for a, b in zip(window, window[1:]) if a != b
        )
        if (
            self._consecutive_failures[peer] >= self.fail_threshold
            or transitions >= FLAP_TRANSITIONS
        ):
            # quarantine; first probe is due one full interval later
            self._quarantined[peer] = self.clock()
            self._window.pop(peer, None)
            self._consecutive_failures.pop(peer, None)
            self.quarantines += 1

    def quarantined(self) -> List[str]:
        return sorted(self._quarantined)

    def probes_due(self) -> List[str]:
        """Quarantined peers whose probe interval has elapsed.  Stamps
        them probed NOW, so concurrent callers never double-probe."""
        now = self.clock()
        due = []
        for peer, last in self._quarantined.items():
            if now - last >= self.probe_interval_sec:
                self._quarantined[peer] = now
                due.append(peer)
        return due

    def record_probe(self, peer: str, ok: bool) -> None:
        """Score a liveness probe: one success re-admits the peer (its
        ring segment moves back); a failure leaves it quarantined until
        the next interval."""
        self.probes += 1
        if ok and peer in self._quarantined:
            del self._quarantined[peer]
            self.readmissions += 1

    def stats(self) -> dict:
        return {
            "enabled": self.enabled,
            "quarantined": self.quarantined(),
            "quarantines": self.quarantines,
            "readmissions": self.readmissions,
            "probes": self.probes,
        }
