"""Fleet membership and consistent-hash ownership.

The roster is a list of replica base URLs (including this replica's
own ``FLEET_SELF``), either static (``FLEET_PEERS``) or read from a
file re-checked on mtime change (``FLEET_PEERS_FILE`` — one URL per
line, ``#`` comments).  Ownership of a cache fingerprint is decided by
a classic consistent-hash ring: each peer contributes ``vnodes``
points (xxh3-64 over ``"url#i"``), a key maps to the first point
clockwise from its own hash, and adding or removing one peer moves
only the keys that peer owned — the property that makes elastic
scale-out and the drain-time hot-set handoff cheap.

Ownership is consumed through immutable ``OwnershipView`` snapshots,
stamped with a **ring epoch** (monotonic per process, bumped on every
ring rebuild) and a **ring digest** (xxh3 over the sorted roster — the
cross-process fingerprint two replicas can compare).  A request pins
ONE view at ``begin`` and routes every later leg (lease, publish,
abandon) through it, so a roster reload mid-request cannot misroute
the publish to a different "owner" than the one holding the lease.
The digest rides every peer call as ``x-fleet-ring``; a mismatch means
the two replicas are operating on different rosters (split-brain from
staggered peers-file reads) and the caller degrades to local instead
of silently double-hitting upstream.

Quarantine (fleet/health.py decides *who*) removes a sick peer from
the ACTIVE ring — ownership is recomputed without it, so a flapping
replica costs one probe instead of a timeout per request.  The digest
deliberately covers only the configured roster, never the quarantine
set: quarantine is local knowledge, and folding it into the digest
would make every replica's ring look divergent the moment one of them
noticed a sick peer.

Hashing is xxh3 (the identity layer's function family, here the port's
own XXH3-64, bit-equal to the ``xxhash`` package's), NOT Python's
``hash()``: ring positions must agree across processes — and with the
reference's replicas — and ``hash()`` is salted per process by
PYTHONHASHSEED.  The port's copy of
``llm_weighted_consensus_tpu/fleet/membership.py``; a membership object
lives on the chat routes' loop like the rest of the fleet.
"""

from __future__ import annotations

import bisect
import os
import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from ..identity.xxh3 import xxh3_64_hexdigest, xxh3_64_intdigest


def _point(label: str) -> int:
    return xxh3_64_intdigest(label.encode("utf-8"))


@dataclass
class FleetConfig:
    """Parsed FLEET_* knobs (serve/config.py ``fleet_config()``)."""

    self_url: str
    peers: List[str] = field(default_factory=list)
    peers_file: Optional[str] = None
    vnodes: int = 64
    lease_millis: float = 10000.0
    fetch_timeout_millis: float = 2000.0
    fault_plan_spec: Optional[str] = None
    quarantine_failures: int = 3
    probe_millis: float = 1000.0


class OwnershipView:
    """One immutable ring snapshot: every routing decision a single
    request makes (owner at begin, publish target, abandon target) must
    come from the SAME view, so membership churn between those calls
    cannot split them across two rosters."""

    __slots__ = ("self_url", "peers", "epoch", "digest", "_points", "_owners")

    def __init__(
        self,
        self_url: str,
        peers: Tuple[str, ...],
        epoch: int,
        digest: str,
        vnodes: int,
    ) -> None:
        self.self_url = self_url
        self.peers = peers
        self.epoch = epoch
        self.digest = digest
        points = []
        for peer in peers:
            for i in range(max(1, vnodes)):
                points.append((_point(f"{peer}#{i}"), peer))
        points.sort()
        self._points = [h for h, _ in points]
        self._owners = [p for _, p in points]

    def owner(self, fp: str) -> Optional[str]:
        """The replica owning ``fp`` in this snapshot, or None with an
        empty ring."""
        if not self._points:
            return None
        i = bisect.bisect_right(self._points, _point(fp))
        if i == len(self._points):
            i = 0
        return self._owners[i]

    def owns(self, fp: str) -> bool:
        return self.owner(fp) == self.self_url


class FleetMembership:
    """The roster + ring.  Pure computation plus an optional lazy file
    re-read; called only from tasks on the fleet's event loop."""

    # peers-file mtime is re-checked at most this often (seconds)
    RELOAD_INTERVAL_SEC = 1.0

    def __init__(
        self,
        config: FleetConfig,
        *,
        clock=time.monotonic,
    ) -> None:
        self.config = config
        self.self_url = config.self_url.rstrip("/")
        self.clock = clock
        self.reloads = 0
        self.epoch = 0
        self._file_mtime: Optional[float] = None
        self._last_check = 0.0
        self._quarantined: set = set()
        self._view: Optional[OwnershipView] = None
        self._departure_view: Optional[OwnershipView] = None
        peers = list(config.peers)
        if config.peers_file:
            loaded = self._read_peers_file()
            if loaded is not None:
                peers = loaded
        self._set_peers(peers)

    # -- roster ---------------------------------------------------------------

    def _read_peers_file(self) -> Optional[List[str]]:
        """The peers file's roster, or None when unreadable (the caller
        keeps the previous roster: a transiently missing file must not
        empty the fleet)."""
        path = self.config.peers_file
        try:
            mtime = os.stat(path).st_mtime
            with open(path, encoding="utf-8") as f:
                lines = f.readlines()
        except OSError:
            return None
        self._file_mtime = mtime
        peers = []
        for line in lines:
            line = line.strip()
            if line and not line.startswith("#"):
                peers.append(line)
        return peers

    def _set_peers(self, peers: List[str]) -> None:
        self._peers = sorted({p.rstrip("/") for p in peers if p})
        self._rebuild()

    def _rebuild(self) -> None:
        """Recompute the active ring (roster minus quarantined peers —
        never this replica itself) and bump the epoch.  Views are
        rebuilt lazily: a rebuild between two requests costs nothing
        until someone routes."""
        self.epoch += 1
        self._view = None
        self._departure_view = None

    def ring_digest(self) -> str:
        """The cross-process roster fingerprint: two replicas reading
        the same peers file agree on it byte-for-byte.  Covers the
        CONFIGURED roster only (see module docstring on quarantine)."""
        label = "|".join(self._peers) + f"#v{self.config.vnodes}"
        return xxh3_64_hexdigest(label.encode("utf-8"))

    def _active_peers(self) -> Tuple[str, ...]:
        return tuple(
            p
            for p in self._peers
            if p == self.self_url or p not in self._quarantined
        )

    def view(self) -> OwnershipView:
        """The current pinned-ownership snapshot (cached until the next
        ring rebuild)."""
        self._maybe_reload()
        if self._view is None:
            self._view = OwnershipView(
                self.self_url,
                self._active_peers(),
                self.epoch,
                self.ring_digest(),
                self.config.vnodes,
            )
        return self._view

    def departure_view(self) -> OwnershipView:
        """The ring as it looks once this replica leaves — the
        drain-time handoff router, built ONCE per rebuild instead of
        the old O(peers×vnodes) scan per entry."""
        self._maybe_reload()
        if self._departure_view is None:
            peers = tuple(
                p for p in self._active_peers() if p != self.self_url
            )
            self._departure_view = OwnershipView(
                self.self_url,
                peers,
                self.epoch,
                self.ring_digest(),
                self.config.vnodes,
            )
        return self._departure_view

    def _maybe_reload(self) -> None:
        if not self.config.peers_file:
            return
        now = self.clock()
        if now - self._last_check < self.RELOAD_INTERVAL_SEC:
            return
        self._last_check = now
        try:
            mtime = os.stat(self.config.peers_file).st_mtime
        except OSError:
            return
        if mtime == self._file_mtime:
            return
        loaded = self._read_peers_file()
        if loaded is not None:
            self._set_peers(loaded)
            self.reloads += 1

    @property
    def peers(self) -> List[str]:
        self._maybe_reload()
        return list(self._peers)

    # -- quarantine -----------------------------------------------------------

    def set_quarantined(self, sick) -> None:
        """Install the health layer's verdict.  Only a CHANGE rebuilds
        the ring (and bumps the epoch) — steady state is a set compare."""
        sick = {s.rstrip("/") for s in sick}
        sick.discard(self.self_url)
        if sick == self._quarantined:
            return
        self._quarantined = sick
        self._rebuild()

    def quarantined(self) -> List[str]:
        return sorted(self._quarantined)

    # -- ownership ------------------------------------------------------------

    def owner(self, fp: str) -> Optional[str]:
        """The replica owning ``fp``, or None with an empty ring."""
        return self.view().owner(fp)

    def owns(self, fp: str) -> bool:
        return self.owner(fp) == self.self_url

    def owner_excluding_self(self, fp: str) -> Optional[str]:
        """Where ``fp`` lands once this replica leaves the ring — the
        drain-time handoff target.  None when no other peer exists."""
        return self.departure_view().owner(fp)

    def owned_share(self, samples: int = 256) -> float:
        """Estimated fraction of the key space this replica owns
        (deterministic probe points; surfaced in /readyz + metrics)."""
        view = self.view()
        if not view._points:
            return 0.0
        owned = sum(
            1
            for i in range(samples)
            if view.owner(f"fleet-share-probe:{i}") == self.self_url
        )
        return owned / float(samples)

    def snapshot(self) -> dict:
        return {
            "self": self.self_url,
            "peers": self.peers,
            "owned_share": round(self.owned_share(), 4),
            "vnodes": self.config.vnodes,
            "roster_reloads": self.reloads,
            "epoch": self.epoch,
            "ring": self.ring_digest(),
            "quarantined": self.quarantined(),
        }
