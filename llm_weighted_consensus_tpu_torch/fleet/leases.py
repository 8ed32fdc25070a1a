"""Owner-side cross-replica single-flight leases.

The per-process ``SingleFlight`` (cache/singleflight.py) collapses
identical concurrent requests *inside* one replica; this table is the
same idea at the fleet level, held by the fingerprint's OWNER: the
first claimant — local or a remote replica over ``POST
/fleet/v1/lease/{fp}`` — is granted the lease and goes upstream, every
later claimant waits for the publish instead of fanning out its own
judge calls.  One upstream fan-out per hot fingerprint, fleet-wide.

Unlike the in-process table, a lease here is TTL-bounded: the holder
may be another process that dies mid-flight, and nothing can ``finally:``
on its behalf.  An expired lease is simply re-grantable — the next
claimant computes locally, which is exactly the pre-fleet behavior.
The failure direction is deliberate: a lost lease costs one duplicate
upstream fan-out, never a stuck request.

Single event loop, no locks: every method is synchronous bookkeeping
except ``wait``, which awaits a future with a timeout.  In the port that
loop is the chat routes' (the ``/fleet/v1`` handler threads submit
their work to it), so ``acquire`` and ``steal`` always find a running
loop.  The port's copy of ``llm_weighted_consensus_tpu/fleet/leases.py``.
"""

from __future__ import annotations

import asyncio
import time
from typing import Optional, Tuple


class LeaseTable:
    def __init__(self, ttl_ms: float, *, clock=time.monotonic) -> None:
        self.ttl_sec = max(0.001, ttl_ms / 1000.0)
        self.clock = clock
        # fp -> [holder, expires_at, future]; the future resolves True on
        # publish, None on release/expiry (waiters re-check and fall back)
        self._leases: dict = {}
        self.granted = 0
        self.waits = 0
        self.published = 0
        self.released = 0
        self.expirations = 0
        self.takeovers = 0
        self.late_publishes = 0

    def _expire(self, fp: str, lease: list) -> None:
        del self._leases[fp]
        self.expirations += 1
        if not lease[2].done():
            lease[2].set_result(None)

    def acquire(
        self, fp: str, holder: str
    ) -> Tuple[bool, Optional[asyncio.Future]]:
        """(granted, wait_future): granted means ``holder`` now owns the
        in-flight slot for ``fp`` and must publish or release; otherwise
        the future resolves when the current holder publishes (True) or
        abandons/expires (None)."""
        now = self.clock()
        lease = self._leases.get(fp)
        if lease is not None and lease[1] <= now:
            self._expire(fp, lease)
            lease = None
        if lease is not None:
            if lease[0] == holder:
                # re-claim by the same holder (a retry): extend, keep it
                lease[1] = now + self.ttl_sec
                return True, None
            self.waits += 1
            return False, lease[2]
        future = asyncio.get_running_loop().create_future()
        self._leases[fp] = [holder, now + self.ttl_sec, future]
        self.granted += 1
        return True, None

    def holder(self, fp: str) -> Optional[str]:
        """The live lease's holder URL (lazily expiring), or None."""
        lease = self._leases.get(fp)
        if lease is None:
            return None
        if lease[1] <= self.clock():
            self._expire(fp, lease)
            return None
        return lease[0]

    def steal(self, fp: str, new_holder: str) -> bool:
        """Early takeover: the current holder is believed dead (its
        breaker is open or a liveness probe failed), so the lease moves
        to ``new_holder`` without waiting out the TTL.  Old waiters wake
        to None (fall back to local compute — the safe direction); the
        thief gets a fresh TTL.  False when no live lease exists or
        ``new_holder`` already holds it."""
        lease = self._leases.get(fp)
        now = self.clock()
        if lease is not None and lease[1] <= now:
            self._expire(fp, lease)
            lease = None
        if lease is None or lease[0] == new_holder:
            return False
        if not lease[2].done():
            lease[2].set_result(None)
        future = asyncio.get_running_loop().create_future()
        self._leases[fp] = [new_holder, now + self.ttl_sec, future]
        self.takeovers += 1
        return True

    def holder_future(self, fp: str) -> Optional[asyncio.Future]:
        """The active lease's publish future (long-poll handlers wait on
        it), or None when nothing is in flight."""
        lease = self._leases.get(fp)
        if lease is None:
            return None
        if lease[1] <= self.clock():
            self._expire(fp, lease)
            return None
        return lease[2]

    def remaining_sec(self, fp: str) -> float:
        lease = self._leases.get(fp)
        if lease is None:
            return 0.0
        return max(0.0, lease[1] - self.clock())

    def publish(self, fp: str, holder: Optional[str] = None) -> bool:
        """The holder's result landed (in the owner's cache): wake every
        waiter with success and retire the lease.

        With ``holder`` given, the retire is holder-checked: a LATE
        publish — the lease already expired (or was stolen and
        re-granted to someone else) — must not tear down the *current*
        claimant's lease.  The late result is still worth caching (the
        caller already put it), so it is counted as a reconciliation
        rather than dropped; returns False so the caller can tell.
        ``holder=None`` keeps the legacy unconditional retire (the
        local-owner path, where the process itself held the slot)."""
        lease = self._leases.get(fp)
        if lease is not None and lease[1] <= self.clock():
            self._expire(fp, lease)
            lease = None
        if holder is not None and (lease is None or lease[0] != holder):
            self.late_publishes += 1
            return False
        self._leases.pop(fp, None)
        self.published += 1
        if lease is not None and not lease[2].done():
            lease[2].set_result(True)
        return True

    def release(self, fp: str, holder: str) -> None:
        """The holder abandons without a result (its upstream fan-out
        failed): waiters wake to None and fall back to local compute."""
        lease = self._leases.get(fp)
        if lease is None or lease[0] != holder:
            return
        del self._leases[fp]
        self.released += 1
        if not lease[2].done():
            lease[2].set_result(None)

    async def wait(
        self, future: asyncio.Future, timeout_sec: float
    ) -> Optional[bool]:
        """Await a lease future for at most ``timeout_sec``; None on
        timeout.  Shielded: one waiter's cancellation must not kill the
        shared future other waiters hold."""
        try:
            return await asyncio.wait_for(
                asyncio.shield(future), timeout=max(0.001, timeout_sec)
            )
        except asyncio.TimeoutError:
            return None

    def active(self) -> int:
        now = self.clock()
        return sum(1 for lease in self._leases.values() if lease[1] > now)

    def stats(self) -> dict:
        return {
            "active": self.active(),
            "granted": self.granted,
            "waits": self.waits,
            "published": self.published,
            "released": self.released,
            "expirations": self.expirations,
            "takeovers": self.takeovers,
            "late_publishes": self.late_publishes,
            "ttl_sec": self.ttl_sec,
        }
