"""The fleet coordinator: what the rest of the service talks to.

The score client's front door calls ``begin(fp)`` on a local cache miss
(only the in-process single-flight LEADER ever gets here — in-process
collapse still happens first, so one replica contributes at most one
fleet participant per fingerprint).  The answer is one of:

* ``("hit", chunks)``  — the owner had the entry; replay it locally.
* ``("lease", None)``  — this replica holds the fleet-wide lease: go
  upstream exactly as before the fleet existed, then ``publish`` (or
  ``abandon`` on failure).
* ``("local", None)``  — the fleet cannot help (no roster, owner dead,
  breaker open, deadline nearly spent, lease wait timed out, rosters
  diverged): behave exactly as today.  Every failure path funnels here —
  a broken fleet degrades to N independent replicas, never worse.

Routing is PINNED per request: ``begin`` resolves one ``OwnershipView``
and the matching ``publish``/``abandon`` route through that same view,
so a roster reload between begin and publish cannot send the publish to
a different "owner" than the one holding the lease (which would both
drop the record and strand the real owner's waiters until TTL).

An owner-side waiter does not ride out ``FLEET_LEASE_MILLIS`` when the
remote holder is dead: the wait runs in probe-interval slices, and a
holder whose breaker is open — or that fails a liveness probe — loses
the lease to the waiter (early takeover).  The dead holder's publish,
if it ever arrives, is a LATE publish: the record is still cached, the
current claimant's lease is untouched, and a counter says it happened.

The drain path calls ``handoff(cache)``: the departing replica's
hottest live entries are pushed to the peers that will own them once it
leaves the ring, before ``/readyz`` flips (serve/lifecycle.py).

The port's copy of ``llm_weighted_consensus_tpu/fleet/coordinator.py``.
A coordinator lives on the chat routes' loop: the score client calls
``begin``/``publish``/``abandon`` there, and the drain thread reaches
``handoff`` through ``handlers.FleetRoutes``, which submits it to that
loop.  ``publish`` and ``abandon`` spawn their peer legs as tasks on the
running loop (``_spawn``), fire-and-forget.
"""

from __future__ import annotations

import asyncio
import time
from typing import Dict, Optional, Tuple

from ..resilience.breaker import OPEN
from ..utils import jsonutil
from .client import FleetClient
from .health import PeerHealth
from .leases import LeaseTable
from .membership import FleetConfig, FleetMembership, OwnershipView

# drain-time handoff: at most this many MRU entries leave with us
HANDOFF_MAX_ENTRIES = 256

# drain-time handoff: per-target pushes in flight at once (one dead
# target must not serialize the rest of the drain budget behind it)
HANDOFF_CONCURRENCY = 4

# drain-time handoff: the JSON bytes of one push's entries at most, half
# the default MAX_BODY_BYTES (1 MiB), so a push fits a peer's default
# body cap.  The reference sends a target's whole hot set in one POST,
# which a peer answers 413 once it passes the cap: at bge-large width a
# training-table record carries its 1024-float prompt embedding, and
# twenty-odd records fill a megabyte.  A hot set goes out in as many
# pushes as it needs, each the reference's body (a deliberate
# divergence that keeps the wire format)
HANDOFF_BATCH_BYTES = 512 * 1024


class FleetCoordinator:
    def __init__(
        self,
        config: FleetConfig,
        *,
        membership: Optional[FleetMembership] = None,
        client: Optional[FleetClient] = None,
        leases: Optional[LeaseTable] = None,
        clock=time.monotonic,
    ) -> None:
        self.config = config
        self.membership = membership or FleetMembership(config, clock=clock)
        if client is None:
            fault_plan = None
            if config.fault_plan_spec:
                from .faults import FleetFaultPlan

                fault_plan = FleetFaultPlan.parse(config.fault_plan_spec)
            client = FleetClient(
                self.membership.self_url,
                fetch_timeout_ms=config.fetch_timeout_millis,
                fault_plan=fault_plan,
            )
        self.client = client
        self.leases = leases or LeaseTable(config.lease_millis, clock=clock)
        self.health = PeerHealth(
            config.quarantine_failures,
            config.probe_millis,
            clock=clock,
        )
        if self.health.enabled:
            self.client.health = self.health
        self.clock = clock
        # attached by build_service: the owner-side score cache the
        # /fleet/v1 handlers serve from and publish into
        self.cache = None
        self.peer_hits = 0
        self.peer_misses = 0
        self.peer_errors = 0
        self.local_fallbacks = 0
        self.publishes = 0
        self.abandons = 0
        self.rejected_publishes = 0
        self.ring_divergences = 0
        self.ring_rejects = 0
        self.early_takeovers = 0
        self.handoff_sent = 0
        self.handoff_accepted = 0
        self.handoff_received = 0
        self.handoff_rejected = 0
        # fp -> the OwnershipView its begin() routed on; publish/abandon
        # must route on the SAME ring (the pinning contract)
        self._pinned: Dict[str, OwnershipView] = {}
        # publish/release tasks in flight (kept so GC can't cancel them)
        self._tasks: set = set()

    # -- the front door -------------------------------------------------------

    async def begin(self, fp: str) -> Tuple[str, Optional[list]]:
        try:
            return await self._begin(fp)
        except Exception:
            # the fleet must never break a request
            self.local_fallbacks += 1
            return "local", None

    async def _begin(self, fp: str) -> Tuple[str, Optional[list]]:
        self._apply_quarantine()
        view = self.membership.view()
        owner = view.owner(fp)
        if owner is None:
            self.local_fallbacks += 1
            return "local", None
        if owner == view.self_url:
            return await self._begin_as_owner(fp, view)
        return await self._begin_as_peer(fp, owner, view)

    async def _begin_as_owner(
        self, fp: str, view: OwnershipView
    ) -> Tuple[str, Optional[list]]:
        """We own ``fp``: claim the lease locally; if a remote replica
        holds it, wait for its publish (bounded by the lease TTL and the
        deadline share) — in probe-interval slices, stealing the lease
        early when the holder is provably gone."""
        self_url = view.self_url
        granted, future = self.leases.acquire(fp, self_url)
        if granted:
            self._pinned[fp] = view
            return "lease", None
        deadline = self.clock() + min(
            self.leases.remaining_sec(fp) or self.leases.ttl_sec,
            self._wait_budget_sec(),
        )
        probe_sec = max(0.001, self.config.probe_millis / 1000.0)
        while not future.done():
            remaining = deadline - self.clock()
            if remaining <= 0:
                break
            result = await self.leases.wait(
                future, min(remaining, probe_sec)
            )
            if result is not None or future.done():
                break
            # wait slice timed out with the lease still in flight: is
            # the holder even alive?  Its breaker open (recent transport
            # failures) is verdict enough; otherwise one liveness probe
            # decides.  A dead holder loses the lease NOW instead of at
            # TTL expiry.
            holder = self.leases.holder(fp)
            if holder is None or holder == self_url:
                break
            dead = self.client.breakers.peek(holder, "fleet") == OPEN
            if not dead:
                dead = not await self.client.probe(holder)
            if dead and self.leases.steal(fp, self_url):
                self.early_takeovers += 1
                self._pinned[fp] = view
                return "lease", None
        chunks = self.cache.get(fp) if self.cache is not None else None
        if chunks is not None:
            self.peer_hits += 1
            return "hit", chunks
        # holder abandoned, expired, or we ran out of patience: take the
        # lease ourselves if free, else compute locally without one
        granted, _ = self.leases.acquire(fp, self_url)
        if granted:
            self._pinned[fp] = view
            return "lease", None
        self.local_fallbacks += 1
        return "local", None

    async def _begin_as_peer(
        self, fp: str, owner: str, view: OwnershipView
    ) -> Tuple[str, Optional[list]]:
        status, chunks = await self.client.fetch_entry(
            owner, fp, ring=view.digest
        )
        if status == "hit":
            self.peer_hits += 1
            return "hit", chunks
        if status == "divergent":
            return self._diverged(owner)
        if status == "error":
            self.peer_errors += 1
            self.local_fallbacks += 1
            return "local", None
        self.peer_misses += 1
        lease = await self.client.request_lease(owner, fp, ring=view.digest)
        if lease == "granted":
            self._pinned[fp] = view
            return "lease", None
        if lease == "divergent":
            return self._diverged(owner)
        if lease == "wait":
            status, chunks = await self.client.fetch_entry(
                owner, fp, wait_ms=self.config.lease_millis,
                ring=view.digest,
            )
            if status == "hit":
                self.peer_hits += 1
                return "hit", chunks
            if status == "divergent":
                return self._diverged(owner)
        self.local_fallbacks += 1
        return "local", None

    def _diverged(self, owner: str) -> Tuple[str, Optional[list]]:
        """The peer rejected our ring digest: it routes on a different
        roster (split-brain from staggered peers-file reads).  Degrade
        to local — a duplicate local compute is bounded and correct,
        while trusting a divergent owner's lease table is neither."""
        self.ring_divergences += 1
        self.local_fallbacks += 1
        return "local", None

    def _wait_budget_sec(self) -> float:
        """How long an owner-side waiter may block on a remote holder:
        the lease TTL, clamped to the deadline share the client applies
        to peer legs."""
        from ..resilience.deadline import current_deadline

        from .client import DEADLINE_SHARE

        budget = self.leases.ttl_sec
        deadline = current_deadline()
        if deadline is not None:
            budget = min(budget, deadline.remaining() * DEADLINE_SHARE)
        return max(0.001, budget)

    # -- quarantine -----------------------------------------------------------

    def _apply_quarantine(self) -> None:
        """Fold the health table's verdict into the routing ring and
        kick liveness probes for quarantined peers whose interval is
        up.  Synchronous except for the spawned probes — ``begin`` pays
        a set compare in the steady state."""
        if not self.health.enabled:
            return
        self.membership.set_quarantined(self.health.quarantined())
        for peer in self.health.probes_due():
            self._spawn(self._probe, peer)

    async def _probe(self, peer: str) -> None:
        ok = await self.client.probe(peer)
        self.health.record_probe(peer, ok)
        if ok:
            # the probe is direct evidence of recovery: re-admit the
            # peer to the ring AND close its breaker, or the re-homed
            # keys keep shedding until the cooldown expires anyway
            self.client.breakers.get(peer, "fleet").force_close()
            self.membership.set_quarantined(self.health.quarantined())

    # -- completion -----------------------------------------------------------

    def publish(self, fp: str, chunk_objs: list) -> None:
        """The lease holder's clean result landed in its local cache:
        retire the lease (owner) or push the record to the owner (peer).
        Fire-and-forget — the response stream must not wait on it.
        Routes on the view pinned at ``begin``, never the live ring."""
        self.publishes += 1
        view = self._pinned.pop(fp, None)
        if view is None:
            view = self.membership.view()
        owner = view.owner(fp)
        if owner is None:
            return
        if owner == view.self_url:
            self.leases.publish(fp, view.self_url)
            return
        self._spawn(self.client.publish_entry, owner, fp, chunk_objs)

    def abandon(self, fp: str) -> None:
        """The lease holder failed without a result: release so waiters
        fall back to local compute instead of riding out the TTL."""
        self.abandons += 1
        view = self._pinned.pop(fp, None)
        if view is None:
            view = self.membership.view()
        owner = view.owner(fp)
        if owner is None:
            return
        if owner == view.self_url:
            self.leases.release(fp, view.self_url)
            return
        self._spawn(self.client.release_lease, owner, fp)

    def _spawn(self, coro_fn, *args) -> None:
        """``coro_fn(*args)`` as a task on the running loop, kept until
        done.  With no running loop (teardown, sync test context) the
        coroutine is never created, so nothing leaks a never-awaited
        warning (the reference creates it and closes it; the same
        outcome without a ``close()`` call, which the concurrency
        audit's name-based resolution would wire to every ``close`` in
        the package)."""
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return
        task = loop.create_task(coro_fn(*args))
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    # -- drain ----------------------------------------------------------------

    async def handoff(self, cache) -> int:
        """Push this replica's hottest live entries to their post-drain
        owners.  Returns the number of entries peers accepted; any
        failure is skipped (the fleet re-computes what it must)."""
        if cache is None or not getattr(cache, "enabled", False):
            return 0
        # one reduced post-departure ring for the whole hot set, not an
        # O(peers x vnodes) scan per entry
        view = self.membership.departure_view()
        # target -> its pushes, each [entries, their JSON bytes] under
        # HANDOFF_BATCH_BYTES (an entry larger than that goes alone)
        by_target: dict = {}
        for fp, chunk_objs, ttl_sec in cache.hot_entries(
            HANDOFF_MAX_ENTRIES
        ):
            target = view.owner(fp)
            if target is None or target == self.membership.self_url:
                continue
            entry = {"fp": fp, "chunks": chunk_objs,
                     "ttl_sec": round(ttl_sec, 3)}
            size = len(jsonutil.dumps(entry))
            pushes = by_target.setdefault(target, [])
            if not pushes or (
                pushes[-1][0] and pushes[-1][1] + size > HANDOFF_BATCH_BYTES
            ):
                pushes.append([[], 0])
            pushes[-1][0].append(entry)
            pushes[-1][1] += size
        if not by_target:
            return 0
        semaphore = asyncio.Semaphore(HANDOFF_CONCURRENCY)

        async def push(target: str, entries: list) -> int:
            async with semaphore:
                self.handoff_sent += len(entries)
                try:
                    return await self.client.handoff(target, entries)
                except Exception:
                    return 0

        results = await asyncio.gather(
            *(push(t, entries)
              for t, pushes in by_target.items() for entries, _ in pushes)
        )
        accepted = sum(results)
        self.handoff_accepted += accepted
        return accepted

    async def close(self) -> None:
        for task in list(self._tasks):
            task.cancel()
        await self.client.close()

    # -- observability --------------------------------------------------------

    def stats(self) -> dict:
        return {
            "membership": self.membership.snapshot(),
            "peer_fetch": {
                "hits": self.peer_hits,
                "misses": self.peer_misses,
                "errors": self.peer_errors,
            },
            "leases": self.leases.stats(),
            "local_fallbacks": self.local_fallbacks,
            "publishes": self.publishes,
            "abandons": self.abandons,
            "rejected_publishes": self.rejected_publishes,
            "ring_divergences": self.ring_divergences,
            "ring_rejects": self.ring_rejects,
            "early_takeovers": self.early_takeovers,
            "health": self.health.stats(),
            "handoff": {
                "sent": self.handoff_sent,
                "accepted": self.handoff_accepted,
                "received": self.handoff_received,
                "rejected": self.handoff_rejected,
            },
            "client": self.client.stats(),
        }
