"""``/fleet/v1/*``: the owner-side HTTP surface, on the stdlib server.

Routes (all replica-to-replica; admission-exempt like the probe
endpoints — each call is bounded, cheap, and sheds itself via the
propagated deadline rather than occupying an admission slot):

* ``GET    /fleet/v1/entry/{fp}``  — the cached record, or 404.  With
  ``?wait_ms=N`` the owner long-polls its lease table first, so a
  waiter picks up the publish in one round trip.
* ``PUT    /fleet/v1/entry/{fp}``  — a lease holder publishes its
  result: the record is re-validated by the wire-side replay admission
  guard (fleet/wire.py) before it may enter the owner's cache; a dirty
  record is refused with 422 and the lease is released so waiters fall
  back to local compute.
* ``POST   /fleet/v1/lease/{fp}``  — claim the cross-replica
  single-flight lease; ``{"granted": bool, "ttl_ms"}``.
* ``DELETE /fleet/v1/lease/{fp}``  — abandon a held lease.
* ``POST   /fleet/v1/handoff``     — a draining replica pushes its hot
  set; every entry passes the same wire guard, and the remaining TTL
  rides along so a handed-off entry can never outlive its original
  lifetime.
* ``GET    /fleet/v1/ping``        — liveness, for quarantine
  re-admission probes.

Entry GET and lease POST additionally check the caller's
``x-fleet-ring`` digest against the local roster and answer 409 on a
mismatch — a split-brain caller must degrade to local, not be handed a
lease decision made on a different ring.

The port's counterpart of ``llm_weighted_consensus_tpu/fleet/handlers.py``
(``register_fleet_routes`` on aiohttp), with the same paths, bodies and
statuses, and one deliberate divergence: **no lease over a cached
entry**.  The reference's lease POST grants a fresh lease whenever none
is in flight, so a peer whose entry fetch missed just before the
owner's publish, and whose lease claim lands just after it, is granted
a second upstream fan-out for a fingerprint the owner already holds.
Here a lease POST for a fingerprint the owner's cache holds answers
``{"granted": false}``: the peer takes its ``wait`` branch, whose
long-poll fetch finds the entry at once.  The wire format is unchanged,
so a reference replica accepts the answer.

Threads and the loop: the stdlib server answers each request on its own
thread, while the fleet's state (the coordinator, its lease table and
its membership) lives on the chat routes' event loop.  ``FleetRoutes``
is the bridge: each route's coroutine is submitted to that loop with
the request's deadline activated in its own context (the long-poll's
clamp reads it), and the handler thread blocks on the answer, never the
loop.  The metrics provider, ``/readyz``'s membership snapshot and the
drain's handoff cross over the same way.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional
from urllib.parse import parse_qs, unquote

from ..resilience.deadline import current_deadline
from ..utils import jsonutil
from .wire import clean_chunk_objs

log = logging.getLogger("lwc.torch.fleet")

# a long-poll may hold the connection at most this long regardless of
# what the caller asked for (connection hygiene, not a semantic bound)
MAX_WAIT_MS = 30000.0

PREFIX = "/fleet/v1/"

# (method, path template) of every route -> its ``FleetRoutes`` method;
# the templates are the series names /metrics observes them under (the
# reference's matched-route canonical names)
ROUTES = {
    ("GET", "/fleet/v1/ping"): "_ping",
    ("GET", "/fleet/v1/entry/{fp}"): "_entry_get",
    ("PUT", "/fleet/v1/entry/{fp}"): "_entry_put",
    ("POST", "/fleet/v1/lease/{fp}"): "_lease_post",
    ("DELETE", "/fleet/v1/lease/{fp}"): "_lease_delete",
    ("POST", "/fleet/v1/handoff"): "_handoff_post",
}

INTERNAL_ERROR = {"code": 500, "message": "internal server error"}


def _read_body(raw: bytes) -> dict:
    try:
        obj = jsonutil.loads(raw.decode("utf-8")) if raw else None
    except ValueError:
        return {}
    return obj if isinstance(obj, dict) else {}


def match(method: str, path: str):
    """``(template, fp)`` of a fleet route, or None.  ``{fp}`` is one
    path segment, percent-decoded, as aiohttp matches it."""
    if not path.startswith(PREFIX):
        return None
    for m, template in ROUTES:
        if m != method:
            continue
        if "{fp}" not in template:
            if path == template:
                return template, None
            continue
        head = template[: -len("{fp}")]
        rest = path[len(head):] if path.startswith(head) else ""
        if rest and "/" not in rest:
            return template, unquote(rest)
    return None


class FleetRoutes:
    """The ``/fleet/v1`` routes of one coordinator, and the bridge from
    the server's threads to the loop (``serve/chat_routes.EventLoop``)
    the coordinator lives on."""

    def __init__(self, fleet, loop) -> None:
        self.fleet = fleet
        self.loop = loop

    # -- the thread -> loop bridge --------------------------------------------

    def _run(self, coro, timeout: Optional[float] = None):
        return self.loop.submit(coro).result(timeout)

    def call(self, fn):
        """``fn()`` run on the fleet's loop (a read of loop-confined
        state from another thread)."""

        async def run():
            return fn()

        return self._run(run())

    def stats(self) -> dict:
        """The ``fleet`` section of ``/metrics``."""
        return self.call(self.fleet.stats)

    def membership_snapshot(self) -> dict:
        """The ``fleet`` object of ``/readyz``."""
        return self.call(self.fleet.membership.snapshot)

    def handoff_hot_set(self, timeout_s: float) -> int:
        """The drain's step 0: push the hot set of the coordinator's
        cache to its post-drain owners within ``timeout_s``; the count
        accepted, 0 on any failure (the fleet re-computes what it
        must)."""

        async def run():
            return await asyncio.wait_for(
                self.fleet.handoff(self.fleet.cache), timeout=timeout_s
            )

        try:
            return self._run(run())
        except Exception:
            return 0

    def close(self, timeout: float = 5.0) -> None:
        """Cancel the coordinator's fire-and-forget peer legs (a second
        close, after the loop is gone, has nothing left to cancel)."""
        if self.loop.loop.is_closed():
            return
        try:
            self._run(self.fleet.close(), timeout)
        except Exception:
            log.exception("fleet close failed")

    # -- serving --------------------------------------------------------------

    def serve(self, method: str, template: str, fp, query: str, headers,
              raw: bytes, deadline):
        """(status, body obj) of one fleet request (``match``'s route),
        answered on the loop with ``deadline`` (the request's
        ``x-deadline-ms``, or the server's default) active there."""
        route = getattr(self, ROUTES[(method, template)])
        ring = headers.get("x-fleet-ring")

        async def run():
            if deadline is not None:
                deadline.activate()
            return await route(fp, query, ring, raw)

        try:
            return self._run(run())
        except Exception:
            log.exception("fleet route failed: %s %s", method, template)
            return 500, INTERNAL_ERROR

    # -- the routes (coroutines on the loop) ------------------------------------

    def _ring_mismatch(self, claimed):
        """A 409 when the caller's ``x-fleet-ring`` digest disagrees
        with ours — the two replicas are routing on different rosters.
        Enforced only on the calls that CAUSE duplicate upstream work
        when misrouted (entry fetch, lease claim); publish, release and
        handoff stay digest-blind on purpose: a draining or lagging
        replica's results and abandons are still valid, and rejecting an
        abandon would strand waiters until TTL."""
        if claimed is None:
            return None
        fleet = self.fleet
        ours = fleet.membership.ring_digest()
        if claimed == ours:
            return None
        fleet.ring_rejects += 1
        return 409, {
            "kind": "ring_divergence",
            "ring": ours,
            "epoch": fleet.membership.epoch,
        }

    async def _ping(self, fp, query, ring, raw):
        # the quarantine re-admission probe target: answering at all is
        # the signal, the body is a courtesy
        return 200, {"ok": True, "self": self.fleet.membership.self_url}

    async def _entry_get(self, fp, query, ring, raw):
        mismatch = self._ring_mismatch(ring)
        if mismatch is not None:
            return mismatch
        fleet = self.fleet
        cache = fleet.cache
        record = cache.get(fp) if cache is not None else None
        if record is None:
            wait_ms = 0.0
            try:
                wait_ms = float(parse_qs(query).get("wait_ms", ["0"])[0])
            except ValueError:
                pass
            wait_ms = min(max(0.0, wait_ms), MAX_WAIT_MS)
            future = fleet.leases.holder_future(fp) if wait_ms else None
            if future is not None:
                timeout = min(
                    wait_ms / 1000.0,
                    fleet.leases.remaining_sec(fp) or wait_ms / 1000.0,
                )
                deadline = current_deadline()
                if deadline is not None:
                    timeout = min(timeout, max(0.0, deadline.remaining()))
                await fleet.leases.wait(future, timeout)
                record = cache.get(fp) if cache is not None else None
        if record is None:
            return 404, {"found": False}
        return 200, {"found": True, "chunks": record}

    async def _entry_put(self, fp, query, ring, raw):
        fleet = self.fleet
        body = _read_body(raw)
        holder = str(body.get("holder", ""))
        chunks = clean_chunk_objs(body.get("chunks"))
        if chunks is None:
            # dirty or corrupt record: never enters the cache, and the
            # lease is released so waiters stop hoping for it
            fleet.rejected_publishes += 1
            fleet.leases.release(fp, holder)
            return 422, {"accepted": False}
        if fleet.cache is not None:
            fleet.cache.put_chunks(fp, chunks)
        # holder-aware retire: a LATE publish (lease expired or stolen
        # while the holder was partitioned away) still lands in the
        # cache — the work is done, wasting it helps no one — but must
        # not tear down the CURRENT claimant's lease
        retired = fleet.leases.publish(fp, holder if holder else None)
        return 200, {"accepted": True, "retired": retired}

    async def _lease_post(self, fp, query, ring, raw):
        mismatch = self._ring_mismatch(ring)
        if mismatch is not None:
            return mismatch
        fleet = self.fleet
        body = _read_body(raw)
        holder = str(body.get("holder", "")) or "unknown-peer"
        if fleet.cache is not None and fleet.cache.holds(fp):
            # the lease guard (a deliberate divergence, module
            # docstring): the answer already exists here, so the
            # claimant waits — its long-poll fetch returns the entry at
            # once — instead of fanning out upstream a second time
            granted = False
        else:
            granted, _ = fleet.leases.acquire(fp, holder)
        return 200, {
            "granted": granted,
            "ttl_ms": fleet.leases.ttl_sec * 1000.0,
        }

    async def _lease_delete(self, fp, query, ring, raw):
        body = _read_body(raw)
        holder = str(body.get("holder", ""))
        self.fleet.leases.release(fp, holder)
        return 200, {"released": True}

    async def _handoff_post(self, fp, query, ring, raw):
        fleet = self.fleet
        body = _read_body(raw)
        entries = body.get("entries")
        if not isinstance(entries, list):
            return 400, {"accepted": 0}
        accepted = 0
        for entry in entries:
            if not isinstance(entry, dict):
                continue
            fp = entry.get("fp")
            chunks = clean_chunk_objs(entry.get("chunks"))
            try:
                ttl_sec = float(entry.get("ttl_sec", 0))
            except (TypeError, ValueError):
                ttl_sec = 0.0
            if not isinstance(fp, str) or chunks is None or ttl_sec <= 0:
                fleet.handoff_rejected += 1
                continue
            if fleet.cache is not None:
                # the remaining lifetime travels with the entry: a
                # handed-off record expires exactly when the original
                # would have
                fleet.cache.put_chunks(fp, chunks, ttl_sec=ttl_sec)
            fleet.leases.publish(fp)
            accepted += 1
        fleet.handoff_received += accepted
        return 200, {"accepted": accepted}
