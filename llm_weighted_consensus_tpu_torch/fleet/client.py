"""The peer-to-peer HTTP surface, guarded by the resilience stack.

Every call a replica makes to a peer (entry fetch, lease claim/release,
publish, drain handoff) goes through here, and every call:

* injects the ambient ``traceparent`` (obs/propagate.py) so the
  cross-replica hop appears as one stitched span tree;
* clamps its timeout to the propagated request deadline
  (resilience/deadline.py) — a peer leg may spend at most HALF the
  remaining budget, so the local-compute fallback always has time left
  to actually run (the "sheds instead of blocking" contract);
* forwards the clamped budget as ``x-deadline-ms`` so the peer's own
  deadline middleware bounds any server-side long-poll;
* rides a per-peer circuit breaker (resilience/breaker.py): a dead or
  flapping owner stops costing a connect timeout per request within a
  few attempts, and the fleet degrades to N independent replicas.

Failures never propagate: every method returns a "treat the fleet as
absent" value and the caller falls back to today's local behavior.

The port's copy of ``llm_weighted_consensus_tpu/fleet/client.py``
without ``aiohttp`` (the card's machine has none): each peer call is one
HTTP/1.1 exchange over ``asyncio.open_connection`` (``_http_call``), as
``clients/chat.py``'s ``StdlibTransport`` talks to the judges, with a
JSON body, ``connection: close`` and one total timeout for the whole
exchange (connect, send, head and body).
"""

from __future__ import annotations

import asyncio
from typing import List, Optional, Tuple
from urllib.parse import urlsplit

from ..obs import propagate
from ..resilience.breaker import BreakerConfig, BreakerRegistry
from ..resilience.deadline import current_deadline
from ..utils import jsonutil
from . import faults as fleet_faults
from .wire import clean_chunk_objs

# a peer leg may consume at most this fraction of the remaining request
# deadline (the rest is reserved for the local-compute fallback)
DEADLINE_SHARE = 0.5

# per-peer breaker: open after repeated transport failures, probe again
# a few seconds later; deliberately NOT configurable per knob — the
# fleet either reaches a peer or routes around it
_BREAKER = BreakerConfig(
    threshold=0.5, window=10, min_samples=3, cooldown_ms=3000.0
)


class PeerCallError(Exception):
    """A peer call failed below HTTP (refused, reset, malformed)."""


async def _exchange(method: str, url: str, headers: dict,
                    body: Optional[bytes]):
    """One HTTP/1.1 request on a fresh connection: (status, content
    type, body bytes).  The peer (the port's stdlib server, or the
    reference's aiohttp one) answers with a content-length."""
    from ..clients.chat import _read_head

    parts = urlsplit(url)
    if parts.scheme != "http" or not parts.hostname:
        raise PeerCallError(f"unsupported peer url: {url}")
    target = parts.path or "/"
    if parts.query:
        target += "?" + parts.query
    data = body or b""
    lines = [
        f"{method} {target} HTTP/1.1",
        f"host: {parts.netloc}",
        f"content-length: {len(data)}",
        "connection: close",
    ]
    lines += [f"{name}: {value}" for name, value in headers.items()]
    head = ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")
    reader, writer = await asyncio.open_connection(
        parts.hostname, parts.port or 80
    )
    try:
        # no drain(): the transport buffers the whole request, and the
        # response read below waits for it to go out
        writer.write(head + data)
        try:
            status, resp_headers = await _read_head(reader)
        except ValueError as e:
            raise PeerCallError(str(e)) from e
        length = resp_headers.get("content-length")
        if length is not None:
            raw = await reader.readexactly(int(length))
        else:
            raw = await reader.read()
        content_type = resp_headers.get("content-type", "")
        return status, content_type.split(";", 1)[0].strip(), raw
    finally:
        # the exchange is over (or abandoned): drop the connection at
        # once.  abort(), not writer.close(): nothing is left to flush,
        # and the concurrency audit resolves calls by name, so a close()
        # here would wire the fleet's peer legs to every close() in the
        # package
        writer.transport.abort()


async def _http_call(method: str, url: str, headers: dict,
                     body: Optional[bytes], timeout_s: float):
    """``_exchange`` under one total timeout (aiohttp's
    ``ClientTimeout(total=...)``); raises ``asyncio.TimeoutError``,
    ``OSError``, ``asyncio.IncompleteReadError`` or ``PeerCallError``."""
    return await asyncio.wait_for(
        _exchange(method, url, headers, body), timeout_s
    )



class FleetClient:
    def __init__(
        self,
        self_url: str,
        *,
        fetch_timeout_ms: float = 2000.0,
        fault_plan=None,
    ) -> None:
        self.self_url = self_url
        self.fetch_timeout_ms = fetch_timeout_ms
        self.breakers = BreakerRegistry(_BREAKER)
        # FLEET_FAULT_PLAN seam (fleet/faults.py); None — the default —
        # costs one identity check per request
        self.fault_plan = fault_plan
        # transport-outcome listener (fleet/health.py PeerHealth),
        # installed by the coordinator when quarantine is enabled
        self.health = None
        self.peer_errors = 0
        self.deadline_sheds = 0
        self.peer_5xx = 0

    # -- plumbing -------------------------------------------------------------

    async def close(self) -> None:
        """Nothing to release: every call opens and closes its own
        connection (the reference closes its aiohttp session here)."""

    def _budget_ms(self, extra_ms: float = 0.0) -> Optional[float]:
        """The timeout for one peer leg: the fetch timeout (+ any
        explicit long-poll extension), clamped to DEADLINE_SHARE of the
        propagated deadline.  None means the deadline is already spent —
        shed the peer leg entirely."""
        budget = self.fetch_timeout_ms + extra_ms
        deadline = current_deadline()
        if deadline is not None:
            remaining_ms = deadline.remaining() * 1000.0
            if remaining_ms <= 1.0:
                return None
            budget = min(budget, remaining_ms * DEADLINE_SHARE)
        return max(1.0, budget)

    def _health(self, peer: str, ok: bool) -> None:
        if self.health is not None:
            self.health.record(peer, ok)

    async def _request(
        self,
        method: str,
        peer: str,
        path: str,
        *,
        body: Optional[dict] = None,
        extra_ms: float = 0.0,
        ring: Optional[str] = None,
    ):
        """(status, json_obj) or None on any transport-level failure
        (breaker open, deadline spent, connect/read error, timeout)."""
        breaker = self.breakers.get(peer, "fleet")
        if not breaker.allow():
            return None
        resolved = False
        try:
            budget_ms = self._budget_ms(extra_ms)
            if budget_ms is None:
                # deadline already spent: the peer's health was never
                # probed — neither success nor failure
                self.deadline_sheds += 1
                return None
            fault = None
            if self.fault_plan is not None:
                fault = self.fault_plan.next_fault(self.self_url, peer)
            if fault in (fleet_faults.CONNECT, fleet_faults.FLAP):
                # connection refused — immediate, no budget burned
                self.peer_errors += 1
                breaker.record_failure()
                self._health(peer, False)
                resolved = True
                return None
            if fault == fleet_faults.BLACKHOLE:
                # packets vanish: the leg rides its whole clamped
                # budget before timing out, like a real partition
                await asyncio.sleep(budget_ms / 1000.0)
                self.peer_errors += 1
                breaker.record_failure()
                self._health(peer, False)
                resolved = True
                return None
            if fault == fleet_faults.BAD_STATUS:
                # the peer answered (transport healthy) but with a 503
                self.peer_5xx += 1
                breaker.record_failure()
                self._health(peer, True)
                resolved = True
                return 503, {
                    "error": {
                        "kind": "fault_injected",
                        "message": "fleet fault-injected 503",
                    }
                }
            if fault == fleet_faults.SLOW:
                await asyncio.sleep(
                    min(self.fault_plan.slow_ms, budget_ms) / 1000.0
                )

            headers = {
                "content-type": "application/json",
                "x-deadline-ms": str(int(budget_ms)),
            }
            if ring is not None:
                headers["x-fleet-ring"] = ring
            propagate.inject(headers)
            try:
                status, content_type, raw = await _http_call(
                    method,
                    peer + path,
                    headers,
                    (
                        jsonutil.dumps(body).encode("utf-8")
                        if body is not None else None
                    ),
                    budget_ms / 1000.0,
                )
                payload = None
                if content_type == "application/json":
                    # a malformed JSON body raises out of the call, as the
                    # reference's does (the coordinator falls back local)
                    payload = jsonutil.loads(raw.decode("utf-8"))
                if fault == fleet_faults.CORRUPT:
                    payload = fleet_faults.corrupt_payload(payload)
                if status >= 500:
                    # a peer stuck returning 5xx is as unavailable
                    # as a dead one: the breaker must open
                    self.peer_5xx += 1
                    breaker.record_failure()
                else:
                    breaker.record_success()
                self._health(peer, True)
                resolved = True
                return status, payload
            except (
                PeerCallError,
                asyncio.TimeoutError,
                asyncio.IncompleteReadError,
                OSError,
            ):
                self.peer_errors += 1
                breaker.record_failure()
                self._health(peer, False)
                resolved = True
                return None
        finally:
            if not resolved:
                breaker.release_probe()

    # -- the peer protocol ----------------------------------------------------

    async def fetch_entry(
        self, owner: str, fp: str, *, wait_ms: float = 0.0,
        ring: Optional[str] = None,
    ) -> Tuple[str, Optional[list]]:
        """("hit", chunks) | ("miss", None) | ("divergent", None) |
        ("error", None).  With ``wait_ms`` the owner long-polls its
        lease table before answering, so a waiter gets the published
        entry in one trip.  "divergent" means the peer rejected our
        ``x-fleet-ring`` digest: it is routing on a different roster."""
        path = f"/fleet/v1/entry/{fp}"
        if wait_ms > 0:
            path += f"?wait_ms={int(wait_ms)}"
        result = await self._request(
            "GET", owner, path, extra_ms=wait_ms, ring=ring
        )
        if result is None:
            return "error", None
        status, payload = result
        if status == 200 and isinstance(payload, dict):
            chunks = clean_chunk_objs(payload.get("chunks"))
            if chunks is not None:
                return "hit", chunks
            return "error", None
        if status == 404:
            return "miss", None
        if status == 409:
            return "divergent", None
        return "error", None

    async def request_lease(
        self, owner: str, fp: str, *, ring: Optional[str] = None
    ) -> str:
        """"granted" | "wait" | "divergent" | "error"."""
        result = await self._request(
            "POST", owner, f"/fleet/v1/lease/{fp}",
            body={"holder": self.self_url},
            ring=ring,
        )
        if result is None:
            return "error"
        status, payload = result
        if status == 200 and isinstance(payload, dict):
            return "granted" if payload.get("granted") else "wait"
        if status == 409:
            return "divergent"
        return "error"

    async def release_lease(self, owner: str, fp: str) -> None:
        await self._request(
            "DELETE", owner, f"/fleet/v1/lease/{fp}",
            body={"holder": self.self_url},
        )

    async def publish_entry(
        self, owner: str, fp: str, chunk_objs: list
    ) -> bool:
        result = await self._request(
            "PUT", owner, f"/fleet/v1/entry/{fp}",
            body={"holder": self.self_url, "chunks": chunk_objs},
        )
        return result is not None and result[0] in (200, 204)

    async def handoff(self, target: str, entries: List[dict]) -> int:
        """Drain-time hot-set transfer; the count the target accepted."""
        result = await self._request(
            "POST", target, "/fleet/v1/handoff",
            body={"from": self.self_url, "entries": entries},
        )
        if result is None or result[0] != 200:
            return 0
        payload = result[1]
        if isinstance(payload, dict):
            return int(payload.get("accepted", 0))
        return 0

    async def probe(self, peer: str) -> bool:
        """One liveness GET against a quarantined peer.  Deliberately
        BYPASSES the breaker gate (a quarantined peer's breaker is
        usually open — that is exactly why traffic stopped and a probe
        must go instead) but still rides the fault seam, so a scripted
        partition fails probes deterministically too."""
        if self.fault_plan is not None:
            fault = self.fault_plan.next_fault(self.self_url, peer)
            if fault in (
                fleet_faults.CONNECT,
                fleet_faults.FLAP,
                fleet_faults.BLACKHOLE,
                fleet_faults.BAD_STATUS,
            ):
                return False
        try:
            status, _, _ = await _http_call(
                "GET", peer + "/fleet/v1/ping", {}, None,
                self.fetch_timeout_ms / 1000.0,
            )
            return status < 500
        except (
            PeerCallError,
            asyncio.TimeoutError,
            asyncio.IncompleteReadError,
            OSError,
        ):
            return False

    def stats(self) -> dict:
        out = {
            "peer_errors": self.peer_errors,
            "peer_5xx": self.peer_5xx,
            "deadline_sheds": self.deadline_sheds,
            "breakers": self.breakers.snapshot(),
        }
        if self.fault_plan is not None:
            out["fault_plan"] = self.fault_plan.snapshot()
        return out
