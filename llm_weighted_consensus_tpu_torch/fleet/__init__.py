"""Fleet tier: N gateway replicas serving as one coherent cache tier.

The port's copy of ``llm_weighted_consensus_tpu/fleet/``.  Without it
every replica is an island: a private result LRU (cache/store.py) and a
per-process single-flight (cache/singleflight.py) mean a fleet-wide hot
score request stampedes every replica's upstream judges independently.
This package adds the cross-replica half of the cache design (cf.
Nishtala et al., *Scaling Memcache at Facebook*, NSDI'13):

* ``membership``  — static-or-file-watched peer roster + consistent-hash
  ownership of cache fingerprints;
* ``leases``      — the owner-side cross-replica single-flight table:
  one lease per in-flight fingerprint, TTL-bounded so a dead holder
  degrades to local compute, never a hang;
* ``client``      — the peer HTTP surface (entry fetch / lease / publish
  / handoff) on HTTP/1.1 over ``asyncio.open_connection``, with
  traceparent + deadline propagation and per-peer circuit breakers;
* ``coordinator`` — the glue the score client's front door and the
  drain path call; every fleet failure collapses to ("local", None),
  i.e. exactly the pre-fleet behavior;
* ``handlers``    — the ``/fleet/v1/*`` routes on the stdlib server,
  including the wire-side replay admission guard (a peer can never be
  served a degraded or errored record) and the lease guard (no lease is
  granted over a fingerprint the owner's cache already holds);
* ``wire``        — record validation shared by publish and handoff;
* ``faults``      — the ``FLEET_FAULT_PLAN`` seam: deterministic
  per-peer-pair fault injection (partitions, flaps, corruption) so
  every failure path above is drillable from a seed;
* ``health``      — peer quarantine: a flapping peer is ejected from
  the routing ring behind a health score and re-admitted by probe.

Loop-confined, lock-free: every object here is touched only on the chat
routes' one event loop (``serve/chat_routes.py`` ``EventLoop``).  The
stdlib server's handler threads and the drain thread reach the fleet
only through ``handlers.FleetRoutes``, which submits each call to that
loop and waits for its answer, so no threading primitive guards fleet
state and the concurrency-model registry gains no rows.
"""

from .client import FleetClient
from .coordinator import FleetCoordinator
from .faults import FleetFaultPlan
from .handlers import FleetRoutes
from .health import PeerHealth
from .leases import LeaseTable
from .membership import FleetConfig, FleetMembership, OwnershipView
from .wire import clean_chunk_objs, record_digest

__all__ = [
    "FleetClient",
    "FleetConfig",
    "FleetCoordinator",
    "FleetFaultPlan",
    "FleetMembership",
    "FleetRoutes",
    "LeaseTable",
    "OwnershipView",
    "PeerHealth",
    "clean_chunk_objs",
    "record_digest",
]
