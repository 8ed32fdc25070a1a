"""The port's fleet tier served: replicas of the port's stdlib server on
loopback ports, on the CPU.

Each replica is a full ``gateway.Server`` with its own scripted judges
(``PortFakeTransport``, the port's twin of ``tests/fakes.py``'s
``FakeTransport``), score cache and ``FleetCoordinator``, on a static
roster, so the exactly-one-upstream and degrade-to-local contracts are
held against the real peer protocol (``/fleet/v1/*`` over HTTP/1.1,
answered on each server's chat-routes loop).  These are the counterparts
of the reference's ``tests/test_fleet.py`` and
``tests/test_fleet_partition.py`` integration tests, with two
differences of substance:

* the hot-key stampede is held to the documented contract, exactly one
  upstream fan-out fleet-wide, which the port meets through its lease
  guard (no lease over a cached entry, ``fleet/handlers.py``); the
  reference's own test of it is red (its lease route grants a second
  lease after the owner's publish), and no reference path is used as an
  oracle here;
* the partition drill's byte-identical replay from ``DRILL_SEED`` is the
  port's own run replayed, modulo the per-request envelope, as the
  reference's drill compares its own.

One case serves a ``bge_micro`` training-table panel: three replicas
share one embedder, and a stampede costs one panel of judge calls and
one prompt-embed dispatch.
"""

import asyncio
import http.client
import json
import os
import random
import re
import signal
import socket
import subprocess
import sys
import textwrap
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import pytest

from llm_weighted_consensus_tpu.fleet import LeaseTable as RefLeaseTable
from llm_weighted_consensus_tpu_torch import archive as port_archive
from llm_weighted_consensus_tpu_torch import registry as port_registry
from llm_weighted_consensus_tpu_torch.ballot import PrefixTree
from llm_weighted_consensus_tpu_torch.cache import (
    ScoreCache,
    score_fingerprint,
)
from llm_weighted_consensus_tpu_torch.clients import chat as port_chat
from llm_weighted_consensus_tpu_torch.clients.score import ScoreClient
from llm_weighted_consensus_tpu_torch.fleet import (
    FleetClient,
    FleetConfig,
    FleetCoordinator,
    FleetFaultPlan,
    FleetMembership,
)
from llm_weighted_consensus_tpu_torch.identity.xxh3 import (
    xxh3_64_hexdigest,
    xxh3_64_intdigest,
)
from llm_weighted_consensus_tpu_torch.serve.gateway import Server
from llm_weighted_consensus_tpu_torch.types.score_request import (
    ChatCompletionCreateParams as ScoreParams,
)
from llm_weighted_consensus_tpu_torch.utils import jsonutil

from fakes import Script, chunk_obj
from test_torch_chat_client import PortFakeTransport

SEED = 11
DRILL_SEED = 1729


def go(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def ballot_keys(n):
    rng = random.Random(SEED)
    tree = PrefixTree.build(rng, n, 20)
    return {idx: k for k, idx in tree.key_indices(rng)}


JUDGES = {"llms": [{"model": "j1"}]}


def score_body(**overrides):
    body = {
        "messages": [{"role": "user", "content": "q"}],
        "model": JUDGES,
        "choices": ["first", "second"],
    }
    body.update(overrides)
    return body


def winning_script():
    keys = ballot_keys(2)
    return Script([chunk_obj(f"pick {keys[1]}", finish="stop")])


def fp_of(body):
    return score_fingerprint(ScoreParams.from_json_obj(body))


def fleet_cfg(self_url, peers, **kw):
    return FleetConfig(self_url=self_url, peers=list(peers), **kw)


URLS = ["http://10.0.0.1:5000", "http://10.0.0.2:5000", "http://10.0.0.3:5000"]


# -- the cluster --------------------------------------------------------------------


class Node(SimpleNamespace):
    def on_loop(self, fn):
        """``fn()`` on the server's chat-routes loop, where the fleet's
        state lives."""
        return self.server.fleet_routes.call(fn)

    def call(self, method, path, body=None, headers=None, timeout=60):
        conn = http.client.HTTPConnection("127.0.0.1", self.port,
                                          timeout=timeout)
        try:
            raw = (body if isinstance(body, bytes) else
                   jsonutil.dumps(body).encode() if body is not None
                   else None)
            h = {"content-type": "application/json"}
            h.update(headers or {})
            try:
                conn.request(method, path, body=raw, headers=h)
            except (BrokenPipeError, ConnectionResetError):
                # a refused body (413) is answered before it is read; the
                # answer is still there to read
                pass
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()

    def score(self, body, headers=None):
        return self.call("POST", "/score/completions", body, headers)

    @property
    def upstream(self) -> int:
        return len(self.transport.requests)


def make_node(scripts, self_url, peers, port, lease_ms=10000.0,
              fetch_ms=2000.0, cache_bytes=1 << 20, **cfg_kw):
    cache = ScoreCache(60, cache_bytes)
    fleet = FleetCoordinator(fleet_cfg(
        self_url, peers, lease_millis=lease_ms,
        fetch_timeout_millis=fetch_ms, **cfg_kw))
    fleet.cache = cache
    transport = PortFakeTransport(scripts)
    chat = port_chat.DefaultChatClient(
        transport, [port_chat.ApiBase("https://up.example", "k")],
        backoff=port_chat.BackoffPolicy(max_elapsed_ms=0))
    score = ScoreClient(
        chat, port_registry.InMemoryModelRegistry(),
        archive_fetcher=port_archive.InMemoryArchive(),
        rng_factory=lambda: random.Random(SEED), cache=cache, fleet=fleet)
    server = Server(None, host="127.0.0.1", port=port, chat_client=chat,
                    score_client=score, fleet=fleet).start()
    return Node(url=self_url, port=port, cache=cache, fleet=fleet,
                transport=transport, server=server)


def start_cluster(scripts_by_node, **kw):
    ports = [free_port() for _ in scripts_by_node]
    urls = [f"http://127.0.0.1:{p}" for p in ports]
    return [make_node(scripts, urls[i], urls, ports[i], **kw)
            for i, scripts in enumerate(scripts_by_node)]


def stop_cluster(nodes):
    for node in nodes:
        node.server.close()


@pytest.fixture
def cluster():
    made = []

    def start(scripts_by_node, **kw):
        nodes = start_cluster(scripts_by_node, **kw)
        made.extend(nodes)
        return nodes

    yield start
    stop_cluster(made)


def owner_of(nodes, body):
    url = nodes[0].on_loop(lambda: nodes[0].fleet.membership.owner(
        fp_of(body)))
    return next(n for n in nodes if n.url == url)


def body_owned_by(nodes, node, tag="q"):
    for i in range(1000):
        body = score_body(messages=[{"role": "user",
                                     "content": f"{tag}-{i}"}])
        if owner_of(nodes, body) is node:
            return body
    raise AssertionError("no fingerprint landed on the node")


def settle(nodes, timeout=10.0):
    """Wait until every node's fire-and-forget peer legs (publishes,
    releases, probes) have finished: the owners' counters then hold."""
    time.sleep(0.02)
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if all(n.on_loop(lambda n=n: len(n.fleet._tasks)) == 0
               for n in nodes):
            return
        time.sleep(0.01)
    raise AssertionError("fleet tasks still running")


def gather(calls):
    """Run ``calls`` (thunks) at once; results in argument order."""
    with ThreadPoolExecutor(max(1, len(calls))) as pool:
        return list(pool.map(lambda f: f(), calls))


# -- the front door: hits, the stampede, degrade-to-local ------------------------


def test_peer_fetch_serves_owner_hit_without_upstream(cluster):
    nodes = cluster([[winning_script()], []])
    body = body_owned_by(nodes, nodes[0])
    body["stream"] = True
    status, miss = nodes[0].score(body)
    assert status == 200
    # the non-owner fetches the record from the owner and replays it
    # byte-identically — zero upstream calls
    status, hit = nodes[1].score(body)
    assert status == 200 and hit == miss
    assert nodes[1].upstream == 0
    assert nodes[1].on_loop(lambda: nodes[1].fleet.peer_hits) == 1


@pytest.mark.parametrize("per_node,owner_last", [(1, False), (8, False),
                                                 (1, True), (4, True)])
def test_hot_key_stampede_hits_upstream_exactly_once(cluster, per_node,
                                                     owner_last):
    # every replica COULD serve upstream (each has a script), so only
    # the lease protocol explains a fan-out count of one
    nodes = cluster([[winning_script()] for _ in range(3)])
    body = score_body(stream=True,
                      messages=[{"role": "user",
                                 "content": f"hot {per_node} {owner_last}"}])
    order = list(nodes)
    if owner_last:
        owner = owner_of(nodes, body)
        order = [n for n in nodes if n is not owner] + [owner]
    calls = [lambda n=n: n.score(body) for _ in range(per_node)
             for n in order]
    results = gather(calls)
    assert {status for status, _ in results} == {200}
    assert len({raw for _, raw in results}) == 1  # byte-identical
    assert sum(n.upstream for n in nodes) == 1


def test_the_lease_route_grants_no_lease_over_a_cached_entry(cluster):
    """The port's deliberate divergence, pinned: with the fingerprint
    already published into the owner's cache and no lease in flight, the
    port's lease route answers ``granted: false`` and the peer's next
    begin is a ``hit``; the reference's ``LeaseTable.acquire`` grants on
    the same table state (its handler consults nothing else)."""
    nodes = cluster([[winning_script()], []])
    owner, peer = nodes
    body = body_owned_by(nodes, owner)
    fp = fp_of(body)
    assert owner.score(body)[0] == 200
    settle(nodes)
    assert owner.on_loop(lambda: owner.fleet.leases.active()) == 0
    ring = owner.on_loop(lambda: owner.fleet.membership.ring_digest())
    status, raw = owner.call("POST", f"/fleet/v1/lease/{fp}",
                             {"holder": peer.url},
                             headers={"x-fleet-ring": ring})
    assert status == 200
    assert json.loads(raw) == {"granted": False, "ttl_ms": 10000.0}
    assert owner.on_loop(lambda: owner.fleet.leases.active()) == 0
    plan = peer.server.fleet_routes._run(peer.fleet.begin(fp))
    assert plan[0] == "hit" and plan[1] == owner.cache.get(fp)
    # the reference's table, in the same state (no lease in flight),
    # would have granted that claim

    async def ref_grant():
        return RefLeaseTable(10000).acquire(fp, peer.url)

    assert go(ref_grant()) == (True, None)
    # a fingerprint the owner does not hold is still granted
    status, raw = owner.call("POST", "/fleet/v1/lease/fp-new",
                             {"holder": peer.url},
                             headers={"x-fleet-ring": ring})
    assert json.loads(raw)["granted"] is True


def test_owner_death_degrades_to_local_compute(cluster):
    nodes = cluster([[], [winning_script()]], fetch_ms=500.0)
    body = body_owned_by(nodes, nodes[0])
    nodes[0].server.close()  # the owner dies
    status, _ = nodes[1].score(body)
    assert status == 200
    assert nodes[1].upstream == 1
    stats = nodes[1].on_loop(nodes[1].fleet.stats)
    assert stats["local_fallbacks"] >= 1
    assert stats["peer_fetch"]["errors"] >= 1


def test_dead_lease_holder_expires_to_local_compute(cluster):
    nodes = cluster([[], [winning_script()]], lease_ms=150.0)
    body = body_owned_by(nodes, nodes[0])
    fp = fp_of(body)
    # a replica claimed the lease on the owner, then died without
    # publishing or releasing
    granted, _ = nodes[0].on_loop(
        lambda: nodes[0].fleet.leases.acquire(fp, "http://dead:9"))
    assert granted
    t0 = time.monotonic()
    status, _ = nodes[1].score(body)
    assert status == 200
    assert time.monotonic() - t0 < 5.0  # bounded by the TTL, never stuck
    assert nodes[1].upstream == 1


def test_peer_wait_sheds_on_propagated_deadline(cluster):
    # the lease TTL is 20 s, the request deadline 1.5 s: peer legs spend
    # at most half the remaining budget, so local compute still fits
    nodes = cluster([[], [winning_script()]], lease_ms=20000.0)
    body = body_owned_by(nodes, nodes[0])
    fp = fp_of(body)
    nodes[0].on_loop(lambda: nodes[0].fleet.leases.acquire(
        fp, "http://hung:9"))
    t0 = time.monotonic()
    status, _ = nodes[1].score(body, headers={"x-deadline-ms": "1500"})
    assert status == 200
    assert time.monotonic() - t0 < 3.0  # nowhere near the TTL
    assert nodes[1].upstream == 1


def test_split_roster_divergence_degrades_to_local(cluster):
    nodes = cluster([[winning_script()], [winning_script()]])
    a, b = nodes
    body = body_owned_by(nodes, b)  # a must cross the wire
    # b's roster diverges (it now believes it is alone): its digest no
    # longer matches a's
    b.on_loop(lambda: b.fleet.membership._set_peers([b.url]))
    status, _ = a.score(body)
    assert status == 200
    sa, sb = a.on_loop(a.fleet.stats), b.on_loop(b.fleet.stats)
    assert sa["ring_divergences"] == 1 and sb["ring_rejects"] >= 1
    # a served the request itself rather than trusting b's lease table
    assert a.upstream == 1 and sa["local_fallbacks"] >= 1


# -- takeover, late publish, the wire guard --------------------------------------


def test_dead_holder_early_takeover_and_late_publish_reconciled(cluster):
    clean = recorded(cluster)
    nodes = cluster([[winning_script()]], lease_ms=30000.0, fetch_ms=300.0,
                    probe_millis=60.0)
    node = nodes[0]
    dead = f"http://127.0.0.1:{free_port()}"
    body = body_owned_by(nodes, node)
    fp = fp_of(body)
    assert node.on_loop(lambda: node.fleet.leases.acquire(fp, dead))[0]
    t0 = time.monotonic()
    status, _ = node.score(body)
    assert status == 200
    # the waiter probed the dead holder and stole the lease in about one
    # probe interval, nowhere near the 30 s TTL
    assert time.monotonic() - t0 < 5.0
    stats = node.on_loop(node.fleet.stats)
    assert stats["early_takeovers"] == 1
    assert stats["leases"]["takeovers"] == 1
    assert node.upstream == 1
    # the "dead" holder's publish arrives after the steal: cached and
    # counted, never retiring the live claimant's state
    status, raw = node.call("PUT", f"/fleet/v1/entry/{fp}",
                            {"holder": dead, "chunks": clean})
    assert status == 200
    assert json.loads(raw) == {"accepted": True, "retired": False}
    assert node.on_loop(lambda: node.fleet.leases.late_publishes) == 1
    assert node.cache.holds(fp)


def test_breaker_open_holder_is_taken_over_without_probe(cluster):
    nodes = cluster([[winning_script()], []], lease_ms=30000.0,
                    probe_millis=60.0)
    a, b = nodes
    body = body_owned_by(nodes, a)
    fp = fp_of(body)

    def hold_and_open():
        granted, _ = a.fleet.leases.acquire(fp, b.url)
        breaker = a.fleet.client.breakers.get(b.url, "fleet")
        for _ in range(3):
            breaker.record_failure()
        return granted

    # b is alive and would answer a ping: only the breaker verdict
    # explains a takeover this fast
    assert a.on_loop(hold_and_open)
    t0 = time.monotonic()
    assert a.score(body)[0] == 200
    assert time.monotonic() - t0 < 5.0
    assert a.on_loop(lambda: a.fleet.early_takeovers) == 1
    assert a.upstream == 1


_RECORD = {}


def recorded(cluster):
    """A real clean record: one scored request on a one-node fleet."""
    if "clean" not in _RECORD:
        (node,) = cluster([[winning_script()]])
        body = score_body(messages=[{"role": "user", "content": "rec"}])
        assert node.score(body)[0] == 200
        _RECORD["clean"] = node.cache.get(fp_of(body))
    return jsonutil.loads(jsonutil.dumps(_RECORD["clean"]))


def test_degraded_publish_is_rejected_at_the_wire(cluster):
    record = recorded(cluster)
    (node,) = cluster([[]])
    dirty = jsonutil.loads(jsonutil.dumps(record))
    dirty[0]["degraded"] = True
    status, raw = node.call("PUT", "/fleet/v1/entry/fp-dirty",
                            {"holder": "http://evil:1", "chunks": dirty})
    assert (status, json.loads(raw)) == (422, {"accepted": False})
    assert node.on_loop(lambda: node.fleet.rejected_publishes) == 1
    assert not node.cache.holds("fp-dirty")
    # the clean original is accepted and servable
    status, _ = node.call("PUT", "/fleet/v1/entry/fp-clean",
                          {"holder": "http://peer:1", "chunks": record})
    assert status == 200
    status, raw = node.call("GET", "/fleet/v1/entry/fp-clean")
    assert status == 200
    assert jsonutil.loads(raw.decode())["chunks"] == record
    status, raw = node.call("GET", "/fleet/v1/entry/fp-none")
    assert (status, json.loads(raw)) == (404, {"found": False})


def test_dirty_publish_releases_the_lease(cluster):
    record = recorded(cluster)
    dirty = jsonutil.loads(jsonutil.dumps(record))
    dirty[0]["choices"][0]["error"] = {"message": "boom"}
    (node,) = cluster([[]])
    node.on_loop(lambda: node.fleet.leases.acquire("fp", "http://peer:1"))
    status, _ = node.call("PUT", "/fleet/v1/entry/fp",
                          {"holder": "http://peer:1", "chunks": dirty})
    assert status == 422
    # waiters must not ride out the TTL hoping for a refused record
    assert node.on_loop(lambda: node.fleet.leases.active()) == 0


def test_the_routes_answer_the_references_bodies(cluster):
    (node,) = cluster([[]])
    status, raw = node.call("GET", "/fleet/v1/ping")
    assert (status, json.loads(raw)) == (200, {"ok": True, "self": node.url})
    status, raw = node.call("POST", "/fleet/v1/lease/fp", {"holder": "h"})
    assert json.loads(raw) == {"granted": True, "ttl_ms": 10000.0}
    status, raw = node.call("DELETE", "/fleet/v1/lease/fp", {"holder": "h"})
    assert (status, json.loads(raw)) == (200, {"released": True})
    assert node.on_loop(lambda: node.fleet.leases.released) == 1
    status, raw = node.call("POST", "/fleet/v1/lease/fp", {"holder": "h"},
                            headers={"x-fleet-ring": "not-ours"})
    body = json.loads(raw)
    assert status == 409 and body["kind"] == "ring_divergence"
    assert body["epoch"] == 1
    status, raw = node.call("POST", "/fleet/v1/handoff", {"entries": 3})
    assert (status, json.loads(raw)) == (400, {"accepted": 0})
    # unknown fleet paths and methods are no routes; a body past the cap
    # is the reference's 413
    assert node.call("GET", "/fleet/v1/lease/fp")[0] == 404
    assert node.call("DELETE", "/fleet/v1/entry/fp")[0] == 404
    big = b"x" * (1 << 20)
    assert node.call("PUT", "/fleet/v1/entry/fp", big)[0] == 413


def test_fleet_routes_skip_the_admission_gate(cluster):
    (node,) = cluster([[]])
    node.server.admission.draining = True  # the gate sheds every POST
    assert node.score(score_body())[0] == 503
    status, raw = node.call("POST", "/fleet/v1/lease/fp", {"holder": "h"})
    assert status == 200 and json.loads(raw)["granted"] is True


def test_the_entry_long_poll_waits_for_the_publish(cluster):
    record = recorded(cluster)
    (node,) = cluster([[]])
    node.on_loop(lambda: node.fleet.leases.acquire("fp", "http://peer:1"))

    def publish_later():
        time.sleep(0.2)
        return node.call("PUT", "/fleet/v1/entry/fp",
                         {"holder": "http://peer:1", "chunks": record})

    t0 = time.monotonic()
    (got, put) = gather([
        lambda: node.call("GET", "/fleet/v1/entry/fp?wait_ms=5000"),
        publish_later])
    assert put[0] == 200 and got[0] == 200
    assert 0.15 < time.monotonic() - t0 < 4.0
    assert jsonutil.loads(got[1].decode())["chunks"] == record
    # a long-poll's clamp follows the caller's x-deadline-ms
    node.on_loop(lambda: node.fleet.leases.acquire("fp2", "http://peer:1"))
    t0 = time.monotonic()
    status, _ = node.call("GET", "/fleet/v1/entry/fp2?wait_ms=5000",
                          headers={"x-deadline-ms": "200"})
    assert status == 404 and time.monotonic() - t0 < 2.0


# -- the drain handoff ---------------------------------------------------------------


def test_drain_handoff_moves_hot_set_to_new_owner(cluster):
    nodes = cluster([[winning_script()], []])
    a, b = nodes
    body = body_owned_by(nodes, a)
    fp = fp_of(body)
    assert a.score(body)[0] == 200
    assert not b.cache.holds(fp)
    status, raw = a.call("GET", "/readyz")
    ready = json.loads(raw)
    assert status == 200 and ready["fleet"]["self"] == a.url
    assert set(ready["fleet"]["peers"]) == {a.url, b.url}
    assert a.server.drain()
    # the hot entry now lives on its post-drain owner, which serves it
    # without ever seeing the original request
    assert b.cache.holds(fp)
    assert b.on_loop(lambda: b.fleet.handoff_received) == 1
    sa = a.on_loop(a.fleet.stats)["handoff"]
    assert (sa["sent"], sa["accepted"]) == (1, 1)
    assert a.server.lifecycle.snapshot()["fleet_handoff_entries"] == 1
    assert b.score(body)[0] == 200
    assert b.upstream == 0


def test_the_handoff_runs_before_readiness_flips(cluster):
    nodes = cluster([[winning_script()], []])
    a, b = nodes
    assert a.score(body_owned_by(nodes, a))[0] == 200
    seen = {}
    bridge = a.server.fleet_routes
    handoff = bridge.handoff_hot_set

    def watched(timeout_s):
        seen["state"] = a.server.lifecycle.state
        seen["readyz"] = a.call("GET", "/readyz")[0]
        seen["budget_s"] = timeout_s
        return handoff(timeout_s)

    bridge.handoff_hot_set = watched
    assert a.server.drain()
    assert seen["state"] == "ready" and seen["readyz"] == 200
    # at most half of DRAIN_TIMEOUT_MILLIS (10 s by default)
    assert 0.05 <= seen["budget_s"] <= 5.0
    assert a.call("GET", "/readyz")[0] == 503


def test_handoff_rejects_dirty_and_expired_entries(cluster):
    record = recorded(cluster)
    dirty = jsonutil.loads(jsonutil.dumps(record))
    dirty[0]["degraded"] = True
    (node,) = cluster([[]])
    status, raw = node.call("POST", "/fleet/v1/handoff", {
        "from": "http://peer:1",
        "entries": [
            {"fp": "ok", "chunks": record, "ttl_sec": 5.0},
            {"fp": "bad", "chunks": dirty, "ttl_sec": 5.0},
            {"fp": "old", "chunks": record, "ttl_sec": 0},
            "not-an-entry",
        ],
    })
    assert (status, json.loads(raw)) == (200, {"accepted": 1})
    stats = node.on_loop(node.fleet.stats)["handoff"]
    assert (stats["received"], stats["rejected"]) == (1, 2)
    assert node.cache.holds("ok")
    assert not node.cache.holds("bad") and not node.cache.holds("old")
    # the remaining lifetime travelled with the entry
    (entry,) = node.on_loop(lambda: node.cache.hot_entries(5))
    assert 4.0 < entry[2] <= 5.0


def test_a_dark_fleet_costs_the_drain_at_most_half_its_budget(cluster):
    record = recorded(cluster)
    nodes = cluster([[], [], []], fetch_ms=5000.0)
    a = nodes[0]
    a.server.lifecycle.drain_timeout_ms = 800.0

    def load_and_cut():
        view = a.fleet.membership.departure_view()
        for i in range(64):
            a.cache.put_chunks(f"fp-{i}", record)
        plan = FleetFaultPlan()
        plan.partition([[a.url], [n.url for n in nodes[1:]]])
        a.fleet.client.fault_plan = plan
        return len({view.owner(f"fp-{i}") for i in range(64)})

    assert a.on_loop(load_and_cut) == 2
    t0 = time.monotonic()
    assert a.server.drain()
    elapsed = time.monotonic() - t0
    assert a.server.lifecycle.handoff_entries == 0
    assert elapsed < 0.8, elapsed  # the handoff gave up at half


def test_handoff_pushes_targets_concurrently_under_partition(cluster):
    record = recorded(cluster)
    nodes = cluster([[], [], []], fetch_ms=400.0)
    a = nodes[0]
    plan = FleetFaultPlan()

    def setup():
        departure = a.fleet.membership.departure_view()
        fps = {}
        for i in range(1000):
            fps.setdefault(departure.owner(f"fp-{i}"), f"fp-{i}")
            if len(fps) == 2:
                break
        for fp in fps.values():
            a.cache.put_chunks(fp, record)
        plan.partition([[a.url], [nodes[1].url, nodes[2].url]])
        a.fleet.client.fault_plan = plan

    a.on_loop(setup)
    t0 = time.monotonic()
    accepted = a.server.fleet_routes._run(a.fleet.handoff(a.cache))
    elapsed = time.monotonic() - t0
    assert accepted == 0
    assert elapsed < 0.75, elapsed  # about one budget, not two
    assert plan.injected["blackhole"] == 2


# -- quarantine -------------------------------------------------------------------------


def test_unreachable_owner_degrades_to_local_and_breaks():
    async def run():
        dead = f"http://127.0.0.1:{free_port()}"
        me = "http://127.0.0.2:1"
        fleet = FleetCoordinator(fleet_cfg(me, [me, dead],
                                           fetch_timeout_millis=300.0))
        fleet.cache = ScoreCache(60, 1 << 20)
        fp = next(f"fp-{i}" for i in range(1000)
                  if fleet.membership.owner(f"fp-{i}") == dead)
        try:
            for _ in range(3):
                assert await fleet.begin(fp) == ("local", None)
            assert fleet.peer_errors >= 1 and fleet.local_fallbacks >= 3
            snap = fleet.client.breakers.snapshot()
            assert any(b.get("state") == "open" for b in snap.values())
            # the third consecutive failure quarantines the dead peer:
            # its keys re-home, so the next begin owns fp locally
            assert fleet.health.quarantined() == [dead]
            assert await fleet.begin(fp) == ("lease", None)
            assert fleet.membership.owner(fp) == me
        finally:
            await fleet.close()

    go(run())


def test_quarantine_drill_readmits_a_recovered_peer(cluster):
    """b is cut off from a by a scripted blackhole: three failed legs
    quarantine it on a (its keys re-home to a), and once the cut heals
    a's next request probes b, re-admits it and closes its breaker."""
    nodes = cluster([[winning_script() for _ in range(8)], []],
                    fetch_ms=150.0, probe_millis=100.0)
    a, b = nodes
    plan = FleetFaultPlan()
    a.on_loop(lambda: setattr(a.fleet.client, "fault_plan", plan))
    plan.set_pair(a.url, b.url, "blackhole")
    for i in range(3):
        assert a.score(body_owned_by(nodes, b, tag=f"cut{i}"))[0] == 200
    assert a.on_loop(a.fleet.health.quarantined) == [b.url]
    # the next begin folds the verdict into the ring: while quarantined,
    # b's keys re-home to a and cost nothing on the wire
    injected = plan.injected["blackhole"]
    upstream = a.upstream
    assert a.score(body_owned_by(nodes, b, tag="cut3"))[0] == 200
    assert plan.injected["blackhole"] == injected
    assert a.upstream == upstream + 1
    stats = a.on_loop(a.fleet.stats)
    assert stats["membership"]["quarantined"] == [b.url]
    assert stats["leases"]["granted"] == 1  # a owned b's key
    assert stats["membership"]["ring"] == b.on_loop(
        lambda: b.fleet.membership.ring_digest())  # local knowledge only
    plan.heal()
    time.sleep(0.15)
    assert a.score(score_body(messages=[{"role": "user",
                                         "content": "kick"}]))[0] == 200
    settle(nodes)
    stats = a.on_loop(a.fleet.stats)
    assert stats["health"]["quarantined"] == []
    assert stats["health"]["readmissions"] == 1
    assert stats["membership"]["quarantined"] == []
    assert stats["client"]["breakers"][f"{b.url}|fleet"]["state"] == "closed"


# -- the client on the wire --------------------------------------------------------------


class _Capture:
    """A stdlib peer that records each request and answers ``status``
    with ``body``."""

    def __init__(self, status=200, body=b'{"found": false}',
                 content_type="application/json"):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        seen = self.seen = []

        class H(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _answer(self):
                length = int(self.headers.get("content-length") or 0)
                seen.append((self.command, self.path, dict(self.headers),
                             self.rfile.read(length)))
                self.send_response(status)
                self.send_header("content-type", content_type)
                self.send_header("content-length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            do_GET = do_POST = do_PUT = do_DELETE = _answer

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.httpd.daemon_threads = True
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def test_peer_legs_carry_the_deadline_ring_and_traceparent():
    from llm_weighted_consensus_tpu_torch import obs
    from llm_weighted_consensus_tpu_torch.resilience.deadline import Deadline

    peer = _Capture(status=404)
    fc = FleetClient("http://me:1", fetch_timeout_ms=2000.0)

    async def run():
        Deadline(1.0).activate()
        root = obs.start_trace("test", sampled=True)
        root.activate()
        got = await fc.fetch_entry(peer.url, "fp", ring="r1")
        lease = await fc.request_lease(peer.url, "fp", ring="r1")
        ok = await fc.publish_entry(peer.url, "fp", [{"x": 1}])
        await fc.release_lease(peer.url, "fp")
        return got, lease, ok, root

    try:
        got, lease, ok, root = go(run())
    finally:
        peer.close()
    assert got == ("miss", None) and lease == "error" and ok is False
    (m1, p1, h1, _), (m2, p2, h2, b2), (m3, p3, _, b3), (m4, p4, _, b4) = \
        peer.seen
    assert (m1, p1) == ("GET", "/fleet/v1/entry/fp")
    assert (m2, p2, m3, p3, m4, p4) == (
        "POST", "/fleet/v1/lease/fp", "PUT", "/fleet/v1/entry/fp",
        "DELETE", "/fleet/v1/lease/fp")
    for h in (h1, h2):
        assert h["x-fleet-ring"] == "r1"
        # half the remaining second, at most
        assert 0 < int(h["x-deadline-ms"]) <= 500
        assert h["traceparent"].split("-")[1] == root.trace.trace_id
        assert h["content-type"] == "application/json"
    assert json.loads(b2) == {"holder": "http://me:1"}
    assert json.loads(b3) == {"holder": "http://me:1", "chunks": [{"x": 1}]}
    assert json.loads(b4) == {"holder": "http://me:1"}


def test_a_spent_deadline_sheds_the_peer_leg():
    from llm_weighted_consensus_tpu_torch.resilience.deadline import Deadline

    fc = FleetClient("http://me:1")

    async def run():
        Deadline(0.0).activate()
        return await fc.fetch_entry("http://127.0.0.1:9", "fp")

    assert go(run()) == ("error", None)
    assert fc.deadline_sheds == 1 and fc.peer_errors == 0


def test_peer_5xx_opens_breaker():
    peer = _Capture(status=500, body=b'{"error": {"kind": "internal"}}')
    fc = FleetClient("http://me:1", fetch_timeout_ms=500.0)

    async def run():
        out = [await fc.fetch_entry(peer.url, "fp") for _ in range(4)]
        return out

    try:
        out = go(run())
    finally:
        peer.close()
    assert out == [("error", None)] * 4
    assert fc.peer_5xx == 3  # the fourth leg shed at the open breaker
    assert len(peer.seen) == 3
    assert "open" in {s["state"] for s in fc.breakers.snapshot().values()}


@pytest.mark.parametrize("kind,want,breaker_failures,health_ok", [
    ("connect", ("error", None), 1, False),
    ("flap", ("error", None), 1, False),
    ("blackhole", ("error", None), 1, False),
    ("5xx", ("error", None), 1, True),
    ("corrupt", ("error", None), 0, True),
    ("slow", ("miss", None), 0, True),
])
def test_each_fault_kind_acts_on_the_leg_as_the_reference(
        kind, want, breaker_failures, health_ok):
    record_body = jsonutil.dumps({"found": True, "chunks": [{"a": 1}]})
    peer = _Capture(status=404 if kind == "slow" else 200,
                    body=record_body.encode())
    plan = FleetFaultPlan(slow_ms=150.0)
    fc = FleetClient("http://me:1", fetch_timeout_ms=200.0, fault_plan=plan)
    outcomes = []
    fc.health = SimpleNamespace(record=lambda p, ok: outcomes.append(ok))
    plan.set_pair("http://me:1", peer.url, kind, count=1)

    async def run():
        t0 = time.monotonic()
        got = await fc.fetch_entry(peer.url, "fp")
        return got, time.monotonic() - t0

    try:
        got, elapsed = go(run())
    finally:
        peer.close()
    assert got == want
    breaker = fc.breakers.get(peer.url, "fleet").snapshot()
    assert breaker["window"] == breaker_failures
    assert outcomes == [health_ok]
    if kind in ("blackhole", "slow"):
        assert elapsed >= 0.14  # the leg burned its budget / its stall
    if kind in ("connect", "flap", "5xx"):
        assert peer.seen == []  # never left this process
    assert plan.injected[kind] == 1


def test_the_probe_bypasses_the_breaker_but_rides_the_fault_seam():
    peer = _Capture(status=200, body=b'{"ok": true}')
    plan = FleetFaultPlan()
    fc = FleetClient("http://me:1", fault_plan=plan)
    breaker = fc.breakers.get(peer.url, "fleet")
    for _ in range(3):
        breaker.record_failure()

    async def run():
        first = await fc.probe(peer.url)
        plan.set_pair("http://me:1", peer.url, "blackhole", count=1)
        second = await fc.probe(peer.url)
        return first, second, await fc.probe("http://127.0.0.1:9")

    try:
        assert go(run()) == (True, False, False)
    finally:
        peer.close()
    assert [s[1] for s in peer.seen] == ["/fleet/v1/ping"]


# -- coordinator-level cases (no HTTP) -------------------------------------------------


def make_coordinator(self_url, peers, **kw):
    fleet = FleetCoordinator(fleet_cfg(self_url, peers, **kw))
    fleet.cache = ScoreCache(60, 1 << 20)
    return fleet


def test_begin_with_empty_roster_is_local():
    async def run():
        fleet = make_coordinator("http://a:1", [])
        assert await fleet.begin("fp") == ("local", None)
        assert fleet.local_fallbacks == 1

    go(run())


def test_owner_lease_lifecycle():
    async def run():
        fleet = make_coordinator("http://a:1", ["http://a:1"])
        assert await fleet.begin("fp") == ("lease", None)
        assert fleet.leases.active() == 1
        fleet.publish("fp", [{"any": "chunks"}])
        assert fleet.leases.active() == 0 and fleet.publishes == 1
        assert await fleet.begin("fp2") == ("lease", None)
        fleet.abandon("fp2")
        assert fleet.leases.active() == 0 and fleet.abandons == 1

    go(run())


def test_owner_waits_out_dead_holder_then_takes_the_lease():
    async def run():
        fleet = make_coordinator("http://a:1", ["http://a:1"],
                                 lease_millis=80.0)
        assert fleet.leases.acquire("fp", "http://dead:9")[0]
        t0 = time.monotonic()
        assert await fleet.begin("fp") == ("lease", None)
        assert time.monotonic() - t0 < 2.0
        assert fleet.leases.expirations == 1

    go(run())


def test_owner_waiter_wakes_on_publish_with_a_hit():
    async def run():
        fleet = make_coordinator("http://a:1", ["http://a:1"])
        fleet.leases.acquire("fp", "http://peer:2")
        record = [{"fake": "record"}]

        async def remote_publishes():
            await asyncio.sleep(0.02)
            fleet.cache.put("fp", record, 64)
            fleet.leases.publish("fp")

        task = asyncio.get_running_loop().create_task(remote_publishes())
        plan = await fleet.begin("fp")
        await task
        assert plan == ("hit", record) and fleet.peer_hits == 1

    go(run())


def test_publish_without_running_loop_spawns_nothing():
    fleet = make_coordinator(URLS[0], URLS)
    fp = next(f"fp-{i}" for i in range(1000)
              if fleet.membership.owner(f"fp-{i}") != URLS[0])
    fleet.publish(fp, [])
    fleet.abandon(fp)
    assert fleet._tasks == set()
    assert (fleet.publishes, fleet.abandons) == (1, 1)


def test_publish_routes_on_pinned_view_across_roster_reload(tmp_path):
    async def run():
        me, other = URLS[0], URLS[1]
        peers_file = tmp_path / "peers.txt"
        peers_file.write_text(f"{me}\n")
        now = [0.0]
        fleet = FleetCoordinator(FleetConfig(self_url=me,
                                             peers_file=str(peers_file)),
                                 clock=lambda: now[0])
        fleet.cache = ScoreCache(60, 1 << 20)
        probe = FleetMembership(fleet_cfg(me, [me, other]))
        fp = next(f"fp-{i}" for i in range(1000)
                  if probe.owner(f"fp-{i}") == other)
        epoch0 = fleet.membership.epoch
        assert await fleet.begin(fp) == ("lease", None)
        # the roster grows mid-request: the live owner flips away
        peers_file.write_text(f"{me}\n{other}\n")
        os.utime(peers_file, (1e9, 1e9))
        now[0] += 2.0
        assert fleet.membership.owner(fp) == other
        assert fleet.membership.epoch > epoch0
        # the publish routes on the view pinned at begin
        fleet.publish(fp, [])
        assert fleet.leases.active() == 0 and fleet.leases.published == 1
        assert fleet._tasks == set()
        await fleet.close()

    go(run())


def test_departure_view_matches_bruteforce_ring_removal():
    me = URLS[0]
    m = FleetMembership(fleet_cfg(me, URLS))

    def brute(fp):
        key = xxh3_64_intdigest(fp.encode())
        best = None
        for peer in m.peers:
            if peer == me:
                continue
            for i in range(m.config.vnodes):
                point = xxh3_64_intdigest(f"{peer}#{i}".encode())
                distance = (point - key) % (1 << 64)
                if best is None or distance < best[0]:
                    best = (distance, peer)
        return best[1]

    for i in range(128):
        assert m.owner_excluding_self(f"fp-{i}") == brute(f"fp-{i}")
    assert FleetMembership(fleet_cfg(me, [me])).owner_excluding_self(
        "x") is None


# -- observability ----------------------------------------------------------------------


def test_fleet_metrics_sections_and_prom_families(cluster):
    nodes = cluster([[winning_script()], []])
    body = body_owned_by(nodes, nodes[0])
    assert nodes[0].score(body)[0] == 200
    assert nodes[1].score(body)[0] == 200
    status, raw = nodes[1].call("GET", "/metrics")
    metrics = json.loads(raw)
    fleet = metrics["fleet"]
    assert fleet["peer_fetch"]["hits"] == 1
    assert fleet["membership"]["self"] == nodes[1].url
    assert 0.0 < fleet["membership"]["owned_share"] < 1.0
    status, prom = nodes[1].call("GET", "/metrics?format=prometheus")
    text = prom.decode()
    assert 'lwc_fleet_peer_fetches_total{result="hits"} 1' in text
    assert "lwc_fleet_leases " in text
    owner_metrics = json.loads(nodes[0].call("GET", "/metrics")[1])
    assert owner_metrics["series"]["http:/fleet/v1/entry/{fp}"]["count"] \
        == 1


def test_a_server_without_a_fleet_has_no_fleet_routes():
    transport = PortFakeTransport([])
    chat = port_chat.DefaultChatClient(
        transport, [port_chat.ApiBase("https://up.example", "k")])
    with Server(None, chat_client=chat) as server:
        node = Node(port=server.port)
        assert node.call("GET", "/fleet/v1/ping")[0] == 404
        assert node.call("POST", "/fleet/v1/lease/fp", {})[0] == 404
        assert node.call("DELETE", "/fleet/v1/lease/fp")[0] == 404
        assert "fleet" not in json.loads(node.call("GET", "/metrics")[1])
        assert "fleet" not in json.loads(node.call("GET", "/readyz")[1])


def test_build_server_wires_the_fleet_from_the_knobs():
    from llm_weighted_consensus_tpu_torch.serve import __main__ as serve_main
    from llm_weighted_consensus_tpu_torch.serve.config import ServeConfig

    port = free_port()
    me = f"http://127.0.0.1:{port}"
    config = ServeConfig.from_env({
        "SCORE_CACHE_TTL": "60", "FLEET_SELF": me,
        "FLEET_PEERS": f"{me},http://127.0.0.1:9", "MEMGUARD": "0",
        "FLEET_LEASE_MILLIS": "1234", "AOT_CACHE_DIR": "/shared/aot"})
    server = serve_main.build_server(None, None, config, "127.0.0.1", port,
                                     device="cpu")
    try:
        assert server.fleet is not None
        assert server.score_client.fleet is server.fleet
        assert server.fleet.cache is server.score_client.cache
        assert server.fleet.leases.ttl_sec == 1.234
        server.start()
        server.lifecycle.mark_ready()
        node = Node(port=port)
        status, raw = node.call("GET", "/fleet/v1/ping")
        assert json.loads(raw) == {"ok": True, "self": me}
        assert json.loads(node.call("GET", "/readyz")[1])["fleet"][
            "self"] == me
    finally:
        server.close()


# -- the partition drill ---------------------------------------------------------------


# the per-request ENVELOPE: a random response id and a wall-clock created
# stamp; the replay contract covers every other byte of every frame
_VOLATILE = re.compile(rb'"id":"scrcpl-[0-9a-f]+-\d+"|"created":\d+')


def _normalize(payload: bytes) -> bytes:
    return _VOLATILE.sub(b"", payload)


def _clean(payload: bytes) -> bool:
    return b'"degraded":true' not in payload and b"corrupt" not in payload


def _drill_body(tag):
    return score_body(messages=[{"role": "user", "content": tag}],
                      stream=True)


def _bodies_owned_by(nodes, node, count, tag):
    out, i = [], 0
    while len(out) < count:
        body = _drill_body(f"{tag}-{i}")
        if owner_of(nodes, body) is node:
            out.append(body)
        i += 1
    return out


def run_drill(seed: int):
    """One partition drill on three port replicas: (history digest,
    counters, phases)."""
    history = []
    nodes = start_cluster(
        [[winning_script() for _ in range(16)] for _ in range(3)],
        lease_ms=30000.0, fetch_ms=250.0, probe_millis=100.0)
    a, b, c = nodes

    def upstream():
        return sum(n.upstream for n in nodes)

    def post_ok(node, body, phase):
        status, payload = node.score(body)
        assert status == 200, (phase, payload[:200])
        assert _clean(payload), (phase, payload[:200])
        return payload

    def record(node, body, phase):
        history.append((phase, post_ok(node, body, phase)))

    def record_gather(posts, phase):
        payloads = gather([lambda n=n, b=body: post_ok(n, b, phase)
                           for n, body in posts])
        history.extend((phase, p) for p in payloads)
        return payloads

    try:
        plans = []
        for node in nodes:
            plan = FleetFaultPlan(seed=seed)
            node.on_loop(lambda n=node, p=plan: setattr(
                n.fleet.client, "fault_plan", p))
            plans.append(plan)
        cond = {
            "b>a": _bodies_owned_by(nodes, a, 3, "cond-ba"),
            "c>a": _bodies_owned_by(nodes, a, 3, "cond-ca"),
            "a>b": _bodies_owned_by(nodes, b, 3, "cond-ab"),
            "a>c": _bodies_owned_by(nodes, c, 3, "cond-ac"),
        }
        # phase 1: healthy, exactly once fleet-wide
        bodies = [_drill_body(f"drill-{i}") for i in range(6)]
        for i, body in enumerate(bodies):
            record(nodes[i % 3], body, "healthy")
        settle(nodes)
        assert upstream() == len(bodies)
        for i, body in enumerate(bodies):
            record(nodes[(i + 1) % 3], body, "warm")
        assert upstream() == len(bodies)
        # phase 2: partition {a} | {b, c}, from a clean breaker slate
        for plan in plans:
            plan.partition([[a.url], [b.url, c.url]])
        for node in nodes:
            node.on_loop(lambda n=node: [
                br.force_close()
                for br in n.fleet.client.breakers._breakers.values()])
        for r in range(3):
            record_gather([(b, cond["b>a"][r]), (c, cond["c>a"][r]),
                           (a, cond["a>b"][r]), (a, cond["a>c"][r])],
                          "conditioning")
        quarantined = [n.on_loop(n.fleet.health.quarantined) for n in nodes]
        assert quarantined == [sorted([b.url, c.url]), [a.url], [a.url]]
        # a hot fingerprint into both components: one fan-out each
        before = upstream()
        hot = _drill_body("hot-question")
        hot_payloads = record_gather([(n, hot) for n in nodes], "hot")
        settle(nodes)
        assert upstream() - before == 2
        assert hot_payloads[1] == hot_payloads[2]
        # phase 3: heal, then a mangled peer payload
        for plan in plans:
            plan.heal()
        victim = _drill_body("mangle-probe")
        owner_url = b.on_loop(lambda: b.fleet.membership.view().owner(
            fp_of(victim)))
        owner = next(n for n in nodes if n.url == owner_url)
        record(owner, victim, "mangle-populate")
        settle(nodes)
        reader = b if owner is not b else c
        reader.on_loop(lambda: reader.fleet.client.fault_plan.set_pair(
            reader.url, owner.url, "corrupt", count=1))
        before = upstream()
        errors_before = reader.on_loop(lambda: reader.fleet.peer_errors)
        record(reader, victim, "mangle")
        # the wire guard refused the mangled record: the reader
        # recomputed locally and served clean bytes
        assert upstream() - before == 1
        assert reader.on_loop(lambda: reader.fleet.peer_errors) == \
            errors_before + 1
        # phase 4: probe re-admission and convergence
        time.sleep(0.15)
        record_gather([(n, _drill_body(f"heal-kick-{i}"))
                       for i, n in enumerate(nodes)], "heal-kick")
        settle(nodes)
        for node in nodes:
            assert node.on_loop(node.fleet.health.quarantined) == []
            assert node.on_loop(node.fleet.membership.quarantined) == []
        assert len({n.on_loop(n.fleet.membership.ring_digest)
                    for n in nodes}) == 1
        before = upstream()
        record_gather([(n, _drill_body("post-heal-hot")) for n in nodes],
                      "healed")
        settle(nodes)
        assert upstream() - before == 1
        stats = [n.on_loop(n.fleet.stats) for n in nodes]
        counters = {
            "upstream_total": upstream(),
            "quarantines": [s["health"]["quarantines"] for s in stats],
            "readmissions": [s["health"]["readmissions"] for s in stats],
            "ring_divergences": [s["ring_divergences"] for s in stats],
            "ring_rejects": [s["ring_rejects"] for s in stats],
            "early_takeovers": [s["early_takeovers"] for s in stats],
            "peer_5xx": [s["client"]["peer_5xx"] for s in stats],
        }
    finally:
        stop_cluster(nodes)
    digest = xxh3_64_hexdigest(b"|".join(
        phase.encode() + b":" + _normalize(payload)
        for phase, payload in history))
    return digest, counters, [phase for phase, _ in history]


@pytest.fixture(scope="module")
def drill():
    return run_drill(DRILL_SEED)


def test_partition_drill_split_brain_and_heal(drill):
    digest, counters, phases = drill
    assert counters["quarantines"] == [2, 1, 1]
    assert counters["readmissions"] == [2, 1, 1]
    # a static roster never diverges: the cut was at the transport
    assert counters["ring_divergences"] == [0, 0, 0]
    assert counters["ring_rejects"] == [0, 0, 0]
    assert counters["early_takeovers"] == [0, 0, 0]
    assert counters["peer_5xx"] == [0, 0, 0]
    assert len(digest) == 16
    for phase in ("healthy", "warm", "conditioning", "hot", "mangle",
                  "heal-kick", "healed"):
        assert phase in phases


def test_partition_drill_replays_byte_identically_from_seed(drill):
    second = run_drill(DRILL_SEED)
    assert second == drill


# -- crash consistency: kill -9 mid-append ----------------------------------------------


_CHILD = textwrap.dedent(
    """
    import os, signal
    from llm_weighted_consensus_tpu_torch.cache import ScoreCache
    from llm_weighted_consensus_tpu_torch.obs import OutcomeLedger

    cache = ScoreCache(600.0, 1 << 20, disk_dir={cache_dir!r})
    for i in range(3):
        cache.put_chunks(
            "fp-%d" % i,
            [{{"id": "chunk-%d" % i, "object": "chat.completion.chunk"}}],
        )
    # torn tail: a partial record flushed right before the crash
    cache._segment.write('{{"k":"fp-torn","e":9e9,"v":[')
    cache._segment.flush()
    os.fsync(cache._segment.fileno())

    ledger = OutcomeLedger(capacity=8, disk_dir={ledger_dir!r})
    ledger.offer({{"id": "r-0", "verdict": "ok"}})
    ledger.offer({{"id": "r-1", "verdict": "ok"}})
    with open(ledger._disk_path, "a", encoding="utf-8") as f:
        f.write('{{"id": "r-torn", "ver')
        f.flush()
        os.fsync(f.fileno())

    os.kill(os.getpid(), signal.SIGKILL)
    """
)


def test_kill9_mid_append_recovers_and_counts_the_tear(tmp_path):
    from llm_weighted_consensus_tpu_torch.obs import load_ledger_records

    cache_dir = str(tmp_path / "cache")
    ledger_dir = str(tmp_path / "ledger")
    proc = subprocess.run(
        [sys.executable, "-c",
         _CHILD.format(cache_dir=cache_dir, ledger_dir=ledger_dir)],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == -signal.SIGKILL, proc.stderr
    reborn = ScoreCache(600.0, 1 << 20, disk_dir=cache_dir)
    assert reborn.disk_loaded == 3
    assert reborn.disk_torn == 1
    assert reborn.stats()["disk_torn"] == 1
    for i in range(3):
        assert reborn.get(f"fp-{i}") == [
            {"id": f"chunk-{i}", "object": "chat.completion.chunk"}]
    records, torn = load_ledger_records(ledger_dir)
    assert [r["id"] for r in records] == ["r-0", "r-1"]
    assert torn == 1


# -- a training-table panel on bge_micro -----------------------------------------------


FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "bge_micro")
TT_PROMPTS = ["what is the capital of france", "paris is in france",
              "bananas are yellow", "how do rivers form",
              "the capital city of france is paris", "tell me about lyon"]


def tt_panel(n_judges=4, top=3):
    return {
        "llms": [{"model": f"judge-{i}", "weight": {
            "type": "training_table", "base_weight": 1 + i % 2,
            "min_weight": 1, "max_weight": 2 + i}}
            for i in range(n_judges)],
        "weight": {"type": "training_table",
                   "embeddings": {"model": "bge-micro", "max_tokens": 32},
                   "top": top},
    }


@pytest.fixture(scope="module")
def micro_embedder():
    from llm_weighted_consensus_tpu_torch.models import loading, tokenizer
    from llm_weighted_consensus_tpu_torch.models.embedder import TorchEmbedder

    cfg = loading.load_hf_config(FIXTURE)
    return TorchEmbedder(
        "bge-micro", model=loading.load_params(FIXTURE, cfg, device="cpu"),
        config=cfg,
        tokenizer=tokenizer.load_tokenizer(loading.find_vocab(FIXTURE)),
        max_tokens=64, device="cpu")


def _tables(embedder):
    import numpy as np

    from llm_weighted_consensus_tpu_torch.identity.model import ModelBase
    from llm_weighted_consensus_tpu_torch.weights.training_table import (
        TrainingTableStore,
    )

    model = ModelBase.from_json_obj(tt_panel()).into_model_validate()
    rows = np.asarray(embedder.embed_texts(TT_PROMPTS), np.float32)
    rng = np.random.default_rng(0)
    store = TrainingTableStore()
    for pos, llm in enumerate(model.llms[:3]):
        keep = rng.permutation(len(rows))[:len(rows) - pos]
        store.add_rows(llm.training_table_id, rows[keep],
                       rng.random(len(keep)).astype(np.float32))
    return store


def _tt_node(embedder, scripts, self_url=None, peers=(), port=0):
    from llm_weighted_consensus_tpu_torch.weights import WeightFetchers
    from llm_weighted_consensus_tpu_torch.weights.training_table import (
        TorchTrainingTableFetcher,
    )

    cache = ScoreCache(60, 1 << 20)
    fleet = None
    if self_url is not None:
        fleet = FleetCoordinator(fleet_cfg(self_url, peers))
        fleet.cache = cache
    transport = PortFakeTransport(scripts)
    chat = port_chat.DefaultChatClient(
        transport, [port_chat.ApiBase("https://up.example", "k")],
        backoff=port_chat.BackoffPolicy(max_elapsed_ms=0))
    score = ScoreClient(
        chat, port_registry.InMemoryModelRegistry(),
        archive_fetcher=port_archive.InMemoryArchive(),
        rng_factory=lambda: random.Random(SEED), cache=cache, fleet=fleet)
    server = Server(embedder, host="127.0.0.1", port=port, chat_client=chat,
                    score_client=score, fleet=fleet)
    score.weight_fetchers = WeightFetchers(
        training_table_fetcher=TorchTrainingTableFetcher(
            embedder, _tables(embedder), batcher=server.batcher))
    server.start()
    return Node(url=self_url, port=server.port, cache=cache, fleet=fleet,
                transport=transport, server=server)


def _dispatches(node) -> int:
    series = node.server.metrics.snapshot()["series"]
    return sum(v["count"] for k, v in series.items()
               if k.startswith("device:batch:"))


def test_a_training_table_stampede_costs_one_panel_and_one_embed(
        micro_embedder):
    keys = ballot_keys(2)
    panel_scripts = [Script([chunk_obj(f"pick {keys[1]}", finish="stop")])
                     for _ in range(4)]
    body = {"messages": [{"role": "user",
                          "content": "which city is the capital of france?"}],
            "model": tt_panel(), "choices": ["paris", "lyon"],
            "stream": True}
    alone = _tt_node(micro_embedder, list(panel_scripts))
    ports = [free_port() for _ in range(3)]
    urls = [f"http://127.0.0.1:{p}" for p in ports]
    nodes = [_tt_node(micro_embedder, list(panel_scripts), urls[i], urls,
                      ports[i]) for i in range(3)]
    try:
        status, want = alone.score(body)
        assert status == 200 and alone.upstream == 4
        before = [_dispatches(n) for n in nodes]
        results = gather([lambda n=n: n.score(body) for _ in range(4)
                          for n in nodes])
        assert {status for status, _ in results} == {200}
        assert len({raw for _, raw in results}) == 1
        # one panel of judge calls and one prompt-embed dispatch,
        # fleet-wide
        assert sum(n.upstream for n in nodes) == 4
        assert sum(_dispatches(n) for n in nodes) - sum(before) == 1
        # the frames are a fleet-less server's, envelope aside
        assert _normalize(results[0][1]) == _normalize(want)
        final = [json.loads(line[len(b"data: "):])
                 for line in want.split(b"\n\n")
                 if line.startswith(b"data: {")][-1]
        assert final["weight_data"]["type"] == "training_table"
    finally:
        alone.server.close()
        stop_cluster(nodes)


def test_a_two_replica_stampede_is_witness_clean(micro_embedder):
    """``LOCK_WITNESS=1`` over a two-replica stampede on the served path
    (``build_server``): every acquisition the fleet's hops cause keeps
    the registered order, and the fleet adds no primitive."""
    from llm_weighted_consensus_tpu_torch.serve import __main__ as serve_main
    from llm_weighted_consensus_tpu_torch.serve.config import ServeConfig
    from llm_weighted_consensus_tpu_torch.serve.fake_upstream import (
        FakeUpstream,
    )

    fake = FakeUpstream()
    ports = [free_port() for _ in range(2)]
    urls = [f"http://127.0.0.1:{p}" for p in ports]
    servers = []
    try:
        for i, port in enumerate(ports):
            config = ServeConfig.from_env({
                "SCORE_CACHE_TTL": "60", "FLEET_SELF": urls[i],
                "FLEET_PEERS": ",".join(urls), "LOCK_WITNESS": "1",
                "MEMGUARD": "0"})
            config.upstream["api_bases"] = [{"api_base": fake.url,
                                             "api_key": "k"}]
            server = serve_main.build_server(
                micro_embedder, None, config, "127.0.0.1", port,
                device="cpu")
            server.start()
            server.lifecycle.mark_ready()
            servers.append(server)
        nodes = [Node(port=p) for p in ports]
        body = score_body(stream=True, messages=[
            {"role": "user", "content": "witnessed"}])
        results = gather([lambda n=n: n.score(body) for _ in range(6)
                          for n in nodes])
        assert {s for s, _ in results} == {200}
        assert len({raw for _, raw in results}) == 1
        assert fake.requests == 1
        for server in servers:
            snap = json.loads(Node(port=server.port).call(
                "GET", "/metrics")[1])["lock_witness"]
            assert snap["violations"] == [] and snap["undeclared"] == [], snap
            assert snap["acquisitions"] > 0
            assert server.lock_witness.snapshot()["violations"] == []
    finally:
        for server in servers:
            server.close()
        fake.close()


def test_a_hot_set_past_the_body_cap_is_handed_off_in_pushes(cluster):
    """A hot set larger than a peer's body cap (``MAX_BODY_BYTES``, 1 MiB
    by default) goes out in pushes of at most ``HANDOFF_BATCH_BYTES``
    each, so every entry arrives; sent whole, as the reference sends it,
    the peer answers 413 and the drain hands nothing off."""
    from llm_weighted_consensus_tpu_torch.fleet import coordinator

    record = recorded(cluster)
    # a record padded to ~60 KB, as a bge-large training-table record
    # carries its 1024-float prompt embedding
    record[0]["system_fingerprint"] = "x" * 60000
    nodes = cluster([[], []], cache_bytes=8 << 20)
    a, b = nodes
    n = 30
    a.on_loop(lambda: [a.cache.put_chunks(f"fp-{i}", record)
                       for i in range(n)])
    body = jsonutil.dumps({"from": a.url, "entries": [
        {"fp": f"fp-{i}", "chunks": record, "ttl_sec": 30.0}
        for i in range(n)]}).encode()
    assert len(body) > 1 << 20
    assert b.call("POST", "/fleet/v1/handoff", body)[0] == 413
    # the reference's one push per target: refused, nothing handed off
    whole = jsonutil.loads(body.decode())["entries"]
    assert a.server.fleet_routes._run(
        a.fleet.client.handoff(b.url, whole)) == 0
    accepted = a.server.fleet_routes._run(a.fleet.handoff(a.cache))
    assert accepted == n
    pushes = b.server.metrics.snapshot()["series"]["http:/fleet/v1/handoff"]
    assert pushes["count"] - 1 >= n * 60000 // coordinator.HANDOFF_BATCH_BYTES
    assert all(b.cache.holds(f"fp-{i}") for i in range(n))
