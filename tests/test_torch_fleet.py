"""The port's fleet tier, unit by unit, against the JAX package's on the
CPU, with exact equality throughout.

The same seeds and inputs go into both packages: the XXH3-64 the ring,
the fault plan and the record digests run on (against the ``xxhash``
package, which only this test imports), the consistent-hash ring
(owners, ``ring_digest``, ``owned_share``, ``departure_view``, the
watched peers file), the lease table under scripted sequences on an
injected clock, peer health, the seeded fault plan's first 256 decisions
per ordered pair and ``parse``'s refusals, the wire guard and record
digests, the cache pieces the fleet needs (``put(ttl_sec)``,
``hot_entries``, ``chunks_from_record``, ``SingleFlight.do``), the
breaker's ``force_close`` and ``peek``, the ``FLEET_*`` knobs, and the
``fleet`` metrics section with its ``lwc_fleet_*`` lines.
"""

import asyncio
import dataclasses
import os
import random
import time

import numpy as np
import pytest
import xxhash

from llm_weighted_consensus_tpu import archive as ref_archive
from llm_weighted_consensus_tpu import registry as ref_registry
from llm_weighted_consensus_tpu.cache import replay as ref_replay
from llm_weighted_consensus_tpu.cache import singleflight as ref_sf
from llm_weighted_consensus_tpu.cache import store as ref_store
from llm_weighted_consensus_tpu.clients import chat as ref_chat
from llm_weighted_consensus_tpu.clients import score as ref_score
from llm_weighted_consensus_tpu import fleet as ref_fleet
from llm_weighted_consensus_tpu.resilience import breaker as ref_breaker
from llm_weighted_consensus_tpu.serve import metrics as ref_metrics
from llm_weighted_consensus_tpu.serve.config import Config as RefConfig
from llm_weighted_consensus_tpu.types import score_request as ref_req
from llm_weighted_consensus_tpu.utils import jsonutil as ref_json
from llm_weighted_consensus_tpu_torch import archive as port_archive
from llm_weighted_consensus_tpu_torch import fleet as port_fleet
from llm_weighted_consensus_tpu_torch import registry as port_registry
from llm_weighted_consensus_tpu_torch.cache import replay as port_replay
from llm_weighted_consensus_tpu_torch.cache import singleflight as port_sf
from llm_weighted_consensus_tpu_torch.cache import store as port_store
from llm_weighted_consensus_tpu_torch.clients import chat as port_chat
from llm_weighted_consensus_tpu_torch.clients import score as port_score
from llm_weighted_consensus_tpu_torch.identity.xxh3 import (
    xxh3_64_hexdigest,
    xxh3_64_intdigest,
)
from llm_weighted_consensus_tpu_torch.resilience import breaker as port_breaker
from llm_weighted_consensus_tpu_torch.serve import metrics as port_metrics
from llm_weighted_consensus_tpu_torch.serve.config import ServeConfig
from llm_weighted_consensus_tpu_torch.types import score_request as port_req
from llm_weighted_consensus_tpu_torch.utils import jsonutil as port_json

from fakes import FakeTransport, Script, chunk_obj
from test_torch_chat_client import PortFakeTransport

SEED = 11
PKGS = {"ref": ref_fleet, "port": port_fleet}


def go(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


def both(fn):
    """``fn(pkg)`` for the reference and the port."""
    return fn(ref_fleet), fn(port_fleet)


# -- XXH3-64 --------------------------------------------------------------------


@pytest.mark.parametrize("lo", range(0, 301, 25))
def test_xxh3_64_is_xxhash_on_every_length_to_300(lo):
    rng = np.random.default_rng(lo)
    for n in range(lo, min(lo + 25, 301)):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert xxh3_64_intdigest(data) == xxhash.xxh3_64_intdigest(data), n
        assert xxh3_64_hexdigest(data) == xxhash.xxh3_64_hexdigest(data), n


def test_xxh3_64_is_xxhash_on_random_lengths_to_4096():
    rng = np.random.default_rng(0)
    for n in rng.integers(0, 4097, 64):
        data = rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
        assert xxh3_64_intdigest(data) == xxhash.xxh3_64_intdigest(data), n
    # the labels the fleet hashes: ring points, fault seeds, digests
    for label in ("http://10.0.0.1:5000#3", "7:http://a:1>http://b:1:12",
                  "fleet-share-probe:9", ""):
        raw = label.encode()
        assert xxh3_64_intdigest(raw) == xxhash.xxh3_64_intdigest(raw)


# -- the ring ---------------------------------------------------------------------


def _urls(n):
    return [f"http://10.0.0.{i + 1}:5000" for i in range(n)]


@pytest.mark.parametrize("n_peers,vnodes", [(3, 64), (3, 7), (5, 64),
                                            (5, 7)])
def test_the_ring_is_the_references(n_peers, vnodes):
    urls = _urls(n_peers)
    fps = [f"fp-{i}" for i in range(1000)]
    for me in urls:
        ref, port = both(lambda p: p.FleetMembership(
            p.FleetConfig(self_url=me, peers=list(urls), vnodes=vnodes)))
        assert [port.owner(f) for f in fps] == [ref.owner(f) for f in fps]
        assert [port.owner_excluding_self(f) for f in fps] == [
            ref.owner_excluding_self(f) for f in fps]
        assert port.ring_digest() == ref.ring_digest()
        assert port.owned_share() == ref.owned_share()
        assert port.snapshot() == ref.snapshot()
        dport, dref = port.departure_view(), ref.departure_view()
        assert dport.peers == dref.peers and me not in dport.peers
        assert dport._points == dref._points


def test_quarantine_masks_the_ring_and_keeps_the_digest():
    urls = _urls(3)
    ref, port = both(lambda p: p.FleetMembership(
        p.FleetConfig(self_url=urls[0], peers=urls)))
    for sick in ({urls[1]}, {urls[1]}, set(), {urls[0], urls[2]}):
        ref.set_quarantined(sick)
        port.set_quarantined(sick)
        assert port.epoch == ref.epoch
        assert port.snapshot() == ref.snapshot()
        assert [port.owner(f"k{i}") for i in range(256)] == [
            ref.owner(f"k{i}") for i in range(256)]


def test_the_watched_peers_file_reloads_as_the_references(tmp_path):
    roster = tmp_path / "peers.txt"
    roster.write_text("# fleet roster\nhttp://a:1/\n\nhttp://b:2\n")
    now = [100.0]
    ref, port = both(lambda p: p.FleetMembership(
        p.FleetConfig(self_url="http://a:1", peers_file=str(roster)),
        clock=lambda: now[0]))
    seen = []
    for step in range(4):
        if step == 1:
            roster.write_text("http://a:1\nhttp://b:2\nhttp://c:3\n")
            os.utime(roster, (time.time() + 5, time.time() + 5))
        if step == 3:
            roster.unlink()  # a missing file keeps the roster
        now[0] += 0.6
        seen.append((ref.peers, port.peers, ref.reloads, port.reloads,
                     ref.epoch, port.epoch))
    for r_peers, p_peers, r_n, p_n, r_e, p_e in seen:
        assert (r_peers, r_n, r_e) == (p_peers, p_n, p_e)
    assert seen[-1][1] == ["http://a:1", "http://b:2", "http://c:3"]


# -- the lease table ----------------------------------------------------------------

# each op: (name, *args); "advance" moves the injected clock
LEASE_SCRIPTS = {
    "grant_wait_publish": [
        ("acquire", "fp", "http://a:1"), ("acquire", "fp", "http://b:2"),
        ("publish", "fp", None), ("wait", 1, 1.0)],
    "release_wakes_waiters": [
        ("acquire", "fp", "http://a:1"), ("acquire", "fp", "http://b:2"),
        ("release", "fp", "http://nobody:9"), ("release", "fp", "http://a:1"),
        ("wait", 1, 1.0), ("acquire", "fp", "http://b:2")],
    "expiry_regrants": [
        ("acquire", "fp", "http://a:1"), ("acquire", "fp", "http://b:2"),
        ("advance", 1.5), ("acquire", "fp", "http://b:2"), ("wait", 1, 1.0),
        ("holder", "fp")],
    "same_holder_reclaim_extends": [
        ("acquire", "fp", "http://a:1"), ("advance", 0.8),
        ("acquire", "fp", "http://a:1"), ("advance", 0.5),
        ("holder_future", "fp"), ("remaining", "fp")],
    "steal_and_late_publish": [
        ("acquire", "fp", "http://a:1"), ("acquire", "fp", "http://b:2"),
        ("steal", "fp", "http://c:3"), ("wait", 1, 1.0),
        ("steal", "fp", "http://c:3"), ("holder", "fp"),
        ("publish", "fp", "http://a:1"), ("publish", "fp", "http://c:3"),
        ("steal", "fp", "http://d:4")],
    "late_publish_after_expiry": [
        ("acquire", "fp", "http://a:1"), ("advance", 2.0),
        ("publish", "fp", "http://a:1"), ("acquire", "fp", "http://b:2"),
        ("publish", "fp", "http://b:2")],
    "wait_timeout_keeps_the_shared_future": [
        ("acquire", "fp", "http://a:1"), ("acquire", "fp", "http://b:2"),
        ("wait", 1, 0.01), ("cancelled", 1), ("publish", "fp", None),
        ("wait", 1, 1.0)],
    "many_fingerprints_expire_lazily": [
        ("acquire", "f1", "http://a:1"), ("advance", 0.4),
        ("acquire", "f2", "http://a:1"), ("advance", 0.7),
        ("active",), ("holder", "f1"), ("holder", "f2"),
        ("remaining", "f2"), ("advance", 1.0), ("active",),
        ("holder_future", "f2")],
}


def _run_leases(pkg, script):
    async def run():
        now = [0.0]
        table = pkg.LeaseTable(1000, clock=lambda: now[0])
        futures, trace = [], []
        for op, *args in script:
            if op == "advance":
                now[0] += args[0]
                continue
            if op == "acquire":
                granted, fut = table.acquire(*args)
                futures.append(fut)
                trace.append((op, granted, fut is None))
            elif op == "wait":
                trace.append((op, await table.wait(futures[args[0]],
                                                   args[1])))
            elif op == "cancelled":
                trace.append((op, futures[args[0]].cancelled()))
            elif op == "holder_future":
                trace.append((op, table.holder_future(*args) is None))
            elif op == "remaining":
                trace.append((op, round(table.remaining_sec(*args), 9)))
            elif op == "active":
                trace.append((op, table.active()))
            else:
                trace.append((op, getattr(table, op)(*args)))
        return trace, table.stats()

    return go(run())


@pytest.mark.parametrize("name", sorted(LEASE_SCRIPTS))
def test_the_lease_table_follows_the_references_trace(name):
    ref, port = both(lambda p: _run_leases(p, LEASE_SCRIPTS[name]))
    assert port == ref


# -- peer health ---------------------------------------------------------------------


HEALTH_SCRIPTS = {
    "flapper": [("record", "p", ok) for ok in
                [True, False, True, False, True, False, True]] + [
        ("record", "p", True), ("due",), ("advance", 0.2), ("due",),
        ("due",), ("probe", "p", False), ("advance", 0.2), ("due",),
        ("probe", "p", True), ("record", "p", False)],
    "consecutive_failures": [("record", "q", False)] * 2 + [
        ("record", "q", True)] + [("record", "q", False)] * 3 + [
        ("record", "r", False), ("advance", 0.05), ("due",),
        ("advance", 0.1), ("due",), ("probe", "q", True), ("due",)],
    "disabled": [("threshold", 0)] + [("record", "p", False)] * 10 + [
        ("due",)],
}


def _run_health(pkg, script):
    now = [0.0]
    threshold = 3
    if script and script[0][0] == "threshold":
        threshold, script = script[0][1], script[1:]
    health = pkg.PeerHealth(threshold, 100.0, clock=lambda: now[0])
    trace = []
    for op, *args in script:
        if op == "advance":
            now[0] += args[0]
        elif op == "record":
            health.record(*args)
        elif op == "due":
            trace.append(health.probes_due())
        elif op == "probe":
            health.record_probe(*args)
        trace.append(health.quarantined())
    return trace, health.stats()


@pytest.mark.parametrize("name", sorted(HEALTH_SCRIPTS))
def test_peer_health_quarantines_and_readmits_as_the_reference(name):
    ref, port = both(lambda p: _run_health(p, HEALTH_SCRIPTS[name]))
    assert port == ref


# -- the fault plan -----------------------------------------------------------------


PAIRS_OF = _urls(3)
PROBS = {"blackhole": 0.1, "slow": 0.1, "connect": 0.05, "5xx": 0.1,
         "corrupt": 0.05, "flap": 0.1}


@pytest.mark.parametrize("seed", [0, 7, 1729])
def test_the_seeded_fault_plan_draws_the_references_faults(seed):
    def draws(pkg):
        plan = pkg.FleetFaultPlan(seed=seed, probabilities=PROBS)
        out = {}
        for src in PAIRS_OF:
            for dst in PAIRS_OF:
                if src != dst:
                    out[(src, dst)] = [plan.next_fault(src, dst)
                                       for _ in range(256)]
        return out, plan.snapshot(), plan.injected

    ref, port = both(lambda p: draws(p.faults))
    assert port == ref
    assert sum(port[2].values()) > 0


def test_scripts_scopes_partitions_and_heal_follow_the_reference():
    a, b, c = PAIRS_OF

    def drive(pkg):
        out = []
        plan = pkg.FleetFaultPlan.parse(
            "seed=3,blackhole=0.5,slow_ms=40,to=" + b)
        out.append((plan.seed, plan.slow_ms, plan.probabilities))
        out.append([plan.next_fault(a, c) for _ in range(20)])
        out.append([plan.next_fault(a, b) for _ in range(20)])
        scripted = pkg.FleetFaultPlan.parse("script=connect|ok|5xx")
        out.append([scripted.next_fault(a, b) for _ in range(4)])
        out.append(scripted.next_fault(a, c))
        plan = pkg.FleetFaultPlan()
        plan.partition([[a], [b, c]])
        out.append([plan.next_fault(x, y) for x, y in
                    ((a, b), (b, a), (c, a), (b, c))])
        plan.set_pair(b, c, "corrupt", count=2)
        out.append([plan.next_fault(b, c) for _ in range(3)])
        plan.heal()
        out.append((plan.next_fault(a, b), plan.snapshot(), plan.injected))
        payload = {"chunks": [{"x": 1}, {"y": 2}], "found": True}
        out.append(pkg.corrupt_payload(payload))
        out.append(pkg.corrupt_payload({"found": False}))
        return out

    ref, port = both(lambda p: drive(p.faults))
    assert port == ref


@pytest.mark.parametrize("spec", ["nope", "bogus=1", "script=warp", "seed",
                                  "seed=x", "blackhole=lots", "slow_ms=",
                                  "script=ok|flap|teleport"])
def test_fault_plan_parse_refuses_as_the_reference(spec):
    errors = []
    for pkg in (ref_fleet, port_fleet):
        with pytest.raises(ValueError) as exc:
            pkg.FleetFaultPlan.parse(spec)
        errors.append(str(exc.value))
    assert errors[0] == errors[1]


# -- the wire guard and record digests -----------------------------------------------


def _keys(n):
    from llm_weighted_consensus_tpu.ballot import PrefixTree

    rng = random.Random(SEED)
    tree = PrefixTree.build(rng, n, 20)
    return {idx: k for k, idx in tree.key_indices(rng)}


SCORE_BODY = {"messages": [{"role": "user", "content": "q"}],
              "model": {"llms": [{"model": "j1"}]},
              "choices": ["first", "second"]}


def recorded_chunks(pkg="port"):
    """A real clean record: one scored request through the package's
    score client and cache."""
    keys = _keys(2)
    script = Script([chunk_obj(f"pick {keys[1]}", finish="stop")])
    if pkg == "port":
        cache = port_store.ScoreCache(60, 1 << 20)
        chat = port_chat.DefaultChatClient(
            PortFakeTransport([script]),
            [port_chat.ApiBase("https://up.example", "k")],
            backoff=port_chat.BackoffPolicy(max_elapsed_ms=0))
        client = port_score.ScoreClient(
            chat, port_registry.InMemoryModelRegistry(),
            archive_fetcher=port_archive.InMemoryArchive(),
            rng_factory=lambda: random.Random(SEED), cache=cache)
        params = port_req.ChatCompletionCreateParams.from_json_obj(
            SCORE_BODY)
    else:
        cache = ref_store.ScoreCache(60, 1 << 20)
        chat = ref_chat.DefaultChatClient(
            FakeTransport([script]),
            [ref_chat.ApiBase("https://up.example", "k")],
            backoff=ref_chat.BackoffPolicy(max_elapsed_ms=0))
        client = ref_score.ScoreClient(
            chat, ref_registry.InMemoryModelRegistry(),
            archive_fetcher=ref_archive.InMemoryArchive(),
            rng_factory=lambda: random.Random(SEED), cache=cache)
        params = ref_req.ChatCompletionCreateParams.from_json_obj(SCORE_BODY)

    async def run():
        stream = await client.create_streaming(None, params)
        async for _ in stream:
            pass

    go(run())
    (record,) = [v for v, _, _ in cache._entries.values()]
    return record


def _variants():
    clean = recorded_chunks("port")
    out = {"clean": clean}
    degraded = port_json.loads(port_json.dumps(clean))
    degraded[-1]["degraded"] = True
    out["degraded"] = degraded
    errored = port_json.loads(port_json.dumps(clean))
    errored[0]["choices"][0]["error"] = {"message": "judge failed"}
    out["errored"] = errored
    truncated = port_json.loads(port_json.dumps(clean))
    out["corrupted"] = truncated[:-1] + [{"corrupt": "fleet-fault-injected"}]
    out["none"] = None
    out["empty"] = []
    out["string"] = "not a list"
    out["ints"] = [1, 2]
    out["not_a_chunk"] = [{"not": "a chunk"}]
    return out


VARIANTS = ["clean", "degraded", "errored", "corrupted", "none", "empty",
            "string", "ints", "not_a_chunk"]


@pytest.fixture(scope="module")
def variants():
    return _variants()


@pytest.mark.parametrize("name", VARIANTS)
def test_the_wire_guard_is_the_references(name, variants):
    record = variants[name]
    ref = ref_fleet.clean_chunk_objs(ref_json.loads(ref_json.dumps(record)))
    port = port_fleet.clean_chunk_objs(
        port_json.loads(port_json.dumps(record)))
    assert port == ref
    assert (port is not None) == (name == "clean")
    if port is not None:
        assert port_fleet.record_digest(port) == ref_fleet.record_digest(ref)


def test_the_port_records_what_the_reference_records(variants):
    ref = recorded_chunks("ref")
    port = variants["clean"]

    def masked(record):
        out = []
        for obj in record:
            obj = dict(obj, id="x", created=0)
            out.append(obj)
        return out

    assert port_json.dumps(masked(port)) == ref_json.dumps(masked(ref))
    # the digest is over the canonical JSON, so equal records hash equal
    assert port_fleet.record_digest(masked(port)) == \
        ref_fleet.record_digest(masked(ref))


@pytest.mark.parametrize("name", ["clean", "corrupted", "not_a_chunk"])
def test_chunks_from_record_decodes_as_the_reference(name, variants):
    record = variants[name]
    ref = ref_replay.chunks_from_record(record)
    port = port_replay.chunks_from_record(record)
    assert (port is None) == (ref is None)
    if port is not None:
        assert [port_json.dumps(c.to_json_obj()) for c in port] == [
            ref_json.dumps(c.to_json_obj()) for c in ref]


# -- the cache pieces ---------------------------------------------------------------


def _store_trace(mod):
    now = [0.0]
    store = mod.CacheStore(10.0, 1 << 20, clock=lambda: now[0])
    out = []
    store.put("short", "v", 1, ttl_sec=2.0)
    store.put("long", "v", 1, ttl_sec=99.0)  # clamped to the store TTL
    store.put("dead", "v", 1, ttl_sec=0.0)   # expired on arrival: dropped
    store.put("plain", "v", 1)
    out.append(store.get("dead"))
    for t in (1.0, 3.0, 9.5, 11.0):
        now[0] = t
        out.append([store.get(k) for k in ("short", "long", "plain")])
    for i in range(4):
        store.put(f"fp{i}", f"v{i}", 1)
    store.get("fp1")
    now[0] = 16.0
    store.put("fresh", "vf", 1)
    out.append(store.hot_entries(3))
    now[0] = 22.0
    out.append(store.hot_entries(10))
    out.append(store.stats())
    off = mod.CacheStore(0.0, 1 << 20)
    out.append(off.hot_entries(5))
    score = mod.ScoreCache(30.0, 1 << 20, clock=lambda: now[0])
    score.put_chunks("a", [{"k": 1, "trace_id": "t"}], ttl_sec=5.0)
    now[0] = 28.0
    out.append(score.get("a"))
    return out


def test_put_clamps_its_ttl_and_hot_entries_are_mru_first_as_the_reference():
    assert _store_trace(port_store) == _store_trace(ref_store)


def test_the_lease_guards_holds_reads_without_counting():
    now = [0.0]
    store = port_store.CacheStore(10.0, 1 << 20, clock=lambda: now[0])
    store.put("a", "v", 1)
    before = store.stats()
    assert store.holds("a") and not store.holds("b")
    assert store.stats() == before
    now[0] = 10.0
    assert not store.holds("a")
    assert not port_store.CacheStore(0.0, 1).holds("a")


def _singleflight_trace(mod):
    async def run():
        flights = mod.SingleFlight()
        calls = []

        async def factory():
            calls.append(1)
            await asyncio.sleep(0.01)
            return "value"

        results = await asyncio.gather(
            *(flights.do("k", factory) for _ in range(5)))
        # a cancelled leader hands the flight to a follower
        started = asyncio.Event()

        async def slow():
            calls.append(2)
            started.set()
            await asyncio.sleep(10)

        async def fast():
            calls.append(3)
            return "promoted"

        leader = asyncio.ensure_future(flights.do("j", slow))
        await started.wait()
        follower = asyncio.ensure_future(flights.do("j", fast))
        await asyncio.sleep(0)
        leader.cancel()
        got = await follower
        with pytest.raises(asyncio.CancelledError):
            await leader
        return results, got, calls, flights.collapses, len(flights)

    return go(run())


def test_singleflight_do_collapses_and_promotes_as_the_reference():
    port = _singleflight_trace(port_sf)
    assert port == _singleflight_trace(ref_sf)
    assert port[0] == ["value"] * 5 and port[2].count(1) == 1


def _breaker_trace(mod):
    now = [0.0]
    reg = mod.BreakerRegistry(
        mod.BreakerConfig(threshold=0.5, window=10, min_samples=3,
                          cooldown_ms=3000.0),
        clock=lambda: now[0])
    out = [reg.peek("http://p:1", "fleet")]
    b = reg.get("http://p:1", "fleet")
    out.append(reg.peek("http://p:1", "fleet"))
    for _ in range(3):
        b.allow()
        b.record_failure()
    out.append((reg.peek("http://p:1", "fleet"), b.allow()))
    b.force_close()
    out.append((reg.peek("http://p:1", "fleet"), b.allow(), b.snapshot()))
    now[0] = 5.0
    for _ in range(3):
        b.record_failure()
    now[0] = 9.0
    out.append((b.allow(), reg.peek("http://p:1", "fleet")))
    b.force_close()  # a half-open probe slot is freed too
    out.append((b.allow(), b.allow(), reg.snapshot()))
    out.append(reg.peek("http://q:1", "fleet"))
    return out


def test_breaker_force_close_and_peek_are_the_references():
    port = _breaker_trace(port_breaker)
    assert port == _breaker_trace(ref_breaker)
    assert port[0] is None and port[1] == "closed"


# -- the FLEET_* knobs ------------------------------------------------------------------

BASE = {"SCORE_CACHE_TTL": "60", "FLEET_SELF": "http://a:1/"}
ACCEPTED = {
    "static": dict(BASE, FLEET_PEERS="http://a:1/, http://b:2 ,"),
    "file": dict(BASE, FLEET_PEERS_FILE="/etc/fleet/peers"),
    "tuned": dict(BASE, FLEET_PEERS="http://a:1", FLEET_VNODES="0",
                  FLEET_LEASE_MILLIS="250.5", FLEET_FETCH_TIMEOUT_MILLIS="75",
                  FLEET_FAULT_PLAN="seed=7,blackhole=0.05,to=http://b:2",
                  FLEET_QUARANTINE_FAILURES="0", FLEET_PROBE_MILLIS="40"),
    "off": {},
}
REFUSED = {
    "both_rosters": dict(BASE, FLEET_PEERS="http://a:1",
                         FLEET_PEERS_FILE="/p"),
    "roster_without_self": {"SCORE_CACHE_TTL": "60",
                            "FLEET_PEERS": "http://a:1"},
    "self_without_roster": dict(BASE),
    "self_not_in_peers": dict(BASE, FLEET_PEERS="http://b:2"),
    "no_cache": {"FLEET_SELF": "http://a:1", "FLEET_PEERS": "http://a:1"},
    "lease_zero": dict(BASE, FLEET_PEERS="http://a:1",
                       FLEET_LEASE_MILLIS="0"),
    "fetch_zero": dict(BASE, FLEET_PEERS="http://a:1",
                       FLEET_FETCH_TIMEOUT_MILLIS="-1"),
    "probe_zero": dict(BASE, FLEET_PEERS="http://a:1",
                       FLEET_PROBE_MILLIS="0"),
    "bad_plan": dict(BASE, FLEET_PEERS="http://a:1",
                     FLEET_FAULT_PLAN="blackhole=0.1,warp=1"),
    "bad_quarantine": dict(BASE, FLEET_PEERS="http://a:1",
                           FLEET_QUARANTINE_FAILURES="-2"),
    "bad_vnodes": dict(BASE, FLEET_PEERS="http://a:1", FLEET_VNODES="many"),
}


@pytest.mark.parametrize("name", sorted(ACCEPTED))
def test_fleet_knobs_parse_as_the_references(name):
    ref = RefConfig.from_env(dict(ACCEPTED[name])).fleet_config()
    port = ServeConfig.from_env(dict(ACCEPTED[name])).fleet_config()
    if ref is None:
        assert port is None
        return
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_fleet_knobs_are_refused_as_the_reference_refuses_them(name):
    messages = []
    for cls in (RefConfig, ServeConfig):
        with pytest.raises(ValueError) as exc:
            cls.from_env(dict(REFUSED[name]))
        messages.append(str(exc.value))
    assert messages[0] == messages[1]


def test_the_xla_compile_knobs_are_read_and_reported_inert():
    config = ServeConfig.from_env({"AOT_CACHE_DIR": "/shared/aot",
                                   "WARMUP_AOT": "0",
                                   "COMPILE_CACHE_DIR": "/var/xla"})
    assert (config.aot_cache_dir, config.warmup_aot,
            config.compile_cache_dir) == ("/shared/aot", False, "/var/xla")
    notes = config.inert_knob_notes()
    assert [n.split("=")[0] for n in notes] == [
        "AOT_CACHE_DIR", "WARMUP_AOT", "COMPILE_CACHE_DIR"]
    assert all("does nothing on this card" in n for n in notes)
    assert ServeConfig.from_env({}).inert_knob_notes() == []
    assert "WARMUP_AOT=1" in ServeConfig.from_env(
        {"WARMUP_AOT": "1"}).inert_knob_notes()[0]


# -- the fleet section and the lwc_fleet_* lines ----------------------------------------


def _coordinator_state(pkg, metrics_mod):
    async def run():
        urls = _urls(3)
        now = [0.0]
        coord = pkg.FleetCoordinator(
            pkg.FleetConfig(self_url=urls[0], peers=urls, lease_millis=500.0,
                            fault_plan_spec="seed=7,flap=0.2"),
            clock=lambda: now[0])
        # owner-side bookkeeping driven as the handlers and begin drive it
        mine = [f"fp-{i}" for i in range(200)
                if coord.membership.owner(f"fp-{i}") == urls[0]][:3]
        assert await coord.begin(mine[0]) == ("lease", None)
        coord.publish(mine[0], [])
        coord.leases.acquire(mine[1], urls[1])
        coord.leases.acquire(mine[2], urls[2])
        now[0] = 1.0
        coord.leases.publish(mine[1], urls[1])  # late: expired
        coord.peer_hits, coord.peer_misses, coord.peer_errors = 5, 2, 1
        coord.ring_divergences, coord.ring_rejects = 1, 3
        coord.early_takeovers, coord.handoff_received = 2, 4
        for ok in (False, False, False):
            coord.health.record(urls[2], ok)
        coord.health.record_probe(urls[2], True)
        coord.client.breakers.get(urls[1], "fleet").record_failure()
        coord.client.fault_plan.next_fault(urls[0], urls[1])
        metrics = metrics_mod.Metrics()
        metrics.register_provider("fleet", coord.stats)
        stats = coord.stats()
        text = metrics_mod.render_prometheus(metrics)
        await coord.close()
        return stats, [line for line in text.splitlines()
                       if "lwc_fleet_" in line]

    return go(run())


def test_the_fleet_section_and_families_are_the_references():
    assert "fleet" in port_metrics.KNOWN_SECTIONS
    ref = _coordinator_state(ref_fleet, ref_metrics)
    port = _coordinator_state(port_fleet, port_metrics)
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert 'lwc_fleet_peer_fetches_total{result="hits"} 5' in port[1]
    assert 'lwc_fleet_disruptions_total{kind="late_publish"} 1' in port[1]
    assert 'lwc_fleet_disruptions_total{kind="readmission"} 1' in port[1]
    # without a fleet: no section, no family
    bare = port_metrics.render_prometheus(port_metrics.Metrics())
    assert "lwc_fleet_" not in bare
