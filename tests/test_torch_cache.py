"""The port's cache package against the JAX package's.

* ``score_fingerprint`` and ``embed_fingerprint``: the same 22-character
  ids from both packages (the port hashes with its own XXH3), over field
  order, non-semantic fields, contexts, panel member order and the
  model's four request forms;
* ``CacheStore``, ``ScoreCache`` and ``EmbeddingCache``: the same
  sequence of puts and gets on an injected clock gives the same values
  and the same ``stats()`` (TTL, LRU byte budget, refused oversize
  entries, the disabled store), and the JSONL disk tier reads the other
  package's segments (warm restart, expired entries skipped, a torn tail
  counted);
* ``SingleFlight``, ``record_stream`` and ``replay_stream``: collapse,
  failure, a cancelled leader promoting a follower (the primitives the
  score client uses), recording only clean complete streams, fresh
  chunks per replay;
* the port's ``ScoreClient`` with a cache: identical concurrent requests
  make one upstream fan-out, a streamed hit replays the miss's frames
  byte for byte (and they equal the reference's frames), ``cache_bypass``
  and TTL 0 go live, errors are not cached, and the disk tier serves a
  fresh client.
"""

import asyncio
import json

import pytest

from llm_weighted_consensus_tpu import cache as ref_cache
from llm_weighted_consensus_tpu.types import score_request as ref_req
from llm_weighted_consensus_tpu.types.score_response import (
    ChatCompletionChunk as RefChunk,
)
from llm_weighted_consensus_tpu_torch import cache as port_cache
from llm_weighted_consensus_tpu_torch.identity import ID_LEN
from llm_weighted_consensus_tpu_torch.types import score_request as port_req
from llm_weighted_consensus_tpu_torch.types.score_response import (
    ChatCompletionChunk as PortChunk,
)
from llm_weighted_consensus_tpu_torch.utils import jsonutil

from fakes import Script, chunk_obj
from test_torch_score import ballot_keys, make_client, masked

JUDGES = {"llms": [{"model": "j1"}]}


def go(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


def score_body(**overrides):
    body = {"messages": [{"role": "user", "content": "q"}], "model": JUDGES,
            "choices": ["first", "second"]}
    body.update(overrides)
    return body


# -- fingerprints -------------------------------------------------------------

FP_BODIES = {
    "base": score_body(),
    "shuffled": {"choices": ["first", "second"], "model": JUDGES,
                 "messages": [{"role": "user", "content": "q"}]},
    "stream": score_body(stream=True),
    "bypass": score_body(cache_bypass=True),
    "other_message": score_body(
        messages=[{"role": "user", "content": "different ✓"}]),
    "other_choices": score_body(choices=["first", "other"]),
    "seeded": score_body(seed=7),
    "two_judges": score_body(model={"llms": [{"model": "j1"},
                                             {"model": "j2"}]}),
    "two_judges_reversed": score_body(model={"llms": [{"model": "j2"},
                                                      {"model": "j1"}]}),
    "weighted_panel": score_body(model={
        "llms": [{"model": "j1", "weight": {"type": "static", "weight": 2.5}},
                 {"model": "j2", "top_logprobs": 5}]}),
    "training_table": score_body(model={
        "llms": [{"model": "j1", "weight": {"type": "training_table"}}],
        "weight": {"type": "training_table",
                   "embeddings": {"model": "bge-large-en", "max_tokens": 128},
                   "top": 16}}),
    "model_id": score_body(model="0123456789abcdefghijkl"),
    "model_slug": score_body(model="author/0123456789abcdefghijkl"),
    "model_json_string": score_body(model=json.dumps(JUDGES)),
    "model_bad_string": score_body(model="not a panel"),
    "long_messages": score_body(messages=[
        {"role": "system", "content": "be fair " * 400},
        {"role": "user", "content": [{"type": "text", "text": "x" * 9000}]}]),
}


@pytest.mark.parametrize("name", sorted(FP_BODIES))
@pytest.mark.parametrize("ctx", [None, "Bearer a", "Bearer b"])
def test_score_fingerprint_equal(name, ctx):
    body = FP_BODIES[name]
    want = ref_cache.score_fingerprint(
        ref_req.ChatCompletionCreateParams.from_json_obj(body), ctx)
    got = port_cache.score_fingerprint(
        port_req.ChatCompletionCreateParams.from_json_obj(body), ctx)
    assert got == want
    assert got is None or len(got) == ID_LEN


def test_score_fingerprint_semantics():
    fp = {name: port_cache.score_fingerprint(
        port_req.ChatCompletionCreateParams.from_json_obj(body))
        for name, body in FP_BODIES.items()}
    assert fp["base"] == fp["shuffled"] == fp["stream"] == fp["bypass"]
    assert fp["two_judges"] == fp["two_judges_reversed"]
    assert len({fp["base"], fp["other_message"], fp["other_choices"],
                fp["seeded"]}) == 4
    assert fp["model_bad_string"] is None


@pytest.mark.parametrize("model", ["bge-large-en", "e5-base-v2", ""])
@pytest.mark.parametrize("text", ["hello", "hello!", "", "café ✓ " * 50])
@pytest.mark.parametrize("max_tokens", [None, 64, 128])
def test_embed_fingerprint_equal(model, text, max_tokens):
    want = ref_cache.embed_fingerprint(model, text, max_tokens)
    got = port_cache.embed_fingerprint(model, text, max_tokens)
    assert got == want and len(got) == ID_LEN


# -- the stores -----------------------------------------------------------------


def _drive(pkg, ops, ttl=10, max_bytes=100):
    """Run one op sequence on a store on an injected clock -> (observed
    values, final stats)."""
    now = [1000.0]
    store = pkg.CacheStore(ttl_sec=ttl, max_bytes=max_bytes,
                           clock=lambda: now[0])
    seen = []
    for op in ops:
        if op[0] == "put":
            store.put(op[1], op[2], op[3])
        elif op[0] == "get":
            seen.append(store.get(op[1]))
        else:
            now[0] += op[1]
    return seen, store.stats()


STORE_OPS = {
    "ttl": [("put", "k1", "v1", 10), ("get", "k1"), ("tick", 9.99),
            ("get", "k1"), ("tick", 0.02), ("get", "k1")],
    "lru": [("put", "a", "A", 40), ("put", "b", "B", 40), ("get", "a"),
            ("put", "c", "C", 40), ("get", "b"), ("get", "a"), ("get", "c"),
            ("put", "huge", "X", 101), ("get", "huge"), ("get", "a")],
    "refresh": [("put", "a", "A", 30), ("put", "a", "A2", 60),
                ("put", "b", "B", 50), ("get", "a"), ("get", "b")],
    "budget_sweep": [("put", "a", "A", 30), ("put", "b", "B", 30),
                     ("put", "c", "C", 30), ("get", "a"), ("tick", 5),
                     ("put", "d", "D", 30), ("get", "b"), ("get", "c"),
                     ("tick", 6), ("get", "a"), ("get", "d")],
}


@pytest.mark.parametrize("case", sorted(STORE_OPS))
@pytest.mark.parametrize("ttl,max_bytes", [(10, 100), (0, 100), (10, 0)])
def test_store_sequence_equal(case, ttl, max_bytes):
    want = _drive(ref_cache, STORE_OPS[case], ttl, max_bytes)
    got = _drive(port_cache, STORE_OPS[case], ttl, max_bytes)
    assert got == want


@pytest.mark.parametrize("writer,reader", [
    (ref_cache, port_cache), (port_cache, ref_cache),
    (port_cache, port_cache)])
def test_disk_tier_warm_restart_across_packages(tmp_path, writer, reader):
    d = str(tmp_path / "seg")
    now = [1000.0]
    first = writer.ScoreCache(60, 1 << 20, d, clock=lambda: now[0])
    chunks = [{"id": "x", "choices": [], "created": 1, "model": "m",
               "trace_id": "dropped"}]
    first.put_chunks("f" * ID_LEN, chunks)
    now[0] += 30
    first.put_chunks("g" * ID_LEN, [{"id": "y"}])
    first.flush()
    now[0] += 31  # f expired, g live
    second = reader.ScoreCache(60, 1 << 20, d, clock=lambda: now[0])
    assert second.disk_loaded == 1
    assert second.get("f" * ID_LEN) is None
    assert second.get("g" * ID_LEN) == [{"id": "y"}]
    # the recording leader's trace id never reaches the cache
    assert chunks == [{"id": "x", "choices": [], "created": 1, "model": "m"}]


@pytest.mark.parametrize("pkg", [ref_cache, port_cache])
def test_disk_tier_survives_torn_tail_write(tmp_path, pkg):
    d = tmp_path / "seg"
    first = port_cache.ScoreCache(60, 1 << 20, str(d))
    first.put_chunks("f" * ID_LEN, [{"id": "x"}])
    seg = next(d.glob("seg-*.jsonl"))
    with open(seg, "a", encoding="utf-8") as f:
        f.write('{"k": "truncated mid-wri')
    second = pkg.ScoreCache(60, 1 << 20, str(d))
    assert second.disk_loaded == 1 and second.disk_torn == 1


def test_embedding_cache_rows_and_budget_equal():
    import numpy as np

    out = []
    for pkg in (ref_cache, port_cache):
        now = [0.0]
        cache = pkg.EmbeddingCache(5, 3 * (4 * 8 + 64),
                                   clock=lambda: now[0])
        for i in range(5):
            cache.put_row(f"r{i}", np.full(8, i, np.float32), 10 + i)
        now[0] += 1
        rows = [cache.get(f"r{i}") for i in range(5)]
        now[0] += 5
        rows.append(cache.get("r4"))
        out.append(([None if r is None else (r[0].tolist(), r[1])
                     for r in rows], cache.stats()))
    assert out[1] == out[0]


# -- single-flight, record, replay ------------------------------------------


def test_singleflight_followers_get_the_leaders_value():
    sf = port_cache.SingleFlight()

    async def run():
        assert sf.claim("k") is None  # the leader
        futures = [sf.claim("k") for _ in range(7)]
        waits = [asyncio.create_task(sf.wait(f)) for f in futures]
        await asyncio.sleep(0)
        sf.complete("k", "result")
        return await asyncio.gather(*waits)

    assert go(run()) == [(True, "result")] * 7
    assert sf.collapses == 7 and len(sf) == 0


def test_singleflight_failure_propagates_and_cleans_up():
    sf = port_cache.SingleFlight()

    async def run():
        sf.claim("k")
        follower = sf.claim("k")
        sf.fail("k", RuntimeError("boom"))
        with pytest.raises(RuntimeError):
            await sf.wait(follower)
        sf.claim("lonely")
        sf.fail("lonely", RuntimeError("nobody waits"))  # no warning left

    go(run())
    assert len(sf) == 0


def test_singleflight_cancelled_leader_lets_a_follower_lead():
    sf = port_cache.SingleFlight()

    async def run():
        sf.claim("k")
        follower = asyncio.create_task(sf.wait(sf.claim("k")))
        await asyncio.sleep(0)
        sf.fail("k", asyncio.CancelledError())
        ok, _ = await follower
        return ok, sf.claim("k")  # the retry: this caller now leads

    assert go(run()) == (False, None)


def test_singleflight_cancelled_follower_leaves_the_flight_alone():
    sf = port_cache.SingleFlight()

    async def run():
        sf.claim("k")
        future = sf.claim("k")
        bystander = asyncio.create_task(sf.wait(future))
        other = asyncio.create_task(sf.wait(future))
        await asyncio.sleep(0)
        bystander.cancel()
        await asyncio.sleep(0)
        sf.complete("k", "value")
        return await other, bystander.cancelled()

    assert go(run()) == ((True, "value"), True)


def _chunk(cls, content="c", finish=None, error=None):
    choice = {"index": 0, "delta": {"content": content},
              "finish_reason": finish}
    if error is not None:
        choice["error"] = error
    return cls.from_json_obj({"id": "r", "choices": [choice], "created": 1,
                              "model": "m"})


def _record(pkg, cls, items, stop_after=None):
    recorded = []

    async def live():
        for item in items:
            yield item(cls) if callable(item) else item

    async def run():
        rec = pkg.record_stream(live(), recorded.append)
        n = 0
        async for _ in rec:
            n += 1
            if stop_after is not None and n >= stop_after:
                break
        await rec.aclose()

    go(run())
    return recorded


RECORD_CASES = {
    "clean": ([lambda c: _chunk(c, "a"), lambda c: _chunk(c, "b", "stop")],
              None),
    "abandoned": ([lambda c: _chunk(c, "a"), lambda c: _chunk(c, "b")], 1),
    "error_item": ([lambda c: _chunk(c, "a"), RuntimeError("trailing")],
                   None),
    "error_choice": ([lambda c: _chunk(c, "a"), lambda c: _chunk(
        c, "b", error={"code": 500, "message": "judge died"})], None),
}


@pytest.mark.parametrize("case", sorted(RECORD_CASES))
def test_record_stream_equal(case):
    items, stop = RECORD_CASES[case]
    want = _record(ref_cache, RefChunk, items, stop)
    got = _record(port_cache, PortChunk, items, stop)
    assert got == want


def test_replay_decodes_fresh_chunks_per_call():
    record = [_chunk(PortChunk, "a").to_json_obj()]

    async def collect():
        return [item async for item in port_cache.replay_stream(record)]

    first, second = go(collect()), go(collect())
    assert first[0].to_json_obj() == second[0].to_json_obj()
    assert first[0] is not second[0]


# -- the score client with a cache ------------------------------------------


def winning_script():
    return Script([chunk_obj(f"pick {ballot_keys(2)[1]}", finish="stop")])


def consume(client, params, pkg="port"):
    async def run():
        stream = await client.create_streaming(None, params)
        try:
            return [masked(pkg, item) async for item in stream]
        finally:
            await stream.aclose()

    return run


def _params(pkg="port", **overrides):
    mod = port_req if pkg == "port" else ref_req
    return mod.ChatCompletionCreateParams.from_json_obj(score_body(**overrides))


def test_identical_concurrent_requests_collapse_to_one_fanout():
    client, transport = make_client(
        "port", [winning_script()], cache=port_cache.ScoreCache(60, 1 << 20))
    params = _params()

    async def run():
        return await asyncio.gather(
            *(consume(client, params)() for _ in range(8)))

    results = go(run())
    assert len(transport.requests) == 1
    assert all(r == results[0] for r in results)
    assert client.flights.collapses == 7
    assert client.cache.stats()["entries"] == 1


def test_streamed_hit_replays_the_miss_and_the_reference():
    frames = {}
    for pkg, cache in (("ref", ref_cache), ("port", port_cache)):
        client, transport = make_client(
            pkg, [winning_script()], cache=cache.ScoreCache(60, 1 << 20))
        params = _params(pkg)
        miss = go(consume(client, params, pkg)())
        hit = go(consume(client, params, pkg)())
        assert len(transport.requests) == 1
        assert hit == miss
        frames[pkg] = miss
    assert frames["port"] == frames["ref"]


def test_unary_hit_equals_miss():
    client, transport = make_client(
        "port", [winning_script()], cache=port_cache.ScoreCache(60, 1 << 20))
    params = _params()

    async def run():
        return (await client.create_unary(None, params),
                await client.create_unary(None, params))

    a, b = go(run())
    assert len(transport.requests) == 1
    assert a.to_json() == b.to_json()


@pytest.mark.parametrize("setup", ["bypass", "ttl_zero"])
def test_bypass_and_ttl_zero_go_live(setup):
    cache = port_cache.ScoreCache(0 if setup == "ttl_zero" else 60, 1 << 20)
    client, transport = make_client(
        "port", [winning_script(), winning_script()], cache=cache)
    params = _params(cache_bypass=(setup == "bypass"))
    go(consume(client, params)())
    go(consume(client, params)())
    assert len(transport.requests) == 2
    assert cache.stats()["entries"] == 0


def test_expired_entry_recomputes():
    now = [1000.0]
    client, transport = make_client(
        "port", [winning_script(), winning_script()],
        cache=port_cache.ScoreCache(10, 1 << 20, clock=lambda: now[0]))
    params = _params()
    go(consume(client, params)())
    now[0] += 11
    go(consume(client, params)())
    assert len(transport.requests) == 2
    assert client.cache.stats()["expirations"] == 1


def test_error_responses_are_not_cached():
    client, transport = make_client(
        "port", [Script(status=503, body=b"{}"), winning_script()],
        cache=port_cache.ScoreCache(60, 1 << 20))
    params = _params()
    first = go(consume(client, params)())
    assert first[-1].startswith("error ")
    second = go(consume(client, params)())
    assert len(transport.requests) == 2
    assert not second[-1].startswith("error ")


def test_disk_warm_restart_end_to_end(tmp_path):
    d = str(tmp_path / "cache")
    client, _ = make_client(
        "port", [winning_script()], cache=port_cache.ScoreCache(60, 1 << 20, d))
    params = _params()
    miss = go(consume(client, params)())
    fresh, transport = make_client(
        "port", [], cache=port_cache.ScoreCache(60, 1 << 20, d))
    assert go(consume(fresh, params)()) == miss
    assert transport.requests == []
    assert jsonutil.loads(miss[-1])["choices"][1]["confidence"] == 1
