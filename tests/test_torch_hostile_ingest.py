"""Hostile upstreams and memory pressure on the port, against the JAX
package.

* The four ingest fault kinds of ``FAULT_PLAN`` (``giant_line``,
  ``newline_less_flood``, ``oversized_unary``, ``binary_garbage``)
  through the port's ``DefaultChatClient`` and its ``clients/sse.py``
  caps: the same items (kinds, the tripped budget, the byte counts) as
  the reference's client over the same scripts and plan; a trip counts
  against the upstream's breaker; a capped judge is an error entry of a
  degraded frame, as the reference's, byte for byte.
* The four ``MemGuard`` drills of the reference's
  ``tests/test_hostile_ingest.py`` (soft pressure shrinks budgets, hard
  pressure sheds ``503 shed_reason: memory``, hysteretic recovery,
  ``degraded_mem`` on ``/readyz``) on the port's gateway: a ``Server``
  with a governor fed a scripted RSS, answering real HTTP requests; the
  watermark resolution, the config factory, the RSS source and the
  metrics plane.
"""

import asyncio
import http.client
import json
import pathlib
import random
from types import SimpleNamespace

import pytest

from llm_weighted_consensus_tpu import archive as ref_archive
from llm_weighted_consensus_tpu import errors as ref_errors
from llm_weighted_consensus_tpu import registry as ref_registry
from llm_weighted_consensus_tpu import resilience as ref_res
from llm_weighted_consensus_tpu.ballot import PrefixTree, branch_limit
from llm_weighted_consensus_tpu.clients import chat as ref_chat
from llm_weighted_consensus_tpu.clients import score as ref_score
from llm_weighted_consensus_tpu.resilience import memguard as ref_memguard
from llm_weighted_consensus_tpu.types import chat_request as ref_chat_req
from llm_weighted_consensus_tpu.types import score_request as ref_req
from llm_weighted_consensus_tpu.utils import jsonutil as ref_json
from llm_weighted_consensus_tpu_torch import archive as port_archive
from llm_weighted_consensus_tpu_torch import errors as port_errors
from llm_weighted_consensus_tpu_torch import registry as port_registry
from llm_weighted_consensus_tpu_torch import resilience as port_res
from llm_weighted_consensus_tpu_torch.cache import ScoreCache
from llm_weighted_consensus_tpu_torch.clients import chat as port_chat
from llm_weighted_consensus_tpu_torch.clients import score as port_score
from llm_weighted_consensus_tpu_torch.obs import TraceSink
from llm_weighted_consensus_tpu_torch.resilience import memguard as port_mg
from llm_weighted_consensus_tpu_torch.resilience.admission import (
    AdmissionConfig,
    AdmissionController,
)
from llm_weighted_consensus_tpu_torch.resilience.memguard import (
    LEVEL_HARD,
    LEVEL_OK,
    LEVEL_SOFT,
    MemGuard,
    read_rss_bytes,
    resolve_watermarks,
)
from llm_weighted_consensus_tpu_torch.serve.config import ServeConfig
from llm_weighted_consensus_tpu_torch.serve.metrics import (
    Metrics,
    register_overload,
    render_prometheus,
)
from llm_weighted_consensus_tpu_torch.types import chat_request as port_chat_req
from llm_weighted_consensus_tpu_torch.types import score_request as port_req
from llm_weighted_consensus_tpu_torch.utils import jsonutil as port_json

from fakes import FakeTransport, Script, chunk_obj
from test_torch_chat_client import PortFakeTransport

SEED = 19
CORPUS = pathlib.Path(__file__).parent / "fixtures" / "ingest"
TEXTS = ["answer alpha", "answer beta", "answer gamma"]

PKGS = {
    "ref": SimpleNamespace(
        res=ref_res, chat=ref_chat, score=ref_score, req=ref_req,
        chat_req=ref_chat_req, errors=ref_errors, registry=ref_registry,
        archive=ref_archive, json=ref_json, transport=FakeTransport,
    ),
    "port": SimpleNamespace(
        res=port_res, chat=port_chat, score=port_score, req=port_req,
        chat_req=port_chat_req, errors=port_errors, registry=port_registry,
        archive=port_archive, json=port_json, transport=PortFakeTransport,
    ),
}


def go(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


def healthy_script():
    return Script([chunk_obj("a"), chunk_obj("b", finish="stop")])


def item_shape(item):
    """An item as comparable data: a chunk's content, or an error's kind,
    tripped budget and byte counts."""
    if isinstance(item, Exception):
        return (type(item).__name__, getattr(item, "what", None),
                getattr(item, "limit_bytes", None),
                getattr(item, "observed_bytes", None), item.status())
    return ("chunk", item.choices[0].delta.content if item.choices else None)


def hostile_items(pkg, faults, *, flood_bytes, scripts=None, **kw):
    """Items of one chat request through ``pkg``'s client behind the
    fault injector, or the raised error's shape."""
    p = PKGS[pkg]
    plan = p.res.FaultPlan(script=list(faults), flood_bytes=flood_bytes)
    transport = p.transport(scripts or [healthy_script()])
    client = p.chat.DefaultChatClient(
        p.res.FaultInjectionTransport(transport, plan),
        [p.chat.ApiBase("https://a.example", "key-a")],
        backoff=p.chat.BackoffPolicy(max_elapsed_ms=0), **kw)
    params = p.chat_req.ChatCompletionCreateParams(
        messages=[p.chat_req.UserMessage(content="hi")], model="fake-model")

    async def run():
        stream = await client.create_streaming(None, params)
        return [item_shape(item) async for item in stream]

    try:
        return go(run())
    except p.errors.ChatError as exc:
        return ["raised", item_shape(exc)]


@pytest.mark.parametrize("fault, caps, what", [
    ("giant_line", {"sse_max_event_bytes": 4096,
                    "judge_stream_max_bytes": 1 << 20}, "sse_event"),
    ("newline_less_flood", {"judge_stream_max_bytes": 4096}, "judge_stream"),
    ("newline_less_flood", {"sse_max_event_bytes": 4096,
                            "judge_stream_max_bytes": 1 << 20}, "sse_buffer"),
    ("oversized_unary", {"judge_stream_max_bytes": 4096}, "unary_body"),
])
def test_an_ingest_fault_trips_the_same_cap_as_the_reference(fault, caps,
                                                             what):
    got = hostile_items("port", [fault], flood_bytes=8192, **caps)
    assert got == hostile_items("ref", [fault], flood_bytes=8192, **caps)
    assert got[-1][0] == "IngestCapError" and got[-1][1] == what
    if fault != "oversized_unary":
        assert got[0] == ("chunk", "a")  # the stream committed first
    else:
        assert got[0] == "raised" and got[1][3] == 8192


def test_binary_garbage_survives_alike_and_is_seeded():
    got = hostile_items("port", ["binary_garbage"], flood_bytes=8192)
    assert got == hostile_items("ref", ["binary_garbage"], flood_bytes=8192)
    assert got[0] == ("chunk", "a")
    assert not any(i[0] == "IngestCapError" for i in got)
    assert hostile_items("port", ["binary_garbage"], flood_bytes=8192) == got


def test_an_oversized_corpus_body_trips_without_a_fault_plan():
    raw = (CORPUS / "oversized_unary.bin").read_bytes()
    transport = PortFakeTransport([Script(status=503, body=raw)])
    client = port_chat.DefaultChatClient(
        transport, [port_chat.ApiBase("https://a.example", "k")],
        backoff=port_chat.BackoffPolicy(max_elapsed_ms=0),
        judge_stream_max_bytes=4096)
    params = port_chat_req.ChatCompletionCreateParams(
        messages=[port_chat_req.UserMessage(content="hi")], model="m")

    async def run():
        stream = await client.create_streaming(None, params)
        return [item async for item in stream]

    with pytest.raises(port_errors.IngestCapError) as info:
        go(run())
    assert info.value.what == "unary_body"


def test_cap_trips_count_against_the_breaker():
    t = {"now": 0.0}
    policy = port_res.ResiliencePolicy(breakers=port_res.BreakerRegistry(
        port_res.BreakerConfig(threshold=1.0, window=2, min_samples=2,
                               cooldown_ms=5000), clock=lambda: t["now"]))
    plan = port_res.FaultPlan(script=["oversized_unary", "oversized_unary"],
                              flood_bytes=8192)
    client = port_chat.DefaultChatClient(
        port_res.FaultInjectionTransport(
            PortFakeTransport([healthy_script()]), plan),
        [port_chat.ApiBase("https://a.example", "key-a")],
        backoff=port_chat.BackoffPolicy(max_elapsed_ms=0),
        resilience=policy, judge_stream_max_bytes=4096)
    params = port_chat_req.ChatCompletionCreateParams(
        messages=[port_chat_req.UserMessage(content="hi")],
        model="fake-model")

    async def run():
        stream = await client.create_streaming(None, params)
        return [item async for item in stream]

    for _ in range(2):
        with pytest.raises(port_errors.IngestCapError):
            go(run())
    with pytest.raises(port_errors.BreakerOpenError):
        go(run())
    assert plan.requests == 2
    assert policy.counters == {"ingest_cap_tripped": 2,
                               "breaker_rejected": 1}
    t["now"] += 6.0
    assert go(run())[0].choices[0].delta.content == "a"
    key = "https://a.example|fake-model"
    assert policy.snapshot()["breakers"][key]["state"] == "closed"


def ballot_keys(n):
    rng = random.Random(SEED)
    tree = PrefixTree.build(rng, n, branch_limit(None))
    return {idx: key for key, idx in tree.key_indices(rng)}


def judge_script(key):
    return Script([chunk_obj("I pick ", model="up-model"),
                   chunk_obj(f"{key} as best.", model="up-model",
                             finish="stop")])


def capped_panel(pkg):
    """The reference's capped-judge drill on ``pkg``: three judges, the
    second upstream request floods a giant line -> (masked frames,
    counters)."""
    from llm_weighted_consensus_tpu.identity.model import ModelBase

    p = PKGS[pkg]
    judges = [
        {"model": "judge-a", "weight": {"type": "static", "weight": 2}},
        {"model": "judge-b", "weight": {"type": "static", "weight": 1}},
        {"model": "judge-c", "weight": {"type": "static", "weight": 1}},
    ]
    model = ModelBase.from_json_obj({"llms": judges}).into_model_validate()
    flood_pos = next(i for i, llm in enumerate(model.llms)
                     if llm.base.model in ("judge-b", "judge-c"))
    faults = [None] * 3
    faults[flood_pos] = "giant_line"
    policy = p.res.ResiliencePolicy()
    keys = ballot_keys(3)
    chat = p.chat.DefaultChatClient(
        p.res.FaultInjectionTransport(
            p.transport([judge_script(keys[1]) for _ in range(3)]),
            p.res.FaultPlan(script=faults, flood_bytes=8192)),
        [p.chat.ApiBase("https://a.example", "key-a")],
        backoff=p.chat.BackoffPolicy(max_elapsed_ms=0), resilience=policy,
        sse_max_event_bytes=4096, judge_stream_max_bytes=1 << 20)
    client = p.score.ScoreClient(
        chat, p.registry.InMemoryModelRegistry(),
        archive_fetcher=p.archive.InMemoryArchive(),
        rng_factory=lambda: random.Random(SEED), resilience=policy)
    params = p.req.ChatCompletionCreateParams.from_json_obj({
        "messages": [{"role": "user", "content": "pick the best"}],
        "model": {"llms": judges}, "choices": TEXTS})

    async def run():
        stream = await client.create_streaming(None, params)
        out = []
        async for item in stream:
            obj = item.to_json_obj()
            obj["id"], obj["created"] = "ID", 0
            out.append(p.json.dumps(obj))
        return out

    return go(run()), dict(policy.counters)


def test_a_capped_judge_degrades_the_frame_as_the_reference():
    frames, counters = capped_panel("port")
    assert (frames, counters) == capped_panel("ref")
    final = json.loads(frames[-1])
    assert final["degraded"] is True
    errors = [c["error"] for c in final["choices"] if c.get("error")]
    assert len(errors) == 1
    assert errors[0]["message"]["error"]["error"]["kind"] == "ingest_cap"
    assert counters == {"ingest_cap_tripped": 1, "ingest_cap_degraded": 1}


# -- the memory governor -------------------------------------------------------


def fed(values):
    """An rss_fn fed from a list."""
    seq = iter(values)
    return lambda: next(seq)


def drill_trail(mod, rss, **kw):
    cache = SimpleNamespace(max_bytes=1000)
    mg = mod.MemGuard(1000, 2000, rss_fn=fed(rss), **kw)
    mg.govern(caches=[cache])
    trail = []
    for _ in rss:
        level = mg.check()
        trail.append((level, cache.max_bytes, mg.gate(), mg.degraded,
                      mg.snapshot()))
    return trail


def test_the_governors_levels_match_the_reference():
    rss = [500, 1500, 950, 899, 2500, 1850, 1750, 100, 2001, 1000, 1799]
    assert drill_trail(port_mg, rss, recover_fraction=0.9) == \
        drill_trail(ref_memguard, rss, recover_fraction=0.9)
    assert drill_trail(port_mg, rss, shrink=0.25) == \
        drill_trail(ref_memguard, rss, shrink=0.25)


def test_memguard_drill_soft_pressure_shrinks_budgets():
    cache = ScoreCache(60, 1 << 20)
    sink = TraceSink(capacity=4096)
    adm = AdmissionController(
        AdmissionConfig(max_inflight=8, adaptive=True, min_limit=2))
    mg = MemGuard(1000, 2000, rss_fn=fed([500, 1500, 100]))
    mg.govern(caches=[cache], sinks=[sink], admission=adm)
    assert mg.check() == LEVEL_OK
    assert cache.max_bytes == 1 << 20
    assert mg.check() == LEVEL_SOFT
    assert cache.max_bytes == (1 << 20) // 2
    assert sink.capacity == 2048 and sink.snapshot()["capacity"] == 2048
    assert adm.limit == 4.0  # the AIMD limit decayed once
    assert mg.snapshot()["level"] == "soft" and mg.degraded
    assert mg.gate() is None  # soft pressure admits everything
    assert mg.check() == LEVEL_OK
    assert (cache.max_bytes, sink.capacity) == (1 << 20, 4096)
    assert adm.limit == 4.0  # not snapped back: AIMD probes it up


def serve_with_governor(rss):
    """A chat-routes server (the fake upstream's endpoint is never
    called) whose governor reads ``rss["v"]``."""
    from llm_weighted_consensus_tpu_torch.serve import __main__ as serve_main

    config = ServeConfig.from_env({
        "OPENAI_API_BASE": "http://127.0.0.1:9/v1", "OPENAI_API_KEY": "k",
        "MEM_SOFT_BYTES": "1000", "MEM_HARD_BYTES": "2000",
        "MEMGUARD_INTERVAL_MILLIS": "60000", "TRACE_ENABLED": "1",
        "TRACE_RING": "64", "SCORE_CACHE_TTL": "60"})
    server = serve_main.build_server(None, None, config, device="cpu")
    server.memguard.rss_fn = lambda: rss["v"]
    server.lifecycle.mark_ready()
    return server.start()


def request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request(method, path,
                     body=None if body is None else json.dumps(body),
                     headers={"content-type": "application/json"})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def test_memguard_drill_hard_pressure_sheds_503_on_the_gateway():
    rss = {"v": 2500}
    server = serve_with_governor(rss)
    try:
        assert server.memguard.check() == LEVEL_HARD
        status, headers, raw = request(
            server.port, "POST", "/score/completions",
            {"messages": [{"role": "user", "content": "q"}],
             "model": {"llms": [{"model": "a"}]}, "choices": ["x", "y"]})
        assert status == 503
        assert headers["Retry-After"] == "1"
        envelope = json.loads(raw)
        assert envelope["code"] == 503
        assert envelope["message"] == {"kind": "overloaded",
                                       "shed_reason": "memory"}
        # probes still answer
        assert request(server.port, "GET", "/livez")[0] == 200
        snap = json.loads(request(server.port, "GET", "/metrics")[2])
        assert snap["admission"]["shed"] == {"memory": 1}
        assert snap["memguard"]["level"] == "hard"
        assert snap["memguard"]["shedding"] is True
        # a shed is a 503: its trace is kept
        assert snap["traces"]["forced"] == 1
    finally:
        server.close()
    assert server.memguard._thread is None  # stopped with the server


def test_memguard_drill_hysteretic_recovery_on_the_gateway():
    rss = {"v": 1500}
    server = serve_with_governor(rss)
    sink, cache = server.trace_sink, server.score_client.cache
    try:
        steps = []
        for v in (1500, 950, 899, 2500, 1850, 1750, 100):
            rss["v"] = v
            level = server.memguard.check()
            steps.append((level, sink.capacity, cache.max_bytes,
                          server.admission.mem_gate()))
        assert steps == [
            (LEVEL_SOFT, 32, 32 << 20, None),
            (LEVEL_SOFT, 32, 32 << 20, None),
            (LEVEL_OK, 64, 64 << 20, None),
            (LEVEL_HARD, 32, 32 << 20, "memory"),
            (LEVEL_HARD, 32, 32 << 20, "memory"),
            (LEVEL_SOFT, 32, 32 << 20, None),
            (LEVEL_OK, 64, 64 << 20, None),
        ]
        snap = server.memguard.snapshot()
        assert (snap["soft_trips"], snap["hard_trips"],
                snap["recoveries"]) == (2, 1, 2)
    finally:
        server.close()


def test_memguard_drill_degraded_mem_on_readyz():
    rss = {"v": 500}
    server = serve_with_governor(rss)
    try:
        def readyz():
            status, _, raw = request(server.port, "GET", "/readyz")
            return status, json.loads(raw)

        server.memguard.check()
        assert readyz() == (200, {"ready": True})
        rss["v"] = 1500
        server.memguard.check()
        assert readyz() == (200, {"ready": True, "degraded_mem": True,
                                  "mem_level": "soft"})
        rss["v"] = 2500
        server.memguard.check()
        assert readyz() == (200, {"ready": True, "degraded_mem": True,
                                  "mem_level": "hard"})
        rss["v"] = 100
        server.memguard.check()
        assert readyz() == (200, {"ready": True})
    finally:
        server.close()


def test_memguard_watermark_resolution(monkeypatch):
    assert resolve_watermarks(100, 200) == (100, 200)
    assert resolve_watermarks(300, 200) == (300, 300)
    monkeypatch.setattr(port_mg, "read_mem_total_bytes", lambda: 1000)
    assert resolve_watermarks(0, 0) == (800, 900)
    assert resolve_watermarks(0, 950) == (800, 950)
    monkeypatch.setattr(port_mg, "read_mem_total_bytes", lambda: None)
    assert resolve_watermarks(0, 0) is None


@pytest.mark.parametrize("env", [
    {}, {"MEMGUARD": "0"}, {"MEM_SOFT_BYTES": "100", "MEM_HARD_BYTES": "200",
                            "MEMGUARD_INTERVAL_MILLIS": "250"},
])
def test_config_memguard_factory_matches(env):
    from llm_weighted_consensus_tpu.serve.config import Config

    got, want = ServeConfig.from_env(env).memguard(), \
        Config.from_env(env).memguard()
    assert (got is None) == (want is None)
    if got is not None:
        assert (got.soft_bytes, got.hard_bytes, got.interval_ms) == \
            (want.soft_bytes, want.hard_bytes, want.interval_ms)


def test_memguard_rss_source_reads_this_process():
    rss = read_rss_bytes()
    assert rss is not None and rss > 0
    assert rss == pytest.approx(ref_memguard.read_rss_bytes(), rel=0.5)


def test_memguard_rides_the_metrics_plane():
    metrics = Metrics()
    mg = MemGuard(1000, 2000, rss_fn=fed([1500]))
    register_overload(metrics, memguard=mg)
    mg.check()
    section = metrics.provider_section("memguard")
    assert section["level"] == "soft" and section["rss_bytes"] == 1500
    text = render_prometheus(metrics)
    assert "lwc_memguard_rss_bytes 1500" in text
    assert "lwc_memguard_level 1" in text
    assert 'lwc_memguard_trips_total{kind="soft"} 1' in text
