"""The port's score engine against the JAX package's, on the same
scripted upstream (``tests/fakes.py`` scripts; the port's client through
a port ``Transport``) and the same seeded ballot generator.

* ``ScoreClient`` streaming and unary: every frame's JSON equal once the
  response id and timestamp are masked, byte for byte (both packages'
  own canonical JSON writers), and the upstream judge requests equal
  (the ballots, the injected system message, the forced output).  The
  cases are those of ``tests/test_score_engine.py``: agreement and
  disagreement, soft votes, a failed judge, all judges failed with 4xx
  and 5xx code folding, invalid content, the json-schema, tool-call and
  synthetic-reasoning modes, archived choices as candidates, fewer than
  two choices, the trailing usage chunk, forwarded sampling params and
  the training-table ``weight_data`` echo and usage seed;
* ``HOST_FASTPATH``: the port's fast lane on and off, and the
  reference's, give the same bytes;
* ``clients.tally.fixed_point_fold`` against the reference's on seeded
  pathological ballots and weights: the same Decimals (exponents
  included), and None exactly where the reference returns None;
* the tally's Decimal context on the server's loop thread is the
  default one, whatever the submitting handler thread set.

Trained weights through the real fetchers are held in
``tests/test_torch_training_table.py``.
"""

import asyncio
import decimal
import math
import random
import threading
from decimal import Decimal
from types import SimpleNamespace

import numpy as np
import pytest

from llm_weighted_consensus_tpu import archive as ref_archive
from llm_weighted_consensus_tpu import registry as ref_registry
from llm_weighted_consensus_tpu.ballot import PrefixTree, branch_limit
from llm_weighted_consensus_tpu.clients import chat as ref_chat
from llm_weighted_consensus_tpu.clients import score as ref_score
from llm_weighted_consensus_tpu.clients import tally as ref_tally
from llm_weighted_consensus_tpu.types import embeddings as ref_emb_types
from llm_weighted_consensus_tpu.types import score_request as ref_req
from llm_weighted_consensus_tpu.types import score_response as ref_resp
from llm_weighted_consensus_tpu.types.chat_response import (
    ChatCompletion as RefChatUnary,
)
from llm_weighted_consensus_tpu.utils import jsonutil as ref_json
from llm_weighted_consensus_tpu import weights as ref_weights
from llm_weighted_consensus_tpu_torch import archive as port_archive
from llm_weighted_consensus_tpu_torch import registry as port_registry
from llm_weighted_consensus_tpu_torch.clients import chat as port_chat
from llm_weighted_consensus_tpu_torch.clients import score as port_score
from llm_weighted_consensus_tpu_torch.clients import tally as port_tally
from llm_weighted_consensus_tpu_torch.types import embeddings as port_emb_types
from llm_weighted_consensus_tpu_torch.types import score_request as port_req
from llm_weighted_consensus_tpu_torch.types import score_response as port_resp
from llm_weighted_consensus_tpu_torch.types.chat_response import (
    ChatCompletion as PortChatUnary,
)
from llm_weighted_consensus_tpu_torch.utils import jsonutil as port_json
from llm_weighted_consensus_tpu_torch import weights as port_weights

from fakes import FakeTransport, Script, chunk_obj
from test_torch_chat_client import PortFakeTransport

SEED = 42
TEXTS = ["answer alpha", "answer beta", "answer gamma"]


def go(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


def ballot_keys(n, top_logprobs=None, seed=SEED):
    """The seeded ballot every judge gets: candidate index -> key."""
    rng = random.Random(seed)
    tree = PrefixTree.build(rng, n, branch_limit(top_logprobs))
    return {idx: key for key, idx in tree.key_indices(rng)}


def clone(s):
    return Script(list(s.events), status=s.status, body=s.body,
                  connect_error=s.connect_error, delays=dict(s.delays),
                  done=s.done)


PKGS = {
    "ref": SimpleNamespace(
        score=ref_score, chat=ref_chat, registry=ref_registry,
        archive=ref_archive, req=ref_req, resp=ref_resp, json=ref_json,
        weights=ref_weights, emb_types=ref_emb_types,
        chat_unary=RefChatUnary, transport=FakeTransport,
    ),
    "port": SimpleNamespace(
        score=port_score, chat=port_chat, registry=port_registry,
        archive=port_archive, req=port_req, resp=port_resp, json=port_json,
        weights=port_weights, emb_types=port_emb_types,
        chat_unary=PortChatUnary, transport=PortFakeTransport,
    ),
}


def make_client(pkg, scripts, archived=(), weight_fetchers=None, **kw):
    """One package's ScoreClient over its fake transport (no retries: one
    upstream attempt per judge keeps the scripts aligned with judges)."""
    p = PKGS[pkg]
    transport = p.transport([clone(s) for s in scripts])
    chat = p.chat.DefaultChatClient(
        transport, [p.chat.ApiBase("https://up.example", "key")],
        backoff=p.chat.BackoffPolicy(max_elapsed_ms=0),
    )
    store = p.archive.InMemoryArchive()
    for obj in archived:
        store.put_chat(p.chat_unary.from_json_obj(obj))
    client = p.score.ScoreClient(
        chat, p.registry.InMemoryModelRegistry(), archive_fetcher=store,
        rng_factory=lambda: random.Random(SEED), **kw,
    )
    if weight_fetchers is not None:
        client.weight_fetchers = weight_fetchers(p)
    return client, transport


def masked(pkg, item) -> str:
    """One stream item as its package's canonical JSON, the per-call id
    and timestamp masked; an error item as its status and message."""
    if isinstance(item, Exception):
        return f"error {item.status()} {item.message()}"
    obj = item.to_json_obj()
    obj["id"] = obj["id"].split("-")[0]
    obj["created"] = 0
    return PKGS[pkg].json.dumps(obj)


def run_both(body, scripts, **kw):
    """(ref frames, port frames, ref requests, port requests) of one
    streamed request."""
    out = {}
    for pkg in ("ref", "port"):
        client, transport = make_client(pkg, scripts, **kw)
        params = PKGS[pkg].req.ChatCompletionCreateParams.from_json_obj(body)

        async def collect(client=client, params=params, pkg=pkg):
            stream = await client.create_streaming(None, params)
            return [masked(pkg, item) async for item in stream]

        out[pkg] = (go(collect()), [b for _, _, b in transport.requests])
    return out["ref"][0], out["port"][0], out["ref"][1], out["port"][1]


def unary_both(body, scripts, **kw):
    out = {}
    for pkg in ("ref", "port"):
        client, _ = make_client(pkg, scripts, **kw)
        params = PKGS[pkg].req.ChatCompletionCreateParams.from_json_obj(body)
        try:
            result = go(client.create_unary(None, params))
            out[pkg] = masked(pkg, result)
        except Exception as exc:  # the same error on both sides
            out[pkg] = f"raised {type(exc).__name__} {exc.status()} " \
                       f"{exc.message()}"
    return out["ref"], out["port"]


def body(judges, choices=TEXTS, **kw):
    return {"messages": [{"role": "user", "content": "pick the best"}],
            "model": {"llms": judges}, "choices": choices, **kw}


def judge_script(key, usage=None, model="up-model", delay=0.0):
    return Script(
        [chunk_obj("I pick ", model=model),
         chunk_obj(f"{key} as best.", model=model, finish="stop",
                   usage=usage)],
        delays={0: delay} if delay else None,
    )


TWO = [{"model": "judge-a", "weight": {"type": "static", "weight": 2}},
       {"model": "judge-b", "weight": {"type": "static", "weight": 1}}]


def judge_order(judges):
    """Upstream model names in the order the judges make their requests
    (the panel's canonical member order)."""
    from llm_weighted_consensus_tpu.identity.model import ModelBase

    model = ModelBase.from_json_obj({"llms": judges}).into_model_validate()
    return [llm.base.model for llm in model.llms]


def scripts_for(judges, by_model):
    return [by_model[m] for m in judge_order(judges)]


def soft_script(n, top_logprobs, pick=0, probs=(0.7, 0.3), seed=SEED):
    rng = random.Random(seed)
    tree = PrefixTree.build(rng, n, branch_limit(top_logprobs))
    pairs = tree.key_indices(rng)
    key = next(k for k, i in pairs if i == pick)
    branch = tree.walk(key)
    letters = list(branch)
    lp = {"content": [
        {"token": key[:-2], "logprob": -0.01, "top_logprobs": []},
        {"token": key[-2], "logprob": math.log(probs[0]),
         "top_logprobs": [
             {"token": c, "logprob": math.log(probs[j % len(probs)])}
             for j, c in enumerate(letters)]},
        {"token": "`", "logprob": -0.01, "top_logprobs": []},
    ]}
    return Script([chunk_obj(key, finish="stop", logprobs=lp)])


TOOL_CHUNK = lambda key: {  # noqa: E731
    "id": "cc-1", "object": "chat.completion.chunk", "created": 1,
    "model": "up",
    "choices": [{"index": 0, "delta": {
        "role": "assistant",
        "tool_calls": [{"index": 0, "id": "call-1", "type": "function",
                        "function": {"name": "response_key",
                                     "arguments": '{"response_key": "%s"}'
                                     % key}}]},
        "finish_reason": None}],
}

USAGE = {"prompt_tokens": 10, "completion_tokens": 5, "total_tokens": 15}
KEYS3, KEYS2 = ballot_keys(3), ballot_keys(2)

# name -> (request body, scripts)
CASES = {
    "agreement": (body(TWO), [judge_script(KEYS3[1]),
                              judge_script(KEYS3[1], delay=0.01)]),
    "disagreement": (body(TWO), scripts_for(TWO, {
        "judge-a": judge_script(KEYS3[0]),
        "judge-b": judge_script(KEYS3[2], delay=0.01)})),
    "usage": (body(TWO), [judge_script(KEYS3[0], usage=USAGE),
                          judge_script(KEYS3[2], usage=USAGE, delay=0.01)]),
    "trailing_usage": (body([{"model": "judge-a"}], ["a", "b"]), [Script([
        chunk_obj(f"pick {KEYS2[0]}", finish="stop"),
        {"id": "cc-1", "object": "chat.completion.chunk", "created": 1,
         "model": "up", "choices": [],
         "usage": {"prompt_tokens": 7, "completion_tokens": 3,
                   "total_tokens": 10}}])]),
    "judge_failure": (body(TWO), scripts_for(TWO, {
        "judge-a": Script(status=500, body=b'{"err":"down"}'),
        "judge-b": judge_script(KEYS3[1], delay=0.01)})),
    "all_failed_4xx": (body(TWO), [Script(status=404, body=b"{}"),
                                   Script(status=422, body=b"{}")]),
    "all_failed_5xx": (body(TWO), [Script(status=404, body=b"{}"),
                                   Script(status=503, body=b"{}")]),
    "invalid_content": (body([{"model": "judge-a"}], ["a", "b"]),
                        [Script([chunk_obj("no key here", finish="stop")])]),
    "soft_vote": (body([{"model": "judge-a", "top_logprobs": 2,
                         "weight": {"type": "static", "weight": 1}}],
                       ["a", "b"]), [soft_script(2, 2)]),
    "soft_vote_wide": (body([{"model": "judge-a", "top_logprobs": 5},
                             {"model": "judge-b", "top_logprobs": 5,
                              "weight": {"type": "static", "weight": 3}}],
                            [f"c{i}" for i in range(7)]),
                       [soft_script(7, 5, pick=3, probs=(0.5, 0.2, 0.1)),
                        soft_script(7, 5, pick=1, probs=(0.4, 0.35))]),
    "system_message_appended": ({
        "messages": [{"role": "user", "content": "q"},
                     {"role": "system", "content": "be fair"}],
        "model": {"llms": [{"model": "judge-a"}]}, "choices": ["a", "b"]},
        [judge_script(KEYS2[0])]),
    "json_schema": (body([{"model": "judge-a", "output_mode": "json_schema"}],
                         ["a", "b"]),
                    [Script([chunk_obj('{"response_key": "%s"}' % KEYS2[1],
                                       finish="stop")])]),
    "tool_call": (body([{"model": "judge-a", "output_mode": "tool_call"}],
                       ["a", "b"]),
                  [Script([TOOL_CHUNK(KEYS2[0]),
                           chunk_obj(finish="tool_calls")])]),
    "synthetic_reasoning": (
        body([{"model": "judge-a", "output_mode": "json_schema",
               "synthetic_reasoning": True}], ["a", "b"]),
        [Script([chunk_obj('{"_think": "hmm", "response_key": "%s"}'
                           % KEYS2[0], finish="stop")])]),
    "sampling_params": (
        body([{"model": "judge-a", "temperature": 0.2, "top_p": 0.9,
               "top_logprobs": 5, "max_tokens": 64}], ["a", "b"], seed=7),
        [judge_script(ballot_keys(2, 5)[0])]),
    "many_judges": (
        body([{"model": f"judge-{i}",
               "weight": {"type": "static", "weight": [1, 2.5, 0.1][
                   i % 3]}} for i in range(6)], [f"c{i}" for i in range(5)]),
        [judge_script(ballot_keys(5)[i % 5], delay=0.005 * i)
         for i in range(6)]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_streaming_frames_and_judge_requests_equal(case):
    b, scripts = CASES[case]
    want, got, want_req, got_req = run_both(b, scripts)
    assert got == want
    assert got_req == want_req


@pytest.mark.parametrize("case", sorted(CASES))
def test_unary_result_equal(case):
    b, scripts = CASES[case]
    want, got = unary_both(b, scripts)
    assert got == want


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_fastpath_gives_the_same_bytes(case):
    b, scripts = CASES[case]
    _, slow, _, _ = run_both(b, scripts)
    fast = run_both(b, scripts, host_fastpath=True)
    assert fast[1] == slow
    assert fast[0] == slow  # the reference's fast lane too


ARCHIVED = {
    "id": "cc-old", "object": "chat.completion", "created": 123,
    "model": "old-model",
    "choices": [{"index": 0, "finish_reason": "stop", "message": {
        "role": "assistant", "content": "archived alpha", "refusal": None,
        "reasoning": "thought hard",
        "tool_calls": [{"id": "t1", "type": "function", "function": {
            "name": "search", "arguments": '{"q": "x"}'}}]}}],
}


def test_archived_chat_choice_as_candidate_equal():
    b = {"messages": [{"role": "user", "content": "q"}],
         "model": {"llms": [{"model": "judge-a"}]},
         "choices": [{"type": "chat_completion", "id": "cc-old",
                      "choice_index": 0}, "plain text candidate"]}
    want, got, want_req, got_req = run_both(
        b, [judge_script(KEYS2[0])], archived=[ARCHIVED])
    assert got == want and got_req == want_req
    assert "thought hard" in got_req[0]["messages"][-1]["content"]


@pytest.mark.parametrize("choices", [[], ["only one"]])
def test_fewer_than_two_choices_rejected_alike(choices):
    want, got = unary_both(body(TWO, choices), [])
    assert want.startswith("raised ExpectedTwoOrMoreChoices")
    assert got == want


@pytest.mark.parametrize("model", ["not json not id", '{"llms": []}'])
def test_invalid_model_rejected_alike(model):
    b = body(TWO)
    b["model"] = model
    want, got = unary_both(b, [])
    assert want.startswith("raised InvalidModelError")
    assert got == want


def _fake_tt(p):
    """A training-table fetcher whose weights and evidence are fixed."""

    class FakeTT(p.weights.TrainingTableWeightFetcher):
        async def fetch(self, ctx, request, model):
            resp = p.emb_types.CreateEmbeddingResponse.from_json_obj({
                "object": "list",
                "data": [{"object": "embedding", "index": 0,
                          "embedding": [0.1, 0.2]}],
                "model": "bge-small",
                "usage": {"prompt_tokens": 4, "completion_tokens": 0,
                          "total_tokens": 4}})
            return ([Decimal("3.4000000953674316"), Decimal(1)],
                    p.resp.TrainingTableData(embeddings_response=resp))

    return p.weights.WeightFetchers(training_table_fetcher=FakeTT())


TT_BODY = {
    "messages": [{"role": "user", "content": "q"}],
    "model": {"llms": [{"model": "judge-a", "weight": {
        "type": "training_table"}}, {"model": "judge-b", "weight": {
            "type": "training_table"}}],
        "weight": {"type": "training_table",
                   "embeddings": {"model": "bge-small"}, "top": 5}},
    "choices": ["a", "b"],
}


def test_training_table_weight_data_echo_and_usage_seed_equal():
    scripts = [judge_script(KEYS2[1], usage=USAGE),
               judge_script(KEYS2[0], delay=0.01)]
    want, got, _, _ = run_both(TT_BODY, scripts, weight_fetchers=_fake_tt)
    assert got == want
    final = port_json.loads(got[-1])
    assert final["weight_data"]["embeddings_response"]["model"] == "bge-small"
    # the embeddings usage seeds the total (client.rs:330-337)
    assert final["usage"]["total_tokens"] == 4 + 15


def test_training_table_without_fetcher_is_501_alike():
    want, got = unary_both(TT_BODY, [])
    assert "501" in want
    assert got == want


# -- the fast-lane fold ---------------------------------------------------------


def _pathological_tail(rng: np.random.Generator, n: int):
    """Judge choices whose votes and weights stress the fixed-point lane:
    tiny, huge, repeating decimals, mixed exponents, ints, zero weights,
    short ballots, floats (which only the Decimal loop may reject), NaN
    and infinities, and missing weights."""
    pool = [Decimal(0), Decimal(1), Decimal("0.5"), Decimal("0.50"),
            Decimal(1) / Decimal(3), Decimal(2) / Decimal(7),
            Decimal("1E-30"), Decimal("1E+20"), Decimal("123456789.987654321"),
            Decimal("-0.25"), Decimal("0.1000"), 1, 0, 3]
    weights = [Decimal(1), Decimal(2), Decimal("0.1"), Decimal("2.5"),
               Decimal("1E-12"), Decimal("9E+15"), Decimal(1) / Decimal(7),
               None, 2, Decimal("3.4000000953674316")]
    tail = []
    for _ in range(int(rng.integers(1, 9))):
        kind = rng.random()
        if kind < 0.08:
            vote = None
        elif kind < 0.12:
            vote = [Decimal(1)] * (n - 1)  # short ballot
        elif kind < 0.15:
            vote = [0.5] * n  # a float: the Decimal loop's to reject
        elif kind < 0.17:
            vote = [Decimal("NaN")] * n
        else:
            vote = [pool[int(rng.integers(0, len(pool)))] for _ in range(n)]
        tail.append(SimpleNamespace(
            delta=SimpleNamespace(vote=vote),
            weight=weights[int(rng.integers(0, len(weights)))]))
    return tail


@pytest.mark.parametrize("seed", range(60))
def test_fixed_point_fold_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 7))
    tail = _pathological_tail(rng, n)
    want = ref_tally.fixed_point_fold(tail, n)
    got = port_tally.fixed_point_fold(tail, n)
    if want is None:
        assert got is None
    else:
        assert [str(d) for d in got] == [str(d) for d in want]


@pytest.mark.parametrize("prec", [6, 28, 60])
def test_fixed_point_fold_gate_follows_the_context_precision(prec):
    tail = [SimpleNamespace(delta=SimpleNamespace(vote=[Decimal(1) / 3,
                                                        Decimal(2) / 3]),
                            weight=Decimal("123456.789"))]
    with decimal.localcontext() as ctx:
        ctx.prec = prec
        want = ref_tally.fixed_point_fold(tail, 2)
        got = port_tally.fixed_point_fold(tail, 2)
    assert (got is None) == (want is None)
    if want is not None:
        assert [str(d) for d in got] == [str(d) for d in want]


def test_tally_runs_in_the_default_decimal_context_on_the_loop():
    """The score route's coroutine starts from a fresh default context (28
    digits), whatever the submitting handler thread's context says."""
    from llm_weighted_consensus_tpu_torch.serve import chat_routes

    seen = {}

    async def create_unary(ctx, params):
        seen["prec"] = decimal.getcontext().prec
        return "done"

    loop = chat_routes.EventLoop()
    try:
        def handler():
            decimal.getcontext().prec = 7
            seen["result"] = loop.submit(chat_routes._unary(
                create_unary, None, None, None)).result(10)

        t = threading.Thread(target=handler)
        t.start()
        t.join(10)
    finally:
        loop.close()
    assert seen == {"prec": 28, "result": "done"}


# -- the server's /score/completions ------------------------------------------

import http.client  # noqa: E402
import json  # noqa: E402


def _ref_app(scripts):
    """The reference's gateway over the same scripts, wired as its
    ``build_service`` wires a server without an embedder."""
    from llm_weighted_consensus_tpu.clients.multichat import MultichatClient
    from llm_weighted_consensus_tpu.serve import build_app

    client, transport = make_client("ref", scripts)
    multichat = MultichatClient(client.chat_client,
                                client.model_fetcher)
    return build_app(client.chat_client, client, multichat, None)


def _port_server(scripts, **kw):
    from llm_weighted_consensus_tpu_torch.serve.gateway import Server

    client, transport = make_client("port", scripts, **kw)
    return Server(None, chat_client=client.chat_client,
                  score_client=client), transport


def _ref_post(app, path, raw: bytes):
    from aiohttp.test_utils import TestClient, TestServer

    async def run():
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            resp = await client.post(
                path, data=raw, headers={"content-type": "application/json"})
            return resp.status, await resp.read()
        finally:
            await client.close()

    return asyncio.new_event_loop().run_until_complete(run())


def _port_post(server, path, raw: bytes):
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=60)
    try:
        conn.request("POST", path, body=raw,
                     headers={"content-type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _wire_masked(raw: bytes) -> list:
    """A response body as its SSE events (or the one JSON body), the
    score response id and timestamp masked."""
    events = [b[len(b"data: "):].decode() for b in raw.split(b"\n\n")
              if b.startswith(b"data: ")] or [raw.decode()]
    out = []
    for ev in events:
        if ev == "[DONE]":
            out.append(ev)
            continue
        obj = json.loads(ev)
        if str(obj.get("id", "")).startswith("scrcpl-"):
            obj["id"], obj["created"] = "scrcpl", 0
        out.append(obj)
    return out


SERVER_CASES = ["agreement", "disagreement", "judge_failure",
                "all_failed_4xx", "all_failed_5xx", "invalid_content",
                "soft_vote", "tool_call"]


@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("case", SERVER_CASES)
def test_score_route_bodies_equal_the_reference_gateway(case, stream):
    b, scripts = CASES[case]
    raw = port_json.dumps({**b, "stream": stream}).encode()
    want_status, want = _ref_post(_ref_app(scripts), "/score/completions",
                                  raw)
    server, _ = _port_server(scripts)
    with server:
        status, got = _port_post(server, "/score/completions", raw)
    assert status == want_status
    assert _wire_masked(got) == _wire_masked(want)
    if stream:
        assert _wire_masked(got)[-1] == "[DONE]"


BAD_SCORE = [
    b"{not json",
    b'{"model": "m"}',
    b'{"messages": [], "model": {"llms": [{"model": "a"}]}, '
    b'"choices": ["x"]}',
    b'{"messages": [], "model": {"llms": []}, "choices": ["x", "y"]}',
    b'{"messages": [], "model": "not a panel", "choices": ["x", "y"]}',
    b'{"messages": [{"role": "robot", "content": "x"}], '
    b'"model": {"llms": [{"model": "a"}]}, "choices": ["x", "y"]}',
    port_json.dumps({**TT_BODY, "stream": True}).encode(),
]


@pytest.mark.parametrize("raw", BAD_SCORE)
def test_score_route_errors_are_the_reference_errors(raw):
    want = _ref_post(_ref_app([]), "/score/completions", raw)
    server, _ = _port_server([])
    with server:
        got = _port_post(server, "/score/completions", raw)
    assert got == want and got[0] >= 400


def test_score_knobs_read_as_the_reference_reads_them():
    from llm_weighted_consensus_tpu.serve.config import Config
    from llm_weighted_consensus_tpu_torch.serve.config import ServeConfig

    names = ("tables_path", "host_fastpath", "score_cache_ttl_sec",
             "score_cache_max_bytes", "score_cache_dir", "score_cache_embed",
             "score_cache_embed_max_bytes")
    for env in ({}, {"SCORE_CACHE_TTL": "60"},
                {"SCORE_CACHE_TTL": "60", "SCORE_CACHE_EMBED": "0",
                 "SCORE_CACHE_MAX_BYTES": "1000",
                 "SCORE_CACHE_EMBED_MAX_BYTES": "99",
                 "SCORE_CACHE_DIR": "/x", "HOST_FASTPATH": "1",
                 "TABLES_PATH": "/t.npz"},
                {"SCORE_CACHE_TTL": "-5", "SCORE_CACHE_EMBED": "1"}):
        ref, port = Config.from_env(env), ServeConfig.from_env(env)
        assert {n: getattr(port, n) for n in names} == \
            {n: getattr(ref, n) for n in names}


def test_entry_points_serve_trained_weights_and_the_caches(tmp_path):
    """``build_server`` over bge_micro on the CPU: a ``TABLES_PATH``
    snapshot the JAX store wrote feeds a training-table panel through
    the batcher; a repeat is a cache hit with no upstream call and no
    dispatch; ``/metrics`` has both cache sections; the tables are saved
    at close."""
    from llm_weighted_consensus_tpu.weights.training_table import (
        TrainingTableStore as RefStore,
    )
    from llm_weighted_consensus_tpu_torch.identity.model import ModelBase
    from llm_weighted_consensus_tpu_torch.serve import __main__ as serve_main
    from llm_weighted_consensus_tpu_torch.serve.config import ServeConfig
    from llm_weighted_consensus_tpu_torch.serve.fake_upstream import (
        FakeUpstream,
    )
    from test_torch_training_table import PROMPTS, micro_embedders

    _, emb = micro_embedders()
    body = {
        "messages": [{"role": "user", "content": "the capital of france"}],
        "model": {"llms": [{"model": f"judge-{i}", "weight": {
            "type": "training_table", "base_weight": 1, "min_weight": 1,
            "max_weight": 5}} for i in range(3)],
            "weight": {"type": "training_table",
                       "embeddings": {"model": "bge-micro",
                                      "max_tokens": 32}, "top": 2}},
        "choices": ["paris", "lyon"],
    }
    model = ModelBase.from_json_obj(body["model"]).into_model_validate()
    rows = emb.embed_texts(PROMPTS)
    ref_store = RefStore()
    for i, llm in enumerate(model.llms[:2]):
        ref_store.add_rows(llm.training_table_id, rows,
                           np.linspace(0.1 * i, 1.0, len(rows)))
    path = str(tmp_path / "tables.npz")
    ref_store.save(path)
    fake = FakeUpstream()
    try:
        config = ServeConfig.from_env({
            "OPENAI_API_BASE": fake.url, "OPENAI_API_KEY": "k",
            "TABLES_PATH": path, "SCORE_CACHE_TTL": "60",
            "BATCH_WINDOW_MS": "1"})
        server = serve_main.build_server(emb, None, config)
        with server:
            serve_main.warm_up(server, config)
            raw = port_json.dumps(body).encode()
            status, got = _port_post(server, "/score/completions", raw)
            dispatches = server.batcher.stats()["dispatches"]["embed"]
            status2, again = _port_post(server, "/score/completions", raw)
            assert server.batcher.stats()["dispatches"]["embed"] == \
                dispatches == 1
            metrics = server.metrics.snapshot()
        saved = RefStore.load(path)
    finally:
        fake.close()
    assert (status, status2) == (200, 200)
    out = json.loads(got)
    assert _wire_masked(again) == _wire_masked(got)
    judges = {c["model_index"]: c for c in out["choices"] if c["index"] >= 2}
    weights = [float(judges[i]["weight"]) for i in range(3)]
    assert all(1.0 <= w <= 5.0 for w in weights[:2]) and weights[2] == 1.0
    emb_resp = out["weight_data"]["embeddings_response"]
    assert emb_resp["model"] == "bge-micro"
    assert out["usage"]["prompt_tokens"] >= emb_resp["usage"]["prompt_tokens"]
    conf = [float(c["confidence"]) for c in out["choices"] if c["index"] < 2]
    assert abs(sum(conf) - 1.0) < 1e-9
    assert metrics["score_cache"]["hits"] == 1
    assert metrics["score_cache"]["inflight_collapses"] == 0
    assert metrics["embed_cache"]["entries"] == 1
    assert len(saved) == 2


def test_training_table_panel_without_an_embedder_is_501():
    server, transport = _port_server([])
    with server:
        status, got = _port_post(server, "/score/completions",
                                 port_json.dumps(TT_BODY).encode())
    assert status == 501 and transport.requests == []
    assert json.loads(got) == {
        "kind": "score",
        "error": "training-table weight fetcher not configured"}
