"""The port's ``HOST_FASTPATH`` splice lane (``types/base.py``
``SpliceEncoder`` behind ``serve/frames.py``'s ``FrameEncoder``) against
its own slow lane and against the JAX package's splice lane, byte for
byte.

* Real engine streams: the port's ``ScoreClient`` and the reference's
  on the same scripts at the reference's seeds 3, 11, 29 and 47, each
  with a judge that errors and a straggler the weight quorum cancels, so
  the streams carry per-judge errors and a degraded final frame: every
  frame of the port's splice lane equals its slow lane's, and equals the
  reference's splice lane's once the response id and ``created`` are
  masked, with no fallback.
* Synthetic sequences the splice caches must never alias: fields
  appearing, vanishing and reverting, unicode and control characters,
  Decimals equal in value but not in their tokens (weights and vote
  vectors).
* Through the port's server with ``HOST_FASTPATH``: the body on the
  wire is the frames the splice lane encoded, each the slow lane's bytes
  for the same item, with no fallback; a frame the splicer cannot encode
  falls back to the slow lane, counted, with the same bytes.
"""

import asyncio
import json
import random
import re
from decimal import Decimal
from types import SimpleNamespace

import pytest

from llm_weighted_consensus_tpu import archive as ref_archive
from llm_weighted_consensus_tpu import registry as ref_registry
from llm_weighted_consensus_tpu import resilience as ref_res
from llm_weighted_consensus_tpu.ballot import PrefixTree
from llm_weighted_consensus_tpu.clients import chat as ref_chat
from llm_weighted_consensus_tpu.clients import score as ref_score
from llm_weighted_consensus_tpu.serve import frames as ref_frames
from llm_weighted_consensus_tpu.types import score_request as ref_req
from llm_weighted_consensus_tpu.types import score_response as ref_resp
from llm_weighted_consensus_tpu_torch import archive as port_archive
from llm_weighted_consensus_tpu_torch import registry as port_registry
from llm_weighted_consensus_tpu_torch import resilience as port_res
from llm_weighted_consensus_tpu_torch.clients import chat as port_chat
from llm_weighted_consensus_tpu_torch.clients import score as port_score
from llm_weighted_consensus_tpu_torch.serve import frames as port_frames
from llm_weighted_consensus_tpu_torch.types import score_request as port_req
from llm_weighted_consensus_tpu_torch.types import score_response as port_resp

from fakes import FakeTransport, Script, chunk_obj
from test_torch_chat_client import PortFakeTransport

PKGS = {
    "ref": SimpleNamespace(
        res=ref_res, chat=ref_chat, score=ref_score, req=ref_req,
        resp=ref_resp, frames=ref_frames, registry=ref_registry,
        archive=ref_archive, transport=FakeTransport,
    ),
    "port": SimpleNamespace(
        res=port_res, chat=port_chat, score=port_score, req=port_req,
        resp=port_resp, frames=port_frames, registry=port_registry,
        archive=port_archive, transport=PortFakeTransport,
    ),
}


def go(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


def ballot_keys(n, seed):
    rng = random.Random(seed)
    tree = PrefixTree.build(rng, n, 20)
    return {idx: k for k, idx in tree.key_indices(rng)}


def judge_scripts(keys, seed, judges, failing, straggler):
    """One script per upstream request: each vote key split across two
    content chunks at a seeded cut; one judge answers 500 and one stalls
    until the quorum cancels it."""
    rng = random.Random(seed)
    scripts = []
    for j in range(judges):
        if j == failing:
            scripts.append(Script(status=500, body=b'{"boom": 1}'))
            continue
        # the fast judges agree, so the quorum can cut the straggler
        text = f"after deliberation I pick {keys[seed % len(keys)]}!"
        cut = rng.randrange(1, len(text))
        scripts.append(Script(
            [chunk_obj(text[:cut]), chunk_obj(text[cut:], finish="stop")],
            delays={0: 30.0} if j == straggler else None))
    return scripts


def engine_stream(pkg, seed, fastpath):
    """The chunk items of one streamed score request through ``pkg``'s
    engine (5 judges, 6 candidates, weights 1..5, quorum 0.5)."""
    p = PKGS[pkg]
    n, judges = 6, 5
    keys = ballot_keys(n, seed)
    policy = p.res.ResiliencePolicy(quorum_fraction=0.5)
    scripts = judge_scripts(keys, seed, judges, failing=1, straggler=3)
    chat = p.chat.DefaultChatClient(
        p.transport(scripts), [p.chat.ApiBase("https://up.example", "k")],
        backoff=p.chat.BackoffPolicy(max_elapsed_ms=0), resilience=policy)
    client = p.score.ScoreClient(
        chat, p.registry.InMemoryModelRegistry(),
        archive_fetcher=p.archive.InMemoryArchive(),
        rng_factory=lambda: random.Random(seed), host_fastpath=fastpath,
        resilience=policy)
    params = p.req.ChatCompletionCreateParams.from_json_obj({
        "messages": [{"role": "user", "content": "q"}],
        "model": {"llms": [
            {"model": f"j{j}", "weight": {"type": "static", "weight": 1 + j}}
            for j in range(judges)]},
        "choices": [f"c{i}" for i in range(n)],
    })

    async def run():
        stream = await client.create_streaming(None, params)
        return [item async for item in stream]

    return go(run())


def normalize(raw: bytes) -> bytes:
    raw = re.sub(rb'"scrcpl-[0-9a-f]+-\d+"', b'"ID"', raw)
    return re.sub(rb'"created":\d+', b'"created":0', raw)


def encode_all(pkg, items, fastpath):
    enc = PKGS[pkg].frames.FrameEncoder(fastpath)
    out = [enc.encode_error(i) if isinstance(i, Exception) else enc.encode(i)
           for i in items]
    return out, enc.fallbacks


@pytest.mark.parametrize("seed", [3, 11, 29, 47])
@pytest.mark.parametrize("fastpath_engine", [False, True])
def test_seeded_streams_splice_byte_identically(seed, fastpath_engine):
    port_items = engine_stream("port", seed, fastpath_engine)
    ref_items = engine_stream("ref", seed, fastpath_engine)
    fast, fast_fallbacks = encode_all("port", port_items, True)
    slow, _ = encode_all("port", port_items, False)
    ref_fast, ref_fallbacks = encode_all("ref", ref_items, True)
    assert fast == slow
    assert fast_fallbacks == ref_fallbacks == 0
    assert [normalize(f) for f in fast] == [normalize(f) for f in ref_fast]
    final = json.loads(fast[-1][len(b"data: "):])
    assert final["degraded"] is True
    codes = {c["error"]["code"] for c in final["choices"] if c.get("error")}
    assert codes == {499, 500}


def synthetic(resp):
    def chunk(choices, **kw):
        return resp.ChatCompletionChunk(
            id="cc-1", created=1700000000, model="m", choices=choices, **kw)

    sc, d = resp.StreamingChoice, resp.Delta
    return [
        chunk([sc(index=0, delta=d(content="héllo\x00\n"))]),
        chunk([sc(index=0, delta=d(content='quote" and \\ back'),
                  weight=Decimal("1.5"))]),
        chunk([sc(index=0, delta=d(content="x"))]),
        chunk([sc(index=0, delta=d(content="x")),
               sc(index=1, delta=d(vote=[Decimal(1), Decimal(0)]),
                  finish_reason="stop")]),
        chunk([sc(index=0, delta=d(content="x"))],
              usage=resp.Usage(prompt_tokens=3, completion_tokens=5,
                               total_tokens=8), degraded=True),
    ] + [
        chunk([sc(index=0, delta=d(content="s"), weight=w)])
        for w in (Decimal("2"), Decimal("2.0"), Decimal("2.00"), Decimal("2"))
    ] + [
        chunk([sc(index=0, delta=d(content="s", vote=list(v)))])
        for v in ([Decimal("1"), Decimal("0")],
                  [Decimal("1.0"), Decimal("0")],
                  [Decimal("1.0"), Decimal("0.00")])
    ]


def test_synthetic_churn_and_exponent_drift_never_alias():
    port_items, ref_items = synthetic(port_resp), synthetic(ref_resp)
    fast, fallbacks = encode_all("port", port_items, True)
    slow, _ = encode_all("port", port_items, False)
    ref_fast, _ = encode_all("ref", ref_items, True)
    assert fast == slow == ref_fast
    assert fallbacks == 0
    assert b'"weight":2.00' in fast[7] and b'"weight":2.0}' in fast[6]


def test_an_unencodable_frame_falls_back_counted_with_the_same_bytes():
    class Update:  # not a Struct: the splicer refuses it
        def to_json_obj(self):
            return {"object": "multichat.consensus",
                    "confidence": {"0": 0.25, "1": 0.75}}

    fast, slow = port_frames.FrameEncoder(True), port_frames.FrameEncoder()
    assert fast.encode(Update()) == slow.encode(Update())
    assert (fast.fallbacks, slow.fallbacks) == (1, 0)
    err = port_frames.FrameEncoder(True).encode_error(ValueError("x"))
    assert err == b'data: {"code":500,"message":"internal error"}\n\n'


class RecordingEncoder(port_frames.FrameEncoder):
    """The splice lane, keeping each (item, frame) it encodes."""

    __slots__ = ("sent",)

    def __init__(self, fastpath):
        super().__init__(fastpath)
        self.sent = []

    def encode(self, item):
        frame = super().encode(item)
        self.sent.append((item, frame))
        return frame


def test_served_frames_are_the_slow_lanes_bytes():
    from test_torch_resilience import LoopbackJudges, body, post_json, serve

    judges = LoopbackJudges()
    server = serve({"OPENAI_API_BASE": judges.url, "OPENAI_API_KEY": "k",
                    "BACKOFF_MAX_ELAPSED_TIME_MILLIS": "0",
                    "RESILIENCE_QUORUM": "0.5", "HOST_FASTPATH": "1"})
    encoders = []

    def new_encoder():
        enc = RecordingEncoder(server.chat_routes.host_fastpath)
        encoders.append(enc)
        return enc

    server.chat_routes.new_encoder = new_encoder
    try:
        panel = [{"model": "fast-a", "weight": {"type": "static",
                                               "weight": 2}},
                 {"model": "fast-b"}, {"model": "stall-c"}]
        status, raw = post_json(server.port, "/score/completions",
                                body(panel, stream=True))
    finally:
        server.close()
        judges.close()
    assert status == 200 and len(encoders) == 1
    sent = encoders[0].sent
    assert raw == b"".join(f for _, f in sent) + port_frames.DONE
    slow = port_frames.FrameEncoder()
    assert [f for _, f in sent] == [slow.encode(i) for i, _ in sent]
    assert b'"degraded":true' in sent[-1][1]
    assert encoders[0].fallbacks == server.chat_routes.fastpath_fallbacks == 0
