"""``/chat/completions`` and ``/multichat/completions`` of the port's
server on the CPU, against the JAX package's gateway.

Both serve the same scripted upstream (``tests/fakes.py`` scripts; the
port's clients through a port ``Transport``) and, for consensus, the
committed ``tests/fixtures/bge_micro`` snapshot in f32 behind their own
batchers.  The SSE frames and unary bodies must be equal byte for byte
once the multichat response id and timestamp are masked, the
``multichat.consensus`` confidences within 1e-5 (f32 encoders summing in
different orders); the 400s with JSON paths, the errors raised before a
stream opens, the overlay that degrades to plain multichat when the
embedder fails, a client that disconnects mid-stream (the upstream
stream is closed), and admission, deadline and drain on the new routes.
"""

import asyncio
import dataclasses
import http.client
import json
import os
import random
import time

import jax
import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from llm_weighted_consensus_tpu import archive as ref_archive
from llm_weighted_consensus_tpu import registry as ref_registry
from llm_weighted_consensus_tpu.clients import chat as ref_chat
from llm_weighted_consensus_tpu.clients.multichat import (
    MultichatClient as RefMultichatClient,
)
from llm_weighted_consensus_tpu.clients.score import ScoreClient
from llm_weighted_consensus_tpu.models import configs as jax_configs
from llm_weighted_consensus_tpu.models import loading as jax_loading
from llm_weighted_consensus_tpu.models import tokenizer as jax_tokenizer
from llm_weighted_consensus_tpu.models.embedder import TpuEmbedder
from llm_weighted_consensus_tpu.serve import build_app
from llm_weighted_consensus_tpu.utils import jsonutil
from llm_weighted_consensus_tpu_torch import archive as port_archive
from llm_weighted_consensus_tpu_torch import registry as port_registry
from llm_weighted_consensus_tpu_torch.clients import chat as port_chat
from llm_weighted_consensus_tpu_torch.clients.multichat import (
    MultichatClient,
)
from llm_weighted_consensus_tpu_torch.models import (
    bert,
    convert,
    loading,
    tokenizer,
)
from llm_weighted_consensus_tpu_torch.models.embedder import TorchEmbedder
from llm_weighted_consensus_tpu_torch.resilience.admission import (
    AdmissionConfig,
)
from llm_weighted_consensus_tpu_torch.serve.gateway import Server

from fakes import FakeTransport, Script, chunk_obj
from test_torch_chat_client import PortFakeTransport

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "bge_micro")
TOL = 1e-5
NO_RETRY = dict(max_elapsed_ms=0)
ANSWERS = ["paris is the capital of france",
           "the capital of france is paris",
           "bananas are yellow and curved",
           "paris, the french capital, on the seine",
           "it is lyon"]


@pytest.fixture(scope="module")
def micro():
    port_cfg = loading.load_hf_config(FIXTURE)
    jax_cfg = jax_configs.BertConfig(
        **{f.name: getattr(port_cfg, f.name)
           for f in dataclasses.fields(port_cfg)}
    )
    params = jax_loading.load_params(FIXTURE, jax_cfg)
    state = convert.from_jax_params(
        jax.tree_util.tree_map(np.asarray, params), port_cfg
    )
    vocab = loading.find_vocab(FIXTURE)
    ref = TpuEmbedder("bge-micro", params=params, config=jax_cfg,
                      tokenizer=jax_tokenizer.load_tokenizer(vocab),
                      max_tokens=64)
    port = TorchEmbedder(
        "bge-micro", model=bert.from_hf_state_dict(state, port_cfg,
                                                   device="cpu"),
        config=port_cfg, tokenizer=tokenizer.load_tokenizer(vocab),
        max_tokens=64, device="cpu",
    )
    return ref, port


def _clone(s):
    return Script(list(s.events), status=s.status, body=s.body,
                  connect_error=s.connect_error, delays=dict(s.delays),
                  done=s.done)


def _ref_app(scripts, embedder=None):
    # wired as the reference's build_service wires it
    transport = FakeTransport([_clone(s) for s in scripts])
    store = ref_archive.InMemoryArchive()
    chat = ref_chat.DefaultChatClient(
        transport, [ref_chat.ApiBase("https://up.example", "k")],
        backoff=ref_chat.BackoffPolicy(**NO_RETRY), archive_fetcher=store)
    reg = ref_registry.InMemoryModelRegistry()
    score = ScoreClient(chat, reg, archive_fetcher=store,
                        rng_factory=lambda: random.Random(11))
    multichat = RefMultichatClient(chat, reg, archive_fetcher=store)
    return build_app(chat, score, multichat, embedder)


def _port_server(scripts, embedder=None, transport=None, **options):
    transport = transport or PortFakeTransport([_clone(s) for s in scripts])
    store = port_archive.InMemoryArchive()
    chat = port_chat.DefaultChatClient(
        transport, [port_chat.ApiBase("https://up.example", "k")],
        backoff=port_chat.BackoffPolicy(**NO_RETRY), archive_fetcher=store)
    multichat = MultichatClient(chat, port_registry.InMemoryModelRegistry(),
                                archive_fetcher=store)
    return Server(embedder, chat_client=chat, multichat_client=multichat,
                  **options)


def _ref_post(app, path, body: bytes):
    async def run():
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            resp = await client.post(
                path, data=body, headers={"content-type": "application/json"})
            return resp.status, await resp.read()
        finally:
            await client.close()

    return asyncio.new_event_loop().run_until_complete(run())


def _port_post(server, path, body: bytes, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=60)
    try:
        conn.request("POST", path, body=body,
                     headers={"content-type": "application/json",
                              **(headers or {})})
        resp = conn.getresponse()
        return resp.status, resp.read(), dict(resp.getheaders())
    finally:
        conn.close()


def _events(raw: bytes) -> list:
    return [block[len(b"data: "):].decode()
            for block in raw.split(b"\n\n") if block.startswith(b"data: ")]


def _masked(event: str):
    if event == "[DONE]":
        return event
    obj = json.loads(event)
    if str(obj.get("id", "")).startswith("mchcpl-"):
        obj["id"], obj["created"] = "mchcpl", 0
    return obj


def _body(obj) -> bytes:
    return jsonutil.dumps(obj).encode()


def _panel(n):
    return {"llms": [{"model": f"gen-{i}"} for i in range(n)]}


# -- /chat/completions ------------------------------------------------------------


@pytest.mark.parametrize("stream", [False, True])
def test_chat_bodies_equal_the_reference(stream):
    scripts = [Script([chunk_obj("hi ", role="assistant"),
                       chunk_obj("there", finish="stop",
                                 usage={"prompt_tokens": 3,
                                        "completion_tokens": 2,
                                        "total_tokens": 5})])]
    body = _body({"model": "m", "stream": stream,
                  "messages": [{"role": "user", "content": "q"}]})
    want_status, want = _ref_post(_ref_app(scripts), "/chat/completions", body)
    with _port_server(scripts) as server:
        status, got, headers = _port_post(server, "/chat/completions", body)
    assert (status, want_status) == (200, 200)
    assert got == want
    if stream:
        assert headers["content-type"] == "text/event-stream"
        assert _events(got)[-1] == "[DONE]"


def test_chat_upstream_failure_equals_the_reference():
    scripts = [Script(status=503, body=b'{"busy": 1}')]
    body = _body({"model": "m", "messages": [{"role": "user", "content": "q"}]})
    want = _ref_post(_ref_app(scripts), "/chat/completions", body)
    with _port_server(scripts) as server:
        status, got, _ = _port_post(server, "/chat/completions", body)
    assert (status, got) == want and status == 503


BAD = [
    b"{not json",
    b'{"model": "m"}',
    b'{"model": "m", "messages": [{"role": "robot", "content": "x"}]}',
    b'{"model": 5, "messages": []}',
    b'[1, 2]',
]


@pytest.mark.parametrize("path", ["/chat/completions",
                                  "/multichat/completions"])
@pytest.mark.parametrize("raw", BAD)
def test_parse_errors_are_the_reference_400s(path, raw):
    want = _ref_post(_ref_app([]), path, raw)
    with _port_server([]) as server:
        status, got, _ = _port_post(server, path, raw)
    assert (status, got) == want and status == 400
    assert json.loads(got)["code"] == 400


# -- /multichat/completions -------------------------------------------------------


def _multichat_scripts(n):
    # each generator finishes 60 ms after the one before: one arrival order
    return [Script([chunk_obj(ANSWERS[i][:9], role="assistant"),
                    chunk_obj(ANSWERS[i][9:], finish="stop")],
                   delays={0: 0.06 * i}) for i in range(n)]


def test_multichat_stream_with_consensus_frames_equals_the_reference(micro):
    ref_emb, port_emb = micro
    n = 5
    body = _body({"messages": [{"role": "user", "content": "q"}],
                  "model": _panel(n), "stream": True, "consensus": True})
    scripts = _multichat_scripts(n)
    want_status, want = _ref_post(_ref_app(scripts, ref_emb),
                                  "/multichat/completions", body)
    with _port_server(scripts, port_emb) as server:
        status, got, _ = _port_post(server, "/multichat/completions", body)
        series = server.metrics.snapshot()["series"]
    assert (status, want_status) == (200, 200)
    want_ev = [_masked(e) for e in _events(want)]
    got_ev = [_masked(e) for e in _events(got)]
    assert got_ev[-1] == "[DONE]" and len(got_ev) == len(want_ev)
    consensus = 0
    for w, g in zip(want_ev, got_ev):
        if isinstance(w, dict) and w.get("object") == "multichat.consensus":
            consensus += 1
            assert g["object"] == "multichat.consensus"
            assert g["confidence"].keys() == w["confidence"].keys()
            assert max(abs(g["confidence"][k] - w["confidence"][k])
                       for k in w["confidence"]) <= TOL
        else:
            assert g == w
    assert consensus == n - 1
    assert series["device:consensus_update"]["count"] == n - 1
    assert series["http:/multichat/completions"]["count"] == 1


def test_multichat_unary_consensus_equals_the_reference(micro):
    ref_emb, port_emb = micro
    n = 4
    body = _body({"messages": [{"role": "user", "content": "q"}],
                  "model": _panel(n), "consensus": True})
    scripts = _multichat_scripts(n)
    _, want = _ref_post(_ref_app(scripts, ref_emb), "/multichat/completions",
                        body)
    with _port_server(scripts, port_emb) as server:
        status, got, _ = _port_post(server, "/multichat/completions", body)
        stats = server.batcher.stats()
    assert status == 200
    want, got = _masked(want.decode()), _masked(got.decode())
    want_conf, got_conf = want.pop("consensus"), got.pop("consensus")
    key = lambda c: c["index"]  # noqa: E731
    want["choices"].sort(key=key)
    got["choices"].sort(key=key)
    assert got == want
    assert got_conf.keys() == want_conf.keys() and len(got_conf) == n
    assert max(abs(got_conf[k] - want_conf[k]) for k in want_conf) <= TOL
    assert stats["dispatches"]["consensus"] == 1


def test_multichat_without_the_flag_has_no_consensus(micro):
    _, port_emb = micro
    body = _body({"messages": [{"role": "user", "content": "q"}],
                  "model": _panel(3), "stream": True})
    with _port_server(_multichat_scripts(3), port_emb) as server:
        _, got, _ = _port_post(server, "/multichat/completions", body)
        assert server.batcher.stats()["stream"]["dispatches"] == 0
    assert b"multichat.consensus" not in got


def test_unknown_panel_is_the_reference_error_before_the_stream():
    body = _body({"messages": [{"role": "user", "content": "q"}],
                  "model": "A" * 22, "stream": True})
    want = _ref_post(_ref_app([]), "/multichat/completions", body)
    with _port_server([]) as server:
        status, got, _ = _port_post(server, "/multichat/completions", body)
    assert (status, got) == want and status == 404


def test_archived_message_from_an_empty_store_is_the_reference_error():
    body = _body({"model": "m", "messages": [
        {"role": "chat_completion", "id": "cc-missing", "choice_index": 0}]})
    want = _ref_post(_ref_app([]), "/chat/completions", body)
    with _port_server([]) as server:
        status, got, _ = _port_post(server, "/chat/completions", body)
    assert (status, got) == want and status == 404


def test_consensus_overlay_degrades_when_the_embedder_fails(micro):
    _, port_emb = micro
    n = 3
    body = _body({"messages": [{"role": "user", "content": "q"}],
                  "model": _panel(n), "stream": True, "consensus": True})
    with _port_server(_multichat_scripts(n), port_emb) as server:
        def boom(*args, **kwargs):
            raise RuntimeError("device OOM")

        server.batcher.embedder = type(
            "Failing", (), {"__getattr__": lambda s, k: getattr(port_emb, k),
                            "stream_vote_update_tokens": boom})()
        status, got, _ = _port_post(server, "/multichat/completions", body)
        series = server.metrics.snapshot()["series"]
    events = _events(got)
    assert status == 200 and events[-1] == "[DONE]"
    frames = [json.loads(e) for e in events[:-1]]
    assert not any(f.get("object") == "multichat.consensus" for f in frames)
    texts = "".join(c["delta"].get("content") or ""
                    for f in frames for c in f["choices"])
    assert all(a in texts for a in ANSWERS[:n])
    assert series["device:consensus_update"]["errors"] >= 1


class _SlowTransport(PortFakeTransport):
    """Slot 0 streams a frame every 50 ms; slot 1 waits 30 s before its
    first frame.  Records when each upstream stream was closed."""

    def __init__(self):
        super().__init__([])
        self.closed = []

    async def post_sse(self, url, headers, body):
        self.requests.append((url, headers, json.loads(body)))
        slot = len(self.requests) - 1
        transport = self

        class _Resp(port_chat.TransportResponse):
            status = 200

            async def byte_stream(self):
                try:
                    if slot == 1:
                        await asyncio.sleep(30)
                    for i in range(400):
                        yield (b"data: " + json.dumps(chunk_obj(f"t{i} "))
                               .encode() + b"\n\n")
                        await asyncio.sleep(0.05)
                finally:
                    transport.closed.append((slot, time.monotonic()))

        return _Resp()


def test_client_disconnect_mid_stream_cancels_the_upstream():
    transport = _SlowTransport()
    body = _body({"messages": [{"role": "user", "content": "q"}],
                  "model": _panel(2), "stream": True})
    with _port_server([], transport=transport) as server:
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=30)
        conn.request("POST", "/multichat/completions", body=body,
                     headers={"content-type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        assert resp.fp.readline()  # the first chunk's size line arrived
        t0 = time.monotonic()
        conn.sock.close()
        conn.close()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and (
                len(transport.closed) < 2 or server.admission.inflight):
            time.sleep(0.05)
        series = server.metrics.snapshot()["series"]
        inflight = server.admission.inflight
    # both upstream streams closed promptly, the slow one long before its
    # 30 s wait would have ended; the slot went back
    assert sorted(slot for slot, _ in transport.closed) == [0, 1]
    assert max(t for _, t in transport.closed) - t0 < 10
    assert series["http:client_disconnect"]["count"] == 1
    assert inflight == 0


def test_admission_holds_a_slot_for_the_whole_stream_and_drain_waits():
    transport = _SlowTransport()
    body = _body({"messages": [{"role": "user", "content": "q"}],
                  "model": {"llms": [{"model": "g"}]}, "stream": True})
    server = _port_server([], transport=transport,
                          admission=AdmissionConfig(max_inflight=1),
                          drain_timeout_ms=300.0).start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=30)
        conn.request("POST", "/multichat/completions", body=body,
                     headers={"content-type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200 and resp.fp.readline()
        status, shed, headers = _port_post(
            server, "/chat/completions",
            _body({"model": "m", "messages": [{"role": "user",
                                               "content": "q"}]}))
        assert status == 503 and headers["Retry-After"] == "1"
        assert json.loads(shed)["message"]["shed_reason"] == "inflight_limit"
        # the stream still holds its slot, so the drain runs out its budget
        assert server.drain() is False
        conn.close()
    finally:
        server.close()


def test_deadline_header_bounds_the_upstream_wait():
    scripts = [Script([chunk_obj("late", finish="stop")], delays={0: 5.0})]
    body = _body({"model": "m", "stream": True,
                  "messages": [{"role": "user", "content": "q"}]})
    with _port_server(scripts) as server:
        t0 = time.monotonic()
        status, got, _ = _port_post(server, "/chat/completions", body,
                                    headers={"x-deadline-ms": "150"})
    assert time.monotonic() - t0 < 4
    assert status == 504
    assert json.loads(got)["error"]["kind"] == "deadline_exceeded"


def test_a_server_with_only_the_chat_routes():
    scripts = [Script([chunk_obj("hi", finish="stop")])]
    with _port_server(scripts) as server:
        status, got, _ = _port_post(
            server, "/chat/completions",
            _body({"model": "m", "messages": [{"role": "user",
                                               "content": "q"}]}))
        assert status == 200
        assert json.loads(got)["choices"][0]["message"]["content"] == "hi"
        for path in ("/consensus", "/embeddings"):
            assert _port_post(server, path, b"{}")[0] == 404


def test_the_entry_points_serve_the_chat_routes_over_the_stdlib_transport():
    from llm_weighted_consensus_tpu_torch.serve import __main__ as serve_main
    from llm_weighted_consensus_tpu_torch.serve.config import ServeConfig
    from llm_weighted_consensus_tpu_torch.serve.fake_upstream import (
        FakeUpstream,
    )

    fake = FakeUpstream()
    try:
        config = ServeConfig.from_env({"OPENAI_API_BASE": fake.url,
                                       "OPENAI_API_KEY": "fake-key"})
        server = serve_main.build_server(None, None, config)
        with server:
            serve_main.warm_up(server, config)
            status, got, _ = _port_post(
                server, "/multichat/completions",
                _body({"model": _panel(2), "messages": [
                    {"role": "user", "content": "q"}]}))
    finally:
        fake.close()
    assert status == 200
    body = json.loads(got)
    assert [c["message"]["content"] for c in body["choices"]] == [
        "This is a fake upstream completion."] * 2


def test_upstream_knobs_read_as_the_reference_reads_them():
    from llm_weighted_consensus_tpu.serve.config import Config
    from llm_weighted_consensus_tpu_torch.serve.config import upstream_options

    env = {
        "OPENAI_APIS": '[{"api_base": "https://a/v1", "api_key": "ka"}, '
                       '{"api_base": "https://b/v1", "api_key": "kb"}]',
        "OPENAI_USER_AGENT": "ua", "OPENAI_X_TITLE": "t",
        "OPENAI_REFERER": "https://r", "FIRST_CHUNK_TIMEOUT_MILLIS": "1234",
        "OTHER_CHUNK_TIMEOUT_MILLIS": "5678", "BACKOFF_MULTIPLIER": "2",
        "BACKOFF_MAX_ELAPSED_TIME_MILLIS": "999",
        "CONNECT_TIMEOUT_MILLIS": "77", "JUDGE_STREAM_MAX_BYTES": "4096",
        "SSE_MAX_EVENT_BYTES": "0",
    }
    for case in (env, {"OPENAI_API_BASE": "https://x/v1",
                       "OPENAI_API_KEY": "k"}, {}):
        ref, port = Config.from_env(case), upstream_options(case)
        assert port["api_bases"] == ref.openai_apis
        policy = ref.backoff_policy()
        assert port["backoff"] == {
            "initial_interval_ms": policy.initial_interval_ms,
            "randomization_factor": policy.randomization_factor,
            "multiplier": policy.multiplier,
            "max_interval_ms": policy.max_interval_ms,
            "max_elapsed_ms": policy.max_elapsed_ms,
        }
        assert (port["user_agent"], port["x_title"], port["referer"]) == (
            ref.openai_user_agent, ref.openai_x_title, ref.openai_referer)
        assert (port["first_chunk_timeout_ms"], port["other_chunk_timeout_ms"],
                port["connect_timeout_ms"]) == (
            ref.first_chunk_timeout_millis, ref.other_chunk_timeout_millis,
            ref.connect_timeout_millis)
        assert (port["judge_stream_max_bytes"],
                port["sse_max_event_bytes"]) == (
            ref.judge_stream_max_bytes, ref.sse_max_event_bytes)
