"""The port's chat client against the JAX package's.

Each case of ``tests/test_chat_client.py`` runs the reference's
``DefaultChatClient`` over the reference's scripted ``FakeTransport`` and
the port's client over a port ``Transport`` that serves the same scripts
(``tests/fakes.py``): the attempt matrix, the first-chunk peek, backoff,
the two-tier timeouts, the OpenRouter error shape, bad-status body
capture, the archive's rehydration and errors.  Every chunk the port
yields must dump to the reference's bytes, every error be of the same
kind with the same status and message, and the upstream requests the
same (url, headers, body).  Then the port's ``StdlibTransport`` (which
takes the place of the reference's aiohttp transport) is driven against a
stdlib SSE server on loopback: chunked and content-length bodies, a bad
status, a silent server.
"""

import asyncio
import json
import random
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from llm_weighted_consensus_tpu import archive as ref_archive
from llm_weighted_consensus_tpu.clients import chat as ref_chat
from llm_weighted_consensus_tpu.types import chat_request as ref_req
from llm_weighted_consensus_tpu.types import chat_response as ref_cr
from llm_weighted_consensus_tpu_torch import archive as port_archive
from llm_weighted_consensus_tpu_torch import errors as port_errors
from llm_weighted_consensus_tpu_torch.clients import chat as port_chat
from llm_weighted_consensus_tpu_torch.clients.sse import SSEParser
from llm_weighted_consensus_tpu_torch.types import chat_request as port_req
from llm_weighted_consensus_tpu_torch.types import chat_response as port_cr

from fakes import FakeTransport, Script, chunk_obj, sse_frames


class PortFakeTransport(port_chat.Transport):
    """``fakes.FakeTransport`` as a port ``Transport``: pops one
    ``Script`` per request and records (url, headers, body)."""

    def __init__(self, scripts: list):
        self.scripts = list(scripts)
        self.requests: list = []

    async def post_sse(self, url, headers, body):
        self.requests.append((url, headers, json.loads(body)))
        if not self.scripts:
            raise AssertionError(f"unexpected request to {url}")
        script = self.scripts.pop(0)
        if script.connect_error is not None:
            raise script.connect_error

        class _Resp(port_chat.TransportResponse):
            status = script.status

            async def read_body(self):
                return script.body or b""

            async def byte_stream(self):
                for i, ev in enumerate(script.events):
                    delay = script.delays.get(i)
                    if delay:
                        await asyncio.sleep(delay)
                    yield sse_frames([ev])
                if script.done:
                    yield b"data: [DONE]\n\n"

        return _Resp()


AB = [("https://a.example", "key-a"), ("https://b.example", "key-b")]
FAST = dict(initial_interval_ms=1, max_interval_ms=2, max_elapsed_ms=10)
NO_RETRY = dict(max_elapsed_ms=0)


def go(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


def _copy_script(s: Script) -> Script:
    return Script(list(s.events), status=s.status, body=s.body,
                  connect_error=s.connect_error, delays=dict(s.delays),
                  done=s.done)


def _port_error(err):
    """A reference connect error re-raised as the port's type."""
    if isinstance(err, ref_chat.TransportError):
        return port_errors.TransportError(err.error, err.code)
    return err


class Pair:
    """The same scripts through both clients."""

    def __init__(self, scripts, api_bases=AB[:1], backoff=FAST, **kw):
        port_scripts = []
        for s in scripts:
            c = _copy_script(s)
            c.connect_error = _port_error(s.connect_error)
            port_scripts.append(c)
        self.ref_t = FakeTransport([_copy_script(s) for s in scripts])
        self.port_t = PortFakeTransport(port_scripts)
        ref_kw, port_kw = dict(kw), dict(kw)
        for name in ("archive_fetcher", "ctx_handler"):
            if name in kw:
                ref_kw[name], port_kw[name] = kw[name]
        self.ref = ref_chat.DefaultChatClient(
            self.ref_t, [ref_chat.ApiBase(*a) for a in api_bases],
            backoff=ref_chat.BackoffPolicy(**backoff), **ref_kw)
        self.port = port_chat.DefaultChatClient(
            self.port_t, [port_chat.ApiBase(*a) for a in api_bases],
            backoff=port_chat.BackoffPolicy(**backoff), **port_kw)

    def stream(self, body=None):
        """(ref items, port items), or the errors each raised."""
        body = body or {"model": "fake-model",
                        "messages": [{"role": "user", "content": "hi"}]}
        out = []
        for client, req in ((self.ref, ref_req), (self.port, port_req)):
            params = req.ChatCompletionCreateParams.from_json_obj(body)

            async def run():
                stream = await client.create_streaming(None, params)
                return [item async for item in stream]

            try:
                out.append(go(run()))
            except Exception as exc:  # compared below
                out.append(exc)
        return out

    def unary(self, body=None):
        body = body or {"model": "fake-model",
                        "messages": [{"role": "user", "content": "hi"}]}
        return [
            go(client.create_unary(
                None, req.ChatCompletionCreateParams.from_json_obj(body)))
            for client, req in ((self.ref, ref_req), (self.port, port_req))
        ]

    def requests_equal(self):
        assert self.port_t.requests == self.ref_t.requests
        return self.port_t.requests


def same_error(ref, port):
    assert type(port).__name__ == type(ref).__name__, (ref, port)
    assert port.status() == ref.status()
    assert port.message() == ref.message()


def same_items(ref, port):
    assert not isinstance(ref, Exception) and not isinstance(port, Exception)
    assert len(port) == len(ref)
    for r, p in zip(ref, port):
        if isinstance(r, Exception):
            same_error(r, p)
        else:
            assert p.to_json() == r.to_json()


# -- SSE parser ---------------------------------------------------------------


def test_sse_parser_frames():
    p = SSEParser()
    events = list(p.feed(b'data: {"a":1}\n\ndata: x\ndata: y\n\n: comment\n\n'))
    assert events == ['{"a":1}', "x\ny"]


def test_sse_parser_crlf_and_split_feeds():
    p = SSEParser()
    out = []
    for b in (b"data: he", b"llo\r", b"\n\r\n", b"data: [DONE]\n\n"):
        out.extend(p.feed(b))
    assert out == ["hello", "[DONE]"]


def test_sse_parser_flush():
    p = SSEParser()
    assert list(p.feed(b"data: tail\n")) == []
    assert p.flush() == "tail"
    assert p.flush() is None


# -- streaming + unary --------------------------------------------------------


def test_unary_is_fold_of_stream():
    pair = Pair([Script([
        chunk_obj("Hel", role="assistant"), chunk_obj("lo"),
        chunk_obj(finish="stop", usage={"prompt_tokens": 3,
                                        "completion_tokens": 2,
                                        "total_tokens": 5}),
    ])])
    ref, port = pair.unary()
    assert port.to_json() == ref.to_json()
    assert port.choices[0].message.content == "Hello"
    _, _, body = pair.requests_equal()[0]
    assert body["stream"] is True
    assert body["stream_options"] == {"include_usage": True}


def test_streaming_yields_chunks_and_auth_headers():
    pair = Pair([Script([chunk_obj("x")])])
    ref, port = pair.stream()
    same_items(ref, port)
    url, headers, _ = pair.requests_equal()[0]
    assert url == "https://a.example/chat/completions"
    assert headers["authorization"] == "Bearer key-a"


def test_attempt_matrix_falls_through_api_bases():
    pair = Pair([Script(status=500, body=b'{"oops":1}'),
                 Script([chunk_obj("ok")])], api_bases=AB)
    same_items(*pair.stream())
    assert [u for u, _, _ in pair.requests_equal()] == [
        "https://a.example/chat/completions",
        "https://b.example/chat/completions",
    ]


def test_attempt_matrix_fallback_models():
    pair = Pair([Script(status=500), Script(status=500),
                 Script([chunk_obj("fb")])], api_bases=AB)
    ref, port = pair.stream({"model": "fake-model", "models": ["backup-model"],
                             "messages": [{"role": "user", "content": "hi"}]})
    same_items(ref, port)
    bodies = [b for _, _, b in pair.requests_equal()]
    assert [b["model"] for b in bodies] == [
        "fake-model", "fake-model", "backup-model"]
    assert all("models" not in b for b in bodies)


def test_first_chunk_peek_moves_to_next_attempt():
    pair = Pair([Script(["not json"]), Script([chunk_obj("good")])],
                api_bases=AB)
    same_items(*pair.stream())
    assert len(pair.requests_equal()) == 2


def test_backoff_retries_then_raises_last_error():
    scripts = [Script(status=503, body=b"busy") for _ in range(40)]
    pair = Pair(scripts, backoff=dict(initial_interval_ms=1,
                                      max_interval_ms=1, max_elapsed_ms=3))
    ref, port = pair.stream()
    same_error(ref, port)
    assert port.status() == 503
    assert len(pair.port_t.requests) >= 2


def test_no_retry_budget_zero():
    pair = Pair([Script(connect_error=ref_chat.TransportError("refused"))],
                backoff=NO_RETRY)
    ref, port = pair.stream()
    same_error(ref, port)
    assert len(pair.requests_equal()) == 1


def test_backoff_schedules_equal_with_a_seeded_rng():
    for kw in (dict(initial_interval_ms=100, randomization_factor=0.5,
                    multiplier=2.0, max_interval_ms=400, max_elapsed_ms=None),
               dict(initial_interval_ms=10, randomization_factor=0.0,
                    multiplier=10.0, max_interval_ms=50, max_elapsed_ms=None)):
        ref = ref_chat.BackoffPolicy(**kw).sleeps(rng=random.Random(7))
        port = port_chat.BackoffPolicy(**kw).sleeps(rng=random.Random(7))
        assert [next(port) for _ in range(8)] == [next(ref) for _ in range(8)]
    assert list(port_chat.BackoffPolicy(max_elapsed_ms=0).sleeps()) == []


def test_backoff_max_elapsed_terminates():
    gen = port_chat.BackoffPolicy(
        initial_interval_ms=1, randomization_factor=0.0, multiplier=1.0,
        max_interval_ms=1, max_elapsed_ms=30,
    ).sleeps()
    assert next(gen) == 0.001
    time.sleep(0.05)
    with pytest.raises(StopIteration):
        next(gen)


# -- stream error taxonomy ----------------------------------------------------


def test_provider_error_mid_stream_yields_and_continues():
    pair = Pair([Script([
        chunk_obj("a"),
        {"error": {"code": 429, "message": "rate limited",
                   "metadata": {"p": "x"}}},
        chunk_obj("b"),
    ])])
    ref, port = pair.stream()
    same_items(ref, port)
    assert isinstance(port[1], port_errors.ProviderError)
    assert port[1].status() == 429


def test_bad_status_body_captured():
    pair = Pair([Script(status=418, body=b'{"detail":"teapot"}')],
                backoff=NO_RETRY)
    ref, port = pair.stream()
    same_error(ref, port)
    assert port.error == {"detail": "teapot"}


def test_bad_status_body_past_the_stream_cap_is_an_ingest_trip():
    pair = Pair([Script(status=500, body=b"x" * 64)], backoff=NO_RETRY,
                judge_stream_max_bytes=32)
    ref, port = pair.stream()
    same_error(ref, port)
    assert isinstance(port, port_errors.IngestCapError)


def test_first_chunk_timeout():
    pair = Pair([Script([chunk_obj("late")], delays={0: 0.2})],
                backoff=NO_RETRY, first_chunk_timeout_ms=20)
    ref, port = pair.stream()
    assert isinstance(port, port_errors.StreamTimeoutError)
    assert type(ref).__name__ == "StreamTimeoutError"
    assert port.tier == ref.tier == "first_chunk"


def test_other_chunk_timeout_yields_mid_stream():
    pair = Pair([Script([chunk_obj("a"), chunk_obj("slow")],
                        delays={1: 0.2})],
                backoff=NO_RETRY, first_chunk_timeout_ms=5000,
                other_chunk_timeout_ms=20)
    ref, port = pair.stream()
    assert port[0].to_json() == ref[0].to_json()
    assert isinstance(port[-1], port_errors.StreamTimeoutError)
    assert port[-1].tier == ref[-1].tier == "other_chunk"


def test_done_comments_and_empty_frames():
    pair = Pair([Script([chunk_obj("x"), ": keepalive", ""])])
    ref, port = pair.stream()
    same_items(ref, port)
    assert len(port) == 1


# -- ctx handler + archive ----------------------------------------------------


def test_ctx_handler_rewrites_api_bases():
    def rewriter(mod):
        class Rewriter(mod.CtxHandler):
            async def handle(self, ctx, api_bases):
                return [mod.ApiBase("https://ctx.example", f"key-{ctx}")]

        return Rewriter()

    pair = Pair([Script([chunk_obj("ok")])],
                ctx_handler=(rewriter(ref_chat), rewriter(port_chat)))
    same_items(*pair.stream())
    url, headers, _ = pair.requests_equal()[0]
    assert url == "https://ctx.example/chat/completions"
    assert headers["authorization"] == "Bearer key-None"


ARCHIVED = {
    "id": "cc-old", "object": "chat.completion", "created": 1, "model": "m",
    "choices": [{"index": 0, "finish_reason": "stop", "message": {
        "role": "assistant", "content": "archived answer", "refusal": None}}],
}


def _stores(completion):
    ref, port = ref_archive.InMemoryArchive(), port_archive.InMemoryArchive()
    ref.put_chat(ref_cr.ChatCompletion.from_json_obj(completion))
    port.put_chat(port_cr.ChatCompletion.from_json_obj(completion))
    return ref, port


def test_archive_rehydration_in_request():
    pair = Pair([Script([chunk_obj("ok")])], archive_fetcher=_stores(ARCHIVED))
    same_items(*pair.stream({"model": "fake-model", "messages": [
        {"role": "user", "content": "hi"},
        {"role": "chat_completion", "id": "cc-old", "choice_index": 0}]}))
    _, _, body = pair.requests_equal()[0]
    assert body["messages"][1] == {"role": "assistant",
                                   "content": "archived answer"}


def test_archive_invalid_choice_index():
    pair = Pair([], archive_fetcher=_stores(dict(ARCHIVED, choices=[])))
    ref, port = pair.stream({"model": "fake-model", "messages": [
        {"role": "chat_completion", "id": "cc-old", "choice_index": 3}]})
    same_error(ref, port)
    assert isinstance(port, port_errors.InvalidCompletionChoiceIndex)


@pytest.mark.parametrize("store", ["unimplemented", "empty"])
def test_archive_fetch_error_wrapped(store):
    kw = {}
    if store == "empty":
        kw["archive_fetcher"] = (ref_archive.InMemoryArchive(),
                                 port_archive.InMemoryArchive())
    pair = Pair([], **kw)
    ref, port = pair.stream({"model": "fake-model", "messages": [
        {"role": "chat_completion", "id": "nope"}]})
    same_error(ref, port)
    assert isinstance(port, port_errors.ArchiveFetchError)
    assert port.status() == (501 if store == "unimplemented" else 404)


# -- the stdlib transport on loopback -----------------------------------------


class _Upstream:
    """A stdlib SSE server on loopback: ``mode`` picks chunked, sized,
    a bad status or silence (never answers)."""

    def __init__(self):
        self.mode = "chunked"
        self.seen = []
        self.release = threading.Event()
        upstream = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def do_POST(self):
                body = self.rfile.read(int(self.headers["content-length"]))
                upstream.seen.append((self.path, dict(self.headers),
                                      json.loads(body)))
                if upstream.mode == "silent":
                    upstream.release.wait(10)
                    return
                if upstream.mode == "bad":
                    payload = b'{"error":{"message":"no such model"}}'
                    self.send_response(404)
                    self.send_header("content-length", str(len(payload)))
                    self.end_headers()
                    self.wfile.write(payload)
                    return
                frames = [
                    sse_frames([chunk_obj("Hel", role="assistant")]),
                    sse_frames([chunk_obj("lo")]),
                    sse_frames([chunk_obj(finish="stop")]) + b"data: [DONE]\n\n",
                ]
                self.send_response(200)
                self.send_header("content-type", "text/event-stream")
                if upstream.mode == "chunked":
                    self.send_header("transfer-encoding", "chunked")
                    self.end_headers()
                    for f in frames:
                        self.wfile.write(b"%x\r\n%s\r\n" % (len(f), f))
                        self.wfile.flush()
                        time.sleep(0.01)
                    self.wfile.write(b"0\r\n\r\n")
                else:
                    payload = b"".join(frames)
                    self.send_header("content-length", str(len(payload)))
                    self.end_headers()
                    self.wfile.write(payload)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.httpd.daemon_threads = True
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}/v1"

    def close(self):
        self.release.set()
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(5)


@pytest.fixture()
def upstream():
    up = _Upstream()
    yield up
    up.close()


def _stdlib_client(base, **kw):
    return port_chat.DefaultChatClient(
        port_chat.StdlibTransport(kw.pop("connect_timeout_ms", 30000.0)),
        [port_chat.ApiBase(base, "key-x")],
        backoff=port_chat.BackoffPolicy(max_elapsed_ms=0),
        user_agent="lwc-test", **kw,
    )


@pytest.mark.parametrize("mode", ["chunked", "sized"])
def test_stdlib_transport_streams_and_folds(upstream, mode):
    upstream.mode = mode
    client = _stdlib_client(upstream.base)
    params = port_req.ChatCompletionCreateParams.from_json_obj(
        {"model": "m", "messages": [{"role": "user", "content": "hi"}]})
    result = go(client.create_unary(None, params))
    assert result.choices[0].message.content == "Hello"
    assert result.choices[0].finish_reason == "stop"
    path, headers, body = upstream.seen[0]
    assert path == "/v1/chat/completions"
    assert headers["authorization"] == "Bearer key-x"
    assert headers["user-agent"] == "lwc-test"
    assert body["stream"] is True and body["model"] == "m"


def test_stdlib_transport_bad_status(upstream):
    upstream.mode = "bad"
    client = _stdlib_client(upstream.base)
    params = port_req.ChatCompletionCreateParams.from_json_obj(
        {"model": "m", "messages": [{"role": "user", "content": "hi"}]})
    with pytest.raises(port_errors.BadStatusError) as err:
        go(client.create_unary(None, params))
    assert err.value.status() == 404
    assert err.value.error == {"error": {"message": "no such model"}}


def test_stdlib_transport_times_out_a_silent_upstream(upstream):
    upstream.mode = "silent"
    client = _stdlib_client(upstream.base, connect_timeout_ms=200.0)
    params = port_req.ChatCompletionCreateParams.from_json_obj(
        {"model": "m", "messages": [{"role": "user", "content": "hi"}]})
    t0 = time.monotonic()
    with pytest.raises(port_errors.TransportError):
        go(client.create_unary(None, params))
    assert time.monotonic() - t0 < 5


def test_stdlib_transport_refused_connection_is_a_transport_error():
    with ThreadingHTTPServer(("127.0.0.1", 0), BaseHTTPRequestHandler) as s:
        port = s.server_address[1]  # bound, then closed: nothing listens
    client = _stdlib_client(f"http://127.0.0.1:{port}/v1")
    params = port_req.ChatCompletionCreateParams.from_json_obj(
        {"model": "m", "messages": [{"role": "user", "content": "hi"}]})
    with pytest.raises(port_errors.TransportError):
        go(client.create_unary(None, params))
