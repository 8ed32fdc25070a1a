"""A scripted OpenAI-compatible provider on loopback, for ``--fake-upstream``.

The stdlib counterpart of the reference's ``_fake_upstream``
(``llm_weighted_consensus_tpu/serve/__main__.py``), with its content:
``POST /v1/chat/completions`` streams "This is a fake upstream
completion." in two content chunks, then a final chunk with
``finish_reason: "stop"`` and usage, then ``data: [DONE]``; a request
whose system prompt carries a ballot ("Select the response:") answers "I
select <a random key>".  ``FAKE_UPSTREAM_DELAY_MS`` (read per request)
sleeps before the first frame, so requests hold their admission slot for
a judge-like interval.

``ScriptedTransport`` is the in-memory twin: a ``clients.chat.Transport``
that answers each request with the next scripted SSE body (``Script``,
``chunk_obj``), the reference's ``tests/fakes.py`` transport.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..clients.chat import Transport, TransportResponse


def fake_completion_frames(body: dict) -> bytes:
    """The SSE body the fake provider answers ``body`` with."""
    content = "This is a fake upstream completion."
    for message in reversed(body.get("messages", [])):
        if message.get("role") == "system" and "Select the response:" in str(
            message.get("content", "")
        ):
            text = message["content"]
            ballot = json.loads(
                text.split("Select the response:\n\n", 1)[1].split(
                    "\n\nOutput", 1
                )[0]
            )
            content = f"I select {random.choice(list(ballot))}"
            break
    model = body.get("model", "fake")
    half = len(content) // 2
    out = []
    for i, frag in enumerate((content[:half], content[half:])):
        chunk = {
            "id": "fake-1",
            "object": "chat.completion.chunk",
            "created": 0,
            "model": model,
            "choices": [
                {
                    "index": 0,
                    "delta": (
                        {"role": "assistant", "content": frag}
                        if i == 0
                        else {"content": frag}
                    ),
                    "finish_reason": None,
                }
            ],
        }
        out.append(f"data: {json.dumps(chunk)}\n\n")
    final = {
        "id": "fake-1",
        "object": "chat.completion.chunk",
        "created": 0,
        "model": model,
        "choices": [{"index": 0, "delta": {}, "finish_reason": "stop"}],
        "usage": {"prompt_tokens": 10, "completion_tokens": 10,
                  "total_tokens": 20},
    }
    out.append(f"data: {json.dumps(final)}\n\ndata: [DONE]\n\n")
    return "".join(out).encode()


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        pass

    def do_POST(self):
        with self.server.lock:
            self.server.requests += 1
        length = int(self.headers.get("content-length") or 0)
        raw = self.rfile.read(length)
        if self.path != "/v1/chat/completions":
            self.send_response(404)
            self.send_header("content-length", "0")
            self.end_headers()
            return
        delay_ms = float(os.environ.get("FAKE_UPSTREAM_DELAY_MS", "0") or 0)
        if delay_ms > 0:
            time.sleep(delay_ms / 1e3)
        payload = fake_completion_frames(json.loads(raw or b"{}"))
        self.send_response(200)
        self.send_header("content-type", "text/event-stream")
        self.send_header("content-length", str(len(payload)))
        self.end_headers()
        try:
            self.wfile.write(payload)
        except (BrokenPipeError, ConnectionResetError):
            # the client cancelled the attempt (a quorum, a deadline)
            self.close_connection = True


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    # a panel's slots connect at once (see the gateway's backlog)
    request_queue_size = 128

    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self.lock = threading.Lock()
        self.requests = 0


class FakeUpstream:
    """The fake provider on ``127.0.0.1:port`` (0: an ephemeral port),
    served by a daemon thread; ``url`` is its API base."""

    def __init__(self, port: int = 0) -> None:
        self.httpd = _Server(("127.0.0.1", port), _Handler)
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, name="lwc-torch-fake-upstream",
            daemon=True,
        )
        self._thread.start()

    @property
    def requests(self) -> int:
        """POSTs answered so far."""
        return self.httpd.requests

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.httpd.server_address[1]}/v1"

    def close(self) -> None:
        self.httpd.shutdown()
        self._thread.join(10)
        self.httpd.server_close()


# -- an in-memory scripted upstream (the benches' configs 2 and 5) --------------


def chunk_obj(content=None, *, cid: str = "cc-1", model: str = "fake-model",
              index: int = 0, finish=None, usage=None, role=None,
              created: int = 1700000000) -> dict:
    """One ``chat.completion.chunk`` object with a one-choice delta."""
    delta: dict = {}
    if role is not None:
        delta["role"] = role
    if content is not None:
        delta["content"] = content
    obj = {
        "id": cid, "object": "chat.completion.chunk", "created": created,
        "model": model,
        "choices": [{"index": index, "delta": delta,
                     "finish_reason": finish}],
    }
    if usage is not None:
        obj["usage"] = usage
    return obj


def sse_frames(events: list) -> bytes:
    """Event payloads (dict -> JSON, str -> raw) as SSE ``data:`` frames."""
    return "".join(
        f"data: {json.dumps(ev) if isinstance(ev, dict) else ev}\n\n"
        for ev in events
    ).encode()


class Script:
    """One scripted upstream response: its SSE events, then ``[DONE]``."""

    def __init__(self, events=None, *, status: int = 200,
                 body: bytes = b"") -> None:
        self.events = list(events or [])
        self.status = status
        self.body = body


class ScriptedTransport(Transport):
    """A ``clients.chat.Transport`` that answers each request with the
    next ``Script``, in memory (no socket): the upstream of the benches
    that time the port's own fan-out and device consensus, not a
    provider."""

    def __init__(self, scripts: list) -> None:
        self.scripts = list(scripts)

    async def post_sse(self, url, headers, body):
        if not self.scripts:
            raise RuntimeError(f"no script left for a request to {url}")
        script = self.scripts.pop(0)

        class _Response(TransportResponse):
            status = script.status

            async def read_body(self) -> bytes:
                return script.body

            async def byte_stream(self):
                for event in script.events:
                    yield sse_frames([event])
                yield b"data: [DONE]\n\n"

        return _Response()
