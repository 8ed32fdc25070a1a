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
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


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
        self.wfile.write(payload)


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    # a panel's slots connect at once (see the gateway's backlog)
    request_queue_size = 128


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
    def url(self) -> str:
        return f"http://127.0.0.1:{self.httpd.server_address[1]}/v1"

    def close(self) -> None:
        self.httpd.shutdown()
        self._thread.join(10)
        self.httpd.server_close()
