"""The port's HTTP surface, on the standard library's threading server.

Counterpart of the ``/consensus``, ``/embeddings`` and ``/healthz`` routes
of ``llm_weighted_consensus_tpu/serve/gateway.py``, with the same request
bodies, responses and input validation:

* ``POST /consensus`` — ``{"input": [>= 2 strings, at most 256],
  "scorer"?: "cosine" | "rm", "prompt"?: str, "temperature"?: finite
  positive number (default 0.05 for cosine, 1.0 for rm)}`` ->
  ``{"model", "scorer", "confidence": [...], "usage": {"prompt_tokens",
  "total_tokens"}}``.  ``cosine`` is the embedder's self-consistency
  vote; ``rm`` is the reward model's ``softmax(reward / T)``, each
  candidate scored after the prompt.  A scorer whose model is not
  configured gets 400 naming ``EMBEDDER_MODEL`` or ``RM_MODEL``;
* ``POST /embeddings`` — ``{"model": str, "input": str | [str]}`` -> the
  OpenAI embeddings response; another model name gets 400; without an
  embedder the route does not exist (404);
* ``GET /healthz`` -> ``{"ok": true}``.

Errors use the ``{"code", "message"}`` envelope.  Each request runs on
its own handler thread.  Cosine and embeddings requests wait on the
batcher, so concurrent requests coalesce into shared device dispatches;
an rm request runs its own forward on its handler thread (its softmax
spans only its own candidates).
"""

from __future__ import annotations

import json
import logging
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

log = logging.getLogger("lwc.torch.gateway")

# the reference's request-size ceiling on /consensus
MAX_CONSENSUS_CANDIDATES = 256
MAX_BODY_BYTES = 16 * 1024 * 1024


class BadRequest(ValueError):
    pass


def parse_consensus(body, has_cosine: bool, has_rm: bool):
    """Validated (texts, scorer, prompt, temperature) of a /consensus
    body, given which scorers this server has."""
    if not isinstance(body, dict):
        raise BadRequest("body must be a JSON object")
    texts = body.get("input")
    if (
        not isinstance(texts, list)
        or len(texts) < 2
        or not all(isinstance(t, str) for t in texts)
    ):
        raise BadRequest("`input` must be a list of >= 2 candidate strings")
    if len(texts) > MAX_CONSENSUS_CANDIDATES:
        raise BadRequest(
            f"`input` accepts at most {MAX_CONSENSUS_CANDIDATES} "
            "candidates per request"
        )
    scorer = body.get("scorer", "cosine")
    if scorer not in ("cosine", "rm"):
        raise BadRequest("`scorer` must be 'cosine' or 'rm'")
    if scorer == "cosine" and not has_cosine:
        raise BadRequest(
            "cosine scorer unavailable: no EMBEDDER_MODEL configured"
        )
    if scorer == "rm" and not has_rm:
        raise BadRequest("rm scorer unavailable: no RM_MODEL configured")
    prompt = body.get("prompt")
    if prompt is not None and not isinstance(prompt, str):
        raise BadRequest("`prompt` must be a string")
    traw = body.get("temperature", 0.05 if scorer == "cosine" else 1.0)
    if isinstance(traw, bool) or not isinstance(traw, (int, float)):
        raise BadRequest("`temperature` must be a number")
    temperature = float(traw)
    if not math.isfinite(temperature) or temperature <= 0:
        raise BadRequest("`temperature` must be a finite positive number")
    return texts, scorer, prompt, temperature


def parse_embeddings(body, model_name: str) -> list:
    """Validated input texts of an /embeddings body."""
    if not isinstance(body, dict):
        raise BadRequest("body must be a JSON object")
    model = body.get("model")
    if not isinstance(model, str):
        raise BadRequest("`model` must be a string")
    if model and model != model_name:
        raise BadRequest(
            f"unknown embeddings model {model!r}; this gateway serves "
            f"{model_name!r}"
        )
    texts = body.get("input")
    if isinstance(texts, str):
        return [texts]
    if not isinstance(texts, list) or not all(
        isinstance(t, str) for t in texts
    ):
        raise BadRequest("`input` must be a string or a list of strings")
    return list(texts)


def make_handler(embedder, batcher, reranker):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet by default
            log.debug("%s - " + fmt, self.address_string(), *args)

        def _send(self, status: int, obj) -> None:
            data = json.dumps(obj).encode()
            self.send_response(status)
            self.send_header("content-type", "application/json")
            self.send_header("content-length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _error(self, status: int, message: str) -> None:
            self._send(status, {"code": status, "message": message})

        def _body(self):
            try:
                length = int(self.headers.get("content-length") or 0)
            except ValueError:
                length = -1
            if length < 0:
                self.close_connection = True
                raise BadRequest("malformed content-length")
            if length > MAX_BODY_BYTES:
                raise OverflowError
            raw = self.rfile.read(length) if length else b""
            try:
                return json.loads(raw or b"null")
            except ValueError as exc:  # bad JSON or bad UTF-8
                raise BadRequest(f"malformed JSON body: {exc}") from exc

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"ok": True})
            else:
                self._error(404, f"no route GET {self.path}")

        def do_POST(self):
            try:
                body = self._body()
                if self.path == "/consensus":
                    texts, scorer, prompt, temperature = parse_consensus(
                        body, embedder is not None, reranker is not None
                    )
                elif self.path == "/embeddings" and embedder is not None:
                    texts = parse_embeddings(body, embedder.model_name)
                else:
                    self._error(404, f"no route POST {self.path}")
                    return
            except OverflowError:
                self.close_connection = True
                self._error(413, "payload too large")
                return
            except BadRequest as exc:
                self._error(400, str(exc))
                return
            try:
                if self.path == "/consensus":
                    if scorer == "rm":
                        conf, tokens = reranker.rerank_confidence(
                            texts, prompt=prompt, temperature=temperature
                        )
                        model_name = reranker.model_name
                    else:
                        conf, tokens = batcher.consensus(texts, temperature)
                        model_name = embedder.model_name
                    obj = {
                        "model": model_name,
                        "scorer": scorer,
                        "confidence": [float(c) for c in conf],
                        "usage": {
                            "prompt_tokens": tokens,
                            "total_tokens": tokens,
                        },
                    }
                else:
                    emb, tokens = batcher.embed(texts)
                    obj = embedder.wire_response(emb, tokens).to_json_obj()
            except Exception:  # the server keeps serving; detail to the log
                log.exception("request failed: POST %s", self.path)
                self._error(500, "internal server error")
                return
            self._send(200, obj)

    return Handler


class _HTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    # the listen backlog: socketserver's default of 5 drops the SYNs of a
    # burst of concurrent clients, which the client's kernel retries
    # after a 1 s timeout; 128 is aiohttp's default (the reference's)
    request_queue_size = 128


class Server:
    """The HTTP server, its batcher and its serving thread, for an
    embedder (``/consensus`` cosine, ``/embeddings``), a reranker
    (``/consensus`` rm) or both.  ``port=0`` binds an ephemeral port
    (``.port`` says which).  ``packing`` options (``packing``,
    ``packing_row_tokens``, ``packing_max_rows``,
    ``packing_max_segments``, ``prefix_dedup``,
    ``prefix_dedup_min_chars``) go to the ``ConsensusBatcher`` as they
    are."""

    def __init__(
        self,
        embedder=None,
        host: str = "127.0.0.1",
        port: int = 0,
        max_batch: int = 16,
        max_wait_ms: float = 2.0,
        reranker=None,
        **packing,
    ) -> None:
        from .batcher import ConsensusBatcher

        if embedder is None and reranker is None:
            raise ValueError("a server needs an embedder, a reranker or both")
        self.embedder = embedder
        self.reranker = reranker
        self.batcher = (
            ConsensusBatcher(
                embedder, max_batch=max_batch, max_wait_ms=max_wait_ms,
                **packing,
            )
            if embedder is not None else None
        )
        self.httpd = _HTTPServer(
            (host, port), make_handler(embedder, self.batcher, reranker)
        )
        self._thread: threading.Thread = None

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def start(self) -> "Server":
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, name="lwc-torch-http",
            daemon=True,
        )
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self.httpd.serve_forever()

    def close(self) -> None:
        if self._thread is not None:
            self.httpd.shutdown()
            self._thread.join(10)
        self.httpd.server_close()
        if self.batcher is not None:
            self.batcher.close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()
