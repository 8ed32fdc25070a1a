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
* ``POST /chat/completions`` and ``POST /multichat/completions`` — the
  reference's chat and multichat routes (``serve/chat_routes.py``), when
  the server has a chat client: streamed as SSE ``data:`` frames (with
  live ``multichat.consensus`` frames for ``"consensus": true`` when an
  embedder is configured) or unary;
* ``POST /score/completions`` — the weighted-consensus judge panel
  (``clients/score.py``), when the server has a score client, streamed or
  unary as the chat routes are;
* ``POST /archive/rescore`` and ``POST /weights/learn`` — the archive's
  re-tally and training-table learning (``serve/archive_routes.py``), as
  ``build_server`` registers them on the chat routes' loop;
* ``GET /healthz`` -> ``{"ok": true}``;
* ``GET /livez`` -> ``{"ok": true}`` while the process answers;
* ``GET /readyz`` -> 200 ``{"ready": true}`` once warmup has finished
  and while the device is healthy (with ``"degraded_mem": true`` and
  ``mem_level`` under memory pressure), else 503 ``{"ready": false,
  "reason": ...}`` (``serve/lifecycle.py``);
* ``GET /metrics`` -> the JSON snapshot (``serve/metrics.py``), or
  OpenMetrics text with ``?format=prometheus``;
* ``GET /v1/judges`` -> ``{"window", "drift_threshold", "judges": [...]}``
  and ``GET /v1/judges/{judge_id}`` -> one judge's scorecard
  (``obs/quality.py``, always served; 404 ``unknown judge id``);
* ``GET /v1/weights`` -> the live weight store's active table, shadow
  table and shadow counters, and ``PUT /v1/weights`` -> installs or
  clears a table (``weights_put``; admission-exempt), when the server
  has a store (``WEIGHTS_*``), else 403 both;
* ``POST /v1/train/rescore`` -> a drive of the batcher's offline lane
  (``OfflineRescore``), when ``OFFLINE_ENABLED``, else 403;
* ``POST /v1/profile`` -> a one-shot ``torch.profiler`` capture of
  ``{"duration_ms"}`` under ``PROFILE_DIR``, with ``POST /profile/start``
  and ``POST /profile/stop`` (``serve/profiling.py``); without
  ``PROFILE_DIR`` ``/v1/profile`` answers the reference's 403 and the
  other two do not exist (404).  ``/v1/profile`` is admission-exempt
  (``resilience.admission.EXEMPT_PATHS``);
* ``/fleet/v1/*`` (``GET``/``PUT /fleet/v1/entry/{fp}``,
  ``POST``/``DELETE /fleet/v1/lease/{fp}``, ``POST /fleet/v1/handoff``,
  ``GET /fleet/v1/ping``) — the replica-to-replica fleet surface
  (``fleet/handlers.py``), when the server has a fleet coordinator
  (``FLEET_*``): admission-exempt, as the reference exempts it, each
  answered on the chat routes' loop and observed as its route template
  (``http:/fleet/v1/entry/{fp}``);
* ``GET /v1/traces`` -> ``{"traces": [...]}`` (newest first, ``?limit=``,
  default 50) and ``GET /v1/traces/{trace_id}`` -> the span tree, when
  the server has a trace sink (``TRACE_*``; 404 ``unknown trace_id``).
  These families and the two above answer through ``json.dumps``, as
  the reference's aiohttp ``json_response`` does.

Tracing (``obs/``, when the server has a trace sink): each request but
the probes, ``/metrics``, ``/v1/traces`` and ``/v1/judges`` is traced on
its handler thread, as the reference's trace middleware does: a
caller's ``traceparent`` is adopted, the head-sampling coin is flipped,
the root span ``gateway:{METHOD} {path}`` is active while the route
runs, the response carries ``x-trace-id`` (a stream too), a status of
500 or more forces the trace's retention, and the finished root carries
``http_status`` and its ``phase_breakdown`` before the sink is offered
the trace.  Error envelopes then carry ``trace_id``.  The admission gate
is timed: ``admission_wait`` is observed once per admitted request, and
a traced request's root carries ``admission_wait_ms`` and
``admission_inflight``, or ``shed_reason`` when it is shed.  A device
route is timed on: ``gateway_read`` from the slot held to its item
submitted, ``gateway_write`` from its answer's return to the last byte
written, and a ``/consensus`` answered 200 observes ``held_idle``, the
device's idle time between its door and its last byte
(``obs/phases.py``).

Errors use the ``{"code", "message"}`` envelope; a request body of
``max_body_bytes`` (``MAX_BODY_BYTES``) or more is refused on every route
with the reference's ``413 {"code": 413, "message": {"kind":
"payload_too_large"}}``, before it is read.  Each request runs on
its own handler thread.  Before a POST route runs, the admission gate
(``resilience/admission.py``) admits it or sheds it with 503 and
``Retry-After`` (the probes above are exempt), and holds its slot until
the response (a stream included) is done; the device routes
(``/consensus``, ``/embeddings``) also shed while the server is still
warming its CUDA graphs or the watchdog holds the device unhealthy, as
the reference's ``DEVICE_PATHS`` do (with a CPU twin, ``fallback``,
the watchdog's trip sheds nothing: the twin absorbs the work); under hard
memory pressure
(``resilience/memguard.py``) every POST route sheds with ``shed_reason:
"memory"``.  An ``x-deadline-ms`` header sets the request's deadline
(``resilience/deadline.py``), else ``RESILIENCE_DEADLINE_MILLIS`` when
set: the batcher sheds its work with 504 once the deadline cannot cover
the dispatch, and the chat clients clamp their waits, retries and hedges
to it.  Cosine and embeddings requests
wait on the batcher, so concurrent requests coalesce into shared device
dispatches; an rm request runs its own forward on its handler thread
(its softmax spans only its own candidates).
"""

from __future__ import annotations

import json
import logging
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, unquote, urlsplit

from .. import obs
from ..errors import (
    OverloadedError,
    StatusError,
    to_response_error,
    with_trace_id,
)
from ..obs.phases import observe_held_idle, observe_phase
from ..resilience.admission import (
    EXEMPT_PATHS,
    AdmissionConfig,
    AdmissionController,
    retry_after_seconds,
    shed_response,
)
from ..fleet.handlers import match as fleet_match
from ..resilience.deadline import Deadline
from ..utils import jsonutil
from .lifecycle import READY, STARTING, Lifecycle
from .metrics import (
    PROM_CONTENT_TYPE,
    Metrics,
    register_graphs,
    register_overload,
    register_performance,
    register_quality,
    register_resilience,
    render_prometheus,
)
from .profiling import PROFILE_DISABLED, ProfileRoutes

log = logging.getLogger("lwc.torch.gateway")

# the reference's request-size ceiling on /consensus
MAX_CONSENSUS_CANDIDATES = 256
# the offline lane's drive (OFFLINE_ENABLED; 403 when off)
RESCORE_PATH = "/v1/train/rescore"
# the default request-body cap (``MAX_BODY_BYTES``; aiohttp's own default,
# which the reference keeps when the knob is 0)
MAX_BODY_BYTES = 1024 * 1024
PAYLOAD_TOO_LARGE = jsonutil.dumps(
    {"code": 413, "message": {"kind": "payload_too_large"}}
).encode()

# the probes and the trace and scorecard reads are never themselves
# traced: a poller scraping /metrics must not churn the sampling budget,
# and reading traces must not mint traces
TRACE_EXEMPT_PATHS = frozenset({"/healthz", "/livez", "/readyz", "/metrics"})


def trace_exempt(path: str) -> bool:
    return path in TRACE_EXEMPT_PATHS or path.startswith(
        ("/v1/traces", "/v1/judges")
    )


def payload_too_large() -> bytes:
    """The 413 envelope, with the trace id of a traced request."""
    if obs.current_span() is None:
        return PAYLOAD_TOO_LARGE
    obs.annotate(payload_too_large=True)
    return jsonutil.dumps(with_trace_id(
        {"code": 413, "message": {"kind": "payload_too_large"}}
    )).encode()


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


def error_response(exc: Exception):
    """(status, headers, body) of an exception from the device path, as
    the reference renders it: an ``OverloadedError`` is a 503 with
    ``Retry-After`` in the ``{code, message}`` envelope, another
    ``StatusError`` its status and its JSON message, anything else a
    masked 500 envelope (detail to the log); a traced request's envelope
    carries its ``trace_id`` (a StatusError's only when its message is a
    dict)."""
    if isinstance(exc, OverloadedError):
        body = with_trace_id({"code": 503, "message": exc.message()})
        headers = {"Retry-After": retry_after_seconds(
            exc.retry_after_ms or 1000.0)}
        return 503, headers, json.dumps(body).encode()
    if isinstance(exc, StatusError):
        message = exc.message()
        if isinstance(message, dict):
            message = with_trace_id(dict(message))
        return exc.status(), {}, json.dumps(message).encode()
    err = to_response_error(exc)
    return err.code, {}, json.dumps(with_trace_id(err.to_json_obj())).encode()


def embeddings_body(obj: dict) -> bytes:
    """``json.dumps(obj).encode()`` of an embeddings response, its rows
    encoded one call each: the C encoder holds the interpreter lock for a
    whole call, and one call over 16 rows of 1024 floats stalls every
    other handler thread for tens of milliseconds."""
    head = json.dumps({**obj, "data": []})
    cut = head.index('"data": []') + len('"data": [')
    rows = ", ".join(json.dumps(row) for row in obj["data"])
    return (head[:cut] + rows + head[cut:]).encode()


def traces_response(sink, path: str, query: str):
    """(status, body obj) of ``GET /v1/traces`` and ``/v1/traces/{id}``,
    or None for another path."""
    if path == "/v1/traces":
        try:
            limit = int(parse_qs(query).get("limit", ["50"])[0])
        except ValueError:
            limit = 50
        return 200, {"traces": sink.index(
            limit=max(1, min(limit, sink.capacity)))}
    trace_id = unquote(path[len("/v1/traces/"):])
    if not path.startswith("/v1/traces/") or not trace_id:
        return None
    record = sink.get(trace_id)
    if record is None:
        return 404, {"code": 404, "message": "unknown trace_id"}
    return 200, record


def judges_response(path: str):
    """(status, body obj) of ``GET /v1/judges`` and ``/v1/judges/{id}``
    (the process-global quality aggregator), or None for another path."""
    from ..obs import quality as _quality

    agg = _quality.quality_aggregator()
    if path == "/v1/judges":
        return 200, {"window": agg.window,
                     "drift_threshold": agg.drift_threshold,
                     "judges": agg.scorecards()}
    judge_id = unquote(path[len("/v1/judges/"):])
    if not path.startswith("/v1/judges/") or not judge_id:
        return None
    card = agg.scorecard(judge_id)
    if card is None:
        return 404, {"code": 404, "message": "unknown judge id"}
    return 200, card


WEIGHTS_DISABLED = {
    "code": 403,
    "message": "live weights disabled: set WEIGHTS_ENABLED=1 "
    "or WEIGHTS_PATH",
}
OFFLINE_DISABLED = {
    "code": 403,
    "message": "offline lane disabled: set OFFLINE_ENABLED=1 "
    "(and configure EMBED_MODEL)",
}


def weights_put(store, raw: bytes):
    """(status, body obj) of ``PUT /v1/weights``: ``{"weights": {judge
    id: number}, "version"?: str, "mode"?: "active" | "shadow"}``
    installs a table (an empty ``weights`` clears the mode's slot); a
    body that is not a JSON object with a ``weights`` object, or a table
    the store refuses, is a 400 that leaves the active table alone."""
    try:
        body = jsonutil.loads(raw.decode("utf-8"))
    except Exception:
        return 400, {"code": 400, "message": "body must be a JSON object"}
    if not isinstance(body, dict) or not isinstance(
        body.get("weights"), dict
    ):
        return 400, {"code": 400, "message": 'body needs a "weights" object'}
    mode = body.get("mode", "active")
    try:
        if not body["weights"]:
            store.clear(mode=mode)
            return 200, {"ok": True, "cleared": mode}
        version = store.put(
            body["weights"], version=body.get("version"), mode=mode
        )
    except ValueError as e:
        return 400, {"code": 400, "message": str(e)}
    return 200, {"ok": True, "version": version, "mode": mode}


class OfflineRescore:
    """``POST /v1/train/rescore``: drive deterministic synthetic candidate
    groups through the batcher's offline priority class
    (``train.feed.OfflineFeed``) and answer the lane stats.  Body, all
    optional: ``{"groups": int (1-4096, default 32), "n": int (2-256,
    default 8), "seed": int, "inflight": int (1-64, default
    OFFLINE_INFLIGHT), "temperature": float (default 0.05)}``; a body
    that is not JSON counts as ``{}``, a value that is not a number is a
    400.  The drive runs to its end on the handler thread, on an event
    loop of its own, and answers ``{"ok", "groups", "items", "errors",
    "offline_occupancy", "lanes"}``.  One drive at a time: another one
    posted meanwhile gets 409 (two saturators would count each other's
    idle)."""

    def __init__(self, batcher, default_inflight: int = 4) -> None:
        self.batcher = batcher
        self.default_inflight = default_inflight
        self._lock = threading.Lock()

    def __call__(self, raw: bytes):
        import asyncio

        from ..train.feed import OfflineFeed, synthetic_groups

        if not self._lock.acquire(blocking=False):
            return 409, {"code": 409,
                         "message": "a rescore drive is already running"}
        try:
            try:
                body = jsonutil.loads(raw.decode("utf-8")) if raw else {}
            except Exception:
                body = {}
            if not isinstance(body, dict):
                body = {}
            try:
                n_groups = max(1, min(int(body.get("groups", 32)), 4096))
                n = max(2, min(int(body.get("n", 8)),
                               MAX_CONSENSUS_CANDIDATES))
                seed = int(body.get("seed", 0))
                inflight = max(1, min(
                    int(body.get("inflight", self.default_inflight)), 64))
                temperature = float(body.get("temperature", 0.05))
            except (TypeError, ValueError):
                return 400, {"code": 400,
                             "message": "rescore params must be numeric"}
            feed = OfflineFeed(self.batcher, inflight=inflight)
            _results, occupancy = asyncio.run(feed.drive(
                synthetic_groups(n_groups, n, seed=seed),
                temperature=temperature,
            ))
        finally:
            self._lock.release()
        return 200, {
            "ok": True,
            "groups": feed.groups,
            "items": feed.items,
            "errors": feed.errors,
            "offline_occupancy": occupancy,
            "lanes": self.batcher.utilization()["lanes"],
        }


def make_handler(embedder, batcher, reranker, metrics, admission,
                 lifecycle, chat_routes=None, max_body_bytes=MAX_BODY_BYTES,
                 trace_sink=None, default_deadline_ms=0.0,
                 live_weights=None, offline_rescore=None, profiler=None,
                 fleet_routes=None):
    device_routes = set()
    if embedder is not None or reranker is not None:
        device_routes.add("/consensus")
    if embedder is not None:
        device_routes.add("/embeddings")
    # the reference's aiohttp cap: a body of the cap's size or more is
    # refused (0 keeps the default)
    body_cap = max_body_bytes if max_body_bytes > 0 else MAX_BODY_BYTES

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # a buffered writer: a unary answer's status line, headers and
        # body leave in one send when the handler returns (streams flush
        # each chunk themselves); two sends per answer cost a handler
        # thread two waits for the interpreter lock while a burst's other
        # handlers run, the phase split's unattributed time on the card
        wbufsize = 64 * 1024

        def log_message(self, fmt, *args):  # quiet by default
            log.debug("%s - " + fmt, self.address_string(), *args)

        # a POST route's series and start time, observed as its response
        # goes out (before the body, or a stream's last frame: a client
        # holding the answer sees it in /metrics)
        _series = None
        # the traced request's root span (None untraced)
        _root = None

        def _observe(self, status: int) -> None:
            if self._series is not None:
                series, t0 = self._series
                self._series = None
                metrics.observe(series, (time.perf_counter() - t0) * 1e3,
                                error=status >= 400,
                                trace_id=obs.current_trace_id())

        def _trace_header(self) -> None:
            if self._root is not None:
                self.send_header("x-trace-id", self._root.trace.trace_id)

        def _send_raw(self, status: int, body: bytes, headers=None,
                      content_type: str = "application/json") -> None:
            self._status = status
            self._observe(status)
            self.send_response(status)
            self.send_header("content-type", content_type)
            for name, value in (headers or {}).items():
                self.send_header(name, value)
            self._trace_header()
            self.send_header("content-length", str(len(body)))
            self.end_headers()
            self._offer_trace()
            self.wfile.write(body)

        def _start_chunked(self, status: int, headers: dict) -> None:
            """Start a streamed response (chunked transfer encoding)."""
            self._status = status
            self.send_response(status)
            for name, value in headers.items():
                self.send_header(name, value)
            self._trace_header()
            self.send_header("transfer-encoding", "chunked")
            self.end_headers()
            self.wfile.flush()

        def _traced(self, method: str, route) -> None:
            """Run ``route`` (the request's handling) under its root span
            when the server traces this path: the reference's trace
            middleware on the handler thread."""
            self._root = None
            self._status = None
            if trace_sink is None:
                route()
                return
            path = urlsplit(self.path).path
            if trace_exempt(path):
                route()
                return
            upstream = obs.extract(self.headers)
            if upstream is not None:
                trace_id, parent_span_id, caller_sampled = upstream
                sampled = caller_sampled or trace_sink.sample()
            else:
                trace_id = parent_span_id = None
                sampled = trace_sink.sample()
            root = obs.start_trace(
                f"gateway:{method} {path}", sampled=sampled,
                trace_id=trace_id, parent_span_id=parent_span_id,
            )
            self._root = root
            token = root.activate()
            try:
                route()
            except Exception as exc:
                root.set_error(exc)
                raise
            finally:
                obs.Span.deactivate(token)
                # a route that wrote no answer's last bytes (it raised,
                # or its stream ended unterminated) is offered here
                self._offer_trace()

        def _offer_trace(self) -> None:
            """Close the traced request's root and offer its trace to the
            sink, once, before the response's last bytes go out (a unary
            body, a stream's terminator): a client holding its answer
            finds the trace at ``/v1/traces``, as in the reference."""
            root = self._root
            if root is None:
                return
            self._root = None
            status = self._status
            if status is not None:
                root.annotate(http_status=status)
                if status >= 500:
                    # sheds answer 503 rather than raising; the gate
                    # annotated shed_reason already
                    root.status = "error"
                    root.trace.force(f"http_{status}")
            root.finish()
            try:
                root.annotate(
                    phase_breakdown=obs.phase_breakdown(root.trace))
            except Exception:
                log.exception("phase breakdown failed")
            trace_sink.offer(root.trace)

        def _write_chunk(self, data: bytes) -> None:
            self.wfile.write(b"%x\r\n%s\r\n" % (len(data), data))
            self.wfile.flush()

        def _end_chunked(self) -> None:
            self._offer_trace()
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()

        def _send(self, status: int, obj) -> None:
            self._send_raw(status, json.dumps(obj).encode())

        def _error(self, status: int, message: str) -> None:
            self._send(status, with_trace_id(
                {"code": status, "message": message}))

        def _body(self):
            try:
                length = int(self.headers.get("content-length") or 0)
            except ValueError:
                length = -1
            if length < 0:
                self.close_connection = True
                raise BadRequest("malformed content-length")
            if length >= body_cap:
                raise OverflowError
            raw = self.rfile.read(length) if length else b""
            try:
                return json.loads(raw or b"null")
            except ValueError as exc:  # bad JSON or bad UTF-8
                raise BadRequest(f"malformed JSON body: {exc}") from exc

        def do_GET(self):
            self._traced("GET", self._get)

        def do_DELETE(self):
            self._traced("DELETE", self._delete)

        def _fleet(self, method: str) -> bool:
            """Answer a ``/fleet/v1`` request (admission-exempt: peer
            calls are cheap bounded bookkeeping that must keep answering
            while the gate sheds); False when it is no fleet route."""
            if fleet_routes is None:
                return False
            url = urlsplit(self.path)
            route = fleet_match(method, url.path)
            if route is None:
                return False
            self._series = (f"http:{route[0]}", time.perf_counter())
            raw = self._raw_body()
            if raw is None:
                return True
            status, obj = fleet_routes.serve(
                method, route[0], route[1], url.query, self.headers, raw,
                self._deadline(),
            )
            self._send_raw(status, jsonutil.dumps(obj).encode())
            return True

        def _delete(self):
            if not self._fleet("DELETE"):
                self.close_connection = True  # its body stays unread
                self._error(404, f"no route DELETE {self.path}")

        def _get(self):
            if self._fleet("GET"):
                return
            url = urlsplit(self.path)
            path = url.path
            answer = None
            if trace_sink is not None and path.startswith("/v1/traces"):
                answer = traces_response(trace_sink, path, url.query)
            elif path.startswith("/v1/judges"):
                answer = judges_response(path)
            if answer is not None:
                self._send(*answer)
            elif path == "/v1/weights":
                if live_weights is None:
                    self._send(403, WEIGHTS_DISABLED)
                else:
                    self._send(200, live_weights.wire())
            elif path in ("/healthz", "/livez"):
                self._send(200, {"ok": True})
            elif path == "/readyz":
                self._send(*lifecycle.readyz())
            elif path == "/metrics":
                if parse_qs(url.query).get("format") == ["prometheus"]:
                    self._send_raw(
                        200, render_prometheus(metrics).encode(),
                        content_type=PROM_CONTENT_TYPE,
                    )
                else:
                    self._send(200, metrics.snapshot())
            else:
                self._error(404, f"no route GET {self.path}")

        def do_POST(self):
            self._traced("POST", self._post_route)

        def do_PUT(self):
            self._traced("PUT", self._put_route)

        def _raw_body(self):
            """The request's raw body, or None once a 400 (malformed
            content-length) or the 413 (the body cap) has been sent."""
            try:
                length = int(self.headers.get("content-length") or 0)
            except ValueError:
                length = -1
            if length < 0:
                self.close_connection = True
                self._send_raw(400, jsonutil.dumps(with_trace_id({
                    "code": 400, "message": "malformed content-length",
                })).encode())
                return None
            if length >= body_cap:
                self.close_connection = True
                self._send_raw(413, payload_too_large())
                return None
            return self.rfile.read(length) if length else b""

        def _put_route(self):
            """``PUT /v1/weights``: admission-exempt (promoting a table
            is a tiny admin swap an operator may need mid-overload, as
            the reference's gate exempts it), under the body cap."""
            t0 = time.perf_counter()
            if self._fleet("PUT"):
                return
            if self.path != "/v1/weights":
                self.close_connection = True  # its body stays unread
                self._error(404, f"no route PUT {self.path}")
                return
            self._series = ("http:/v1/weights", t0)
            raw = self._raw_body()
            if raw is None:
                return
            if live_weights is None:
                self._send(403, WEIGHTS_DISABLED)
            else:
                self._send(*weights_put(live_weights, raw))

        def _post_rescore(self) -> None:
            raw = self._raw_body()
            if raw is None:
                return
            if offline_rescore is None:
                self._send(403, OFFLINE_DISABLED)
                return
            deadline = self._deadline()
            token = deadline.activate() if deadline is not None else None
            try:
                answer = offline_rescore(raw)
            except Exception:  # the server keeps serving; detail to the log
                log.exception("request failed: POST /v1/train/rescore")
                self._error(500, "internal server error")
                return
            finally:
                if token is not None:
                    Deadline.deactivate(token)
            self._send(*answer)

        def _post_profile(self, path: str) -> None:
            raw = self._raw_body()
            if raw is None:
                return
            if profiler is None:
                self._send(403, PROFILE_DISABLED)
                return
            route = {"/profile/start": profiler.start,
                     "/profile/stop": profiler.stop,
                     "/v1/profile": profiler.capture}[path]
            try:
                answer = route(raw)
            except Exception as exc:  # the server keeps serving
                log.exception("request failed: POST %s", path)
                status, headers, body = error_response(exc)
                self._send_raw(status, body, headers)
                return
            self._send(*answer)

        def _post_route(self):
            if self._fleet("POST"):
                return
            t0 = time.perf_counter()
            path = self.path
            profile_route = path == "/v1/profile" or (
                profiler is not None
                and path in ("/profile/start", "/profile/stop"))
            host_route = path == RESCORE_PATH or profile_route or (
                chat_routes is not None and chat_routes.serves(path))
            if path not in device_routes and not host_route:
                self.close_connection = True  # its body stays unread
                self._error(404, f"no route POST {path}")
                return
            self._series = (f"http:{path}", t0)
            # admitted or shed here (the exempt routes skip the gate); the
            # device routes also pass the device gate (warming, watchdog)
            exempt = path in EXEMPT_PATHS
            if not exempt:
                t_wait = time.perf_counter()
                reason = admission.try_acquire(
                    device_work=path in device_routes)
                if reason is not None:
                    # lands on the root span; the 503 forces its retention
                    obs.annotate(shed_reason=reason)
                    status, headers, body = shed_response(
                        reason, admission.config.retry_after_ms
                    )
                    self._send_raw(status, body, headers)
                    return
                # door -> slot held; the gate is admit-or-shed (no
                # queueing), so this phase reads ~0, recorded so the
                # breakdown is whole
                wait_ms = (time.perf_counter() - t_wait) * 1e3
                observe_phase("admission_wait", wait_ms)
                obs.annotate(admission_inflight=admission.inflight,
                             admission_wait_ms=round(wait_ms, 3))
            try:
                if profile_route:
                    self._post_profile(path)
                elif path == RESCORE_PATH:
                    self._post_rescore()
                elif host_route:
                    self._post_chat(path)
                else:
                    self._post(path, t0)
            finally:
                # a stream cut short is observed here
                status = self._status or 500  # None: nothing was sent
                self._observe(status)
                if not exempt:
                    admission.release(
                        (time.perf_counter() - t0) * 1e3,
                        error=status >= 500,
                    )

        def _deadline(self):
            """The request's deadline: ``x-deadline-ms`` wins, else the
            default (``RESILIENCE_DEADLINE_MILLIS``); None when neither
            is a positive number."""
            ms = default_deadline_ms
            header = self.headers.get("x-deadline-ms")
            if header:
                try:
                    ms = float(header)
                except ValueError:
                    pass
            return Deadline(ms / 1000.0) if ms > 0 else None

        def _post_chat(self, path: str) -> None:
            raw = self._raw_body()
            if raw is None:
                return
            chat_routes.serve(self, path, raw, self._deadline(), metrics)

        def _post(self, path: str, door: float) -> None:
            """A device route: ``gateway_read`` until its item is
            submitted, ``gateway_write`` from the answer's return to its
            last byte, and for a ``/consensus`` answered 200 the device's
            idle time while it was held (``held_idle``, from ``door``)."""
            read = obs.phase("gateway_read").enter()
            write = obs.phase("gateway_write")
            try:
                self._answer(path, read, write)
            finally:
                read.leave()
                write.leave()
            if path == "/consensus" and self._status == 200:
                observe_held_idle(door, time.perf_counter())

        def _answer(self, path: str, read, write) -> None:
            try:
                body = self._body()
                if path == "/consensus":
                    texts, scorer, prompt, temperature = parse_consensus(
                        body, embedder is not None, reranker is not None
                    )
                else:
                    texts = parse_embeddings(body, embedder.model_name)
            except OverflowError:
                self.close_connection = True
                self._send_raw(413, payload_too_large())
                return
            except BadRequest as exc:
                self._error(400, str(exc))
                return
            deadline = self._deadline()
            token = deadline.activate() if deadline is not None else None
            try:
                if path == "/consensus":
                    if scorer == "rm":
                        read.leave()
                        conf, tokens = reranker.rerank_confidence(
                            texts, prompt=prompt, temperature=temperature
                        )
                        model_name = reranker.model_name
                    else:
                        pending = batcher.submit_consensus(texts, temperature)
                        read.leave()
                        conf, tokens = batcher.wait(pending)
                        model_name = embedder.model_name
                    write.enter()
                    answer = json.dumps({
                        "model": model_name,
                        "scorer": scorer,
                        "confidence": [float(c) for c in conf],
                        "usage": {
                            "prompt_tokens": tokens,
                            "total_tokens": tokens,
                        },
                    }).encode()
                else:
                    pending = batcher.submit_embed(texts)
                    read.leave()
                    emb, tokens = batcher.wait(pending)
                    write.enter()
                    answer = embeddings_body(
                        embedder.wire_response(emb, tokens).to_json_obj())
            except StatusError as exc:
                status, headers, raw = error_response(exc)
                self._send_raw(status, raw, headers)
                return
            except Exception:  # the server keeps serving; detail to the log
                log.exception("request failed: POST %s", path)
                self._error(500, "internal server error")
                return
            finally:
                if token is not None:
                    Deadline.deactivate(token)
            self._send_raw(200, answer)

    return Handler


def _roofline_gauge(embedder):
    """The live roofline gauge over ``analysis/roofline.json`` for the
    embedder's device type, or None (no embedder, no committed file).
    Observability, never a serving dependency: a failure to build it
    leaves the section out."""
    if embedder is None:
        return None
    try:
        from ..analysis.roofline import RooflineGauge, load_roofline

        roofline = load_roofline()
        return (RooflineGauge(roofline, embedder.device.type) if roofline
                else None)
    except Exception:
        log.exception("roofline gauge unavailable")
        return None


class _HTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    # the listen backlog: socketserver's default of 5 drops the SYNs of a
    # burst of concurrent clients, which the client's kernel retries
    # after a 1 s timeout; 128 is aiohttp's default (the reference's)
    request_queue_size = 128


class Server:
    """The HTTP server, its batcher, admission gate, lifecycle and
    metrics, and its serving thread, for an embedder (``/consensus``
    cosine, ``/embeddings``), a reranker (``/consensus`` rm), a chat
    client (``/chat/completions``; with a multichat client also
    ``/multichat/completions``, whose consensus needs the embedder; with
    a score client also ``/score/completions``, and the ``score_cache``
    section of ``/metrics`` when it has a cache), or any mix; a server
    with a chat client only serves the host routes, as the reference
    can.  The chat routes' coroutines run on one asyncio loop the server
    owns (``serve/chat_routes.py``).  ``on_close`` hooks run after the
    batcher stops (``build_server`` saves the training tables and
    flushes the score cache's disk tier there).
    ``port=0`` binds an ephemeral port (``.port`` says which).

    Batching options go to the ``DeviceBatcher`` as they are
    (``window_ms``, ``max_batch``, ``pipeline_depth``, ``max_rows``,
    ``host_tokenizer_workers``, ``max_queue_depth`` and the packing
    options).
    ``admission`` is an ``AdmissionConfig``; ``drain_timeout_ms`` bounds
    ``drain()``; ``watchdog_ms`` > 0 starts a ``DeviceWatchdog`` that
    checks every ``watchdog_interval_ms`` (0: a quarter of its timeout);
    ``max_body_bytes`` caps every route's request body (413 past it);
    ``device_timing=False`` turns off per-bucket device timing.  With
    ``ready=False`` the server answers ``/readyz`` 503 and sheds device
    routes until ``warmup`` (or ``lifecycle.mark_ready()``).
    ``trace_sink`` (an ``obs.TraceSink``) turns request tracing and
    ``/v1/traces`` on, with the ``traces`` section of ``/metrics``;
    ``ledger`` (the score client's ``obs.OutcomeLedger``) adds the
    ``ledger`` section beside the always-on ``quality`` one.
    ``resilience`` (the clients' ``resilience.ResiliencePolicy``) and
    ``fault_plan`` (``FAULT_PLAN``'s ``FaultPlan``) add the ``resilience``
    section, and the policy's ``deadline_ms`` is the default deadline of
    a request without ``x-deadline-ms``.  ``memguard`` (a
    ``resilience.MemGuard``) sheds every POST with 503 ``shed_reason:
    "memory"`` under hard pressure, flags ``/readyz``, adds the
    ``memguard`` section and is stopped with the server (``build_server``
    governs the budgets and starts it).  ``host_fastpath`` puts the
    streams' frames on the splice lane (``serve/frames.py``).
    ``live_weights`` (a ``weights.live.LiveWeightStore``, the score
    client's) serves ``GET``/``PUT /v1/weights`` and the ``weights``
    section; ``offline_enabled`` (with an embedder) serves ``POST
    /v1/train/rescore``, ``offline_inflight`` groups in flight by
    default.  Either route answers 403 when off.
    ``fallback_embedder`` (the CPU twin, ``DEVICE_WATCHDOG_CPU_FALLBACK``)
    and ``meshfault`` (a ``resilience.MeshFaultManager``,
    ``MESH_FAULT_ENABLED``) go to the batcher; the watchdog's trip and
    recovery switch the twin with the reference's precedence (under a
    manager a trip marks the next fault persistent and the ladder
    decides, and a twin switched on survives the recovery; without one a
    trip turns the twin on and the recovery off), a manager adds the
    ``meshfault`` section (and, with ``probe_millis``, the recovery
    prober) and ``mesh`` (``MESH_ENABLED``) the ``mesh`` section.
    ``profile_dir`` turns the profiler routes on; with an embedder the
    ``roofline`` section gauges its buckets against
    ``analysis/roofline.json``.  ``fleet`` (a ``fleet.FleetCoordinator``
    over the score client's cache, ``FLEET_*``; needs the chat client)
    serves ``/fleet/v1/*`` on the chat routes' loop, adds the ``fleet``
    section, hands the hot set off at the drain's step 0 and puts the
    membership on ``/readyz``; ``close`` closes it."""

    def __init__(
        self,
        embedder=None,
        host: str = "127.0.0.1",
        port: int = 0,
        max_batch: int = 64,
        window_ms: float = 3.0,
        reranker=None,
        *,
        admission: AdmissionConfig = None,
        drain_timeout_ms: float = 10000.0,
        watchdog_ms: float = 0.0,
        watchdog_interval_ms: float = 0.0,
        max_body_bytes: int = MAX_BODY_BYTES,
        device_timing: bool = True,
        ready: bool = True,
        chat_client=None,
        multichat_client=None,
        score_client=None,
        trace_sink=None,
        ledger=None,
        resilience=None,
        fault_plan=None,
        memguard=None,
        host_fastpath: bool = False,
        live_weights=None,
        offline_enabled: bool = False,
        offline_inflight: int = 4,
        fallback_embedder=None,
        meshfault=None,
        mesh: bool = False,
        profile_dir=None,
        fleet=None,
        **batching,
    ) -> None:
        from ..resilience.watchdog import DeviceWatchdog
        from .batcher import DeviceBatcher
        from .chat_routes import ChatRoutes

        if embedder is None and reranker is None and chat_client is None:
            raise ValueError(
                "a server needs an embedder, a reranker or a chat client"
            )
        if (multichat_client is not None or score_client is not None) \
                and chat_client is None:
            raise ValueError(
                "a multichat or score client needs the chat client")
        self.embedder = embedder
        self.reranker = reranker
        for model in (embedder, reranker):
            if model is not None:
                model.device_timing = bool(device_timing)
        self.metrics = Metrics()
        self.watchdog = (
            DeviceWatchdog(watchdog_ms, interval_ms=watchdog_interval_ms)
            if watchdog_ms > 0 else None
        )
        admission = admission or AdmissionConfig()
        if admission.max_queue_depth:
            batching.setdefault("max_queue_depth", admission.max_queue_depth)
        self.batcher = (
            DeviceBatcher(
                embedder, self.metrics, max_batch=max_batch,
                window_ms=window_ms, watchdog=self.watchdog,
                fallback_embedder=fallback_embedder, meshfault=meshfault,
                **batching,
            )
            if embedder is not None else None
        )
        self.meshfault = meshfault if self.batcher is not None else None
        if self.watchdog is not None:
            self.watchdog.on_trip = self._on_trip
            self.watchdog.on_recover = self._on_recover
        self.memguard = memguard
        self.lifecycle = Lifecycle(
            batcher=self.batcher, watchdog=self.watchdog, memguard=memguard,
            meshfault=self.meshfault, drain_timeout_ms=drain_timeout_ms,
            state=READY if ready else STARTING,
        )
        self.admission = AdmissionController(
            admission, device_gate=self._device_gate,
            mem_gate=memguard.gate if memguard is not None else None,
        )
        self.lifecycle.admission = self.admission
        if self.meshfault is not None:
            # every shape change rescales admission (the hard cap and the
            # AIMD limit) and the batcher's group capacity to the
            # surviving device fraction
            self.meshfault.rescale_hooks.append(self.admission.rescale)
            self.meshfault.rescale_hooks.append(
                self.batcher.rescale_capacity)
        register_performance(self.metrics, _roofline_gauge(embedder))
        if mesh and embedder is not None:
            self.metrics.register_provider("mesh", embedder.mesh_stats)
        if self.meshfault is not None:
            self.metrics.register_provider("meshfault",
                                           self.meshfault.snapshot)
        self.profiler = (ProfileRoutes(profile_dir) if profile_dir
                         else None)
        register_overload(self.metrics, self.admission, self.watchdog,
                          self.lifecycle, memguard)
        register_resilience(self.metrics, resilience, fault_plan)
        register_graphs(self.metrics, embedder=embedder, reranker=reranker)
        register_quality(self.metrics, ledger, live_weights)
        self.live_weights = live_weights
        self.offline_rescore = (
            OfflineRescore(self.batcher, offline_inflight)
            if offline_enabled and self.batcher is not None else None
        )
        self.trace_sink = trace_sink
        if trace_sink is not None:
            self.metrics.register_provider("traces", trace_sink.snapshot)
        self.chat_routes = (
            ChatRoutes(chat_client, multichat_client, embedder, self.batcher,
                       self.metrics, score_client=score_client,
                       host_fastpath=host_fastpath)
            if chat_client is not None else None
        )
        self.score_client = score_client
        cache = getattr(score_client, "cache", None)
        if cache is not None:
            flights = score_client.flights

            def score_cache_stats():
                stats = cache.stats()
                stats["inflight_collapses"] = flights.collapses
                return stats

            self.metrics.register_provider("score_cache", score_cache_stats)
        self.fleet_routes = None
        if fleet is not None and self.chat_routes is not None:
            from ..fleet import FleetRoutes

            self.fleet_routes = FleetRoutes(fleet, self.chat_routes.loop)
            self.metrics.register_provider("fleet", self.fleet_routes.stats)
            self.lifecycle.fleet = self.fleet_routes
        # run at close, after the batcher stops (the training tables'
        # snapshot, the score cache's disk flush)
        self.on_close: list = []
        self.httpd = _HTTPServer(
            (host, port),
            make_handler(embedder, self.batcher, reranker, self.metrics,
                         self.admission, self.lifecycle, self.chat_routes,
                         max_body_bytes, trace_sink,
                         resilience.deadline_ms if resilience is not None
                         else 0.0, live_weights, self.offline_rescore,
                         self.profiler, self.fleet_routes),
        )
        self._thread: threading.Thread = None
        if self.watchdog is not None:
            self.watchdog.start()
        self._prober_stop = threading.Event()
        self._prober = None
        if self.meshfault is not None and self.meshfault.probe_millis > 0:
            self._prober = threading.Thread(
                target=self._probe_loop, name="lwc-torch-mesh-prober",
                daemon=True)
            self._prober.start()

    def _device_gate(self):
        """Shed device routes while the graphs are still being captured
        (a capture must own the card), or while the device is unhealthy
        and no CPU twin can absorb the work."""
        if self.lifecycle.state == STARTING:
            return "warming"
        if self.watchdog is not None and not self.watchdog.healthy():
            if self.batcher is None or self.batcher.fallback_embedder is None:
                return "device_unhealthy"
        return None

    # -- the watchdog's switch of the twin (the reference's precedence) ------

    def _mesh_absorbs(self) -> bool:
        """Under a fault manager a wedge goes to the ladder, not straight
        to the twin: the batcher switches the twin on only when the ladder
        reports itself spent."""
        return self.meshfault is not None and not self.batcher.fallback_active

    def _on_trip(self, kind: str, overdue_ms: float) -> None:
        twin = self.batcher is not None and (
            self.batcher.fallback_embedder is not None)
        log.error(
            "device watchdog TRIPPED: %s dispatch overdue after %.0f ms%s",
            kind, overdue_ms,
            "; escalating to the fault ladder" if self._mesh_absorbs()
            else "; routing device work to the CPU twin" if twin
            else "; device routes shed until it completes")
        if self._mesh_absorbs():
            self.meshfault.note_watchdog_trip()
            return
        if self.batcher is not None:
            self.batcher.use_fallback(True)

    def _on_recover(self) -> None:
        log.warning("device watchdog recovered: the overdue dispatch "
                    "completed, device traffic resumes")
        if self.meshfault is not None:
            # a twin switched on by a spent ladder survives: a completed
            # wedge does not un-spend the ladder
            return
        if self.batcher is not None:
            self.batcher.use_fallback(False)

    def _probe_loop(self) -> None:
        """``MESH_FAULT_PROBE_MILLIS``: while degraded, re-validate the
        full shape and upsize back, through the full rung's stored model
        and graphs (``MeshFaultManager.try_recover``)."""
        mf = self.meshfault
        while not self._prober_stop.wait(
                mf.probe_millis / 1e3 * mf.probe_backoff_scale()):
            try:
                if mf.try_recover():
                    log.warning("mesh fault recovery: back to %s",
                                mf.current_shape)
            except Exception:
                log.exception("mesh fault recovery probe failed")

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def warmup(self, specs=(), r_buckets=(), packed_buckets=(),
               rm_specs=(), ring_buckets=()) -> list:
        """Capture the CUDA graphs of every configured bucket
        (``TorchEmbedder.warmup``, ``TorchReranker.warmup``; the ring
        buckets of an sp mesh), then turn ready.  Returns [(label,
        seconds)]."""
        timings = []
        if self.embedder is not None:
            timings += self.embedder.warmup(specs, r_buckets, packed_buckets,
                                            ring_buckets)
        mf = self.meshfault
        if mf is not None and specs and len(mf.build_ladder()) > 1:
            # every fallback rung warmed now, under its own shape's keys:
            # a downsize mid-traffic switches to graphs captured here
            from ..models.embedder import _seq_bucket

            snapped = list(dict.fromkeys(
                (n, _seq_bucket(s, self.embedder.max_tokens))
                for n, s in specs))
            for label, seconds in mf.warm_ladder(
                    snapped, r_buckets, packed_buckets, ring_buckets):
                log.info("mesh fault ladder warmup %s in %.1fs", label,
                         seconds)
                timings.append((label, seconds))
            for (dp, tp), pool in sorted(mf.rung_pool_bytes.items(),
                                         reverse=True):
                log.info("mesh fault ladder rung %dx%d: graph pool +%d "
                         "bytes", dp, tp, pool)
        if self.reranker is not None:
            timings += self.reranker.warmup(rm_specs)
        self.lifecycle.mark_ready()
        return timings

    def start(self) -> "Server":
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, name="lwc-torch-http",
            daemon=True,
        )
        self._thread.start()
        return self

    def drain(self) -> bool:
        """Stop admitting, let in-flight requests finish and the batcher
        empty, within the drain budget; True if it drained clean.  A
        second call joins the first."""
        return self.lifecycle.begin_drain().result()

    def close(self) -> None:
        if self._thread is not None:
            self.httpd.shutdown()
            self._thread.join(10)
        self.httpd.server_close()
        if self.fleet_routes is not None:
            self.fleet_routes.close()
        if self.chat_routes is not None:
            self.chat_routes.close()
        if self.batcher is not None:
            self.batcher.close()
        if self.watchdog is not None:
            self.watchdog.stop()
        self._prober_stop.set()
        if self._prober is not None:
            self._prober.join(5)
        if self.profiler is not None:
            self.profiler.close()
        if self.memguard is not None:
            self.memguard.stop()
        hooks, self.on_close = self.on_close, []
        for hook in hooks:
            try:
                hook()
            except Exception:
                log.exception("close hook failed")

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()
