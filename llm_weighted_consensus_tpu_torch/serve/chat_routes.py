"""The chat routes of the port's server: ``POST /chat/completions``,
``POST /multichat/completions`` and ``POST /score/completions``, on the
stdlib server's threads.

Counterpart of the chat, score and multichat parts of
``llm_weighted_consensus_tpu/serve/gateway.py`` (``_make_handler``,
``_respond_streaming``, ``_with_consensus_frames``,
``_multichat_streaming``, ``_multichat_unary``, ``_error_response``,
``_parse_error_response``), with the same bodies, frames and errors:

* the body parses with the reference's JSON reader into the request type;
  a ``SchemaError`` or malformed JSON is a 400 whose message names the
  JSON path, anything else a masked 400;
* ``"stream": true`` answers ``text/event-stream``: one ``data:`` frame
  per item in the reference's compact JSON, an error item as its
  ``{code, message}`` envelope, then ``data: [DONE]``; otherwise the
  folded unary body.  Frames are encoded by ``serve/frames.py``'s
  ``FrameEncoder``, one per stream, on the splice lane under
  ``HOST_FASTPATH`` (the same bytes; a frame the splicer cannot prove
  equal goes out on the slow lane, is counted in ``fastpath_fallbacks``
  and annotated on the request's trace);
* ``/multichat/completions`` with ``"consensus": true`` and an embedder
  interleaves ``multichat.consensus`` frames as candidates finish
  (``clients.multichat.StreamingSelfConsistency`` through the batcher's
  ``stream`` kind), or, unary, votes once over the finished candidates
  (the batcher's ``consensus``); an embedder failure degrades to plain
  multichat in both;
* ``/score/completions`` is the score client's (``clients/score.py``):
  chunk frames and, when every judge failed, the ``AllVotesFailed``
  envelope as the last frame; unary, that error's status and message;
* an error before the stream opens is the reference's error response
  (503 with ``Retry-After`` for a shed, a ``StatusError``'s status and
  message, else the masked 500 envelope).

The clients are asyncio code.  One event loop on a daemon thread
(``EventLoop``, owned by the ``Server``) runs every client coroutine; a
handler thread submits its request's coroutine there, which puts frames
on a queue the handler thread drains onto the socket.  A client that goes
away (a write fails, or, while the stream is quiet, its socket reads as
closed) cancels the coroutine, whose cleanup closes the upstream streams
and drops the request's queued device work.  Each coroutine starts from a
fresh default ``decimal`` context (28 digits, as on the reference's loop):
``asyncio`` copies the submitting thread's context into the task, and the
score tally's fast lane reads ``decimal.getcontext().prec``.

Traced requests: that copy of the handler thread's context also carries
its root span (``obs/span.py``), so the client coroutines, and every task
they start, build their spans under their own request's root, and two
concurrent requests never share one.  An error envelope or mid-stream
error frame of a traced request carries its ``trace_id``, a mid-stream
error forces the trace's retention (``stream_error``), and a client that
leaves is annotated ``client_disconnect`` on the root.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import decimal
import logging
import queue
import select
import socket
import threading
import time

from .. import obs
from ..clients.multichat import ConsensusUpdate, StreamingSelfConsistency
from ..errors import (
    MASKING_LOGGER,
    OverloadedError,
    StatusError,
    to_response_error,
    with_trace_id,
)
from ..resilience.admission import retry_after_seconds
from ..types.chat_request import ChatCompletionCreateParams as ChatParams
from ..types.multichat_request import (
    ChatCompletionCreateParams as MultichatParams,
)
from ..types.score_request import ChatCompletionCreateParams as ScoreParams
from ..utils import jsonutil
from .frames import DONE, FrameEncoder

log = logging.getLogger("lwc.torch.gateway")

SSE_HEADERS = {"content-type": "text/event-stream", "cache-control": "no-cache"}


def error_response(exc: Exception):
    """(status, headers, body) of an error raised before a response
    started, as the reference's ``_error_response`` renders it (a traced
    request's envelope, and a dict-shaped StatusError message, carry its
    ``trace_id``)."""
    if isinstance(exc, OverloadedError):
        body = with_trace_id({"code": 503, "message": exc.message()})
        headers = {"Retry-After": retry_after_seconds(
            exc.retry_after_ms or 1000.0)}
        return 503, headers, jsonutil.dumps(body).encode()
    if isinstance(exc, StatusError):
        message = exc.message()
        if isinstance(message, dict):
            message = with_trace_id(dict(message))
        return exc.status(), {}, jsonutil.dumps(message).encode()
    err = to_response_error(exc)
    return err.code, {}, jsonutil.dumps(
        with_trace_id(err.to_json_obj())).encode()


def parse_error_response(exc: Exception):
    """(status, body) of the parse phase's 400: a ``ValueError``'s text
    (a ``SchemaError`` with its JSON path, or the JSON decoder's) is the
    client's input and safe to echo; anything else is masked."""
    if isinstance(exc, ValueError):
        message: object = str(exc)
    else:
        logging.getLogger(MASKING_LOGGER).error(
            "unexpected parse-phase error", exc_info=exc
        )
        message = "malformed request body"
    return 400, jsonutil.dumps(
        with_trace_id({"code": 400, "message": message})).encode()


class EventLoop:
    """One asyncio loop on a daemon thread, for every client coroutine of
    the chat routes."""

    def __init__(self) -> None:
        self.loop = asyncio.new_event_loop()
        self._thread = threading.Thread(
            target=self.loop.run_forever, name="lwc-torch-aio", daemon=True
        )
        self._thread.start()

    def submit(self, coro) -> concurrent.futures.Future:
        return asyncio.run_coroutine_threadsafe(coro, self.loop)

    def close(self, timeout: float = 5.0) -> None:
        """Cancel what still runs, then stop and close the loop."""

        async def cancel_all():
            tasks = [t for t in asyncio.all_tasks()
                     if t is not asyncio.current_task()]
            for task in tasks:
                task.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)

        if self.loop.is_closed():
            return
        try:
            self.submit(cancel_all()).result(timeout)
        except concurrent.futures.TimeoutError:
            log.warning("chat coroutines still running at close")
        self.loop.call_soon_threadsafe(self.loop.stop)
        self._thread.join(timeout)
        if not self._thread.is_alive():
            self.loop.close()


# ---------------------------------------------------------------------------
# The multichat consensus overlay
# ---------------------------------------------------------------------------


async def with_consensus_frames(stream, embedder, metrics=None, batcher=None):
    """Interleave live ``multichat.consensus`` frames into a multichat
    stream; each update's embed + vote goes through the batcher (shared
    dispatches across concurrent streams) when one is attached."""
    sc = StreamingSelfConsistency(embedder, batcher=batcher)
    try:
        async for chunk in stream:
            yield chunk
            if isinstance(chunk, Exception) or sc is None:
                continue
            t0 = time.perf_counter()
            try:
                update = await sc.push_chunk_async(chunk)
            except Exception:
                # consensus frames are an overlay on the multichat stream:
                # an embedder failure degrades to plain multichat (no more
                # consensus frames) rather than tearing the stream down
                log.warning("consensus update failed; the stream goes on "
                            "without consensus frames", exc_info=True)
                if metrics is not None:
                    metrics.observe(
                        "device:consensus_update",
                        (time.perf_counter() - t0) * 1e3, error=True,
                    )
                sc = None
                continue
            if update is not None:
                if metrics is not None:
                    metrics.observe(
                        "device:consensus_update",
                        (time.perf_counter() - t0) * 1e3,
                    )
                yield ConsensusUpdate(update)
    finally:
        # a client disconnect surfaces here as GeneratorExit or a
        # cancellation; the inner stream's cleanup must still run
        aclose = getattr(stream, "aclose", None)
        if aclose is not None:
            await aclose()


def multichat_streaming(multichat_client, embedder, metrics, batcher=None):
    async def create_streaming(ctx, params):
        stream = await multichat_client.create_streaming(ctx, params)
        if params.consensus and embedder is not None:
            return with_consensus_frames(stream, embedder, metrics, batcher)
        return stream

    return create_streaming


def multichat_unary(multichat_client, embedder, batcher):
    """Unary multichat with ``consensus: true``: after the fold, embed the
    finished candidates and vote once (the batcher's ``consensus``, which
    groups concurrent requests of one candidate count), and attach the
    distribution by slot."""

    async def create_unary(ctx, params):
        result = await multichat_client.create_unary(ctx, params)
        if not (params.consensus and embedder is not None and batcher):
            return result
        slots, texts = [], []
        for choice in result.choices:
            content = getattr(choice.message, "content", None)
            if choice.error is None and isinstance(content, str) and content:
                slots.append(choice.index)
                texts.append(content)
        if len(texts) >= 2:
            try:
                conf, _tokens = await batcher.wait_async(
                    batcher.submit_consensus(texts)
                )
            except Exception:
                # the consensus is an overlay: an embedder failure keeps
                # the N completed generations (no `consensus` field)
                log.warning("unary consensus failed; answering without it",
                            exc_info=True)
                return result
            result.consensus = {
                str(slot): float(c) for slot, c in zip(slots, conf)
            }
        return result

    return create_unary


# stream pump -> handler thread messages
_OPENED, _OPEN_FAILED, _FRAME, _FAILED, _END = range(5)


async def _pump(create_streaming, ctx, params, deadline, frames: queue.Queue,
                encoder, routes):
    """Open the stream and put its frames, encoded by ``encoder``, on
    ``frames`` (runs on the loop; the deadline is activated in this
    task's own context, so the tasks it spawns inherit it)."""
    decimal.setcontext(decimal.Context())
    if deadline is not None:
        deadline.activate()
    try:
        stream = await create_streaming(ctx, params)
    except Exception as exc:
        frames.put((_OPEN_FAILED, exc))
        return
    frames.put((_OPENED, None))
    try:
        async for item in stream:
            if isinstance(item, Exception):
                # a mid-stream error makes this trace worth keeping even
                # when head sampling said no
                obs.force_keep("stream_error")
                frames.put((_FRAME, encoder.encode_error(item)))
            else:
                frames.put((_FRAME, encoder.encode(item)))
    except asyncio.CancelledError:
        # the client left, or the server is closing: end the response
        frames.put((_FAILED, None))
        raise
    except Exception as exc:
        frames.put((_FAILED, exc))
        return
    finally:
        aclose = getattr(stream, "aclose", None)
        if aclose is not None:
            await aclose()
        if encoder.fallbacks:
            # fast-lane frames that fell back to the slow lane: loud in
            # the trace and the counter, invisible on the wire
            routes.fastpath_fallbacks += encoder.fallbacks
            obs.annotate(fastpath_fallbacks=encoder.fallbacks)
    frames.put((_END, None))


async def _unary(create_unary, ctx, params, deadline):
    decimal.setcontext(decimal.Context())
    if deadline is not None:
        deadline.activate()
    return await create_unary(ctx, params)


async def _json_call(handler, raw: bytes):
    decimal.setcontext(decimal.Context())
    return await handler(raw)


class ChatRoutes:
    """The routes a chat client (and a multichat client, and a score
    client) serve: path -> (request type, create_streaming,
    create_unary), and the loop their coroutines run on.  Plain JSON
    routes (``/archive/rescore``, ``/weights/learn``) are coroutines
    ``raw body -> (status, body bytes)`` on the same loop
    (``add_json_route``).  ``host_fastpath`` (``HOST_FASTPATH``) puts
    every stream's frames on the splice lane; ``fastpath_fallbacks``
    counts the frames it handed to the slow lane (on the loop thread)."""

    def __init__(self, chat_client, multichat_client=None, embedder=None,
                 batcher=None, metrics=None, score_client=None,
                 host_fastpath: bool = False) -> None:
        self.loop = EventLoop()
        self.host_fastpath = bool(host_fastpath)
        self.fastpath_fallbacks = 0
        self.routes = {
            "/chat/completions": (
                ChatParams, chat_client.create_streaming,
                chat_client.create_unary,
            ),
        }
        if multichat_client is not None:
            self.routes["/multichat/completions"] = (
                MultichatParams,
                multichat_streaming(multichat_client, embedder, metrics,
                                    batcher),
                multichat_unary(multichat_client, embedder, batcher),
            )
        if score_client is not None:
            self.routes["/score/completions"] = (
                ScoreParams, score_client.create_streaming,
                score_client.create_unary,
            )
        self.json_routes: dict = {}

    def new_encoder(self) -> FrameEncoder:
        """The frame encoder of one response stream."""
        return FrameEncoder(self.host_fastpath)

    def add_json_route(self, path: str, handler) -> None:
        self.json_routes[path] = handler

    def serves(self, path: str) -> bool:
        return path in self.routes or path in self.json_routes

    def close(self) -> None:
        self.loop.close()

    def serve(self, handler, path: str, raw: bytes, deadline,
              metrics) -> None:
        """Answer one chat-route request on ``handler`` (the stdlib request
        handler) from its raw body."""
        json_route = self.json_routes.get(path)
        if json_route is not None:
            try:
                status, body = self.loop.submit(
                    _json_call(json_route, raw)).result()
            except Exception as exc:
                handler._send_raw(*_status_body_headers(exc))
                return
            handler._send_raw(status, body)
            return
        params_cls, create_streaming, create_unary = self.routes[path]
        try:
            params = params_cls.from_json_obj(jsonutil.loads(raw.decode("utf-8")))
        except Exception as exc:  # the parse phase is side-effect free
            status, body = parse_error_response(exc)
            handler._send_raw(status, body)
            return
        ctx = handler.headers.get("authorization")
        if not params.stream:
            future = self.loop.submit(
                _unary(create_unary, ctx, params, deadline)
            )
            try:
                result = future.result()
            except Exception as exc:
                handler._send_raw(*_status_body_headers(exc))
                return
            handler._send_raw(200, result.to_json().encode())
            return
        frames: queue.Queue = queue.Queue()
        future = self.loop.submit(
            _pump(create_streaming, ctx, params, deadline, frames,
                  self.new_encoder(), self)
        )
        kind, value = frames.get()
        if kind == _OPEN_FAILED:
            handler._send_raw(*_status_body_headers(value))
            return
        try:
            handler._start_chunked(200, SSE_HEADERS)
            while True:
                try:
                    kind, value = frames.get(timeout=_IDLE_CHECK_S)
                except queue.Empty:
                    if _client_gone(handler.connection):
                        raise ConnectionResetError("client closed") from None
                    continue
                if kind == _FRAME:
                    handler._write_chunk(value)
                elif kind == _END:
                    handler._observe(200)
                    handler._write_chunk(DONE)
                    handler._end_chunked()
                    return
                else:  # raised or cancelled: end the response unterminated
                    log.error("stream ended early: POST %s", path,
                              exc_info=value)
                    handler.close_connection = True
                    return
        except (ConnectionError, OSError):
            # the client went away mid-stream: tear the pipeline down now
            # (upstream streams closed, queued device work dropped)
            future.cancel()
            handler.close_connection = True
            obs.annotate(client_disconnect=True)
            if metrics is not None:
                metrics.observe("http:client_disconnect", 0.0, error=True)


# how often a quiet stream checks whether its client is still there
_IDLE_CHECK_S = 0.25


def _client_gone(conn) -> bool:
    """True when the client's end of ``conn`` has closed (readable, and
    a peek reads end of file)."""
    try:
        readable, _, _ = select.select([conn], [], [], 0)
        return bool(readable) and conn.recv(1, socket.MSG_PEEK) == b""
    except (OSError, ValueError):
        return True


def _status_body_headers(exc):
    status, headers, body = error_response(exc)
    return status, body, headers
