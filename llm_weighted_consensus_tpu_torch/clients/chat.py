"""Resilient asyncio SSE client for OpenAI-compatible chat APIs.

Parity target: reference src/chat/completions/client.rs — ``DefaultClient``:

* per-request ``CtxHandler`` hook that can rewrite the endpoint list
  (client.rs:26-54);
* archived-completion prefetch + message rehydration (client.rs:211-222,
  437-645 — implemented in ``archive``);
* forced streaming with ``include_usage`` when the caller wanted unary
  (client.rs:230-236);
* attempt matrix: primary model x every api_base, then each fallback model x
  every api_base (client.rs:238-258);
* retry under exponential backoff with first-chunk peek: a stream only
  commits once its first chunk arrives (client.rs:263-304);
* SSE decode with two-tier timeouts (first vs other chunk), ``[DONE]``
  handling, OpenRouter error-shape fallback, JSON-path deserialization
  errors, bad-status body capture (client.rs:334-434).

Streams yield a union: ``ChatCompletionChunk`` items interleaved with
``ChatError`` items (the reference's ``Result`` stream).  A yielded error
does not necessarily end the stream — a malformed chunk yields an error and
decoding continues — matching the reference exactly; consumers decide.

Transport is a seam (``Transport``) so tests script byte streams without
sockets.

The port's copy of ``llm_weighted_consensus_tpu/clients/chat.py``.  Its
real transport is ``StdlibTransport`` (HTTP/1.1 over
``asyncio.open_connection``, ``ssl`` for https, chunked decoding, a connect
timeout) in place of the reference's ``AiohttpTransport``: the card's
machine has no ``aiohttp``.  The client is the reference's with
``resilience=None`` (its default): breakers, hedging and fault injection
wait for their slice; ``_open_committed`` is the seam where they go.
Traced, each attempt is a ``judge:attempt`` span (gate -> open ->
first-chunk commit) and its upstream request carries the W3C
``traceparent`` naming that span as the upstream's parent.
"""

from __future__ import annotations

import asyncio
import random
import ssl
import time
from dataclasses import dataclass
from typing import AsyncIterator, Optional
from urllib.parse import urlsplit

from .. import archive as archive_mod
from .. import obs
from ..errors import (
    BadStatusError,
    ChatError,
    CtxHandlerError,
    DeadlineExceededError,
    DeserializationError,
    EmptyStreamError,
    IngestCapError,
    ProviderError,
    ResponseError,
    StreamTimeoutError,
    TransportError,
)
from ..resilience.budget import current_retry_budget
from ..resilience.deadline import current_deadline
from ..types.base import SchemaError, fold_chunks
from ..types.chat_request import ChatCompletionCreateParams, StreamOptions
from ..types.chat_response import ChatCompletion, ChatCompletionChunk
from ..utils import jsonutil
from .sse import make_parser

DONE_FRAME = "[DONE]"


@dataclass
class ApiBase:
    """One upstream endpoint (client.rs:13-17)."""

    api_base: str
    api_key: str

    @classmethod
    def from_json_obj(cls, obj: dict) -> "ApiBase":
        return cls(api_base=obj["api_base"], api_key=obj["api_key"])


@dataclass
class BackoffPolicy:
    """Exponential backoff (reference uses the ``backoff`` crate; defaults
    from main.rs:5-16)."""

    initial_interval_ms: float = 100.0
    randomization_factor: float = 0.5
    multiplier: float = 1.5
    max_interval_ms: float = 1000.0
    max_elapsed_ms: Optional[float] = 40000.0

    def sleeps(self, rng: Optional[random.Random] = None):
        """Yield sleep durations (seconds); stops when max_elapsed exceeded.

        ``max_elapsed`` caps *wall-clock since the first attempt* (attempt
        time included), matching the backoff crate's max_elapsed_time.
        """
        rng = rng or random
        interval = self.initial_interval_ms
        start = time.monotonic()
        while True:
            jittered = interval * (
                1 + self.randomization_factor * (2 * rng.random() - 1)
            )
            if self.max_elapsed_ms is not None:
                elapsed_ms = (time.monotonic() - start) * 1000.0
                if elapsed_ms + jittered > self.max_elapsed_ms:
                    return
            yield jittered / 1000.0
            interval = min(interval * self.multiplier, self.max_interval_ms)


class CtxHandler:
    """Per-request auth/routing hook (client.rs:26-54).

    ``handle`` may rewrite the endpoint list per request context; raising
    :class:`ResponseError` aborts the request as a ctx error.
    """

    async def handle(self, ctx, api_bases: list) -> list:
        return api_bases


# ---------------------------------------------------------------------------
# Transport seam
# ---------------------------------------------------------------------------


class TransportResponse:
    status: int = 0

    async def read_body(self) -> bytes:
        raise NotImplementedError

    def byte_stream(self) -> AsyncIterator[bytes]:
        raise NotImplementedError

    async def close(self) -> None:
        pass


class Transport:
    async def post_sse(
        self, url: str, headers: dict, body: bytes
    ) -> TransportResponse:
        raise NotImplementedError

    async def close(self) -> None:
        pass


class StdlibTransport(Transport):
    """HTTP/1.1 over ``asyncio.open_connection`` (``ssl`` for https): one
    connection per request, closed with its response.  ``connect_timeout_ms``
    bounds the TCP (and TLS) connect and the wait for the status line and
    headers, the reference's ``sock_connect``; the body is bounded by the
    client's own per-chunk timeouts.  Bodies come as they arrive,
    ``transfer-encoding: chunked`` decoded, else up to ``content-length``
    or the connection's end."""

    def __init__(self, connect_timeout_ms: float = 30000.0) -> None:
        self.connect_timeout_ms = connect_timeout_ms

    async def post_sse(self, url, headers, body) -> TransportResponse:
        parts = urlsplit(url)
        https = parts.scheme == "https"
        if parts.scheme not in ("http", "https") or not parts.hostname:
            raise TransportError(f"unsupported upstream url: {url}")
        port = parts.port or (443 if https else 80)
        target = parts.path or "/"
        if parts.query:
            target += "?" + parts.query
        host = parts.hostname if parts.port is None else parts.netloc
        lines = [
            f"POST {target} HTTP/1.1",
            f"host: {host}",
            "content-type: application/json",
            f"content-length: {len(body)}",
            "connection: close",
        ]
        lines += [
            f"{name}: {value}" for name, value in headers.items()
            if name.lower() not in ("host", "content-length", "content-type",
                                    "connection")
        ]
        head = ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")
        timeout = self.connect_timeout_ms / 1000.0
        writer = None
        try:
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(
                    parts.hostname, port,
                    ssl=ssl.create_default_context() if https else None,
                ),
                timeout,
            )
            writer.write(head + body)
            await writer.drain()
            status, resp_headers = await asyncio.wait_for(
                _read_head(reader), timeout
            )
        except asyncio.TimeoutError as e:
            _close_writer(writer)
            raise TransportError("connect timeout") from e
        except (OSError, ValueError, asyncio.IncompleteReadError) as e:
            _close_writer(writer)
            raise TransportError(str(e) or type(e).__name__) from e
        return _StdlibResponse(status, resp_headers, reader, writer)


async def _read_head(reader) -> tuple:
    """The status code and the lower-cased headers of a response."""
    line = await reader.readline()
    fields = line.decode("latin-1").split()
    if len(fields) < 2 or not fields[0].startswith("HTTP/"):
        raise ValueError(f"malformed status line {line[:80]!r}")
    status = int(fields[1])
    headers = {}
    while True:
        line = await reader.readline()
        if line in (b"\r\n", b"\n", b""):
            return status, headers
        name, _, value = line.decode("latin-1").partition(":")
        headers[name.strip().lower()] = value.strip()


def _close_writer(writer) -> None:
    if writer is not None:
        writer.close()


class _StdlibResponse(TransportResponse):
    def __init__(self, status, headers, reader, writer) -> None:
        self.status = status
        self._headers = headers
        self._reader = reader
        self._writer = writer

    async def byte_stream(self):
        reader = self._reader
        if "chunked" in self._headers.get("transfer-encoding", "").lower():
            while True:
                size_line = await reader.readline()
                if not size_line:
                    return  # the connection ended mid-body
                size = int(size_line.split(b";", 1)[0].strip() or b"0", 16)
                if size == 0:
                    return
                data = await reader.readexactly(size)
                await reader.readexactly(2)  # the chunk's CRLF
                yield data
        length = self._headers.get("content-length")
        if length is not None:
            left = int(length)
            while left > 0:
                data = await reader.read(min(left, 65536))
                if not data:
                    return
                left -= len(data)
                yield data
            return
        while True:
            data = await reader.read(65536)
            if not data:
                return
            yield data

    async def read_body(self) -> bytes:
        parts = []
        try:
            async for data in self.byte_stream():
                parts.append(data)
        finally:
            await self.close()
        return b"".join(parts)

    async def close(self) -> None:
        writer, self._writer = self._writer, None
        if writer is not None:
            writer.close()
            try:
                await writer.wait_closed()
            except OSError:
                pass


# ---------------------------------------------------------------------------
# The client
# ---------------------------------------------------------------------------


@dataclass
class _Attempt:
    api_base: ApiBase
    model: str


class ChatClient:
    """Abstract client interface (client.rs:56-79): the consensus engine and
    the gateway depend on this, not on the HTTP implementation."""

    async def create_streaming(self, ctx, params: ChatCompletionCreateParams):
        raise NotImplementedError

    async def create_unary(self, ctx, params) -> ChatCompletion:
        stream = await self.create_streaming(ctx, params)
        chunks = []
        try:
            async for item in stream:
                if isinstance(item, ChatError):
                    raise item
                chunks.append(item)
        finally:
            aclose = getattr(stream, "aclose", None)
            if aclose is not None:
                await aclose()
        aggregate = fold_chunks(chunks)
        if aggregate is None:
            raise EmptyStreamError()
        return ChatCompletion.from_streaming(aggregate)


class DefaultChatClient(ChatClient):
    def __init__(
        self,
        transport: Transport,
        api_bases: list,
        *,
        backoff: Optional[BackoffPolicy] = None,
        user_agent: Optional[str] = None,
        x_title: Optional[str] = None,
        referer: Optional[str] = None,
        first_chunk_timeout_ms: float = 10000.0,
        other_chunk_timeout_ms: float = 60000.0,
        ctx_handler: Optional[CtxHandler] = None,
        archive_fetcher: Optional[archive_mod.Fetcher] = None,
        judge_stream_max_bytes: int = 0,
        sse_max_event_bytes: int = 0,
    ) -> None:
        self.transport = transport
        self.api_bases = list(api_bases)
        self.backoff = backoff or BackoffPolicy()
        self.user_agent = user_agent
        self.x_title = x_title
        self.referer = referer
        self.first_chunk_timeout_ms = first_chunk_timeout_ms
        self.other_chunk_timeout_ms = other_chunk_timeout_ms
        self.ctx_handler = ctx_handler or CtxHandler()
        self.archive_fetcher = archive_fetcher or archive_mod.UnimplementedFetcher()
        # the ambient retry budget / deadline contextvars are honored
        # (activating them is opt-in upstream); breakers and hedging wait.
        # Ingest byte budgets (0 = uncapped, the library-level
        # default — the serving config turns them on): the cumulative
        # per-leg stream budget doubles as the bad-status/unary body cap,
        # and the SSE event cap also bounds the parser's newline-less
        # residue (a line cannot be longer than the event it would form)
        self.judge_stream_max_bytes = int(judge_stream_max_bytes)
        self.sse_max_event_bytes = int(sse_max_event_bytes)
        # compile/load the native SSE parser NOW (sync startup context) so
        # make_parser() inside the async decode loop never blocks the loop
        # on a g++ run
        from .sse import load_native_library

        load_native_library()

    # -- public API ---------------------------------------------------------

    async def create_streaming(self, ctx, params):
        stream, _api_base = await self.create_streaming_return_api_base(ctx, params)
        return stream

    async def create_streaming_return_api_base(self, ctx, params):
        """Returns (stream, api_base_used); raises ChatError when every
        attempt fails for the whole backoff budget (client.rs:193-306)."""
        # concurrently: ctx hook + archive prefetch
        async def _handle_ctx():
            try:
                return await self.ctx_handler.handle(ctx, list(self.api_bases))
            except ResponseError as e:
                raise CtxHandlerError(e) from e

        # join with cancellation (tokio::try_join! semantics): first failure
        # cancels the sibling so an aborted request does no stray archive IO
        api_bases, completions = await _try_join(
            _handle_ctx(),
            archive_mod.fetch_archived_for_messages(
                self.archive_fetcher, ctx, params.messages
            ),
        )

        request = params.clone()
        request.messages = archive_mod.replace_archive_messages(
            completions, request.messages
        )

        # force streaming (+usage when the caller wanted unary)
        if not request.stream:
            request.stream_options = StreamOptions(include_usage=True)
        request.stream = True

        # attempt matrix: primary model x ctx api_bases, then each fallback
        # model x the configured api_bases (client.rs:238-258)
        attempts = [_Attempt(ab, request.model) for ab in api_bases]
        if request.models:
            for model in request.models:
                attempts.extend(_Attempt(ab, model) for ab in self.api_bases)
            request.models = None
        if not attempts:
            raise TransportError("no api endpoints to attempt", 500)

        last_error: Optional[ChatError] = None
        sleeps = self.backoff.sleeps()
        while True:
            for attempt in attempts:
                result = await self._open_committed(attempt, request)
                if isinstance(result, ChatError):
                    last_error = result
                    continue
                return result
            sleep = next(sleeps, None)
            if sleep is None:
                raise last_error if last_error is not None else EmptyStreamError()
            deadline = current_deadline()
            if deadline is not None:
                if deadline.expired():
                    obs.annotate(deadline_expired="retry loop")
                    raise DeadlineExceededError("retry loop")
                # never sleep past the deadline: wake with whatever budget
                # is left and let the next attempt's clamped timeouts decide
                sleep = min(sleep, deadline.remaining())
            budget = current_retry_budget()
            if budget is not None and not budget.try_acquire():
                # the fan-out's shared retry budget is dry: fail this judge
                # over to its error path instead of joining a retry storm
                obs.annotate(retry_denied=True)
                raise last_error if last_error is not None else EmptyStreamError()
            await asyncio.sleep(sleep)

    # -- one attempt ---------------------------------------------------------

    async def _open_committed(self, attempt, request):
        """One attempt end to end: open, first-chunk peek.  Returns
        ``(stream, api_base)`` on commit or the ``ChatError`` that felled
        it (the reference's ``_open_committed`` with no resilience
        policy).

        The attempt span (a child of the ambient judge span) covers open
        -> first-chunk commit; its activation makes the outgoing
        ``traceparent`` name THIS attempt as the upstream's parent."""
        aspan = obs.child_span(
            "judge:attempt",
            api_base=attempt.api_base.api_base,
            model=attempt.model,
        )
        atoken = aspan.activate() if aspan is not None else None
        try:
            req = request.clone()
            req.model = attempt.model
            start = time.monotonic()
            stream = self._open_event_stream(attempt.api_base, req)
            # first-chunk peek: commit only on a good first chunk
            try:
                first = await stream.__anext__()
            except StopAsyncIteration:
                first = EmptyStreamError()
            if isinstance(first, ChatError):
                await stream.aclose()
                if aspan is not None:
                    # attempt-level failures are routine (the retry loop
                    # may still commit): mark the span errored without
                    # forcing trace retention
                    aspan.annotate(error=str(first))
                    aspan.finish("error")
                return first
            if aspan is not None:
                aspan.annotate(first_chunk_ms=round(
                    (time.monotonic() - start) * 1000.0, 3))
            return _prepend(first, stream), attempt.api_base
        finally:
            if aspan is not None:
                obs.Span.deactivate(atoken)
                aspan.finish()

    # -- stream machinery ---------------------------------------------------

    def _headers(self, api_base: ApiBase) -> dict:
        headers = {
            "authorization": f"Bearer {api_base.api_key}",
            "accept": "text/event-stream",
        }
        if self.user_agent:
            headers["user-agent"] = self.user_agent
        if self.x_title:
            headers["x-title"] = self.x_title
        if self.referer:
            headers["referer"] = self.referer
            headers["http-referer"] = self.referer
        # W3C traceparent: the ambient span (the attempt span, when one
        # is active) becomes the upstream's parent; no-op untraced
        obs.inject(headers)
        return headers

    async def _open_event_stream(self, api_base: ApiBase, request):
        """Async generator yielding ChatCompletionChunk | ChatError items.

        Mirrors create_streaming_stream (client.rs:334-434).  Decode errors
        for individual frames yield an error item and keep going; transport
        errors, bad statuses and timeouts yield an error item and stop.
        """
        url = f"{api_base.api_base.rstrip('/')}/chat/completions"
        body = jsonutil.dumps(request.to_json_obj()).encode("utf-8")
        # propagated per-request deadline (None unless the gateway set one):
        # every wait below is clamped to its remaining budget
        deadline = current_deadline()
        try:
            resp = await self.transport.post_sse(url, self._headers(api_base), body)
        except ChatError as e:
            yield e
            return
        except Exception as e:
            yield TransportError(str(e))
            return

        byte_iter = None
        try:
            if not (200 <= resp.status < 300):
                started = time.monotonic()
                try:
                    raw = await asyncio.wait_for(
                        resp.read_body(),
                        _clamp(self.first_chunk_timeout_ms, deadline),
                    )
                except asyncio.TimeoutError:
                    yield _timeout_error("first_chunk", started, deadline)
                    return
                if (
                    self.judge_stream_max_bytes
                    and len(raw) > self.judge_stream_max_bytes
                ):
                    # a hostile upstream can pad an error body too: the
                    # leg's byte budget caps the unary read, and the
                    # oversized body is dropped, not parsed
                    yield IngestCapError(
                        "unary_body", self.judge_stream_max_bytes, len(raw)
                    )
                    return
                try:
                    parsed = jsonutil.loads(raw.decode("utf-8", errors="replace"))
                except Exception:
                    parsed = raw.decode("utf-8", errors="replace")
                yield BadStatusError(resp.status, parsed)
                return

            # native C++ parser when built (hot loop #1), Python fallback;
            # the event cap bounds both one event's data payload and the
            # newline-less residue (giant_line / newline_less_flood)
            parser = make_parser(
                max_buffer_bytes=self.sse_max_event_bytes,
                max_event_bytes=self.sse_max_event_bytes,
            )
            byte_iter = resp.byte_stream().__aiter__()
            first = True
            stream_bytes = 0
            pending: list = []
            while True:
                # per-chunk timeout tiers (client.rs:334-354; defaults
                # main.rs:17-20)
                if not pending:
                    tier = "first_chunk" if first else "other_chunk"
                    timeout = _clamp(
                        self.first_chunk_timeout_ms
                        if first
                        else self.other_chunk_timeout_ms,
                        deadline,
                    )
                    started = time.monotonic()
                    try:
                        data = await asyncio.wait_for(
                            byte_iter.__anext__(), timeout
                        )
                    except StopAsyncIteration:
                        try:
                            tail = parser.flush()
                        except IngestCapError as e:
                            yield e
                            return
                        if tail is not None and tail != DONE_FRAME:
                            pending.append(tail)
                        if not pending:
                            return
                        data = None
                    except asyncio.TimeoutError:
                        yield _timeout_error(tier, started, deadline)
                        return
                    except Exception as e:
                        yield TransportError(str(e))
                        return
                    if data is not None:
                        # cumulative leg budget (JUDGE_STREAM_MAX_BYTES):
                        # checked before the parser sees the chunk so a
                        # flood is dropped, not buffered
                        stream_bytes += len(data)
                        if (
                            self.judge_stream_max_bytes
                            and stream_bytes > self.judge_stream_max_bytes
                        ):
                            yield IngestCapError(
                                "judge_stream",
                                self.judge_stream_max_bytes,
                                stream_bytes,
                            )
                            return
                        try:
                            pending.extend(parser.feed(data))
                        except IngestCapError as e:
                            yield e
                            return
                        continue
                event = pending.pop(0)
                first = False
                if event == DONE_FRAME:
                    # annotates the ambient judge span (this generator
                    # body runs in the judge's pump task)
                    obs.annotate(sse_events=parser.events_parsed)
                    return
                if not event or event.startswith(":"):
                    continue
                item = self._decode_chunk(event)
                yield item
        finally:
            # a [DONE] frame exits before the byte stream is exhausted:
            # close it rather than leave a suspended generator to the GC
            aclose = getattr(byte_iter, "aclose", None)
            if aclose is not None:
                await aclose()
            await resp.close()

    @staticmethod
    def _decode_chunk(data: str):
        try:
            obj = jsonutil.loads(data)
        except Exception as e:
            return DeserializationError(f"invalid JSON: {e}")
        try:
            chunk = ChatCompletionChunk.from_json_obj(obj)
            chunk.with_total_cost()
            return chunk
        except SchemaError as e:
            # OpenRouter provider-error passthrough (error.rs:99-141)
            if isinstance(obj, dict) and isinstance(obj.get("error"), dict):
                inner = obj["error"]
                return ProviderError(
                    code=inner.get("code"),
                    message=inner.get("message"),
                    metadata=inner.get("metadata"),
                    user_id=obj.get("user_id"),
                )
            return DeserializationError(str(e))


def _clamp(timeout_ms: float, deadline) -> float:
    """A tier timeout clamped to the remaining request deadline."""
    timeout = timeout_ms / 1000.0
    if deadline is not None:
        timeout = min(timeout, deadline.remaining())
    return timeout


def _timeout_error(tier: str, started: float, deadline) -> ChatError:
    """TimeoutError -> taxonomy: the deadline expiring is reported as such
    (it is this request's budget, not the upstream's slowness)."""
    if deadline is not None and deadline.expired():
        return DeadlineExceededError(f"{tier} wait")
    return StreamTimeoutError(tier, (time.monotonic() - started) * 1000.0)


async def _try_join(*coros):
    """asyncio.gather with sibling cancellation on first failure."""
    tasks = [asyncio.ensure_future(c) for c in coros]
    try:
        return await asyncio.gather(*tasks)
    except BaseException:
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        raise


async def _prepend(first, rest):
    """StreamOnce(first).chain(rest) (util.rs:33-53, client.rs:281-302)."""
    yield first
    async for item in rest:
        yield item
