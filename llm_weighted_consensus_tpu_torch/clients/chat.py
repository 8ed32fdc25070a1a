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
machine has no ``aiohttp``.  With a ``resilience.ResiliencePolicy`` the
client is the reference's resilient one: each attempt passes its
upstream's circuit breaker (keyed ``api_base|model``; 4xx answers and an
expired deadline are not failures, and a cancelled half-open probe hands
its slot back), a hedge delay races a backup attempt against the next
endpoint (it spends the shared retry budget, and the loser is cancelled
and closed), and the ``resilience`` counters count rejections, hedges,
denials and ingest-cap trips.  ``resilience=None`` (the default) keeps
the pre-resilience path.  Traced, each attempt is a ``judge:attempt``
span (gate -> open -> first-chunk commit; a hedge's primary and backup
are sibling spans, the judge span carries ``hedge_launched`` /
``hedge_won``, the attempt its ``breaker_state``) and its upstream
request carries the W3C ``traceparent`` naming that span as the
upstream's parent.
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
    BreakerOpenError,
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
    or the connection's end.  ``max_body_bytes`` (the client's
    ``judge_stream_max_bytes``; 0 = no cap) bounds what a unary
    ``read_body`` holds: past it the rest is counted, not kept, and the
    read raises ``IngestCapError("unary_body", cap, full length)``, the
    error the client's own check after a full read gives."""

    def __init__(self, connect_timeout_ms: float = 30000.0,
                 max_body_bytes: int = 0) -> None:
        self.connect_timeout_ms = connect_timeout_ms
        self.max_body_bytes = int(max_body_bytes)

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
        except BaseException:
            # cancelled before the response exists (a hedge loser, a
            # quorum straggler): nothing else would close this socket
            _close_writer(writer)
            raise
        return _StdlibResponse(status, resp_headers, reader, writer,
                               self.max_body_bytes)


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
    def __init__(self, status, headers, reader, writer,
                 max_body_bytes: int = 0) -> None:
        self.status = status
        self._headers = headers
        self._reader = reader
        self._writer = writer
        self._max_body_bytes = max_body_bytes

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
        cap = self._max_body_bytes
        body, total, over = bytearray(), 0, False
        try:
            async for data in self.byte_stream():
                total += len(data)
                if cap and len(body) + len(data) > cap:
                    over = True  # the rest is counted, never held
                if not over:
                    body += data
        finally:
            await self.close()
        if over:
            raise IngestCapError("unary_body", cap, total)
        return bytes(body)

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
        resilience=None,
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
        # optional resilience.ResiliencePolicy: breakers, hedging, counters.
        # None (the default) preserves pre-resilience behavior exactly; the
        # ambient retry budget / deadline contextvars are still honored
        # because activating them is itself opt-in upstream.
        self.resilience = resilience
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
            for i, attempt in enumerate(attempts):
                result = await self._attempt_maybe_hedged(attempts, i, request)
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
                    self._inc("deadline_expired")
                    obs.annotate(deadline_expired="retry loop")
                    raise DeadlineExceededError("retry loop")
                # never sleep past the deadline: wake with whatever budget
                # is left and let the next attempt's clamped timeouts decide
                sleep = min(sleep, deadline.remaining())
            budget = current_retry_budget()
            if budget is not None and not budget.try_acquire():
                # the fan-out's shared retry budget is dry: fail this judge
                # over to its error path instead of joining a retry storm
                self._inc("retry_denied")
                obs.annotate(retry_denied=True)
                raise last_error if last_error is not None else EmptyStreamError()
            await asyncio.sleep(sleep)

    # -- resilience-aware attempt machinery ----------------------------------

    def _inc(self, name: str) -> None:
        if self.resilience is not None:
            self.resilience.inc(name)

    async def _attempt_maybe_hedged(self, attempts, i, request):
        """One slot of the attempt matrix; with hedging enabled, a backup
        against the next endpoint races the primary after the hedge delay
        (Dean & Barroso: the loser is cancelled, extra load is bounded by
        how rarely the delay fires)."""
        policy = self.resilience
        hedge = policy.hedge if policy is not None else None
        if hedge is None or not hedge.enabled or len(attempts) < 2:
            return await self._open_committed(attempts[i], request)
        delay_ms = hedge.delay_ms_effective()
        if delay_ms is None:
            # quantile-only config, reservoir still cold: no hedge yet
            return await self._open_committed(attempts[i], request)

        primary = asyncio.create_task(self._open_committed(attempts[i], request))
        backup = None
        try:
            delay = delay_ms / 1000.0
            deadline = current_deadline()
            if deadline is not None:
                delay = min(delay, deadline.remaining())
            done, _ = await asyncio.wait({primary}, timeout=delay)
            if primary in done:
                return primary.result()

            # a hedge is an extra attempt, so it spends the shared retry
            # budget: under a brown-out (exactly when hedge delays fire) a
            # dry budget disables hedging before it can double the load
            budget = current_retry_budget()
            if budget is not None and not budget.try_acquire():
                self._inc("hedge_denied")
                obs.annotate(hedge_denied=True)
                return await primary

            self._inc("hedge_launched")
            obs.annotate(
                hedge_launched=True,
                hedge_delay_ms=delay_ms,
                hedge=policy.hedge.explain(),
            )
            backup = asyncio.create_task(
                self._open_committed(attempts[(i + 1) % len(attempts)], request)
            )
            tasks = {primary, backup}
            last: Optional[ChatError] = None
            while tasks:
                done, tasks = await asyncio.wait(
                    tasks, return_when=asyncio.FIRST_COMPLETED
                )
                winner = None
                for task in done:
                    result = task.result()
                    if isinstance(result, ChatError):
                        last = result
                    elif winner is None:
                        winner = (task, result)
                    else:
                        # both committed in one wake-up: keep the first,
                        # close the duplicate stream
                        await _close_committed(result)
                if winner is not None:
                    if winner[0] is backup:
                        self._inc("hedge_won")
                        obs.annotate(hedge_won=True)
                    await _discard_attempts(tasks)
                    return winner[1]
            return last
        except BaseException:
            # cancellation (quorum early-exit, client disconnect) or an
            # unexpected task exception must not orphan the sibling attempt
            # or any committed upstream stream it holds
            await _discard_attempts({t for t in (primary, backup) if t is not None})
            raise

    async def _open_committed(self, attempt, request):
        """One attempt end to end: breaker gate, open, first-chunk peek.

        Returns ``(stream, api_base)`` on commit or the ``ChatError`` that
        felled it; the outcome lands on the attempt's breaker and a commit's
        first-chunk latency feeds the hedge tracker.

        The attempt span (child of the ambient judge span — hedged
        attempts run as tasks that inherit it, so primary and backup
        become sibling children) covers gate -> open -> first-chunk
        commit; its activation makes the outgoing ``traceparent`` name
        THIS attempt as the upstream's parent."""
        policy = self.resilience
        aspan = obs.child_span(
            "judge:attempt",
            api_base=attempt.api_base.api_base,
            model=attempt.model,
        )
        atoken = aspan.activate() if aspan is not None else None
        try:
            breaker = None
            if policy is not None and policy.breakers is not None:
                breaker = policy.breakers.get(
                    attempt.api_base.api_base, attempt.model
                )
                if aspan is not None:
                    aspan.annotate(breaker_state=breaker.describe())
                if not breaker.allow():
                    self._inc("breaker_rejected")
                    if aspan is not None:
                        aspan.annotate(breaker_rejected=True)
                        aspan.finish("error")
                    return BreakerOpenError(
                        attempt.api_base.api_base, attempt.model
                    )
            # allow() may have claimed a half-open probe slot; from here on
            # every exit must settle it — record an outcome, or release it
            # when the attempt is cancelled / ends without a verdict
            resolved = breaker is None
            try:
                # per-attempt clone: hedged attempts run concurrently and
                # must not race on the shared request's model field
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
                    if breaker is not None:
                        if _breaker_failure(first):
                            breaker.record_failure()
                        elif isinstance(first, DeadlineExceededError):
                            # our budget ran out before the upstream
                            # answered: neither success nor failure — the
                            # upstream's health was never actually probed
                            breaker.release_probe()
                        else:
                            breaker.record_success()
                        resolved = True
                    await stream.aclose()
                    if aspan is not None:
                        # attempt-level failures are routine (the retry
                        # loop may still commit): mark the span errored
                        # without forcing trace retention — that verdict
                        # belongs to the judge/request outcome
                        aspan.annotate(error=str(first))
                        aspan.finish("error")
                    return first
                if breaker is not None:
                    breaker.record_success()
                    resolved = True
                first_chunk_ms = (time.monotonic() - start) * 1000.0
                if policy is not None and policy.hedge is not None:
                    policy.hedge.observe(first_chunk_ms)
                if aspan is not None:
                    aspan.annotate(first_chunk_ms=round(first_chunk_ms, 3))
                return _prepend(first, stream), attempt.api_base
            finally:
                if not resolved:
                    breaker.release_probe()
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
                except IngestCapError as e:
                    # a transport that caps its own unary read
                    # (StdlibTransport's max_body_bytes)
                    self._inc("ingest_cap_tripped")
                    yield e
                    return
                if (
                    self.judge_stream_max_bytes
                    and len(raw) > self.judge_stream_max_bytes
                ):
                    # a hostile upstream can pad an error body too: the
                    # leg's byte budget caps the unary read, and the
                    # oversized body is dropped, not parsed
                    self._inc("ingest_cap_tripped")
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
                            self._inc("ingest_cap_tripped")
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
                            self._inc("ingest_cap_tripped")
                            yield IngestCapError(
                                "judge_stream",
                                self.judge_stream_max_bytes,
                                stream_bytes,
                            )
                            return
                        try:
                            pending.extend(parser.feed(data))
                        except IngestCapError as e:
                            self._inc("ingest_cap_tripped")
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


def _breaker_failure(err: ChatError) -> bool:
    """Upstream-health classification: transport failures, timeouts and
    5xx/429 count against the breaker; any other 4xx means the upstream is
    alive and answering (a bad request is our fault, not its health), and a
    deadline expiry is our budget running out, not the upstream's fault."""
    if isinstance(err, DeadlineExceededError):
        return False
    if isinstance(
        err,
        (TransportError, StreamTimeoutError, EmptyStreamError, IngestCapError),
    ):
        # an ingest-cap trip is the upstream misbehaving (giant lines,
        # newline-less floods, oversized bodies): it counts against the
        # upstream's health exactly like a transport failure
        return True
    if isinstance(err, BadStatusError):
        return err.code >= 500 or err.code == 429
    return False


async def _close_committed(result) -> None:
    """Close a committed (stream, api_base) that lost the hedge race."""
    stream = result[0]
    aclose = getattr(stream, "aclose", None)
    if aclose is not None:
        await aclose()


async def _discard_attempts(tasks) -> None:
    """Cancel in-flight hedge losers; close any that committed anyway."""
    for task in tasks:
        task.cancel()
    results = await asyncio.gather(*tasks, return_exceptions=True)
    for result in results:
        if isinstance(result, tuple):
            await _close_committed(result)


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
