"""The error taxonomy, in the reference's ``{code, message}`` envelope.

The port's copy of ``llm_weighted_consensus_tpu/errors.py``: ``StatusError``
(an error that knows its HTTP status and JSON message), ``OverloadedError``
(503, a load shed, with a retry hint), the chat client's errors
(``ChatError`` and its kinds, ``DeadlineExceededError`` 504 among them,
``IngestCapError`` 502 for the byte caps and ``BreakerOpenError`` 503 for
an attempt an open circuit breaker refused), the score engine's errors
(``ScoreChatError``, ``FetchModelError``, ``FetchModelWeightsError``,
``InvalidContentError``, ``AllVotesFailed``, ...), and ``to_response_error``, which folds any
exception into the envelope and sends the detail of an unexpected one to
the server log.  ``ResponseError`` is the wire type of
``types/base.py``.  ``with_trace_id`` stamps the traced request's id on an
error envelope.
"""

from __future__ import annotations

import logging
from http import HTTPStatus
from typing import Optional

from .types.base import ResponseError  # noqa: F401  (canonical home: type core)

# every site that folds internal detail into the uniform envelope logs
# under this name
MASKING_LOGGER = "lwc.torch.serve"


def with_trace_id(envelope: dict) -> dict:
    """Stamp the ambient request's trace id onto an error envelope (the
    ``{code, message}`` dict or a mid-stream SSE error frame) so a
    client holding a failure can hand the operator the exact trace.
    No-op (and allocation-free) when tracing is off or inactive."""
    from .obs.span import current_trace_id

    trace_id = current_trace_id()
    if trace_id is not None:
        envelope["trace_id"] = trace_id
    return envelope


def _status_phrase(code: int) -> str:
    try:
        return f"{code} {HTTPStatus(code).phrase}"
    except ValueError:
        return "unknown"


class StatusError(Exception):
    """Base for rich errors that know their HTTP status + JSON message."""

    def status(self) -> int:
        return 500

    def message(self):
        return None

    def to_response_error(self) -> ResponseError:
        msg = self.message()
        if msg is None:
            msg = _status_phrase(self.status())
        return ResponseError(code=self.status(), message=msg)


def to_response_error(err) -> ResponseError:
    if isinstance(err, ResponseError):
        return err
    if isinstance(err, StatusError):
        return err.to_response_error()
    # Unexpected (non-taxonomy) exception reaching a client-visible
    # surface — mid-stream SSE error frames, per-judge error choices:
    # uniform envelope only, detail to the server log (the reference's
    # envelope, src/error.rs:8-13, never echoes internals; neither do we).
    logging.getLogger(MASKING_LOGGER).error(
        "unexpected error folded into response envelope",
        exc_info=err if isinstance(err, BaseException) else None,
    )
    return ResponseError(code=500, message="internal error")


class OverloadedError(StatusError):
    """Load shed (503): the gateway's admission gate or the device
    batcher's bounded queue refused the work.  ``shed_reason`` is the
    machine-readable discriminator clients back off on (the gateway
    middleware renders the same body shape plus a ``Retry-After``
    header — resilience/admission.py)."""

    def __init__(
        self,
        shed_reason: str,
        retry_after_ms: Optional[float] = None,
    ):
        super().__init__(f"overloaded: {shed_reason}")
        self.shed_reason = shed_reason
        self.retry_after_ms = retry_after_ms

    def status(self) -> int:
        return 503

    def message(self):
        return {"kind": "overloaded", "shed_reason": self.shed_reason}


# ---------------------------------------------------------------------------
# Chat client errors (reference src/chat/completions/error.rs)
# ---------------------------------------------------------------------------


class ChatError(StatusError):
    kind = "chat"

    def __init__(self, inner_kind: str, error, code: int = 500):
        super().__init__(f"{self.kind}/{inner_kind}: {error}")
        self.inner_kind = inner_kind
        self.error = error
        self.code = code

    def status(self) -> int:
        return self.code

    def message(self):
        return {"kind": "chat", "error": {"kind": self.inner_kind, "error": self.error}}


class TransportError(ChatError):
    def __init__(self, error: str, code: int = 500):
        super().__init__("transport", error, code)


class EmptyStreamError(ChatError):
    def __init__(self):
        super().__init__("empty_stream", "received an empty stream", 500)


class DeserializationError(ChatError):
    def __init__(self, error: str):
        super().__init__("deserialization", error, 500)


class BadStatusError(ChatError):
    def __init__(self, code: int, body):
        super().__init__("bad_status", body, code)


class StreamTimeoutError(ChatError):
    """Per-chunk stream timeout; records which tier fired and how long it
    actually waited (``tier`` is ``"first_chunk"`` or ``"other_chunk"``).
    The argless form keeps the reference's constant message."""

    def __init__(
        self,
        tier: Optional[str] = None,
        elapsed_ms: Optional[float] = None,
    ):
        if tier is None:
            message = "error fetching stream: timeout"
        elif elapsed_ms is None:
            message = f"error fetching stream: {tier} timeout"
        else:
            message = (
                f"error fetching stream: {tier} timeout after {elapsed_ms:.0f}ms"
            )
        super().__init__("stream_timeout", message, 500)
        self.tier = tier
        self.elapsed_ms = elapsed_ms


class IngestCapError(ChatError):
    """A byte-budget cap tripped while ingesting upstream bytes.

    ``what`` names the tripped budget: ``sse_buffer`` (newline-less
    residue in the SSE parser), ``sse_event`` (one event's accumulated
    ``data:`` payload), ``judge_stream`` (a judge leg's cumulative
    stream budget, JUDGE_STREAM_MAX_BYTES) or ``unary_body`` (a
    non-streaming body read).  502: the upstream is misbehaving, not
    us — and like any upstream failure the trip counts against that
    upstream's breaker (clients/chat.py ``_breaker_failure``)."""

    def __init__(self, what: str, limit_bytes: int, observed_bytes: int):
        super().__init__(
            "ingest_cap",
            (
                f"{what} exceeded {limit_bytes} bytes "
                f"(observed {observed_bytes})"
            ),
            502,
        )
        self.what = what
        self.limit_bytes = limit_bytes
        self.observed_bytes = observed_bytes


class BreakerOpenError(ChatError):
    """Attempt refused locally: the upstream's circuit breaker is open."""

    def __init__(self, api_base: str, model: str):
        super().__init__(
            "breaker_open",
            f"circuit breaker open for {api_base}|{model}",
            503,
        )
        self.api_base = api_base
        self.model = model


class DeadlineExceededError(ChatError):
    """The request's propagated deadline ran out mid-attempt."""

    def __init__(self, detail: Optional[str] = None):
        message = "request deadline exceeded"
        if detail:
            message = f"{message}: {detail}"
        super().__init__("deadline_exceeded", message, 504)


class CtxHandlerError(ChatError):
    def __init__(self, inner: ResponseError):
        super().__init__("ctx", inner.message, inner.code)

    def message(self):
        return self.error


class ArchiveFetchError(ChatError):
    def __init__(self, inner: ResponseError):
        super().__init__("completions_archive", inner.message, inner.code)

    def message(self):
        return self.error


class InvalidCompletionChoiceIndex(ChatError):
    def __init__(self, completion_id: str, choice_index: int):
        super().__init__(
            "invalid_completion_choice_index",
            f"invalid choice_index for completion {completion_id}: {choice_index}",
            400,
        )
        self.completion_id = completion_id
        self.choice_index = choice_index


class ProviderError(ChatError):
    """OpenRouter mid-stream provider error shape (error.rs:99-141)."""

    def __init__(self, code: Optional[int], message, metadata=None, user_id=None):
        self.provider_code = code
        self.provider_message = message
        self.metadata = metadata
        self.user_id = user_id
        super().__init__("provider", message, code if code is not None else 500)

    def message(self):
        return {
            "kind": "provider",
            "message": self.provider_message,
            "metadata": self.metadata,
        }


# ---------------------------------------------------------------------------
# Score / consensus errors (reference src/score/completions/error.rs)
# ---------------------------------------------------------------------------


class ScoreError(StatusError):
    def __init__(self, inner_kind: str, error, code: int = 500):
        super().__init__(f"score/{inner_kind}: {error}")
        self.inner_kind = inner_kind
        self.error = error
        self.code = code

    def status(self) -> int:
        return self.code

    def message(self):
        return {
            "kind": "score",
            "error": {"kind": self.inner_kind, "error": self.error},
        }


class FetchModelError(ScoreError):
    def __init__(self, inner: ResponseError):
        super().__init__("fetch_model", inner.message, inner.code)

    def message(self):
        return {"kind": "score", "error": self.error}


class FetchModelWeightsError(ScoreError):
    def __init__(self, inner: ResponseError):
        super().__init__("fetch_model_weights", inner.message, inner.code)

    def message(self):
        return {"kind": "score", "error": self.error}


class InvalidModelError(ScoreError):
    def __init__(self, error: str):
        super().__init__("invalid_model", error, 400)


class ExpectedTwoOrMoreChoices(ScoreError):
    def __init__(self, got: int):
        super().__init__(
            "expected_two_or_more_choices",
            f"expected 2 or more provided choices but got {got}",
            400,
        )


class InvalidContentError(ScoreError):
    """No parseable ballot key in a judge's output.

    ``detail`` refines the diagnostic for logs; the wire message stays the
    reference's fixed string (score/completions/error.rs:12-13).
    """

    def __init__(self, detail: Optional[str] = None):
        super().__init__("invalid_content", "expected a valid response key", 500)
        self.detail = detail


class AllVotesFailed(ScoreError):
    def __init__(self, code: Optional[int]):
        super().__init__(
            "all_votes_failed",
            "all votes failed, see choices for further details",
            code if code is not None else 500,
        )


class ScoreArchiveError(ScoreError):
    def __init__(self, inner: ResponseError):
        super().__init__("completions_archive", inner.message, inner.code)

    def message(self):
        return {"kind": "score", "error": self.error}


class ScoreChatError(ScoreError):
    """Chat error surfaced through the score endpoint (transparent wrap)."""

    def __init__(self, chat_error: ChatError):
        self.chat_error = chat_error
        super().__init__("chat", str(chat_error), chat_error.status())

    def message(self):
        return {"kind": "score", "error": self.chat_error.message()}


class ScoreInvalidCompletionChoiceIndex(ScoreError):
    def __init__(self, completion_id: str, choice_index: int):
        super().__init__(
            "invalid_completion_choice_index",
            f"invalid choice_index for completion {completion_id}: {choice_index}",
            400,
        )
