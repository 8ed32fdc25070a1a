"""The errors serving raises, in the reference's ``{code, message}``
envelope.

Counterpart of the part of ``llm_weighted_consensus_tpu/errors.py`` that
the serving path raises: ``StatusError`` (an error that knows its HTTP
status and JSON message), ``OverloadedError`` (503, a load shed, with a
retry hint), ``DeadlineExceededError`` (504, the request's deadline ran
out) and ``to_response_error``, which folds any exception into the
envelope and sends the detail of an unexpected one to the server log.
"""

from __future__ import annotations

import logging
from http import HTTPStatus
from typing import Optional

# every site that folds internal detail into the uniform envelope logs
# under this name
MASKING_LOGGER = "lwc.torch.serve"


def _status_phrase(code: int) -> str:
    try:
        return f"{code} {HTTPStatus(code).phrase}"
    except ValueError:
        return "unknown"


class ResponseError(Exception):
    """The wire form ``{"code": status, "message": json}``."""

    def __init__(self, code: int, message=None) -> None:
        super().__init__(f"{code}: {message}")
        self.code = int(code)
        self.message = message

    def to_json_obj(self) -> dict:
        return {"code": self.code, "message": self.message}


class StatusError(Exception):
    """Base of the errors that know their HTTP status and JSON message."""

    def status(self) -> int:
        return 500

    def message(self):
        return None

    def to_response_error(self) -> ResponseError:
        msg = self.message()
        if msg is None:
            msg = _status_phrase(self.status())
        return ResponseError(self.status(), msg)


def to_response_error(err) -> ResponseError:
    """The envelope of ``err``; an exception outside the taxonomy becomes
    a 500 whose detail goes to the log, never to the client."""
    if isinstance(err, ResponseError):
        return err
    if isinstance(err, StatusError):
        return err.to_response_error()
    logging.getLogger(MASKING_LOGGER).error(
        "unexpected error folded into response envelope",
        exc_info=err if isinstance(err, BaseException) else None,
    )
    return ResponseError(500, "internal error")


class OverloadedError(StatusError):
    """A load shed (503): the admission gate or the batcher's bounded
    queue refused the work.  ``shed_reason`` is what clients back off
    on."""

    def __init__(
        self, shed_reason: str, retry_after_ms: Optional[float] = None
    ) -> None:
        super().__init__(f"overloaded: {shed_reason}")
        self.shed_reason = shed_reason
        self.retry_after_ms = retry_after_ms

    def status(self) -> int:
        return 503

    def message(self):
        return {"kind": "overloaded", "shed_reason": self.shed_reason}


class ChatError(StatusError):
    """The reference's chat-client error family (its message shape)."""

    kind = "chat"

    def __init__(self, inner_kind: str, error, code: int = 500) -> None:
        super().__init__(f"{self.kind}/{inner_kind}: {error}")
        self.inner_kind = inner_kind
        self.error = error
        self.code = code

    def status(self) -> int:
        return self.code

    def message(self):
        return {
            "kind": "chat",
            "error": {"kind": self.inner_kind, "error": self.error},
        }


class DeadlineExceededError(ChatError):
    """The request's propagated deadline ran out (504)."""

    def __init__(self, detail: Optional[str] = None) -> None:
        message = "request deadline exceeded"
        if detail:
            message = f"{message}: {detail}"
        super().__init__("deadline_exceeded", message, 504)
