"""Multichat completion response types — one request, many models.

Parity target: reference src/multichat/completions/response.rs (229 LoC) —
chat-completion-shaped responses whose choices each carry ``error`` /
``model`` / ``model_index`` / ``completion_metadata``.  Types-only in the
reference; this framework implements the actual fan-out client
(clients/multichat.py).
"""

from __future__ import annotations

from typing import Optional

from .base import ResponseError
from .base import Const, KEEP, KEYED, List, Map, NESTED, Struct, field
from .chat_response import (
    Delta,
    FINISH_REASON,
    FINISH_REASON_DEFAULT,
    Logprobs,
    Message,
    Usage,
)
from .score_response import CompletionMetadata


class StreamingChoice(Struct):
    delta: Delta = field(Delta, default_factory=Delta, merge=NESTED)
    finish_reason: Optional[str] = field(FINISH_REASON, default=None, skip_if_none=False)
    index: int = field(int, default=0, merge=KEEP, skip_if_none=False)
    logprobs: Optional[Logprobs] = field(Logprobs, default=None, merge=NESTED)
    # custom fields
    error: Optional[ResponseError] = field(ResponseError, default=None)
    model: Optional[str] = field(str, default=None)
    model_index: Optional[int] = field(int, default=None)
    completion_metadata: Optional[CompletionMetadata] = field(
        CompletionMetadata, default=None, merge=NESTED
    )

    def has_finish_reason_or_usage(self) -> bool:
        return self.finish_reason is not None or (
            self.completion_metadata is not None
            and self.completion_metadata.usage is not None
        )


class ChatCompletionChunk(Struct):
    id: str = field(str, merge=KEEP)
    choices: list = field(
        List(StreamingChoice), default_factory=list, merge=KEYED,
        skip_if_none=False, required=True
    )
    created: int = field(int, default=0, merge=KEEP, skip_if_none=False, required=True)
    model: str = field(str, default="", merge=KEEP, skip_if_none=False, required=True)
    object: str = field(
        Const("chat.completion.chunk"), default="chat.completion.chunk", merge=KEEP
    )
    usage: Optional[Usage] = field(Usage, default=None, merge=NESTED)

    def clone_without_choices(self) -> "ChatCompletionChunk":
        clone = self.clone()
        clone.choices = []
        return clone


class UnaryChoice(Struct):
    message: Message = field(Message)
    finish_reason: str = field(
        FINISH_REASON, default=FINISH_REASON_DEFAULT, skip_if_none=False
    )
    index: int = field(int, default=0, skip_if_none=False)
    logprobs: Optional[Logprobs] = field(Logprobs, default=None, skip_if_none=False)
    # custom fields
    error: Optional[ResponseError] = field(ResponseError, default=None, skip_if_none=False)
    model: Optional[str] = field(str, default=None, skip_if_none=False)
    model_index: Optional[int] = field(int, default=None, skip_if_none=False)
    completion_metadata: Optional[CompletionMetadata] = field(
        CompletionMetadata, default=None, skip_if_none=False
    )

    @classmethod
    def from_streaming(cls, choice: StreamingChoice) -> "UnaryChoice":
        return cls(
            message=Message.from_delta(choice.delta),
            finish_reason=choice.finish_reason or FINISH_REASON_DEFAULT,
            index=choice.index,
            logprobs=choice.logprobs,
            error=choice.error,
            model=choice.model,
            model_index=choice.model_index,
            completion_metadata=choice.completion_metadata,
        )


class ChatCompletion(Struct):
    id: str = field(str, default="")
    choices: list = field(List(UnaryChoice), default_factory=list, skip_if_none=False)
    created: int = field(int, default=0, skip_if_none=False)
    model: str = field(str, default="", skip_if_none=False)
    object: str = field(Const("chat.completion"), default="chat.completion")
    usage: Optional[Usage] = field(Usage, default=None)
    # wire extension (no reference analog — the reference has no multichat
    # client): the unary view of the streaming ``multichat.consensus``
    # frames, {slot: confidence} over finished candidates, present when the
    # request set ``consensus: true`` and the gateway has an embedder
    consensus: Optional[dict] = field(Map(float), default=None)

    @classmethod
    def from_streaming(cls, chunk: ChatCompletionChunk) -> "ChatCompletion":
        return cls(
            id=chunk.id,
            choices=[UnaryChoice.from_streaming(c) for c in chunk.choices],
            created=chunk.created,
            model=chunk.model,
            object="chat.completion",
            usage=chunk.usage,
        )
