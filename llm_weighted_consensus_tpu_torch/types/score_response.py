"""Score completion response types — chat chunks extended with consensus data.

Parity target: reference src/score/completions/response.rs (385 LoC).  Choices
carry per-candidate ``weight``/``confidence``, per-judge ``error``/``model``
(judge id)/``model_index``/``completion_metadata``; the delta additionally
carries the judge's ``vote`` vector and the chunk the ``weight_data`` evidence.
This shape IS the product contract (SURVEY §2.1).
"""

from __future__ import annotations

from decimal import Decimal
from typing import Optional

from .base import ResponseError
from .base import (
    Const,
    EXTEND,
    FIRST,
    KEEP,
    KEYED,
    List,
    NESTED,
    Struct,
    TaggedUnion,
    field,
)
from .chat_response import (
    Annotation,
    Audio,
    Delta as ChatDelta,
    FINISH_REASON,
    FINISH_REASON_DEFAULT,
    Image,
    Logprobs,
    Message as ChatMessage,
    SERVICE_TIER,
    StreamingToolCall,
    UnaryToolCall,
    Usage,
)
from .embeddings import CreateEmbeddingResponse


# ---------------------------------------------------------------------------
# Weight data evidence (reference src/score/completions/weight.rs:5-18)
# ---------------------------------------------------------------------------


class StaticData(Struct):
    pass


class TrainingTableData(Struct):
    embeddings_response: CreateEmbeddingResponse = field(CreateEmbeddingResponse)


WEIGHT_DATA = TaggedUnion(
    "type", {"static": StaticData, "training_table": TrainingTableData}
)


# ---------------------------------------------------------------------------
# Completion metadata (response.rs:326-385)
# ---------------------------------------------------------------------------


class CompletionMetadata(Struct):
    id: str = field(str, default="", merge=KEEP, skip_if_none=False)
    created: int = field(int, default=0, merge=KEEP, skip_if_none=False)
    model: str = field(str, default="", merge=KEEP, skip_if_none=False)
    service_tier: Optional[str] = field(SERVICE_TIER, default=None)
    system_fingerprint: Optional[str] = field(str, default=None)
    usage: Optional[Usage] = field(Usage, default=None, merge=NESTED)
    provider: Optional[str] = field(str, default=None)


# ---------------------------------------------------------------------------
# Streaming side
# ---------------------------------------------------------------------------


class Delta(Struct):
    """Chat delta flattened + the judge's ``vote`` vector (response.rs:184-199).

    The reference flattens the chat delta via serde ``#[serde(flatten)]``; we
    inline the same fields plus ``vote``.
    """

    content: Optional[str] = field(str, default=None, merge="concat")
    refusal: Optional[str] = field(str, default=None, merge="concat")
    role: Optional[str] = field(Const("assistant"), default=None)
    tool_calls: Optional[list] = field(
        List(StreamingToolCall),
        default=None,
        merge=KEYED,
        key="index",
    )
    reasoning: Optional[str] = field(str, default=None, merge="concat")
    images: Optional[list] = field(
        List(Image),
        default=None,
        merge=EXTEND,
    )
    vote: Optional[list] = field(List(Decimal), default=None)

    @classmethod
    def from_chat(cls, delta: ChatDelta, vote=None) -> "Delta":
        return cls(
            content=delta.content,
            refusal=delta.refusal,
            role=delta.role,
            tool_calls=delta.tool_calls,
            reasoning=delta.reasoning,
            images=delta.images,
            vote=vote,
        )

    def inner(self) -> ChatDelta:
        return ChatDelta(
            content=self.content,
            refusal=self.refusal,
            role=self.role,
            tool_calls=self.tool_calls,
            reasoning=self.reasoning,
            images=self.images,
        )

    def tool_as_content(self) -> None:
        if self.tool_calls is None:
            return
        tool_calls, self.tool_calls = self.tool_calls, None
        for tool_call in tool_calls:
            if tool_call.function is not None and tool_call.function.arguments is not None:
                if self.content is None:
                    self.content = tool_call.function.arguments
                else:
                    self.content += tool_call.function.arguments


class StreamingChoice(Struct):
    delta: Delta = field(Delta, default_factory=Delta, merge=NESTED)
    finish_reason: Optional[str] = field(FINISH_REASON, default=None, skip_if_none=False)
    index: int = field(int, default=0, merge=KEEP, skip_if_none=False)
    logprobs: Optional[Logprobs] = field(Logprobs, default=None, merge=NESTED)
    # custom fields
    weight: Optional[Decimal] = field(Decimal, default=None)
    confidence: Optional[Decimal] = field(Decimal, default=None)
    error: Optional[ResponseError] = field(ResponseError, default=None)
    model: Optional[str] = field(str, default=None)
    model_index: Optional[int] = field(int, default=None)
    completion_metadata: Optional[CompletionMetadata] = field(
        CompletionMetadata, default=None, merge=NESTED
    )

    def tool_as_content(self) -> None:
        if self.finish_reason == "tool_calls":
            self.finish_reason = "stop"
        self.delta.tool_as_content()

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
    # custom field
    weight_data: object = field(WEIGHT_DATA, default=None)
    # set (true) on the final aggregate frame when the consensus shipped
    # without the full panel — weight-quorum early exit or deadline expiry
    # with a partial panel; absent entirely from healthy responses
    degraded: Optional[bool] = field(bool, default=None, merge=KEEP)
    # set on the final aggregate frame when the request is traced: the key
    # into GET /v1/traces/{trace_id} for the consensus explain record.
    # Absent on untraced requests and on cache replays (the recording
    # strips the leader's id — see cache/store.py).  FIRST, not KEEP, so
    # fold_chunks carries it from the final frame into the unary fold.
    trace_id: Optional[str] = field(str, default=None, merge=FIRST)

    def tool_as_content(self) -> None:
        for choice in self.choices:
            choice.tool_as_content()

    def clone_without_choices(self) -> "ChatCompletionChunk":
        clone = self.clone()
        clone.choices = []
        return clone


# ---------------------------------------------------------------------------
# Unary side
# ---------------------------------------------------------------------------


class UnaryMessage(Struct):
    """Chat unary message flattened + ``vote`` (response.rs:301-320)."""

    content: Optional[str] = field(str, default=None, skip_if_none=False)
    refusal: Optional[str] = field(str, default=None, skip_if_none=False)
    role: str = field(Const("assistant"), default="assistant", skip_if_none=False)
    annotations: Optional[list] = field(
        List(Annotation),
        default=None,
    )
    audio: Optional[object] = field(
        Audio,
        default=None,
    )
    tool_calls: Optional[list] = field(
        List(UnaryToolCall),
        default=None,
    )
    reasoning: Optional[str] = field(str, default=None)
    images: Optional[list] = field(
        List(Image),
        default=None,
    )
    vote: Optional[list] = field(List(Decimal), default=None, skip_if_none=False)

    @classmethod
    def from_delta(cls, delta: Delta) -> "UnaryMessage":
        chat_msg = ChatMessage.from_delta(delta.inner())
        return cls(
            content=chat_msg.content,
            refusal=chat_msg.refusal,
            role=chat_msg.role,
            annotations=chat_msg.annotations,
            audio=chat_msg.audio,
            tool_calls=chat_msg.tool_calls,
            reasoning=chat_msg.reasoning,
            images=chat_msg.images,
            vote=delta.vote,
        )

    def inner(self) -> ChatMessage:
        return ChatMessage(
            content=self.content,
            refusal=self.refusal,
            role=self.role,
            annotations=self.annotations,
            audio=self.audio,
            tool_calls=self.tool_calls,
            reasoning=self.reasoning,
            images=self.images,
        )


class UnaryChoice(Struct):
    message: UnaryMessage = field(UnaryMessage)
    finish_reason: str = field(
        FINISH_REASON, default=FINISH_REASON_DEFAULT, skip_if_none=False
    )
    index: int = field(int, default=0, skip_if_none=False)
    logprobs: Optional[Logprobs] = field(Logprobs, default=None, skip_if_none=False)
    # custom fields
    weight: Optional[Decimal] = field(Decimal, default=None, skip_if_none=False)
    confidence: Optional[Decimal] = field(Decimal, default=None, skip_if_none=False)
    error: Optional[ResponseError] = field(ResponseError, default=None, skip_if_none=False)
    model: Optional[str] = field(str, default=None, skip_if_none=False)
    model_index: Optional[int] = field(int, default=None, skip_if_none=False)
    completion_metadata: Optional[CompletionMetadata] = field(
        CompletionMetadata, default=None, skip_if_none=False
    )

    @classmethod
    def from_streaming(cls, choice: StreamingChoice) -> "UnaryChoice":
        return cls(
            message=UnaryMessage.from_delta(choice.delta),
            finish_reason=choice.finish_reason or FINISH_REASON_DEFAULT,
            index=choice.index,
            logprobs=choice.logprobs,
            weight=choice.weight,
            confidence=choice.confidence,
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
    # custom field
    weight_data: object = field(WEIGHT_DATA, default=None, skip_if_none=False)
    degraded: Optional[bool] = field(bool, default=None)
    trace_id: Optional[str] = field(str, default=None)

    @classmethod
    def from_streaming(cls, chunk: ChatCompletionChunk) -> "ChatCompletion":
        return cls(
            id=chunk.id,
            choices=[UnaryChoice.from_streaming(c) for c in chunk.choices],
            created=chunk.created,
            model=chunk.model,
            object="chat.completion",
            usage=chunk.usage,
            weight_data=chunk.weight_data,
            degraded=chunk.degraded,
            trace_id=chunk.trace_id,
        )
