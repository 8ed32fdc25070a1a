"""Chat completion response types — streaming chunks, unary, merge algebra.

Parity target: reference src/chat/completions/response.rs (872 LoC).  The
dual streaming/unary representation and the chunk-merge ``push`` algebra are
the load-bearing spec (SURVEY §2.3): strings concatenate, usage adds,
optionals first-write-win, choices/tool-calls merge keyed by ``index``, and
``unary == fold(push, chunks)``.
"""

from __future__ import annotations

from decimal import Decimal
from typing import Optional

from .base import (
    ADD,
    CONCAT,
    Const,
    EXTEND,
    Enum,
    KEEP,
    KEYED,
    List,
    NESTED,
    RAW,
    Struct,
    field,
)

SERVICE_TIER = Enum("auto", "default", "flex")

# FinishReason includes the custom `error` variant, which is also the default
# when a streaming choice never finished (response.rs:530-547).
FINISH_REASON = Enum("stop", "length", "tool_calls", "content_filter", "error")
FINISH_REASON_DEFAULT = "error"

ROLE = Enum("assistant")


# ---------------------------------------------------------------------------
# Usage & cost accounting (response.rs:549-734)
# ---------------------------------------------------------------------------


class CompletionTokensDetails(Struct):
    accepted_prediction_tokens: Optional[int] = field(int, default=None, merge=ADD)
    audio_tokens: Optional[int] = field(int, default=None, merge=ADD)
    reasoning_tokens: Optional[int] = field(int, default=None, merge=ADD)
    rejected_prediction_tokens: Optional[int] = field(int, default=None, merge=ADD)


class PromptTokensDetails(Struct):
    audio_tokens: Optional[int] = field(int, default=None, merge=ADD)
    cached_tokens: Optional[int] = field(int, default=None, merge=ADD)


class CostDetails(Struct):
    upstream_inference_cost: Optional[Decimal] = field(Decimal, default=None, merge=ADD)
    # custom field carried through nested archive completions
    upstream_upstream_inference_cost: Optional[Decimal] = field(
        Decimal, default=None, merge=ADD
    )

    def is_empty(self) -> bool:
        return (
            self.upstream_inference_cost is None
            and self.upstream_upstream_inference_cost is None
        )

    def total_cost(self) -> Decimal:
        total = Decimal(0)
        if self.upstream_inference_cost is not None:
            total += self.upstream_inference_cost
        if self.upstream_upstream_inference_cost is not None:
            total += self.upstream_upstream_inference_cost
        return total


class Usage(Struct):
    completion_tokens: int = field(int, default=0, merge=ADD, skip_if_none=False)
    prompt_tokens: int = field(int, default=0, merge=ADD, skip_if_none=False)
    total_tokens: int = field(int, default=0, merge=ADD, skip_if_none=False)
    completion_tokens_details: Optional[CompletionTokensDetails] = field(
        CompletionTokensDetails, default=None, merge=NESTED
    )
    prompt_tokens_details: Optional[PromptTokensDetails] = field(
        PromptTokensDetails, default=None, merge=NESTED
    )
    # openrouter fields
    cost: Optional[Decimal] = field(Decimal, default=None, merge=ADD)
    cost_details: Optional[CostDetails] = field(CostDetails, default=None, merge=NESTED)
    # custom field: derived total (cost + cost_details components)
    total_cost: Optional[Decimal] = field(Decimal, default=None, merge=ADD)

    def is_empty(self) -> bool:
        return (
            self.completion_tokens == 0
            and self.prompt_tokens == 0
            and self.total_tokens == 0
            and self.completion_tokens_details is None
            and self.prompt_tokens_details is None
        )

    def with_total_cost(self) -> None:
        """Derive ``total_cost`` once (response.rs:635-649)."""
        if self.total_cost is None and (
            self.cost is not None
            or (self.cost_details is not None and not self.cost_details.is_empty())
        ):
            total = Decimal(0)
            if self.cost is not None:
                total += self.cost
            if self.cost_details is not None:
                total += self.cost_details.total_cost()
            self.total_cost = total


# ---------------------------------------------------------------------------
# Logprobs (response.rs:736-778)
# ---------------------------------------------------------------------------


class TopLogprob(Struct):
    token: str = field(str)
    bytes: Optional[list] = field(List(int), default=None, skip_if_none=False)
    logprob: Optional[Decimal] = field(Decimal, default=None, skip_if_none=False)


class Logprob(Struct):
    token: str = field(str)
    bytes: Optional[list] = field(List(int), default=None, skip_if_none=False)
    logprob: Decimal = field(Decimal, default=None, skip_if_none=False)
    top_logprobs: list = field(List(TopLogprob), default_factory=list, skip_if_none=False)


class Logprobs(Struct):
    content: Optional[list] = field(List(Logprob), default=None, merge=EXTEND, skip_if_none=False)
    refusal: Optional[list] = field(List(Logprob), default=None, merge=EXTEND, skip_if_none=False)


# ---------------------------------------------------------------------------
# Generated images (openrouter; response.rs:794-810)
# ---------------------------------------------------------------------------


class ImageUrl(Struct):
    url: str = field(str)


class Image(Struct):
    type: str = field(Const("image_url"), default="image_url")
    image_url: ImageUrl = field(ImageUrl, default=None)


# ---------------------------------------------------------------------------
# Streaming side
# ---------------------------------------------------------------------------


class StreamingToolCallFunction(Struct):
    name: Optional[str] = field(str, default=None)
    arguments: Optional[str] = field(str, default=None, merge=CONCAT)


class StreamingToolCall(Struct):
    index: int = field(int, merge=KEEP)
    id: Optional[str] = field(str, default=None)
    function: Optional[StreamingToolCallFunction] = field(
        StreamingToolCallFunction, default=None, merge=NESTED
    )
    type: Optional[str] = field(Const("function"), default=None)


class Delta(Struct):
    content: Optional[str] = field(str, default=None, merge=CONCAT)
    refusal: Optional[str] = field(str, default=None, merge=CONCAT)
    role: Optional[str] = field(ROLE, default=None)
    tool_calls: Optional[list] = field(
        List(StreamingToolCall), default=None, merge=KEYED, key="index"
    )
    # openrouter fields
    reasoning: Optional[str] = field(str, default=None, merge=CONCAT)
    images: Optional[list] = field(List(Image), default=None, merge=EXTEND)

    def tool_as_content(self) -> None:
        """Fold tool-call argument deltas into content (response.rs:161-177)."""
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
    delta: Delta = field(Delta, merge=NESTED)
    finish_reason: Optional[str] = field(FINISH_REASON, default=None, skip_if_none=False)
    index: int = field(int, default=0, merge=KEEP, skip_if_none=False)
    logprobs: Optional[Logprobs] = field(Logprobs, default=None, merge=NESTED)


class ChatCompletionChunk(Struct):
    id: str = field(str, merge=KEEP)
    choices: list = field(List(StreamingChoice), default_factory=list, merge=KEYED, skip_if_none=False, required=True)
    created: int = field(int, default=0, merge=KEEP, skip_if_none=False, required=True)
    model: str = field(str, default="", merge=KEEP, skip_if_none=False, required=True)
    object: str = field(Const("chat.completion.chunk"), default="chat.completion.chunk", merge=KEEP)
    service_tier: Optional[str] = field(SERVICE_TIER, default=None)
    system_fingerprint: Optional[str] = field(str, default=None)
    usage: Optional[Usage] = field(Usage, default=None, merge=NESTED)
    # openrouter fields
    provider: Optional[str] = field(str, default=None)

    def with_total_cost(self) -> None:
        if self.usage is not None:
            self.usage.with_total_cost()


# ---------------------------------------------------------------------------
# Unary side
# ---------------------------------------------------------------------------


class UnaryToolCallFunction(Struct):
    name: str = field(str, default="")
    arguments: str = field(str, default="")


class UnaryToolCall(Struct):
    id: str = field(str, default="")
    function: UnaryToolCallFunction = field(
        UnaryToolCallFunction, default_factory=UnaryToolCallFunction
    )
    type: str = field(Const("function"), default="function")

    @classmethod
    def from_streaming(cls, tc: StreamingToolCall) -> "UnaryToolCall":
        fn = tc.function
        return cls(
            id=tc.id or "",
            function=UnaryToolCallFunction(
                name=(fn.name if fn and fn.name else ""),
                arguments=(fn.arguments if fn and fn.arguments else ""),
            ),
            type="function",
        )


class AnnotationUrlCitation(Struct):
    end_index: int = field(int)
    start_index: int = field(int)
    title: str = field(str)
    url: str = field(str)


class Annotation(Struct):
    type: str = field(Const("url_citation"), default="url_citation")
    url_citation: AnnotationUrlCitation = field(AnnotationUrlCitation, default=None)


class Audio(Struct):
    id: str = field(str)
    data: str = field(str)
    expires_at: int = field(int)
    transcript: str = field(str)


class Message(Struct):
    content: Optional[str] = field(str, default=None, skip_if_none=False)
    refusal: Optional[str] = field(str, default=None, skip_if_none=False)
    role: str = field(ROLE, default="assistant", skip_if_none=False)
    annotations: Optional[list] = field(List(Annotation), default=None)
    audio: Optional[Audio] = field(Audio, default=None)
    tool_calls: Optional[list] = field(List(UnaryToolCall), default=None)
    # openrouter fields
    reasoning: Optional[str] = field(str, default=None)
    images: Optional[list] = field(List(Image), default=None)

    @classmethod
    def from_delta(cls, delta: Delta) -> "Message":
        return cls(
            content=delta.content,
            refusal=delta.refusal,
            role=delta.role or "assistant",
            annotations=None,
            audio=None,
            tool_calls=(
                [UnaryToolCall.from_streaming(tc) for tc in delta.tool_calls]
                if delta.tool_calls is not None
                else None
            ),
            reasoning=delta.reasoning,
            images=delta.images,
        )


class UnaryChoice(Struct):
    message: Message = field(Message)
    finish_reason: str = field(FINISH_REASON, default=FINISH_REASON_DEFAULT, skip_if_none=False)
    index: int = field(int, default=0, skip_if_none=False)
    logprobs: Optional[Logprobs] = field(Logprobs, default=None, skip_if_none=False)

    @classmethod
    def from_streaming(cls, choice: StreamingChoice) -> "UnaryChoice":
        return cls(
            message=Message.from_delta(choice.delta),
            finish_reason=choice.finish_reason or FINISH_REASON_DEFAULT,
            index=choice.index,
            logprobs=choice.logprobs,
        )


class ChatCompletion(Struct):
    id: str = field(str, default="")
    choices: list = field(List(UnaryChoice), default_factory=list, skip_if_none=False)
    created: int = field(int, default=0, skip_if_none=False)
    model: str = field(str, default="", skip_if_none=False)
    object: str = field(Const("chat.completion"), default="chat.completion")
    service_tier: Optional[str] = field(SERVICE_TIER, default=None)
    system_fingerprint: Optional[str] = field(str, default=None)
    usage: Optional[Usage] = field(Usage, default=None)
    # openrouter fields
    provider: Optional[str] = field(str, default=None)

    @classmethod
    def from_streaming(cls, chunk: ChatCompletionChunk) -> "ChatCompletion":
        """The unary-is-fold-of-streaming contract (response.rs:344-370)."""
        return cls(
            id=chunk.id,
            choices=[UnaryChoice.from_streaming(c) for c in chunk.choices],
            created=chunk.created,
            model=chunk.model,
            object="chat.completion",
            service_tier=chunk.service_tier,
            system_fingerprint=chunk.system_fingerprint,
            usage=chunk.usage,
            provider=chunk.provider,
        )
