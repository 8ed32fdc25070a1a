"""Score completion request types.

Parity target: reference src/score/completions/request.rs (128 LoC) — messages
+ ``model`` (22-char id | author-prefixed slug | inline JSON | structured
body) + >=2 ``choices``; the choice union covers plain text, archived
chat/score/multichat completion references, and raw chat messages.
"""

from __future__ import annotations

from typing import Optional

from .base import Lazy, List, Struct, TaggedUnion, Union, field
from .chat_request import (
    MESSAGE,
    SERVICE_TIER,
    StreamOptions,
    Tool,
    UsageInclude,
)
from .chat_response import Message as ChatResponseMessage


class ChatCompletionChoiceRef(Struct):
    """Archived chat completion choice reference (request.rs:70-76)."""

    id: str = field(str)
    choice_index: int = field(int, default=0)


class ScoreCompletionChoiceRef(Struct):
    id: str = field(str)
    choice_index: int = field(int, default=0)


class MultichatCompletionChoiceRef(Struct):
    id: str = field(str)
    choice_index: int = field(int, default=0)


ARCHIVE_CHOICE_REF = TaggedUnion(
    "type",
    {
        "chat_completion": ChatCompletionChoiceRef,
        "score_completion": ScoreCompletionChoiceRef,
        "multichat_completion": MultichatCompletionChoiceRef,
    },
)

# Choice = text | archived completion ref | raw chat response message
# (untagged; declaration order mirrors request.rs:68-91)
CHOICE = Union(str, ARCHIVE_CHOICE_REF, ChatResponseMessage)


def _model_spec():
    # Model = Id(String) | Provided(ModelBase) — untagged (request.rs:42-47).
    from ..identity.model import ModelBase

    return Union(str, ModelBase)


MODEL = Lazy(_model_spec)


class ChatCompletionCreateParams(Struct):
    messages: list = field(List(MESSAGE))
    model: object = field(MODEL)
    seed: Optional[int] = field(int, default=None)
    service_tier: Optional[str] = field(SERVICE_TIER, default=None)
    stream: Optional[bool] = field(bool, default=None)
    stream_options: Optional[StreamOptions] = field(StreamOptions, default=None)
    tools: Optional[list] = field(List(Tool), default=None)  # readonly passthrough
    # openrouter fields
    usage: Optional[UsageInclude] = field(UsageInclude, default=None)
    # custom fields
    choices: list = field(List(CHOICE), default_factory=list, skip_if_none=False)
    # opt out of the consensus result cache for this request (cache/);
    # non-semantic: never part of the request fingerprint
    cache_bypass: Optional[bool] = field(bool, default=None)

    def template_content(self) -> str:
        return "\n".join(m.template_content() for m in self.messages)
