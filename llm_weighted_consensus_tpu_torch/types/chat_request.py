"""Chat completion request surface (OpenAI + OpenRouter superset).

Parity target: reference src/chat/completions/request.rs:4-753 — the full
request params, the 8-role message tree (including the three custom archive
reference roles ``chat_completion`` / ``score_completion`` /
``multichat_completion``, request.rs:328-333), rich content parts, tools,
provider preferences, and the ``template_content`` flattener (request.rs:78-91)
that feeds the trained-weight embedding input.
"""

from __future__ import annotations

from typing import Optional

from .base import (
    RAW,
    Const,
    Enum,
    List,
    Map,
    SchemaError,
    Struct,
    TaggedUnion,
    Union,
    field,
)

# ---------------------------------------------------------------------------
# Simple enums / small structs
# ---------------------------------------------------------------------------

SERVICE_TIER = Enum("auto", "default", "flex")
REASONING_EFFORT = Enum("minimal", "low", "medium", "high")
VERBOSITY = Enum("low", "medium", "high")


class PredictionContentPart(Struct):
    text: str = field(str)
    type: str = field(Const("text"), default="text")


class Prediction(Struct):
    content: object = field(Union(str, List(PredictionContentPart)))
    type: str = field(Const("content"), default="content")


class JsonSchema(Struct):
    name: str = field(str)
    description: Optional[str] = field(str, default=None)
    schema: object = field(RAW, default=None)
    strict: Optional[bool] = field(bool, default=None)


class ResponseFormat(Struct):
    """serde ``#[serde(tag = "type")]`` enum flattened into one struct.

    ``type`` is one of ``text`` / ``json_object`` / ``json_schema``;
    ``json_schema`` present only for the last (request.rs:184-193).
    """

    type: str = field(Enum("text", "json_object", "json_schema"))
    json_schema: Optional[JsonSchema] = field(JsonSchema, default=None)

    def is_json(self) -> bool:
        return self.type in ("json_object", "json_schema")


class StreamOptions(Struct):
    include_usage: Optional[bool] = field(bool, default=None)


class ToolChoiceFunctionFunction(Struct):
    name: str = field(str)


class ToolChoiceFunction(Struct):
    type: str = field(Const("function"), default="function")
    function: ToolChoiceFunctionFunction = field(ToolChoiceFunctionFunction, default=None)


# ToolChoice = "none" | "auto" | "required" | ToolChoiceFunction
TOOL_CHOICE = Union(Enum("none", "auto", "required"), ToolChoiceFunction)


class FunctionDefinition(Struct):
    name: str = field(str)
    description: Optional[str] = field(str, default=None)
    parameters: object = field(RAW, default=None)
    strict: Optional[bool] = field(bool, default=None)


class Tool(Struct):
    function: FunctionDefinition = field(FunctionDefinition)
    type: str = field(Const("function"), default="function")


class UserLocationApproximate(Struct):
    city: Optional[str] = field(str, default=None)
    country: Optional[str] = field(str, default=None)
    region: Optional[str] = field(str, default=None)
    timezone: Optional[str] = field(str, default=None)


class UserLocation(Struct):
    approximate: UserLocationApproximate = field(UserLocationApproximate)
    type: str = field(Const("approximate"), default="approximate")


class WebSearchOptions(Struct):
    search_context_size: Optional[str] = field(Enum("low", "medium", "high"), default=None)
    user_location: Optional[UserLocation] = field(UserLocation, default=None)


class ProviderPreferences(Struct):
    """OpenRouter provider routing preferences (request.rs:682-713)."""

    order: Optional[list] = field(List(str), default=None)
    allow_fallbacks: Optional[bool] = field(bool, default=None)
    require_parameters: Optional[bool] = field(bool, default=None)
    data_collection: Optional[str] = field(Enum("allow", "deny"), default=None)
    only: Optional[list] = field(List(str), default=None)
    ignore: Optional[list] = field(List(str), default=None)
    quantizations: Optional[list] = field(List(str), default=None)
    sort: Optional[str] = field(str, default=None)

    def is_empty(self) -> bool:
        return all(
            getattr(self, f) is None
            for f in (
                "order",
                "allow_fallbacks",
                "require_parameters",
                "data_collection",
                "only",
                "ignore",
                "quantizations",
                "sort",
            )
        )


class Plugin(Struct):
    # serde flattens unknown fields into `fields`; we keep them raw.
    id: str = field(str)
    fields: Optional[dict] = field(Map(RAW), default=None)

    def to_json_obj(self):
        out = {"id": self.id}
        if self.fields:
            out.update(self.fields)
        return out

    @classmethod
    def from_json_obj(cls, obj, *, path: str = ""):
        if not isinstance(obj, dict) or "id" not in obj:
            raise SchemaError(path, "expected plugin object with `id`")
        rest = {k: v for k, v in obj.items() if k != "id"}
        return cls(id=obj["id"], fields=rest or None)


class Reasoning(Struct):
    max_tokens: Optional[int] = field(int, default=None)
    effort: Optional[str] = field(REASONING_EFFORT, default=None)
    enabled: Optional[bool] = field(bool, default=None)


class UsageInclude(Struct):
    include: bool = field(bool)


# ---------------------------------------------------------------------------
# Content
# ---------------------------------------------------------------------------


class SimpleContentPart(Struct):
    text: str = field(str)
    type: str = field(Const("text"), default="text")


# SimpleContent = str | [SimpleContentPart]
SIMPLE_CONTENT = Union(str, List(SimpleContentPart))


class ImageUrl(Struct):
    url: str = field(str)
    detail: Optional[str] = field(Enum("auto", "low", "high"), default=None)


class InputAudio(Struct):
    data: str = field(str)
    format: str = field(Enum("wav", "mp3"))


class VideoUrl(Struct):
    url: str = field(str)


class FilePart(Struct):
    file_data: Optional[str] = field(str, default=None)
    file_id: Optional[str] = field(str, default=None)
    filename: Optional[str] = field(str, default=None)


class TextPart(Struct):
    text: str = field(str)


class ImageUrlPart(Struct):
    image_url: ImageUrl = field(ImageUrl)


class InputAudioPart(Struct):
    input_audio: InputAudio = field(InputAudio)


class InputVideoPart(Struct):
    video_url: VideoUrl = field(VideoUrl)


class FileContentPart(Struct):
    file: FilePart = field(FilePart)


RICH_CONTENT_PART = TaggedUnion(
    "type",
    {
        "text": TextPart,
        "image_url": ImageUrlPart,
        "input_audio": InputAudioPart,
        "input_video": InputVideoPart,
        "file": FileContentPart,
    },
)

# RichContent = str | [RichContentPart]
RICH_CONTENT = Union(str, List(RICH_CONTENT_PART))


def simple_content_text(content) -> str:
    """Flatten SimpleContent to plain text (request.rs:514-523)."""
    if isinstance(content, str):
        return content
    return "".join(part.text for part in content)


def rich_content_text(content) -> str:
    """Flatten RichContent keeping only text parts (request.rs:550-583)."""
    if isinstance(content, str):
        return content
    return "".join(part.text for part in content if isinstance(part, TextPart))


# ---------------------------------------------------------------------------
# Tool calls (request side)
# ---------------------------------------------------------------------------


class AssistantToolCallFunction(Struct):
    name: str = field(str)
    arguments: str = field(str)


class AssistantToolCall(Struct):
    id: str = field(str)
    function: AssistantToolCallFunction = field(AssistantToolCallFunction)
    type: str = field(Const("function"), default="function")

    def template_content(self) -> str:
        from ..utils import jsonutil

        return "<tool_call>%s</tool_call>" % jsonutil.dumps(self.to_json_obj())


# ---------------------------------------------------------------------------
# Messages (tagged by role; request.rs:315-334)
# ---------------------------------------------------------------------------


class DeveloperMessage(Struct):
    content: object = field(SIMPLE_CONTENT)
    name: Optional[str] = field(str, default=None)

    def template_content(self) -> str:
        who = f"developer ({self.name})" if self.name else "developer"
        return f"{who}: {simple_content_text(self.content)}"


class SystemMessage(Struct):
    content: object = field(SIMPLE_CONTENT)
    name: Optional[str] = field(str, default=None)

    def template_content(self) -> str:
        who = f"system ({self.name})" if self.name else "system"
        return f"{who}: {simple_content_text(self.content)}"


class UserMessage(Struct):
    content: object = field(RICH_CONTENT)
    name: Optional[str] = field(str, default=None)

    def template_content(self) -> str:
        who = f"user ({self.name})" if self.name else "user"
        return f"{who}: {rich_content_text(self.content)}"


class ToolMessage(Struct):
    content: object = field(RICH_CONTENT)
    tool_call_id: str = field(str)

    def template_content(self) -> str:
        return f"tool ({self.tool_call_id}): {rich_content_text(self.content)}"


class AssistantMessage(Struct):
    content: object = field(RICH_CONTENT, default=None)
    name: Optional[str] = field(str, default=None)
    refusal: Optional[str] = field(str, default=None)
    tool_calls: Optional[list] = field(List(AssistantToolCall), default=None)
    reasoning: Optional[str] = field(str, default=None)

    def template_content(self) -> str:
        # request.rs:442-478: content / refusal / tool_calls lines, each
        # prefixed with the role tag, newline-joined.
        who = f"assistant ({self.name})" if self.name else "assistant"
        lines = []
        if self.content is not None:
            lines.append(f"{who}: {rich_content_text(self.content)}")
        if self.refusal is not None:
            lines.append(f"{who}: {self.refusal}")
        if self.tool_calls is not None:
            lines.append(
                f"{who}: " + "".join(tc.template_content() for tc in self.tool_calls)
            )
        return "\n".join(lines)


class ChatCompletionMessage(Struct):
    """Archive reference role ``chat_completion`` (request.rs:480-487)."""

    id: str = field(str)
    choice_index: int = field(int, default=0)
    name: Optional[str] = field(str, default=None)

    def template_content(self) -> str:
        return ""


class ScoreCompletionMessage(Struct):
    id: str = field(str)
    choice_index: int = field(int, default=0)
    name: Optional[str] = field(str, default=None)

    def template_content(self) -> str:
        return ""


class MultichatCompletionMessage(Struct):
    id: str = field(str)
    choice_index: int = field(int, default=0)
    name: Optional[str] = field(str, default=None)

    def template_content(self) -> str:
        return ""


MESSAGE = TaggedUnion(
    "role",
    {
        "developer": DeveloperMessage,
        "system": SystemMessage,
        "user": UserMessage,
        "assistant": AssistantMessage,
        "tool": ToolMessage,
        "chat_completion": ChatCompletionMessage,
        "score_completion": ScoreCompletionMessage,
        "multichat_completion": MultichatCompletionMessage,
    },
)

ARCHIVE_MESSAGE_TYPES = (
    ChatCompletionMessage,
    ScoreCompletionMessage,
    MultichatCompletionMessage,
)


# Stop = str | [str]
STOP = Union(str, List(str))


def stop_to_list(stop) -> list:
    if stop is None:
        return []
    if isinstance(stop, str):
        return [stop]
    return list(stop)


# ---------------------------------------------------------------------------
# The request params
# ---------------------------------------------------------------------------


class ChatCompletionCreateParams(Struct):
    """Full request body for POST /chat/completions (request.rs:4-76)."""

    messages: list = field(List(MESSAGE))
    model: str = field(str)
    frequency_penalty: Optional[float] = field(float, default=None)
    logit_bias: Optional[dict] = field(Map(int), default=None)
    logprobs: Optional[bool] = field(bool, default=None)
    max_completion_tokens: Optional[int] = field(int, default=None)
    modalities: Optional[list] = field(List(str), default=None)
    n: Optional[int] = field(int, default=None)
    parallel_tool_calls: Optional[bool] = field(bool, default=None)
    prediction: Optional[Prediction] = field(Prediction, default=None)
    presence_penalty: Optional[float] = field(float, default=None)
    reasoning_effort: Optional[str] = field(REASONING_EFFORT, default=None)
    response_format: Optional[ResponseFormat] = field(ResponseFormat, default=None)
    seed: Optional[int] = field(int, default=None)
    service_tier: Optional[str] = field(SERVICE_TIER, default=None)
    stop: object = field(STOP, default=None)
    stream: Optional[bool] = field(bool, default=None)
    stream_options: Optional[StreamOptions] = field(StreamOptions, default=None)
    temperature: Optional[float] = field(float, default=None)
    tool_choice: object = field(TOOL_CHOICE, default=None)
    tools: Optional[list] = field(List(Tool), default=None)
    top_logprobs: Optional[int] = field(int, default=None)
    top_p: Optional[float] = field(float, default=None)
    web_search_options: Optional[WebSearchOptions] = field(WebSearchOptions, default=None)
    # openrouter fields
    max_tokens: Optional[int] = field(int, default=None)
    min_p: Optional[float] = field(float, default=None)
    plugins: Optional[list] = field(List(Plugin), default=None)
    provider: Optional[ProviderPreferences] = field(ProviderPreferences, default=None)
    reasoning: Optional[Reasoning] = field(Reasoning, default=None)
    repetition_penalty: Optional[float] = field(float, default=None)
    top_a: Optional[float] = field(float, default=None)
    top_k: Optional[int] = field(int, default=None)
    usage: Optional[UsageInclude] = field(UsageInclude, default=None)
    verbosity: Optional[str] = field(VERBOSITY, default=None)
    models: Optional[list] = field(List(str), default=None)

    def template_content(self) -> str:
        """Newline-join each message's template line (request.rs:78-91)."""
        return "\n".join(m.template_content() for m in self.messages)
