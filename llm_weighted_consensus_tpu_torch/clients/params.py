"""Shared judge/generator upstream-request assembly.

Both the consensus engine (score) and the multichat fan-out build a chat
request from a judge's ``LlmBase`` sampling surface plus the caller's
request-level passthrough fields (client.rs:488-743).  The field mapping
lives here once; score layers ballot forcing on top, multichat offsets the
seed per slot.
"""

from __future__ import annotations

from typing import Optional

from ..types import chat_request


def wrap_messages(base, messages: list) -> list:
    """Splice the judge's prefix/suffix messages around the conversation
    (client.rs:488-495)."""
    messages = list(messages)
    if base.prefix_messages:
        messages = list(base.prefix_messages) + messages
    if base.suffix_messages:
        messages = messages + list(base.suffix_messages)
    return messages


def base_chat_params(
    base,
    request,
    messages: list,
    *,
    seed: Optional[int],
    logprobs: Optional[bool] = None,
    top_logprobs: Optional[int] = None,
    response_format=None,
    tools=None,
    tool_choice=None,
) -> chat_request.ChatCompletionCreateParams:
    """The judge's upstream chat request (client.rs:661-743 field map)."""
    return chat_request.ChatCompletionCreateParams(
        messages=messages,
        model=base.model,
        frequency_penalty=base.frequency_penalty,
        logit_bias=base.logit_bias,
        logprobs=logprobs,
        max_completion_tokens=base.max_completion_tokens,
        presence_penalty=base.presence_penalty,
        response_format=response_format,
        seed=seed,
        service_tier=request.service_tier,
        stop=base.stop,
        stream=request.stream,
        stream_options=request.stream_options,
        temperature=base.temperature,
        tool_choice=tool_choice,
        tools=tools,
        top_logprobs=top_logprobs,
        top_p=base.top_p,
        max_tokens=base.max_tokens,
        min_p=base.min_p,
        provider=base.provider,
        reasoning=base.reasoning,
        repetition_penalty=base.repetition_penalty,
        top_a=base.top_a,
        top_k=base.top_k,
        usage=request.usage,
        verbosity=base.verbosity,
        models=base.models,
    )
