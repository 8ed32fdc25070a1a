"""Completions archive: addressable past completions (checkpoint/resume analog).

Every completion type (chat / score / multichat) is addressable by id and can
be rehydrated into later requests — as conversation messages (the custom
``chat_completion`` / ``score_completion`` / ``multichat_completion`` roles)
or as score candidates.  Parity targets: reference
src/completions_archive/{mod,fetcher}.rs (seam + union + unimplemented stub),
src/chat/completions/client.rs:437-645 (prefetch + rehydration).

The port's copy of the read side of ``llm_weighted_consensus_tpu/archive``:
the seam, the unconfigured stub, the in-memory store's lookups, and the
prefetch + rehydration the chat and multichat clients run.  Archive writes,
snapshots and ``/archive/rescore`` wait for their own slice.
"""

from __future__ import annotations

import asyncio
from typing import Optional

from ..errors import (
    ArchiveFetchError,
    InvalidCompletionChoiceIndex,
    ResponseError,
)
from ..types import chat_request

# Completion union (completions_archive/mod.rs:5-9): a fetched completion is
# one of the three unary completion types, discriminated by source kind.
KIND_CHAT = "chat"
KIND_SCORE = "score"
KIND_MULTICHAT = "multichat"


class Fetcher:
    """Archive seam (completions_archive/fetcher.rs:3-29).

    All three methods are async and return the unary completion types from
    ``types``.  Failures raise :class:`ResponseError` (converted to
    ``ArchiveFetchError`` by callers).
    """

    async def fetch_chat_completion(self, ctx, completion_id: str):
        raise NotImplementedError

    async def fetch_score_completion(self, ctx, completion_id: str):
        raise NotImplementedError

    async def fetch_multichat_completion(self, ctx, completion_id: str):
        raise NotImplementedError


class UnimplementedFetcher(Fetcher):
    """Default stub — the service runs without an archive store, and any
    archive-reference message is a client error (mod.rs:31-65 panics; we map
    to a 501 ResponseError instead of crashing the process)."""

    async def fetch_chat_completion(self, ctx, completion_id: str):
        raise ResponseError(code=501, message="completions archive not configured")

    fetch_score_completion = fetch_chat_completion
    fetch_multichat_completion = fetch_chat_completion


class InMemoryArchive(Fetcher):
    """Dict-backed archive store: completions by id, per kind.  The
    port's read side of the reference's store (its ``put_*`` and
    ``fetch_*``); the write path (``ARCHIVE_WRITE``, the cap, ballots
    and snapshots) waits for its own slice."""

    def __init__(self) -> None:
        self._chat: dict = {}
        self._score: dict = {}
        self._multichat: dict = {}

    def put_chat(self, completion) -> str:
        self._chat[completion.id] = completion
        return completion.id

    def put_score(self, completion) -> str:
        self._score[completion.id] = completion
        return completion.id

    def put_multichat(self, completion) -> str:
        self._multichat[completion.id] = completion
        return completion.id

    async def _get(self, table: dict, completion_id: str):
        completion = table.get(completion_id)
        if completion is None:
            raise ResponseError(
                code=404, message=f"completion not found: {completion_id}"
            )
        return completion

    async def fetch_chat_completion(self, ctx, completion_id: str):
        return await self._get(self._chat, completion_id)

    async def fetch_score_completion(self, ctx, completion_id: str):
        return await self._get(self._score, completion_id)

    async def fetch_multichat_completion(self, ctx, completion_id: str):
        return await self._get(self._multichat, completion_id)


# ---------------------------------------------------------------------------
# Prefetch + rehydration (chat client.rs:437-645)
# ---------------------------------------------------------------------------

_MESSAGE_KIND = {
    chat_request.ChatCompletionMessage: KIND_CHAT,
    chat_request.ScoreCompletionMessage: KIND_SCORE,
    chat_request.MultichatCompletionMessage: KIND_MULTICHAT,
}


def fetch_fn(fetcher: Fetcher, kind: str):
    return {
        KIND_CHAT: fetcher.fetch_chat_completion,
        KIND_SCORE: fetcher.fetch_score_completion,
        KIND_MULTICHAT: fetcher.fetch_multichat_completion,
    }[kind]


def message_refs(messages: list, seen: set) -> list:
    """Unique (id, kind) pairs referenced by archive-role messages."""
    refs = []
    for message in messages:
        kind = _MESSAGE_KIND.get(type(message))
        if kind is None or message.id in seen:
            continue
        seen.add(message.id)
        refs.append((message.id, kind))
    return refs


async def fetch_archived(
    fetcher: Fetcher, ctx, refs: list, error_cls=None
) -> dict:
    """Concurrently fetch archived completions for (id, kind) pairs;
    returns {id: (kind, completion)}.

    Mirrors fetch_completion_futs_from_messages (chat client.rs:437-514):
    one future per unique id, all awaited together; ``error_cls`` wraps
    ResponseError failures (chat vs score error envelope).
    """
    if not refs:
        return {}
    try:
        completions = await asyncio.gather(
            *(fetch_fn(fetcher, kind)(ctx, cid) for cid, kind in refs)
        )
    except ResponseError as e:
        raise (error_cls or ArchiveFetchError)(e) from e
    return {cid: (kind, c) for (cid, kind), c in zip(refs, completions)}


async def fetch_archived_for_messages(
    fetcher: Fetcher, ctx, messages: list
) -> dict:
    return await fetch_archived(fetcher, ctx, message_refs(messages, set()))


def completion_choice_message(kind: str, completion, choice_index: int):
    """The unary response message of choice ``choice_index``, or None."""
    for choice in completion.choices:
        if choice.index == choice_index:
            message = choice.message
            if kind == KIND_SCORE:
                # score choices wrap the chat message (inner) next to the vote
                return message.inner()
            return message
    return None


def replace_archive_messages(completions: dict, messages: list) -> list:
    """Replace archive-reference messages with real assistant messages.

    Mirrors replace_completion_messages_with_assistant_messages (chat
    client.rs:516-581).  Returns a new message list; raises
    :class:`InvalidCompletionChoiceIndex` for an out-of-range choice.
    """
    if not completions:
        return messages
    out = []
    for message in messages:
        kind = _MESSAGE_KIND.get(type(message))
        if kind is None:
            out.append(message)
            continue
        stored_kind, completion = completions[message.id]
        response_message = completion_choice_message(
            stored_kind, completion, message.choice_index
        )
        if response_message is None:
            raise InvalidCompletionChoiceIndex(message.id, message.choice_index)
        out.append(
            response_message_to_assistant_message(response_message, message.name)
        )
    return out


def response_message_to_assistant_message(
    message, name: Optional[str] = None
) -> chat_request.AssistantMessage:
    """Convert a unary response message back into request form.

    Mirrors convert_completion_choice_message_to_assistant_message (chat
    client.rs:583-645): generated images become input image parts; response
    tool calls become request tool calls; reasoning is dropped.
    """
    image_parts = [
        chat_request.ImageUrlPart(
            image_url=chat_request.ImageUrl(url=image.image_url.url)
        )
        for image in (message.images or [])
    ]
    content = None
    if message.content is not None and image_parts:
        content = [chat_request.TextPart(text=message.content), *image_parts]
    elif message.content is not None:
        content = message.content
    elif image_parts:
        content = image_parts
    tool_calls = None
    if message.tool_calls is not None:
        tool_calls = [
            chat_request.AssistantToolCall(
                id=tc.id,
                function=chat_request.AssistantToolCallFunction(
                    name=tc.function.name, arguments=tc.function.arguments
                ),
            )
            for tc in message.tool_calls
        ]
    return chat_request.AssistantMessage(
        content=content,
        name=name,
        refusal=message.refusal,
        tool_calls=tool_calls,
        reasoning=None,
    )
