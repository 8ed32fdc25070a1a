"""The part of the consensus engine the multichat fan-out imports.

The port's copy of three pieces of
``llm_weighted_consensus_tpu/clients/score.py``: the panel resolution
(``fetch_or_validate_score_model``), the archive prefetch over choices
and messages (``fetch_archived_for_choices_and_messages``) and the
unordered stream merge (``merge_streams``).  The score engine itself
(``ScoreClient``, ballots, the tally, weights) is the next slice.
"""

from __future__ import annotations

import asyncio
from typing import AsyncIterator

from .. import archive as archive_mod
from ..errors import (
    FetchModelError,
    InvalidModelError,
    ResponseError,
    ScoreArchiveError,
)
from ..identity.model import Model, ModelBase
from ..types import score_request
from ..types.base import SchemaError
from ..utils import jsonutil



# ---------------------------------------------------------------------------
# Model resolution (client.rs:911-950)
# ---------------------------------------------------------------------------


async def fetch_or_validate_score_model(model_fetcher, ctx, model_param) -> Model:
    """Resolve the ``model`` request field: 22-char id -> fetch;
    author-prefixed slug ending in a 22-char id -> fetch; inline JSON string
    -> parse+validate; structured body -> validate."""
    if isinstance(model_param, ModelBase):
        try:
            return model_param.into_model_validate()
        except ValueError as e:
            raise InvalidModelError(str(e)) from e
    model_id = model_param
    if len(model_id) == 22:
        return await _fetch_model(model_fetcher, ctx, model_id)
    slug = model_id.split("/")[-1]
    if len(slug) == 22:
        return await _fetch_model(model_fetcher, ctx, slug)
    try:
        obj = jsonutil.loads(model_id)
        base = ModelBase.from_json_obj(obj)
    except (ValueError, SchemaError):
        raise InvalidModelError(model_id) from None
    try:
        return base.into_model_validate()
    except ValueError as e:
        raise InvalidModelError(str(e)) from e


async def _fetch_model(model_fetcher, ctx, model_id: str) -> Model:
    try:
        return await model_fetcher.fetch(ctx, model_id)
    except ResponseError as e:
        raise FetchModelError(e) from e


# ---------------------------------------------------------------------------
# Archive prefetch (client.rs:952-1076)
# ---------------------------------------------------------------------------

_CHOICE_REF_KIND = {
    score_request.ChatCompletionChoiceRef: archive_mod.KIND_CHAT,
    score_request.ScoreCompletionChoiceRef: archive_mod.KIND_SCORE,
    score_request.MultichatCompletionChoiceRef: archive_mod.KIND_MULTICHAT,
}


async def fetch_archived_for_choices_and_messages(
    fetcher, ctx, choices: list, messages: list
) -> dict:
    """Prefetch unique archived completions referenced by score choices and
    by archive-role messages (client.rs:952-1076); failures carry the
    score-level error envelope (score Error::CompletionsArchiveError)."""
    seen: set = set()
    refs: list = []
    for choice in choices:
        kind = _CHOICE_REF_KIND.get(type(choice))
        if kind is None or choice.id in seen:
            continue
        seen.add(choice.id)
        refs.append((choice.id, kind))
    refs.extend(archive_mod.message_refs(messages, seen))
    return await archive_mod.fetch_archived(
        fetcher, ctx, refs, error_cls=ScoreArchiveError
    )


# ---------------------------------------------------------------------------
# Stream merge (select_all analog)
# ---------------------------------------------------------------------------


# terminal queue markers for merge_streams: module-private, so a judge
# stream can never yield one as a payload (identity-checked)
_PUMP_DONE = object()


class _PumpCrash:
    """A pump task's exception, surfaced through the queue in FIFO order
    so items the crashed judge already delivered still drain first."""

    __slots__ = ("exc",)

    def __init__(self, exc):
        self.exc = exc


async def merge_streams(streams: list) -> AsyncIterator:
    """Unordered interleaved merge of async iterators (futures select_all,
    client.rs:342-356).  Items surface in arrival order across all judges."""
    # Bounded queue preserves select_all's pull-based backpressure: a slow
    # downstream consumer throttles upstream judge reads instead of
    # buffering every provider token in memory.  Exactly one pump task per
    # stream for the whole merge — completion and pump crashes travel
    # through the queue as terminal markers, so the consumer is a plain
    # ``await queue.get()`` with zero per-chunk task creation (the old
    # select loop burned a fresh ``queue.get()`` task plus a rebuilt
    # ``asyncio.wait`` pending-set per item; tests/test_host_fastpath.py
    # pins the no-churn contract).
    queue: asyncio.Queue = asyncio.Queue(maxsize=16)

    async def pump(stream):
        try:
            async for item in stream:
                await queue.put(item)
        except Exception as exc:
            # judge streams themselves never raise; this catches
            # programming errors instead of hanging the merge.
            # CancelledError is not an Exception and propagates.
            await queue.put(_PumpCrash(exc))
            return
        await queue.put(_PUMP_DONE)

    tasks = [asyncio.create_task(pump(s)) for s in streams]
    remaining = len(tasks)
    try:
        while remaining:
            item = await queue.get()
            if item is _PUMP_DONE:
                remaining -= 1
            elif type(item) is _PumpCrash:
                raise item.exc
            else:
                yield item
    finally:
        # an abandoned consumer can always cancel pumps blocked on a full
        # queue — the markers above never wedge shutdown
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
