"""Record a streamed score response's chunk frames; replay them on a hit.

The cache value is the stream's *wire form*: the list of chunk JSON
objects exactly as the live stream yielded them.  Replaying that list
through the same SSE framing the gateway already uses makes a hit
byte-identical to the original streamed response, and the unary path
needs nothing extra — ``fold_chunks`` over replayed chunks produces the
same ``ChatCompletion`` the original unary call did.

Recording is conservative about what it considers a cacheable outcome:

* the stream must be consumed to natural completion — an abandoned
  stream (client disconnect, unary early-raise) records nothing;
* a trailing error item (``ScoreError``, e.g. AllVotesFailed) marks the
  whole stream uncacheable;
* any per-choice error inside a chunk (a judge that failed) marks it
  uncacheable too — a transient upstream failure must not be pinned for
  a full TTL;
* a ``degraded: true`` frame (weight-quorum early exit / deadline
  expiry with a partial panel — resilience/) marks it uncacheable: a
  degraded consensus is an emergency answer, never an authoritative one,
  and the next identical request should get a full-panel attempt.

Frames are snapshotted via ``to_json_obj()`` *before* they are yielded,
so no downstream consumer (unary fold, archiving tee) can mutate the
recorded copy; replay decodes fresh typed chunks per call for the same
reason.  The port's copy of ``llm_weighted_consensus_tpu/cache/replay.py``.
"""

from __future__ import annotations

from typing import AsyncIterator, Callable, List, Optional


async def record_stream(
    stream: AsyncIterator, on_complete: Callable[[List[dict]], None]
) -> AsyncIterator:
    """Tee ``stream``, yielding every item unchanged; fire
    ``on_complete(chunk_objs)`` only after clean, error-free, complete
    consumption."""
    chunk_objs: List[dict] = []
    cacheable = True
    completed = False
    try:
        async for item in stream:
            if isinstance(item, BaseException):
                cacheable = False
            elif cacheable:
                if getattr(item, "degraded", None) or any(
                    c.error is not None for c in item.choices
                ):
                    cacheable = False
                    chunk_objs = []
                else:
                    chunk_objs.append(item.to_json_obj())
            yield item
        completed = True
    finally:
        aclose = getattr(stream, "aclose", None)
        if aclose is not None:
            await aclose()
    if completed and cacheable:
        on_complete(chunk_objs)


async def replay_stream(chunk_objs: List[dict]) -> AsyncIterator:
    """Yield typed chunks decoded from recorded frames.

    Decoding per replay (rather than storing typed chunks) costs a little
    CPU per hit but guarantees isolation: concurrent replays and the
    cached entry never share mutable state.
    """
    from ..types.score_response import ChatCompletionChunk

    for obj in chunk_objs:
        yield ChatCompletionChunk.from_json_obj(obj)


def chunks_from_record(chunk_objs: List[dict]) -> Optional[list]:
    """Decode all recorded frames at once (the unary hit path: callers
    fold these with ``fold_chunks``).  Returns None on a corrupt record
    (e.g. a hand-edited disk segment) so callers fall back to a miss."""
    from ..types.base import SchemaError
    from ..types.score_response import ChatCompletionChunk

    try:
        return [ChatCompletionChunk.from_json_obj(obj) for obj in chunk_objs]
    except (SchemaError, ValueError, TypeError, KeyError):
        return None
