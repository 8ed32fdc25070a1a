"""Multichat client: one request fans out to many generator models.

The reference defines multichat only as response types + identity
(SURVEY §2.10: "one request, many models, choices = each model's answer");
this implements the client for real.  A score panel's judges define the
generator slots: judges are deduplicated by ``multichat_id`` (weight /
output_mode / synthetic_reasoning / top_logprobs reset — llm/mod.rs:538-548)
and duplicates of the same generator occupy consecutive slots
(model/mod.rs:153-178) — i.e. extra samples from that generator.

Streaming protocol mirrors the score engine's: slots stream interleaved,
per-slot errors are error choices (never request failures), unary is the
fold of the stream.  ``StreamingSelfConsistency`` adds the incremental
on-device consensus update (BASELINE config 5): each finished candidate is
embedded and the cosine consensus recomputed, so consumers watch confidence
converge while slower generators are still streaming.

The port's copy of ``llm_weighted_consensus_tpu/clients/multichat.py``.
The stream's consensus state is a device tensor in place of the jnp
buffers: f32 [capacity, H], capacity 16, doubling when full.  Each update
writes the new candidate's vector into it in place (no ``valid`` mask: the
live rows are always the first ``count``, so the vote takes a count), and
the slot commits only after the dispatch succeeds.
"""

from __future__ import annotations

import asyncio
import time
from typing import Optional

from ..errors import ChatError, ScoreChatError, to_response_error
from ..identity.model import Model
from ..types.base import fold_chunks
from ..types.chat_response import Delta as ChatDelta
from ..types.multichat_response import (
    ChatCompletion,
    ChatCompletionChunk,
    StreamingChoice,
)
from ..types.score_response import CompletionMetadata
from ..utils import response_id
from .chat import ChatClient, _try_join
from .score import (
    fetch_archived_for_choices_and_messages,
    fetch_or_validate_score_model,
    merge_streams,
)

RESPONSE_ID_PREFIX = "mchcpl"


def generator_slots(model: Model) -> list:
    """(slot_index, llm) per generator slot, ordered by multichat_index.

    Every judge occupies exactly one slot; judges sharing a multichat_id
    are the same generator sampled multiple times.
    """
    return [
        (llm.multichat_index, llm)
        for llm in sorted(model.llms, key=lambda l: l.multichat_index)
    ]


class MultichatClient:
    def __init__(
        self,
        chat_client: ChatClient,
        model_fetcher,
        archive_fetcher=None,
    ) -> None:
        from .. import archive as archive_mod

        self.chat_client = chat_client
        self.model_fetcher = model_fetcher
        self.archive_fetcher = archive_fetcher or archive_mod.UnimplementedFetcher()

    async def create_unary(self, ctx, params) -> ChatCompletion:
        stream = await self.create_streaming(ctx, params)
        chunks = []
        try:
            # slot streams convert every failure into error choices, so the
            # stream yields only chunks (unlike score's AllVotesFailed item)
            async for item in stream:
                chunks.append(item)
        finally:
            await stream.aclose()
        return ChatCompletion.from_streaming(fold_chunks(chunks))

    async def create_streaming(self, ctx, params):
        from .. import archive as archive_mod

        created = int(time.time())
        resp_id = response_id(RESPONSE_ID_PREFIX, created)

        model, completions = await _try_join(
            fetch_or_validate_score_model(self.model_fetcher, ctx, params.model),
            fetch_archived_for_choices_and_messages(
                self.archive_fetcher, ctx, [], params.messages
            ),
        )
        request = params.clone()
        request.model = model.id
        request.messages = archive_mod.replace_archive_messages(
            completions, request.messages
        )
        return self._stream(ctx, resp_id, created, model, request)

    async def _stream(self, ctx, resp_id, created, model, request):
        streams = [
            self._slot_stream(ctx, resp_id, created, slot, llm, request)
            for slot, llm in generator_slots(model)
        ]
        async for chunk in merge_streams(streams):
            yield chunk

    def _slot_params(self, llm, request, slot: int):
        """The upstream chat request for one generator slot: the judge's
        sampling surface minus ballot forcing (the multichat-reset fields)."""
        from .params import base_chat_params, wrap_messages

        base = llm.base
        # identical generators must not produce identical samples: offset a
        # caller-provided seed per slot
        seed = request.seed + slot if request.seed is not None else None
        return base_chat_params(
            base, request, wrap_messages(base, request.messages), seed=seed
        )

    async def _slot_stream(self, ctx, resp_id, created, slot, llm, request):
        def error_chunk(err) -> ChatCompletionChunk:
            return ChatCompletionChunk(
                id=resp_id,
                choices=[
                    StreamingChoice(
                        delta=ChatDelta(),
                        finish_reason="error",
                        index=slot,
                        logprobs=None,
                        error=to_response_error(ScoreChatError(err))
                        if isinstance(err, ChatError)
                        else to_response_error(err),
                        model=llm.multichat_id,
                        model_index=llm.multichat_index,
                        completion_metadata=None,
                    )
                ],
                created=created,
                model=request.model,
                usage=None,
            )

        try:
            stream = await self.chat_client.create_streaming(
                ctx, self._slot_params(llm, request, slot)
            )
        except ChatError as e:
            yield error_chunk(e)
            return
        except Exception as e:
            # per-slot isolation covers unexpected failures too
            yield error_chunk(to_response_error(e))
            return

        try:
            async for item in stream:
                if isinstance(item, ChatError):
                    yield error_chunk(item)
                    return
                yield ChatCompletionChunk(
                    id=resp_id,
                    choices=[
                        StreamingChoice(
                            delta=choice.delta,
                            finish_reason=choice.finish_reason,
                            index=slot,
                            logprobs=choice.logprobs,
                            error=None,
                            model=llm.multichat_id,
                            model_index=llm.multichat_index,
                            completion_metadata=CompletionMetadata(
                                id=item.id,
                                created=item.created,
                                model=item.model,
                                service_tier=item.service_tier,
                                system_fingerprint=item.system_fingerprint,
                                usage=item.usage,
                                provider=item.provider,
                            ),
                        )
                        for choice in item.choices
                        if choice.index == 0
                    ],
                    created=created,
                    model=request.model,
                    usage=None,
                )
        finally:
            aclose = getattr(stream, "aclose", None)
            if aclose is not None:
                await aclose()


# ---------------------------------------------------------------------------
# Streaming incremental consensus (BASELINE config 5)
# ---------------------------------------------------------------------------


class StreamingSelfConsistency:
    """Fold a multichat stream into a live consensus distribution.

    As each candidate finishes, it is embedded on device and the cosine
    consensus vote recomputed over the completed set — consumers see
    ``confidence`` tighten while slow generators are still streaming.
    """

    INITIAL_CAPACITY = 16

    def __init__(self, embedder, temperature: float = 0.05, batcher=None):
        self.embedder = embedder
        self.temperature = temperature
        # when set (serve/batcher.py), async updates go through the serving
        # micro-batcher so concurrent streams share device dispatches
        self.batcher = batcher
        self.texts: dict = {}
        self.failed: set = set()
        self.confidence: dict = {}
        # device-resident consensus state: embedded candidates live in a
        # fixed-capacity buffer (grown by bucket) so every update is ONE
        # fused embed+revote dispatch and the only fetch is the confidence
        # vector
        self._order: list = []  # position -> slot
        self._buf = None

    @property
    def count(self) -> int:
        return len(self._order)

    def _absorb(self, chunk: ChatCompletionChunk) -> list:
        """Fold a chunk into the text accumulators; returns the slots that
        just finished and now need embedding (pure host work)."""
        pending = []
        for choice in chunk.choices:
            slot = choice.index
            if choice.delta.content:
                self.texts[slot] = self.texts.get(slot, "") + choice.delta.content
            if choice.error is not None or choice.finish_reason == "error":
                # errored generators contribute nothing to the consensus
                self.failed.add(slot)
                continue
            if (
                choice.finish_reason is not None
                and slot not in self._order
                and slot not in pending
                and slot not in self.failed
            ):
                pending.append(slot)
        return pending

    def _ensure_capacity(self) -> None:
        # through the batcher, the buffer lives where its model serves
        # now (the card, or the CPU twin)
        source = self.batcher if self.batcher is not None else self.embedder
        if self._buf is None:
            self._buf = source.stream_buffer(self.INITIAL_CAPACITY)
        elif self.count == self._buf.shape[0]:
            # double (the next power-of-two bucket); the live rows move
            # with it, the new half is zero
            grown = source.stream_buffer(2 * self._buf.shape[0])
            grown[: self.count].copy_(self._buf)
            self._buf = grown

    def _next_position(self) -> int:
        self._ensure_capacity()
        return len(self._order)

    def _commit(self, slot: int) -> None:
        # the update wrote buf[position] in place, but only the count says
        # what is live: a dispatch that raised commits nothing, leaves no
        # phantom slot, and the next update writes the same position
        self._order.append(slot)

    def _publish(self, conf) -> None:
        if conf is not None and self.count >= 2:
            self.confidence = {
                slot: float(conf[i]) for i, slot in enumerate(self._order)
            }

    def _embed_slots(self, slots: list) -> None:
        """Fold finished candidates into the device buffer; one fused
        embed+revote dispatch per candidate."""
        conf = None
        for slot in slots:
            position = self._next_position()
            conf = self.embedder.stream_vote_update(
                self.texts.get(slot, ""),
                self._buf,
                position,
                self.temperature,
            )
            self._commit(slot)
        self._publish(conf)

    def push_chunk(self, chunk: ChatCompletionChunk) -> Optional[dict]:
        """Returns {slot: confidence} when the distribution updates.

        Blocking variant (embeds + revotes inline); async consumers must
        use ``push_chunk_async`` so the device work never stalls the event
        loop."""
        pending = self._absorb(chunk)
        if pending:
            self._embed_slots(pending)
        if not pending or self.count < 2:
            return None
        return dict(self.confidence)

    async def _embed_slots_batched(self, slots: list) -> None:
        """``_embed_slots`` through the serving micro-batcher: each update
        awaits its turn in a shared device dispatch, so R concurrent
        streams' finished candidates ride one embed + vote.  Only the
        LAST slot's confidence is published, so intermediate updates skip
        the host fetch (want_conf=False)."""
        conf = None
        for i, slot in enumerate(slots):
            position = self._next_position()
            conf = await self.batcher.wait_async(self.batcher.submit_stream(
                self.texts.get(slot, ""),
                self._buf,
                position,
                self.temperature,
                want_conf=i == len(slots) - 1,
            ))
            self._commit(slot)
        self._publish(conf)

    async def push_chunk_async(
        self, chunk: ChatCompletionChunk
    ) -> Optional[dict]:
        """``push_chunk`` with the fused embed+revote dispatch moved off
        the event loop (a blocking embed would stall it on every finished
        candidate) — through the micro-batcher when one is attached, else
        a plain executor hop."""
        pending = self._absorb(chunk)
        if not pending:
            return None
        if self.batcher is not None:
            await self._embed_slots_batched(pending)
        else:
            loop = asyncio.get_running_loop()
            await loop.run_in_executor(None, self._embed_slots, pending)
        if self.count < 2:
            return None
        return dict(self.confidence)


class ConsensusUpdate:
    """In-stream consensus frame (a wire extension — the reference has no
    multichat client at all, SURVEY §2.10): emitted by the gateway between
    multichat chunks as the live confidence distribution tightens."""

    def __init__(self, confidence: dict):
        self.confidence = confidence

    def to_json_obj(self) -> dict:
        return {
            "object": "multichat.consensus",
            "confidence": {
                str(slot): conf
                for slot, conf in sorted(self.confidence.items())
            },
        }
