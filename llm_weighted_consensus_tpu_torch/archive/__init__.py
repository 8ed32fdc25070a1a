"""Completions archive: addressable past completions (checkpoint/resume analog).

Every completion type (chat / score / multichat) is addressable by id and can
be rehydrated into later requests — as conversation messages (the custom
``chat_completion`` / ``score_completion`` / ``multichat_completion`` roles)
or as score candidates.  Parity targets: reference
src/completions_archive/{mod,fetcher}.rs (seam + union + unimplemented stub),
src/chat/completions/client.rs:437-645 (prefetch + rehydration).

The port's copy of ``llm_weighted_consensus_tpu/archive``: the seam, the
unconfigured stub, the in-memory store (its FIFO cap, score requests,
ballots and snapshots; a snapshot either package writes loads in the
other and saves to the same bytes), and the prefetch + rehydration the
chat and multichat clients run.  ``archive/rescore.py`` re-tallies the
store on the device.
"""

from __future__ import annotations

import asyncio
from typing import Optional

from ..errors import (
    ArchiveFetchError,
    InvalidCompletionChoiceIndex,
    ResponseError,
)
from ..types import (
    chat_request,
    chat_response,
    multichat_response,
    score_response,
)

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
    """Dict-backed archive store, used by tests and the batch re-score path.

    ``max_completions`` bounds EACH completion table (chat / score /
    multichat) with FIFO eviction — a long-running service with
    ARCHIVE_WRITE on must not grow with traffic forever (the shutdown
    snapshot re-serializes everything it holds).  Evicting a score
    completion drops its ballots and request record too (useless without
    the completion).  ``None`` = unbounded (library use; the service
    default is ``ARCHIVE_MAX_COMPLETIONS``, serve/config.py).
    """

    def __init__(self, max_completions: Optional[int] = None):
        self.max_completions = max_completions
        self._chat: dict = {}
        self._score: dict = {}
        self._multichat: dict = {}
        # score completion id -> {judge model_index: [(key, candidate)]}:
        # the archivable ballot form enabling logprob re-extraction
        # (archive/rescore.py revote; populated via ScoreClient.ballot_sink)
        self._ballots: dict = {}
        # score completion id -> originating request params (the training
        # signal source: prompts are embedded for table rows)
        self._score_requests: dict = {}
        # FIFO of ballot cids not (yet) archived — the O(1) eviction
        # candidate queue for put_ballot (entries are lazily discarded
        # when they turn out to be archived by the time they surface) —
        # plus the live count of orphans (ballot cids NOT in _score):
        # the cap must bound the orphan population, not total ballots,
        # or an archive holding >cap archived-with-ballots completions
        # would drain every in-flight request's ballots on each
        # put_ballot
        from collections import deque

        # maxlen bounds the queue STRUCTURE, not just the orphan count:
        # cids that get archived after queueing stay in the deque as
        # stale entries (lazily discarded), and a streaming-heavy service
        # whose completions all get archived would otherwise grow the
        # deque forever while _n_orphan_ballots sat at zero.  2x the
        # orphan cap leaves room for a full cap of live orphans plus as
        # many stale entries; displacement past that is handled (and
        # counted) explicitly in put_ballot
        self._ballot_orphans = deque(maxlen=2 * self.MAX_BALLOT_COMPLETIONS)
        self._orphan_queue_drops = 0
        self._n_orphan_ballots = 0

    def _evict_over_cap(self, table: dict) -> None:
        if self.max_completions is None:
            return
        cap = max(0, self.max_completions)  # negative never drains past 0
        while len(table) > cap:
            victim = next(iter(table))  # dicts preserve insertion order
            table.pop(victim)
            if table is self._score:
                self._ballots.pop(victim, None)
                self._score_requests.pop(victim, None)

    def enforce_cap(self) -> None:
        """Apply the cap to every table now (e.g. after loading an
        over-cap snapshot or lowering ``max_completions``)."""
        for table in (self._chat, self._score, self._multichat):
            self._evict_over_cap(table)

    def put_chat(self, completion) -> str:
        self._chat[completion.id] = completion
        self._evict_over_cap(self._chat)
        return completion.id

    def put_score(self, completion) -> str:
        if completion.id not in self._score and completion.id in self._ballots:
            # orphan -> archived transition: its ballots leave the capped
            # population (revote needs them for as long as the completion
            # lives)
            self._n_orphan_ballots -= 1
        self._score[completion.id] = completion
        self._evict_over_cap(self._score)
        return completion.id

    def put_score_request(self, completion_id: str, params) -> None:
        """Keep the originating request beside its completion — training
        tables learn from the PROMPT embedding (weights/learning.py), and
        the prompt lives in the request, not the completion."""
        self._score_requests[completion_id] = params

    def score_request(self, completion_id: str):
        return self._score_requests.get(completion_id)

    def score_completion(self, completion_id: str):
        """Sync accessor (the async fetch_* trio serves the client seam)."""
        return self._score.get(completion_id)

    # ballots are recorded for EVERY score request (the sink fires inside
    # create_streaming) but only archived completions keep needing theirs;
    # cap the table so streaming-heavy services can't grow it unboundedly
    # (FIFO eviction of the oldest completion's ballots — dicts preserve
    # insertion order, and in-flight requests are by definition newest)
    MAX_BALLOT_COMPLETIONS = 4096

    def put_ballot(
        self, completion_id: str, judge_index: int, key_indices: list
    ) -> None:
        """ScoreClient.ballot_sink-shaped recorder:
        ``ScoreClient(..., ballot_sink=store.put_ballot)``."""
        if completion_id not in self._ballots:
            if (
                self._ballot_orphans.maxlen is not None
                and len(self._ballot_orphans) == self._ballot_orphans.maxlen
            ):
                # the append below would silently displace the head; make
                # the displacement an honest eviction instead — if the
                # head is still a live orphan its ballots go with it
                # (it was the oldest candidate anyway), and either way
                # the drop is counted for /metrics-side forensics
                dropped = self._ballot_orphans[0]
                self._orphan_queue_drops += 1
                if (
                    dropped != completion_id
                    and dropped not in self._score
                    and dropped in self._ballots
                ):
                    self._ballots.pop(dropped)
                    self._n_orphan_ballots -= 1
            self._ballot_orphans.append(completion_id)
            if completion_id not in self._score:
                self._n_orphan_ballots += 1
        self._ballots.setdefault(completion_id, {})[judge_index] = list(
            key_indices
        )
        # the cap bounds ORPHANS (streaming requests whose completions
        # never get archived), oldest first via the FIFO — O(1) amortized
        # per eviction, not a scan of every key.  Archived completions'
        # ballots — and the in-flight request being recorded right now —
        # are never evicted: revote needs the former, put_score hasn't
        # had its chance at the latter; neither counts against the cap
        # (archived growth legitimately tracks the archive's size).
        rotated = False
        while self._n_orphan_ballots > self.MAX_BALLOT_COMPLETIONS:
            if not self._ballot_orphans:
                break
            victim = self._ballot_orphans[0]
            if victim == completion_id:
                if rotated:
                    break  # full cycle: nothing else left to evict
                # rotate the in-flight id to the back so eviction can
                # continue past it to newer orphans (a late ballot for an
                # old completion must not wedge the queue)
                self._ballot_orphans.popleft()
                self._ballot_orphans.append(completion_id)
                rotated = True
                continue
            self._ballot_orphans.popleft()
            if victim in self._score or victim not in self._ballots:
                # archived since queued (keep forever) or already dropped
                continue
            self._ballots.pop(victim)
            self._n_orphan_ballots -= 1

    def score_ballots(self, completion_id: str) -> Optional[dict]:
        return self._ballots.get(completion_id)

    def put_multichat(self, completion) -> str:
        self._multichat[completion.id] = completion
        self._evict_over_cap(self._multichat)
        return completion.id

    def chat_ids(self) -> list:
        return list(self._chat)

    def score_ids(self) -> list:
        return list(self._score)

    def multichat_ids(self) -> list:
        return list(self._multichat)

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

    # -- disk snapshot (checkpoint/resume) ------------------------------------

    SNAPSHOT_VERSION = 1

    def save(self, path: str) -> None:
        """Snapshot every table (+ ballot records) to one JSON file.
        Written atomically (temp + rename); Decimal-exact via jsonutil."""
        from ..utils import jsonutil

        obj = {
            "version": self.SNAPSHOT_VERSION,
            "chat": {k: v.to_json_obj() for k, v in self._chat.items()},
            "score": {k: v.to_json_obj() for k, v in self._score.items()},
            "multichat": {
                k: v.to_json_obj() for k, v in self._multichat.items()
            },
            # ballots for never-archived completions (e.g. streaming
            # requests whose fold was not stored) would accumulate forever
            "ballots": {
                cid: b
                for cid, b in self._ballots.items()
                if cid in self._score
            },
            "score_requests": {
                cid: params.to_json_obj()
                for cid, params in self._score_requests.items()
                if cid in self._score
            },
        }
        from ..utils.io import atomic_write

        atomic_write(path, lambda f: f.write(jsonutil.dumps(obj).encode("utf-8")))

    @classmethod
    def load(cls, path: str) -> "InMemoryArchive":
        """Rebuild an archive from a :meth:`save` snapshot."""
        from ..utils import jsonutil

        with open(path, encoding="utf-8") as f:
            obj = jsonutil.loads(f.read())
        version = obj.get("version")
        if version != cls.SNAPSHOT_VERSION:
            raise ValueError(
                f"unsupported archive snapshot version {version!r}"
            )
        store = cls()
        store._chat = {
            k: chat_response.ChatCompletion.from_json_obj(v)
            for k, v in obj.get("chat", {}).items()
        }
        store._score = {
            k: score_response.ChatCompletion.from_json_obj(v)
            for k, v in obj.get("score", {}).items()
        }
        store._multichat = {
            k: multichat_response.ChatCompletion.from_json_obj(v)
            for k, v in obj.get("multichat", {}).items()
        }
        # JSON stringifies the judge-index keys; restore them as ints
        store._ballots = {
            cid: {int(judge): pairs for judge, pairs in judges.items()}
            for cid, judges in obj.get("ballots", {}).items()
        }
        # rebuild the orphan queue/count the snapshot doesn't carry, so
        # loaded not-yet-archived ballots stay evictable and the cap
        # arithmetic starts consistent
        for cid in store._ballots:
            if cid not in store._score:
                store._ballot_orphans.append(cid)
                store._n_orphan_ballots += 1
        from ..types import score_request

        store._score_requests = {
            cid: score_request.ChatCompletionCreateParams.from_json_obj(v)
            for cid, v in obj.get("score_requests", {}).items()
        }
        return store


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
