"""The consensus engine: weighted consensus scoring over LLM completions.

The port's copy of ``llm_weighted_consensus_tpu/clients/score.py``
(reference src/score/completions/client.rs).  Pipeline
(client.rs:93-465):

1. stamp ``created``, generate ``scrcpl-{uuid}-{created}`` id;
2. reject <2 candidate choices;
3. concurrently resolve the panel model and prefetch archived completions
   referenced by choices *and* messages;
4. resolve choices to internal form, render every candidate to plain text
   for the ballot;
5. fetch per-judge weights (static config, or the training-table path on
   the card: ``weights/training_table.py``);
6. emit an initial chunk carrying all N candidates as finished choices;
7. fan out all judges concurrently, each with its own randomized ballot
   (``ballot/``) — unordered interleaved streaming, re-indexed into the
   global choice space by ``ChoiceIndexer``;
8. accumulate chunks; strip per-judge usage into a running total;
9. tally ``choice_weight[i] += vote[i] * judge_weight`` (exact Decimal, or
   the fixed-point fold of ``clients/tally.py`` under ``host_fastpath``,
   byte-identical), detect all-failed;
10. final chunk: weight_data, total usage(+cost), per-candidate weight +
    confidence, per-judge-choice confidence; deltas cleared;
11. if every judge errored: trailing AllVotesFailed error item.

A cache (``cache/``) in front answers repeats from recorded frames and
collapses identical concurrent requests onto one fan-out.  With a
``fleet`` (``fleet.FleetCoordinator``, ``FLEET_*``) the in-process
leader of a miss also asks the fleet: a peer's cached entry is replayed,
a cross-replica lease makes this replica the one that fans out (and
publishes to the owner), and every fleet failure computes locally.

Streaming protocol invariants (the product contract): candidate choices
arrive first and finished; judge streams interleave arbitrarily but
per-choice chunks are ordered; each judge's last frame carries its
``vote``; exactly one final aggregate frame carries
weights/confidences/usage; errors are per-choice and never abort other
judges.

Observability, as the reference's: traced, the request's tree holds a
``cache:lookup`` span (the front door's routing decision), one
``judge:stream`` span per judge (the chat client's ``judge:attempt``
spans under it) and a ``consensus:tally`` span whose attributes are the
explain record (per-judge vote, weight and contribution, per-candidate
weight and confidence, the winner, the weight sum); the final frame
carries ``trace_id``, and an all-failed panel forces the trace's
retention.  Traced or not, every tally feeds the process-global quality
aggregator (``obs/quality.py``) and, with a ``ledger``
(``obs/ledger.py``), one outcome record.

Resilience, as the reference's: with a ``resilience.ResiliencePolicy``
the fan-out shares one ``RetryBudget`` (``RESILIENCE_RETRY_BUDGET``), a
``QuorumTracker`` (``RESILIENCE_QUORUM``) cancels the stragglers once
they cannot flip the argmax (each gets a ``499`` entry, the frame ships
``degraded: true``, the trace is kept and annotated with the quorum's
explain record), and a panel cut short by an expired deadline ships
degraded with the late judges' ``504`` entries; a degraded frame is never
cached.  ``bias_plan`` (``JUDGE_BIAS_PLAN``) perturbs one judge's
extracted vote, for drills.

Live weights (``WEIGHTS_*``): with a ``weights.live.LiveWeightStore``
the active table overrides the fetched weights by judge id, its version
(``base`` without one) is captured once per request and stamped on the
``consensus:tally`` span and the ledger record, and a staged shadow
table is compared against every tally.
"""

from __future__ import annotations

import asyncio
import random
import re
import time
from decimal import Decimal
from typing import AsyncIterator, Optional

from .. import archive as archive_mod
from .. import obs
from ..ballot import (
    PrefixTree,
    ballot_instruction,
    branch_limit,
    extract_vote,
    serialize_ballot,
)
from ..ballot.prompting import response_key_schema
from ..errors import (
    AllVotesFailed,
    ChatError,
    ExpectedTwoOrMoreChoices,
    FetchModelError,
    FetchModelWeightsError,
    InvalidContentError,
    InvalidModelError,
    ResponseError,
    ScoreArchiveError,
    ScoreChatError,
    ScoreError,
    ScoreInvalidCompletionChoiceIndex,
    to_response_error,
)
from ..identity.model import Model, ModelBase
from ..obs.phases import observe_phase
from ..resilience import QuorumTracker, RetryBudget, current_deadline
from ..types import chat_request, score_request
from ..types.base import SchemaError, fold_chunks
from ..types.chat_response import Usage
from ..types.score_response import (
    ChatCompletion,
    ChatCompletionChunk,
    CompletionMetadata,
    Delta,
    StreamingChoice,
    TrainingTableData,
)
from ..utils import ChoiceIndexer, jsonutil, response_id
from ..weights import WeightFetchers
from .chat import ChatClient, _try_join
from .tally import fixed_point_fold

RESPONSE_ID_PREFIX = "scrcpl"


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
# Choice resolution (client.rs:952-1163)
# ---------------------------------------------------------------------------

# InternalChoice variants (request.rs:93-110), as (kind, payload) pairs
_TEXT = "text"
_RAW_MESSAGE = "raw_message"
_CHAT = "chat"
_SCORE = "score"
_MULTICHAT = "multichat"


class InternalChoice:
    __slots__ = ("kind", "message", "logprobs", "error", "model", "metadata")

    def __init__(self, kind, message, logprobs=None, error=None, model=None, metadata=None):
        self.kind = kind
        self.message = message  # text str | chat_response.Message-like
        self.logprobs = logprobs
        self.error = error
        self.model = model
        self.metadata = metadata  # CompletionMetadata (usage already dropped)


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


def convert_choices_to_internal(completions: dict, choices: list) -> list:
    """Score request choices -> InternalChoice list (client.rs:1078-1163)."""
    out = []
    for choice in choices:
        if isinstance(choice, str):
            out.append(InternalChoice(_TEXT, choice))
            continue
        ref_kind = _CHOICE_REF_KIND.get(type(choice))
        if ref_kind is None:
            # raw chat response message provided inline
            out.append(InternalChoice(_RAW_MESSAGE, choice))
            continue
        _, completion = completions[choice.id]
        found = None
        for arch_choice in completion.choices:
            if arch_choice.index == choice.choice_index:
                found = arch_choice
                break
        if found is None:
            raise ScoreInvalidCompletionChoiceIndex(choice.id, choice.choice_index)
        if ref_kind == archive_mod.KIND_CHAT:
            out.append(
                InternalChoice(
                    _CHAT,
                    found.message,
                    logprobs=found.logprobs,
                    metadata=CompletionMetadata(
                        id=completion.id,
                        created=completion.created,
                        model=completion.model,
                        service_tier=completion.service_tier,
                        system_fingerprint=completion.system_fingerprint,
                        usage=None,
                        provider=completion.provider,
                    ),
                )
            )
        elif ref_kind == archive_mod.KIND_SCORE:
            metadata = found.completion_metadata
            if metadata is not None:
                metadata = metadata.clone()
                metadata.usage = None
            out.append(
                InternalChoice(
                    _SCORE,
                    found.message.inner(),
                    logprobs=found.logprobs,
                    error=found.error,
                    model=found.model,
                    metadata=metadata,
                )
            )
        else:
            metadata = found.completion_metadata
            if metadata is not None:
                metadata = metadata.clone()
                metadata.usage = None
            out.append(
                InternalChoice(
                    _MULTICHAT,
                    found.message,
                    logprobs=found.logprobs,
                    error=found.error,
                    model=found.model,
                    metadata=metadata,
                )
            )
    return out


def render_message_text(message) -> str:
    """Flatten a response message to ballot text (client.rs:1222-1289):
    reasoning + content + refusal + pretty-printed tool calls, joined by
    blank lines."""
    parts = []
    if getattr(message, "reasoning", None):
        parts.append(message.reasoning)
    if getattr(message, "content", None):
        parts.append(message.content)
    if getattr(message, "refusal", None):
        parts.append(message.refusal)
    tool_calls = getattr(message, "tool_calls", None)
    if tool_calls:
        rendered = []
        for tc in tool_calls:
            try:
                args = jsonutil.loads(tc.function.arguments)
            except ValueError:
                args = tc.function.arguments
            rendered.append(
                {"type": "tool_call", "name": tc.function.name, "arguments": args}
            )
        parts.append(jsonutil.dumps(rendered, pretty=True))
    return "\n\n".join(parts)


def internal_choice_text(choice: InternalChoice) -> str:
    if choice.kind == _TEXT:
        return choice.message
    return render_message_text(choice.message)


def _message_to_delta(message) -> Delta:
    """Unary response message -> streaming score delta (client.rs:1196-1220)."""
    tool_calls = None
    if getattr(message, "tool_calls", None) is not None:
        from ..types.chat_response import (
            StreamingToolCall,
            StreamingToolCallFunction,
        )

        tool_calls = [
            StreamingToolCall(
                index=i,
                id=tc.id,
                function=StreamingToolCallFunction(
                    name=tc.function.name, arguments=tc.function.arguments
                ),
                type="function",
            )
            for i, tc in enumerate(message.tool_calls)
        ]
    return Delta(
        content=message.content,
        refusal=message.refusal,
        role=getattr(message, "role", None) or "assistant",
        tool_calls=tool_calls,
        reasoning=getattr(message, "reasoning", None),
        images=getattr(message, "images", None),
        vote=None,
    )


def _is_ingest_cap_error(error) -> bool:
    """True when a per-judge ResponseError carries an ingest-cap trip
    (IngestCapError, the judge stream's byte budgets).  The wire nesting is
    score -> chat -> {"kind": "ingest_cap", ...}; walked generically so
    both the stream-opening and mid-stream error paths match."""
    msg = getattr(error, "message", None)
    while isinstance(msg, dict):
        inner = msg.get("error")
        if isinstance(inner, dict) and inner.get("kind") == "ingest_cap":
            return True
        msg = inner
    return False


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
        finally:
            # a pump cancelled while its stream waits at a yield (the
            # consumer left: a quorum cut, a client disconnect) closes the
            # stream here, in the context that set its span tokens, rather
            # than leaving it to the event loop's finalizer task
            aclose = getattr(stream, "aclose", None)
            if aclose is not None:
                await aclose()
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


# ---------------------------------------------------------------------------
# The client
# ---------------------------------------------------------------------------


class ScoreClient:
    """``/score/completions``: ``create_streaming`` (chunk frames, then
    an ``AllVotesFailed`` item when every judge failed) and
    ``create_unary`` (their fold).

    ``rng_factory`` makes each judge's ballot generator (a fresh
    ``random.Random`` per judge by default; a seeded factory makes the
    ballots reproducible).  ``cache`` (a ``cache.ScoreCache``) with
    ``flights`` (a ``cache.SingleFlight``, made when omitted) answers
    repeats from recorded frames and collapses identical concurrent
    requests onto one fan-out.  ``host_fastpath`` (``HOST_FASTPATH``)
    folds the tally on scaled-int64 vectors (``clients/tally.py``) and
    divides each candidate's share once; the bytes are the Decimal
    loop's either way.  ``ballot_sink(response_id, judge_index,
    key_indices)``, when set, records each judge's ballot as it is built
    (``archive.InMemoryArchive.put_ballot``: the archived ballots let
    ``archive/rescore.py`` re-extract votes from stored logprobs).
    ``resilience`` (a ``resilience.ResiliencePolicy``) adds the shared
    retry budget, the weight quorum and the deadline degrade; ``bias_plan``
    (a ``resilience.JudgeBiasPlan``) miscalibrates one judge's votes;
    ``live_weights`` (a ``weights.live.LiveWeightStore``) overrides the
    fetched weights with its active table; ``fleet`` (a
    ``fleet.FleetCoordinator``) shares the cache across replicas."""

    def __init__(
        self,
        chat_client: ChatClient,
        model_fetcher,
        weight_fetchers: Optional[WeightFetchers] = None,
        archive_fetcher: Optional[archive_mod.Fetcher] = None,
        rng_factory=random.Random,
        cache=None,
        flights=None,
        host_fastpath: bool = False,
        ballot_sink=None,
        ledger=None,
        resilience=None,
        bias_plan=None,
        live_weights=None,
        fleet=None,
    ) -> None:
        self.chat_client = chat_client
        self.model_fetcher = model_fetcher
        self.weight_fetchers = weight_fetchers or WeightFetchers()
        self.archive_fetcher = (
            archive_fetcher or archive_mod.UnimplementedFetcher()
        )
        self.rng_factory = rng_factory
        self.cache = cache
        if flights is None and cache is not None:
            from ..cache import SingleFlight

            flights = SingleFlight()
        self.flights = flights
        self.host_fastpath = host_fastpath
        self.ballot_sink = ballot_sink
        # one outcome record per scored request (obs/ledger.py), or None
        self.ledger = ledger
        # optional resilience.ResiliencePolicy: a per-request retry budget
        # shared across the judge fan-out and weight-quorum graceful
        # degradation.  None (the default) = pre-resilience behavior.
        self.resilience = resilience
        # optional resilience.JudgeBiasPlan: deterministic per-judge vote
        # perturbation at the extraction seam (drills only)
        self.bias_plan = bias_plan
        # optional weights.live.LiveWeightStore (WEIGHTS_*): versioned
        # per-judge weight overrides behind atomic hot-swap, with the
        # applied version stamped on every tally span and ledger record
        # and the shadow table's would-have-flipped counters
        self.live_weights = live_weights
        # optional fleet.FleetCoordinator (FLEET_*): after winning the
        # in-process single-flight slot, the leader additionally consults
        # the fleet — peer cache fetch or a cross-replica lease — so a
        # fleet-wide hot fingerprint hits upstream exactly once
        self.fleet = fleet

    # -- unary (client.rs:71-91) --------------------------------------------

    async def create_unary(self, ctx, params) -> ChatCompletion:
        stream = await self.create_streaming(ctx, params)
        chunks = []
        try:
            async for item in stream:
                if isinstance(item, ScoreError):
                    raise item
                chunks.append(item)
        finally:
            await stream.aclose()
        aggregate = fold_chunks(chunks)
        return ChatCompletion.from_streaming(aggregate)

    # -- cache front door (cache/: fingerprint -> hit replay / miss record) --

    def _cache_key(self, ctx, params) -> Optional[str]:
        if self.cache is None or not self.cache.enabled:
            return None
        if getattr(params, "cache_bypass", None):
            return None
        from ..cache import score_fingerprint

        return score_fingerprint(params, ctx)

    async def create_streaming(self, ctx, params):
        """Cache front door.  Uncacheable requests (no cache configured,
        ``cache_bypass``, unfingerprintable model form) go straight to the
        live pipeline; otherwise a hit replays the recorded chunk frames
        byte-identically and a miss claims the single-flight slot — the
        leader streams live while recording, concurrent identical
        requests await the leader's recording and replay it."""
        fp = self._cache_key(ctx, params)
        # front-door span: one per request, closed at the routing decision
        # (hit / leader / follower / bypass); the streaming itself is
        # covered by the judge and tally spans downstream
        cspan = obs.child_span("cache:lookup")

        def _decide(outcome: str) -> None:
            if cspan is not None:
                cspan.annotate(outcome=outcome)
                cspan.finish()

        if fp is None:
            _decide("bypass")
            return await self._create_streaming_live(ctx, params)
        from ..cache import replay_stream

        waits = 0
        while True:
            record = self.cache.get(fp)
            if record is not None:
                _decide("hit" if waits == 0 else "follower")
                return replay_stream(record)
            future = self.flights.claim(fp)
            if future is None:  # leader
                # only the in-process leader talks to the fleet: one
                # replica contributes at most one fleet participant per
                # fingerprint, and every fleet failure mode resolves to
                # plan "local" — exactly the pre-fleet behavior
                plan, chunks = "local", None
                if self.fleet is not None:
                    plan, chunks = await self.fleet.begin(fp)
                if plan == "hit":
                    _decide("fleet_hit")
                    self.cache.put_chunks(fp, chunks)
                    self.flights.complete(fp, chunks)
                    return replay_stream(chunks)
                _decide("leader")
                try:
                    live = await self._create_streaming_live(ctx, params)
                except BaseException as e:
                    self.flights.fail(fp, e)
                    if plan == "lease":
                        self.fleet.abandon(fp)
                    raise
                return self._record_and_stream(
                    fp, live, lease=(plan == "lease")
                )
            waits += 1
            if cspan is not None:
                cspan.annotate(singleflight_waits=waits)
            ok, record = await self.flights.wait(future)
            if ok:
                _decide("follower")
                return replay_stream(record)
            # leader abandoned (disconnect) or produced an uncacheable
            # stream: retry — this caller likely becomes the new leader

    async def _record_and_stream(self, fp, live, lease: bool = False):
        """Leader path: stream live to this client while recording; on
        clean error-free completion the recording lands in the cache and
        resolves every follower.  Any other outcome (abandoned stream,
        error items) releases the flight so followers retry as leaders.
        With ``lease`` (the fleet granted this replica the cross-replica
        slot) a clean completion also publishes to the owning replica,
        and anything else releases the lease so fleet waiters fall back
        instead of riding out the TTL."""
        from ..cache import record_stream

        done = False

        def on_complete(chunk_objs):
            nonlocal done
            done = True
            self.cache.put_chunks(fp, chunk_objs)
            self.flights.complete(fp, chunk_objs)
            if lease:
                self.fleet.publish(fp, chunk_objs)

        rec = record_stream(live, on_complete)
        try:
            async for item in rec:
                yield item
        finally:
            await rec.aclose()
            if not done:
                self.flights.fail(fp, asyncio.CancelledError())
                if lease:
                    self.fleet.abandon(fp)

    # -- streaming (client.rs:93-465) ---------------------------------------

    async def _create_streaming_live(self, ctx, params):
        created = int(time.time())
        resp_id = response_id(RESPONSE_ID_PREFIX, created)

        n_choices = len(params.choices)
        if n_choices < 2:
            raise ExpectedTwoOrMoreChoices(n_choices)

        model, completions = await _try_join(
            fetch_or_validate_score_model(self.model_fetcher, ctx, params.model),
            fetch_archived_for_choices_and_messages(
                self.archive_fetcher, ctx, params.choices, params.messages
            ),
        )

        request = params.clone()
        request.model = model.id
        request.messages = archive_mod.replace_archive_messages(
            completions, request.messages
        )
        internal_choices = convert_choices_to_internal(
            completions, request.choices
        )
        request.choices = [internal_choice_text(c) for c in internal_choices]

        try:
            weights, weight_data = await self.weight_fetchers.fetch(
                ctx, request, model
            )
        except ResponseError as e:
            raise FetchModelWeightsError(e) from e

        # live weight overrides (weights/live.py): the (weights, version)
        # pair is captured HERE, in one store read, and threaded through
        # the whole stream, so a hot swap mid-request can never mix two
        # versions inside one tally
        weights_version = None
        if self.live_weights is not None:
            weights, weights_version = self.live_weights.apply(
                model, weights
            )

        initial_chunk = self._initial_chunk(
            resp_id, created, model, internal_choices
        )
        return self._stream(
            ctx, resp_id, created, model, request, weights, weight_data,
            initial_chunk, n_choices, weights_version=weights_version,
        )

    def _initial_chunk(
        self, resp_id: str, created: int, model: Model, internal_choices: list
    ) -> ChatCompletionChunk:
        """All N candidates as already-finished choices (client.rs:182-327)."""
        choices = []
        for i, ic in enumerate(internal_choices):
            if ic.kind == _TEXT:
                delta = Delta(content=ic.message, role="assistant")
            else:
                delta = _message_to_delta(ic.message)
            choices.append(
                StreamingChoice(
                    delta=delta,
                    finish_reason="stop",
                    index=i,
                    logprobs=ic.logprobs,
                    weight=None,
                    confidence=None,
                    error=ic.error,
                    model=ic.model,
                    model_index=None,
                    completion_metadata=ic.metadata,
                )
            )
        return ChatCompletionChunk(
            id=resp_id,
            choices=choices,
            created=created,
            model=model.id,
            usage=None,
            weight_data=None,
        )

    async def _stream(
        self, ctx, resp_id, created, model, request, weights, weight_data,
        initial_chunk, n_choices, weights_version=None,
    ):
        # usage seeded by embeddings evidence for trained weights
        # (client.rs:330-337)
        if isinstance(weight_data, TrainingTableData) and (
            weight_data.embeddings_response.usage is not None
        ):
            usage = weight_data.embeddings_response.usage.clone()
        else:
            usage = Usage()

        aggregate = initial_chunk.clone()
        pending_initial = initial_chunk
        indexer = ChoiceIndexer(n_choices)

        policy = self.resilience
        budget_token = None
        if policy is not None and policy.retry_budget_tokens > 0:
            # one bucket for the whole fan-out: the pump tasks the stream
            # merge spawns inherit it via contextvar, so every judge's
            # backoff loop draws from the same allotment
            budget_token = RetryBudget(policy.retry_budget_tokens).activate()

        quorum = None
        if policy is not None and policy.quorum_fraction > 0:
            # judge-level tracking (each judge settles on its first final
            # frame); the same Decimal weights as the tally below
            quorum = QuorumTracker(
                {llm.index: weights[llm.index] for llm in model.llms},
                n_choices,
                policy.quorum_fraction,
            )

        judge_streams = [
            self._judge_stream(
                ctx, resp_id, created, indexer, llm, weights[llm.index],
                request,
            )
            for llm in model.llms
        ]

        degraded = False
        quorum_degraded = False
        merged = merge_streams(judge_streams)
        try:
            async for chunk in merged:
                if pending_initial is not None:
                    yield pending_initial
                    pending_initial = None
                aggregate.push(chunk)
                # strip per-judge usage into the running total; interim
                # chunks go out without it, the final frame carries the sum
                for choice in chunk.choices:
                    metadata = choice.completion_metadata
                    if metadata is not None and metadata.usage is not None:
                        usage.push(metadata.usage)
                        metadata.usage = None
                yield chunk
                if quorum is not None:
                    for choice in chunk.choices:
                        if choice.model_index is None:
                            continue
                        if choice.delta.vote is not None:
                            quorum.record_vote(
                                choice.model_index, choice.delta.vote
                            )
                        elif choice.error is not None:
                            quorum.record_error(choice.model_index)
                    if quorum.decided():
                        # stragglers cannot flip the argmax: cancel them
                        # (closing the merge cancels pumps and judge
                        # streams, which close their upstreams) and ship
                        degraded = True
                        quorum_degraded = True
                        policy.inc("quorum_degraded")
                        obs.annotate(quorum=quorum.explain())
                        break
        finally:
            await merged.aclose()
            if budget_token is not None:
                RetryBudget.deactivate(budget_token)

        if pending_initial is not None:
            # no judges / no judge produced output: still emit candidates
            yield pending_initial

        if degraded and quorum is not None:
            # per-judge failure detail for the cancelled stragglers,
            # pushed into the aggregate so the tally and the final frame
            # see them like any other errored judge
            straggler_chunk = self._straggler_chunk(
                resp_id, created, indexer, model, weights, request, quorum
            )
            if straggler_chunk is not None:
                aggregate.push(straggler_chunk)
                yield straggler_chunk

        if not degraded and policy is not None:
            deadline = current_deadline()
            if deadline is not None and deadline.expired():
                # time ran out with a partial panel: judges that missed the
                # deadline carry errors, at least one vote landed -> the
                # consensus ships, marked degraded (all-failed keeps its
                # AllVotesFailed error path below)
                tail = aggregate.choices[n_choices:]
                if any(c.delta.vote is not None for c in tail) and any(
                    c.error is not None for c in tail
                ):
                    degraded = True
                    policy.inc("deadline_degraded")
                    obs.annotate(deadline_degraded=True)

        if not degraded:
            # a judge leg tripped an ingest byte budget while other judges
            # voted: the consensus ships degraded, so the final frame keeps
            # the per-judge error entries and the recording refuses to
            # cache it (all-failed keeps its AllVotesFailed error path)
            tail = aggregate.choices[n_choices:]
            if any(
                c.error is not None and _is_ingest_cap_error(c.error)
                for c in tail
            ) and any(c.delta.vote is not None for c in tail):
                degraded = True
                if policy is not None:
                    policy.inc("ingest_cap_degraded")
                obs.annotate(ingest_cap_degraded=True)

        # tally + all-error detection (client.rs:384-416)
        # the tally span's attributes are the consensus "explain" record:
        # per-judge vote/weight/contribution plus per-candidate results,
        # built only when a trace is live (None otherwise, zero cost)
        t_tally = time.perf_counter()
        tspan = obs.child_span("consensus:tally", n_judges=len(model.llms))
        tail = aggregate.choices[n_choices:]
        choice_weight = None
        if self.host_fastpath:
            # the weighted-vote fold on scaled-int64 vectors: byte-identical
            # by construction, None when the ballots cannot be proven exact
            # (the Decimal loop below is the authority and re-runs in full)
            choice_weight = fixed_point_fold(tail, n_choices)
        fold_in_loop = choice_weight is None
        if fold_in_loop:
            choice_weight = [Decimal(0)] * n_choices
        all_error = True
        all_error_code: Optional[int] = None
        for choice in tail:
            if all_error:
                if choice.error is None:
                    all_error = False
                elif all_error_code is None:
                    all_error_code = choice.error.code
                elif choice.error.code != all_error_code:
                    if (
                        400 <= choice.error.code < 500
                        and 400 <= all_error_code < 500
                    ):
                        all_error_code = 400
                    else:
                        all_error_code = 500
            if fold_in_loop and choice.delta.vote is not None:
                w = choice.weight if choice.weight is not None else Decimal(0)
                for i, v in enumerate(choice.delta.vote):
                    choice_weight[i] += v * w

        # final frame (client.rs:418-456)
        weight_sum = sum(choice_weight)
        aggregate.weight_data = weight_data
        usage.with_total_cost()
        aggregate.usage = usage
        if degraded:
            aggregate.degraded = True
        all_failed = all_error and len(model.llms) > 0
        # winner + confidence margin (top1 - top2) are consensus-health
        # facts, computed Decimal-exact whether or not a trace is live:
        # the quality aggregates must not depend on sampling
        winner = None
        margin = None
        if weight_sum > 0:
            winner = max(range(n_choices), key=lambda i: choice_weight[i])
            ranked = sorted(choice_weight, reverse=True)
            top2 = ranked[1] if len(ranked) > 1 else Decimal(0)
            margin = float((ranked[0] - top2) / weight_sum)
        explain_candidates: list = []
        explain_judges: list = []
        quality_ballots: list = []
        want_ledger = self.ledger is not None
        conf_vec = [0.0] * n_choices
        ledger_judges: list = []
        # HOST_FASTPATH: the share choice_weight[i]/weight_sum is divided
        # out once per candidate instead of once per judge per candidate
        # (the division is deterministic, so hoisting it is byte-identical)
        shares = None
        if self.host_fastpath:
            if weight_sum > 0:
                # identical weight OBJECTS (the fixed-point fold memoizes
                # repeated sums onto one Decimal) share one division
                div_memo: dict = {}
                shares = []
                for w in choice_weight:
                    hit = div_memo.get(id(w))
                    if hit is None:
                        div_memo[id(w)] = hit = (w, w / weight_sum)
                    shares.append(hit[1])
            else:
                shares = [Decimal(0)] * n_choices
        for choice in aggregate.choices:
            if choice.index < n_choices:
                w = choice_weight[choice.index]
                choice.weight = w
                if shares is not None:
                    choice.confidence = shares[choice.index]
                else:
                    choice.confidence = (
                        w / weight_sum if weight_sum > 0 else Decimal(0)
                    )
                if want_ledger:
                    conf_vec[choice.index] = float(choice.confidence)
                if tspan is not None:
                    explain_candidates.append({
                        "index": choice.index,
                        "weight": float(w),
                        "confidence": float(choice.confidence),
                    })
            elif choice.delta.vote is not None:
                vote = choice.delta.vote
                confidence = Decimal(0)
                if shares is not None:
                    for i, v in enumerate(vote):
                        confidence += shares[i] * v
                else:
                    for i, v in enumerate(vote):
                        share = (
                            choice_weight[i] / weight_sum
                            if weight_sum > 0
                            else Decimal(0)
                        )
                        confidence += share * v
                choice.confidence = confidence
                judge_weight = (
                    choice.weight if choice.weight is not None else Decimal(0)
                )
                # one Decimal->float pass per ballot, shared by the
                # quality ballot and the ledger record (the weight itself
                # stays Decimal for the exact weight share)
                fvote = [float(v) for v in vote]
                quality_ballots.append(obs.JudgeBallot(
                    choice.model or "", choice.model_index, judge_weight,
                    fvote,
                ))
                if want_ledger:
                    ledger_judges.append({
                        "model": choice.model,
                        "model_index": choice.model_index,
                        "weight": float(judge_weight),
                        "vote": fvote,
                        "error": None,
                        # the judge's vote-mass-weighted share of the final
                        # confidence vector: the alignment score learning
                        # trains on
                        "alignment": float(confidence),
                    })
                if tspan is not None:
                    explain_judges.append({
                        "model": choice.model,
                        "model_index": choice.model_index,
                        "weight": float(choice.weight)
                        if choice.weight is not None else None,
                        "vote": fvote,
                        "confidence_contribution": float(confidence),
                        "error": choice.error.code
                        if choice.error is not None else None,
                    })
            else:
                # voteless judge choice: errored or cancelled
                error_code = (
                    choice.error.code if choice.error is not None else None
                )
                quality_ballots.append(obs.JudgeBallot(
                    choice.model or "", choice.model_index,
                    choice.weight if choice.weight is not None
                    else Decimal(0),
                    None, error_code,
                ))
                if want_ledger:
                    ledger_judges.append({
                        "model": choice.model,
                        "model_index": choice.model_index,
                        "weight": float(choice.weight)
                        if choice.weight is not None else None,
                        "vote": None,
                        "error": error_code,
                        "alignment": None,
                    })
                if tspan is not None:
                    explain_judges.append({
                        "model": choice.model,
                        "model_index": choice.model_index,
                        "weight": float(choice.weight)
                        if choice.weight is not None else None,
                        "vote": None,
                        "confidence_contribution": 0.0,
                        "error": error_code,
                    })
            choice.delta = Delta()
            choice.finish_reason = None
            choice.logprobs = None
            if not degraded:
                choice.error = None
            # degraded: keep per-judge failure detail on the final frame so
            # unary consumers see WHY the panel is partial
        if tspan is not None:
            tspan.annotate(
                judges=explain_judges,
                candidates=explain_candidates,
                weight_sum=float(weight_sum),
                winner=winner,
                degraded=degraded,
                **({"weights_version": weights_version}
                   if weights_version is not None else {}),
            )
            tspan.finish()
        if self.live_weights is not None:
            # shadow-mode comparison: re-tally the same ballots under the
            # staged table; pure observation, the result is already final
            self.live_weights.observe_shadow(quality_ballots, n_choices)
        trace_id = obs.current_trace_id()
        # consensus-quality aggregates (obs/quality.py): always on, like
        # the phase aggregate below
        obs.observe_outcome(obs.Outcome(
            winner=winner,
            margin=margin,
            weight_sum=weight_sum if weight_sum > 0 else Decimal(0),
            n_choices=n_choices,
            degraded=degraded,
            quorum_degraded=quorum_degraded,
            all_failed=all_failed,
            trace_id=trace_id,
            judges=quality_ballots,
        ))
        if self.ledger is not None:
            # one record per scored request: the persistent training
            # substrate for weight learning and archive re-scoring
            self.ledger.offer({
                "id": resp_id,
                "created": created,
                "panel": model.id,
                "n_choices": n_choices,
                "winner": winner,
                "confidence": conf_vec,
                "margin": margin,
                "weight_sum": float(weight_sum),
                "degraded": degraded,
                "quorum_degraded": quorum_degraded,
                "all_failed": all_failed,
                "trace_id": trace_id,
                # the table version that scored this request: "base" with
                # no active table, None with no live weight store
                "weights_version": weights_version,
                "judges": ledger_judges,
            })
        # host_tally phase: the weighted-vote fold + final-frame build
        observe_phase("host_tally", (time.perf_counter() - t_tally) * 1e3)
        if degraded:
            # degraded consensus is always retained, whatever the sample
            # rate said at the door
            obs.force_keep("degraded")
        if all_failed:
            # an all-judges-failed tally is as diagnosis-worthy as a 5xx;
            # the unary surface can be a merged 4xx, below the gateway's
            # >= 500 forcing
            obs.force_keep("all_failed")
        # the final frame carries the trace id, so SSE consumers can fetch
        # the explain trace from /v1/traces/{trace_id}
        aggregate.trace_id = trace_id
        yield aggregate

        if all_failed:
            yield AllVotesFailed(all_error_code)

    @staticmethod
    def _straggler_chunk(
        resp_id, created, indexer, model, weights, request, quorum
    ):
        """Error choices for judges cancelled by the quorum early exit."""
        pending = sorted(quorum.pending())
        if not pending:
            return None
        llms_by_index = {llm.index: llm for llm in model.llms}
        choices = []
        for judge_index in pending:
            quorum.record_error(judge_index)
            llm = llms_by_index.get(judge_index)
            choices.append(
                StreamingChoice(
                    delta=Delta(),
                    finish_reason="error",
                    index=indexer.get(judge_index, 0),
                    logprobs=None,
                    weight=weights[judge_index],
                    confidence=None,
                    error=ResponseError(
                        code=499,
                        message="straggler cancelled: weight quorum reached",
                    ),
                    model=llm.id if llm is not None else None,
                    model_index=judge_index,
                    completion_metadata=None,
                )
            )
        return ChatCompletionChunk(
            id=resp_id,
            choices=choices,
            created=created,
            model=request.model,
            usage=None,
            weight_data=None,
        )

    # -- per-judge ballot stream (client.rs:467-908) ------------------------

    async def _judge_stream(
        self, ctx, resp_id, created, indexer, llm, weight, request
    ):
        """The ballot stream proper, timed as the ``upstream_judge``
        phase: this judge's whole ballot-stream lifetime.  Traced, a
        ``judge:stream`` span: this generator is driven by exactly one
        pump task (``merge_streams``), so the span lives in the pump's
        context and the chat client's attempt spans land under it."""
        inner = self._judge_stream_inner(
            ctx, resp_id, created, indexer, llm, weight, request
        )
        jspan = obs.child_span(
            "judge:stream",
            model=llm.id,
            judge_index=llm.index,
            weight=float(weight),
        )
        token = jspan.activate() if jspan is not None else None
        t_judge = time.perf_counter()
        try:
            async for item in inner:
                yield item
        finally:
            await inner.aclose()
            observe_phase(
                "upstream_judge", (time.perf_counter() - t_judge) * 1e3
            )
            if jspan is not None:
                obs.Span.deactivate(token)
                jspan.finish()

    async def _judge_stream_inner(
        self, ctx, resp_id, created, indexer, llm, weight, request
    ):
        rng = self.rng_factory()
        n_choices = len(request.choices)

        # ballot construction (client.rs:497-517)
        tree = PrefixTree.build(
            rng, n_choices, branch_limit(llm.base.top_logprobs)
        )
        key_indices = tree.key_indices(rng)
        keys = [k for k, _ in key_indices]
        ballot_json = serialize_ballot(request.choices, key_indices)
        with_ticks, without_ticks = PrefixTree.regex_patterns(keys)
        if self.host_fastpath:
            # compile the per-judge ballot patterns once: every ballot
            # alphabet is freshly randomized, so the module-level re cache
            # churns under concurrent panels; matches (and therefore
            # bytes) are identical either way
            with_ticks = re.compile(with_ticks)
            without_ticks = re.compile(without_ticks)
        if self.ballot_sink is not None:
            self.ballot_sink(resp_id, llm.index, list(key_indices))

        chat_params = self._judge_chat_params(llm, request, ballot_json, keys)

        def error_chunk(err) -> ChatCompletionChunk:
            # lands on the ambient judge span (we run in the pump task)
            obs.annotate(judge_error=str(err))
            return ChatCompletionChunk(
                id=resp_id,
                choices=[
                    StreamingChoice(
                        delta=Delta(),
                        finish_reason="error",
                        index=indexer.get(llm.index, 0),
                        logprobs=None,
                        weight=weight,
                        confidence=None,
                        error=to_response_error(ScoreChatError(err))
                        if isinstance(err, ChatError)
                        else to_response_error(err),
                        model=llm.id,
                        model_index=llm.index,
                        completion_metadata=None,
                    )
                ],
                created=created,
                model=request.model,
                usage=None,
                weight_data=None,
            )

        # open the judge's chat stream; failure -> error choice, not stream
        # failure (client.rs:712-783)
        try:
            stream = await self.chat_client.create_streaming(ctx, chat_params)
        except ChatError as e:
            yield error_chunk(e)
            return
        except Exception as e:
            # per-judge error isolation covers unexpected failures too: a
            # judge must never take the whole consensus down
            yield error_chunk(ResponseError(code=500, message=str(e)))
            return

        aggregate_chunk = None
        final_chunk = None
        # Deviation from the reference: it attaches chat-chunk usage only to
        # per-choice metadata, so an OpenAI-style trailing usage chunk with
        # empty `choices` is silently dropped from cost accounting.  Such
        # trailing usage is collected and grafted onto the judge's final
        # frame metadata.
        trailing_usage = None
        try:
            # look-ahead loop: an error on the *next* item marks the current
            # chunk's choices as errored (client.rs:795-882)
            try:
                next_chat_chunk = await stream.__anext__()
            except StopAsyncIteration:
                next_chat_chunk = None
            if isinstance(next_chat_chunk, ChatError):
                yield error_chunk(next_chat_chunk)
                return

            while next_chat_chunk is not None:
                chat_chunk = next_chat_chunk
                error = None
                try:
                    upcoming = await stream.__anext__()
                except StopAsyncIteration:
                    upcoming = None
                if isinstance(upcoming, ChatError):
                    error = to_response_error(ScoreChatError(upcoming))
                    next_chat_chunk = None
                else:
                    next_chat_chunk = upcoming

                if not chat_chunk.choices and chat_chunk.usage is not None:
                    if trailing_usage is None:
                        trailing_usage = chat_chunk.usage.clone()
                    else:
                        trailing_usage.push(chat_chunk.usage)
                chunk = self._convert_chat_chunk(
                    chat_chunk, resp_id, created, indexer, llm, weight,
                    request, error,
                )
                if llm.base.output_mode == "tool_call":
                    chunk.tool_as_content()

                if aggregate_chunk is None:
                    aggregate_chunk = chunk.clone()
                else:
                    aggregate_chunk.push(chunk)

                finished = self._split_off_finished(chunk)
                if finished is not None:
                    if final_chunk is None:
                        final_chunk = finished
                    else:
                        final_chunk.push(finished)
                if chunk.choices:
                    yield chunk
        finally:
            aclose = getattr(stream, "aclose", None)
            if aclose is not None:
                await aclose()

        if final_chunk is None:
            if aggregate_chunk is None:
                yield error_chunk(
                    ResponseError(code=500, message="empty judge stream")
                )
                return
            # no finish_reason ever arrived (provider ended the stream
            # abruptly): synthesize a final frame with cleared deltas so the
            # vote can still attach without re-streaming content
            final_chunk = aggregate_chunk.clone_without_choices()
            for c in aggregate_chunk.choices:
                cc = c.clone()
                cc.delta = Delta()
                final_chunk.choices.append(cc)

        if trailing_usage is not None and final_chunk.choices:
            first = final_chunk.choices[0]
            if first.completion_metadata is None:
                first.completion_metadata = CompletionMetadata(
                    id="", created=0, model="", usage=trailing_usage
                )
            elif first.completion_metadata.usage is None:
                first.completion_metadata.usage = trailing_usage
            else:
                first.completion_metadata.usage.push(trailing_usage)

        # attach votes to the withheld final frame (client.rs:884-907)
        for choice in final_chunk.choices:
            agg_choice = next(
                (c for c in aggregate_chunk.choices if c.index == choice.index),
                None,
            )
            try:
                if agg_choice is None:
                    raise InvalidContentError("choice missing from aggregate")
                logprob_tokens = None
                if (
                    agg_choice.logprobs is not None
                    and agg_choice.logprobs.content is not None
                ):
                    logprob_tokens = agg_choice.logprobs.content
                vote = extract_vote(
                    tree,
                    with_ticks,
                    without_ticks,
                    n_choices,
                    agg_choice.delta.content,
                    logprob_tokens,
                )
                if self.bias_plan is not None:
                    # JUDGE_BIAS_PLAN drill seam: deterministically
                    # miscalibrate the targeted judge's extracted vote
                    # (Decimal-in, Decimal-out) before it enters the tally
                    vote = self.bias_plan.perturb(llm.index, vote)
                choice.delta.vote = vote
                obs.annotate(vote=[float(v) for v in vote])
            except InvalidContentError as e:
                obs.annotate(vote_error=str(e))
                if choice.error is None:
                    choice.error = to_response_error(e)
                    choice.finish_reason = "error"
        yield final_chunk

    def _judge_chat_params(self, llm, request, ballot_json, keys):
        """Assemble the judge's upstream chat request (client.rs:488-743)."""
        from .params import base_chat_params, wrap_messages

        base = llm.base
        messages = wrap_messages(base, request.messages)

        # ballot goes into (or creates) the trailing system message
        # (client.rs:533-572)
        content = ballot_instruction(ballot_json, keys, base.output_mode)
        if messages and isinstance(messages[-1], chat_request.SystemMessage):
            last = messages[-1].clone()
            if isinstance(last.content, str):
                last.content = f"{last.content}\n\n{content}"
            else:
                last.content = list(last.content) + [
                    chat_request.SimpleContentPart(text=f"\n\n{content}")
                ]
            messages = messages[:-1] + [last]
        else:
            messages = messages + [chat_request.SystemMessage(content=content)]

        # output forcing by mode (client.rs:574-659)
        schema = response_key_schema(keys, bool(base.synthetic_reasoning))
        readonly_tools = request.tools
        response_format = None
        tools = None
        tool_choice = None
        if base.output_mode == "instruction":
            if readonly_tools:
                tools = list(readonly_tools)
                tool_choice = "none"
        elif base.output_mode == "json_schema":
            response_format = chat_request.ResponseFormat(
                type="json_schema",
                json_schema=chat_request.JsonSchema(
                    name="response_key", strict=True, schema=schema
                ),
            )
            if readonly_tools:
                tools = list(readonly_tools)
                tool_choice = "none"
        else:  # tool_call
            tools = list(readonly_tools or [])
            tools.append(
                chat_request.Tool(
                    function=chat_request.FunctionDefinition(
                        name="response_key", parameters=schema, strict=True
                    )
                )
            )
            tool_choice = chat_request.ToolChoiceFunction(
                function=chat_request.ToolChoiceFunctionFunction(
                    name="response_key"
                )
            )

        return base_chat_params(
            base,
            request,
            messages,
            seed=request.seed,
            logprobs=True if base.top_logprobs is not None else None,
            top_logprobs=base.top_logprobs,
            response_format=response_format,
            tools=tools,
            tool_choice=tool_choice,
        )

    @staticmethod
    def _convert_chat_chunk(
        chat_chunk, resp_id, created, indexer, llm, weight, request, error
    ) -> ChatCompletionChunk:
        """Chat chunk -> score chunk with global indices + judge identity
        (client.rs:813-868)."""
        choices = []
        for choice in chat_chunk.choices:
            choices.append(
                StreamingChoice(
                    delta=Delta.from_chat(choice.delta),
                    finish_reason=(
                        "error" if error is not None else choice.finish_reason
                    ),
                    index=indexer.get(llm.index, choice.index),
                    logprobs=choice.logprobs,
                    weight=weight,
                    confidence=None,
                    error=error,
                    model=llm.id,
                    model_index=llm.index,
                    completion_metadata=CompletionMetadata(
                        id=chat_chunk.id,
                        created=chat_chunk.created,
                        model=chat_chunk.model,
                        service_tier=chat_chunk.service_tier,
                        system_fingerprint=chat_chunk.system_fingerprint,
                        usage=chat_chunk.usage,
                        provider=chat_chunk.provider,
                    ),
                )
            )
        return ChatCompletionChunk(
            id=resp_id,
            choices=choices,
            created=created,
            model=request.model,
            usage=None,
            weight_data=None,
        )

    @staticmethod
    def _split_off_finished(chunk: ChatCompletionChunk):
        """Withhold finished choices so the judge's final frame can attach
        the vote (client.rs:1633-1659)."""
        if not any(c.has_finish_reason_or_usage() for c in chunk.choices):
            return None
        finished_chunk = chunk.clone_without_choices()
        unfinished = []
        for choice in chunk.choices:
            if choice.has_finish_reason_or_usage():
                finished_chunk.choices.append(choice)
            else:
                unfinished.append(choice)
        chunk.choices = unfinished
        return finished_chunk
