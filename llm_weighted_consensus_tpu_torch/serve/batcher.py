"""Dynamic micro-batching in front of the device.

Counterpart of ``llm_weighted_consensus_tpu/serve/batcher.py``'s
``DeviceBatcher``, for the ``embed`` and ``consensus`` kinds and the
packed path, on threads and ``concurrent.futures.Future``s where the
reference runs an asyncio loop.  Callers submit device work and block on
a future; concurrent work of one key coalesces into one dispatch:

* padded (the default): consensus requests group by ``(N,
  temperature)`` and run ``consensus_confidence_tokens_many`` (one
  request: ``consensus_confidence_tokens``); embedding requests group by
  their token cap and run ``embed_tokens``;
* packed (``packing=True``, ``PACKING_ENABLED``): every request groups
  under one key, capped by its estimated segments (``packing_max_rows``
  x ``packing_max_segments``; ``max_batch`` does not cap it).  The
  group's texts are laid end to end in rows of ``packing_row_tokens``
  (``serve/packing.py``) and embedded by one ``embed_packed`` per packed
  call; embedding requests gather their vectors, consensus requests of
  any N and temperature vote on the host
  (``packing.consensus_vote_np``).  With ``prefix_dedup`` a consensus
  request whose candidates share a prefix of at least
  ``prefix_dedup_min_chars`` embeds it once and composes each candidate
  from its prefix and suffix vectors (``packing.compose_prefix_suffix``).

The pipeline, as in the reference:

* **submit time**: the caller's thread checks the queue bound
  (``max_queue_depth``; past it ``OverloadedError``, a 503) and captures
  its deadline (``resilience.deadline``); the item's tokenization, or its
  packed plan, starts on a host pool (``host_tokenizer_workers``) at
  once;
* **the flusher thread** waits ``window_ms`` for company when the
  device path is idle (less when a full group is already queued), then
  takes a pipeline slot (``pipeline_depth``) and plans ONE group from
  what is queued at that moment: the head item's key, up to
  ``max_batch`` items and ``max_rows`` encoder rows, consensus groups cut
  into power-of-two chunks where padding would waste over a quarter of
  the rows.  Before dispatch it drops items whose caller cancelled and
  fails with 504 items whose deadline cannot cover the kind's EWMA
  dispatch time; the latency lane is always planned before the offline
  lane;
* **a dispatch thread** stages the group in pinned buffers and launches
  it (a CUDA graph replay at a warmed bucket) under the embedder's
  deferred-readiness sink (``models/dispatch_seam.py``) and returns at
  enqueue, so the next group stages while this one runs;
* **a waiter thread** waits on the group's CUDA events, records its
  device time per bucket and its interval (``obs/phases.py``), recycles
  the staging buffers and resolves the futures.  The slot frees here.

Every dispatch is bracketed by the watchdog (``begin`` at its start,
``end`` at readiness).  ``utilization()`` and ``lane_occupancy()`` have
the reference's keys; ``close()`` drains before it stops.

The ring kinds (``ring_embed``, ``ring_vote``): on an embedder whose
mesh carries an sp axis (``ring_available``), a request with a text past
the dense token window (``max_tokens``) rides the long-context ring
dispatch instead of truncating, as the reference routes it.  Routing
keys off the text: ``len(text) + 2`` bounds its token count, so a request
under the window in characters stays dense at no cost, and only a longer
one pays a precise tokenization (``tokenize_ring``); an explicit
``max_tokens`` at or under the window is a truncation request and stays
dense.  Ring embeds group by their cap and make one
``embed_tokens_ring`` per group, bypassing the embed cache (its keys
assume dense truncation); each ring vote item is one
``consensus_confidence_tokens_ring`` dispatch.  On the CPU twin (no sp
mesh) both fall back to the dense kinds' dispatches.

The ``stream`` kind (``submit_stream``, the reference's ``stream_update``)
carries one streaming-consensus update: a live stream's newly finished
candidate, its device-resident buffer and its position.  Updates group by
``("stream", capacity, temperature)`` (packing on or off) and one group is
one ``stream_vote_update_tokens``: one encoder forward at the embed
bucket, each vector written into its stream's buffer on the device, one
vote launch with a count per stream, and one copy back of the wanted
confidences; the buffers never leave the device.  Its counters are
``stats()["stream"]``.

With an ``embed_cache`` (a ``cache.EmbeddingCache``, ``SCORE_CACHE_EMBED``)
an embedding request resolves its rows one by one before it queues, as
the reference's ``embed`` does: a cached row skips the device, a row that
a concurrent request is already computing is joined (the ``embed_cache``
section of ``/metrics`` counts these ``inflight_collapses``), and only
new rows ride a dispatch.  The join table is guarded by a lock, since
callers are threads here.  A row whose peer's dispatch failed (or was
cancelled by its caller) is computed again for this caller rather than
inheriting the failure, and a caller's cancellation never cancels a row
future that a peer has joined: it fails it, and the peer recomputes.

Tracing (``obs/``): contextvars do not reach the flusher, dispatch and
waiter threads, so each item carries its request's span explicitly, as
the reference's does.  ``_submit`` makes the ``batcher:{kind}`` child of
the ambient span (``queue_depth``, ``lane`` on the offline lane,
``shed="queue_full"`` or ``"deadline"`` on a shed), each dispatch gives
every traced item of its group a ``device:dispatch`` child (``kind``,
``batch_size``, and under ``MESH_FAULT_ENABLED`` the ``mesh_epoch`` the
dispatch was stamped with) bracketing what the watchdog brackets, and the
packed
path stamps each item's share of the group's ``pack_plan_ms`` and
``host_tally_ms``.  The device span finishes on the waiter thread before
the item's future resolves; the batcher span finishes when the caller
that reads the result resumes (``consensus``/``embed`` on the caller's
thread, ``wait_async`` on the chat routes' loop), as the reference's
``_submit`` finishes it after its ``await``: the caller's wake-up is queue
time, not time outside every span.  A failed, shed or cancelled item
finishes its span at once, errored.  An untraced item carries None and
costs nothing.

Phases (``obs/phases.py``), each timed on the thread doing it and
observed once per item: ``tokenize`` on the host pool (or inline on the
dispatch thread when no rows were prepared), ``batch_window`` on the
flusher for each item that sat in the window, from its arrival,
``batcher_queue`` and ``prepare_wait`` on the dispatch thread,
``launch`` in ``models/graphs.py`` for each item of the group (the
sink's spans), ``device_dispatch`` and ``finalize`` on the waiter, from
its wait's return to the answers going out.  ``stats()["phases"]``
gives each phase's exact sum and count.

Device faults (``resilience/meshfault.py``), as the reference triages
them: with a ``meshfault`` manager (``MESH_FAULT_ENABLED``) a card
dispatch that fails on either hop is classified.  A transient fault puts
the group's live items back at the front of their lane (``_requeue``:
an item past its deadline fails with 504, one re-queued
``REDISPATCH_LIMIT`` times inherits the fault and counts in
``shed_redispatch_limit``); a persistent one walks the ladder, and with
the ladder spent (on one card, at once) switches to the CPU twin
(``fallback_embedder``, ``DEVICE_WATCHDOG_CPU_FALLBACK``) and re-queues,
or, without a twin, fails the group.  An application error keeps the
fail-the-group path.  The ``DEVICE_FAULT_PLAN`` seam injects on the
dispatch thread, inside the manager's ``dispatch_guard``, before
anything is staged; a clean dispatch notes ``note_dispatch_ok`` at
readiness.  Without a manager nothing of this runs.

The twin (``use_fallback(True)``: the watchdog's trip, or the spent
ladder) serves every kind, the offline lane's too, on the CPU and touches
no CUDA state: no pinned staging buffer, no CUDA event, no graph replay
and no launch lock of the card, so it neither fails after a sticky error
nor queues behind a wedged launch.  It tokenizes inline with its own
tokenizer, as the reference's does, and makes its results on the
dispatch thread.  A stream's buffer moves to the device of the model
serving its update (``buf.data``, in place), and ``stream_buffer``
allocates a new one there.  ``fallback_dispatches`` counts the twin's
dispatches and ``fallback_active`` shows the switch; a twin dispatch's
failure is never classified.  Unlike the reference, which stops
classifying once the switch is on, a card dispatch that fails after the
switch (the other pipelined group after a sticky error) is still
classified and re-queued onto the twin.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import threading
import time
from collections import deque
from concurrent.futures import (
    CancelledError,
    Future,
    InvalidStateError,
    ThreadPoolExecutor,
)
from typing import Optional

import numpy as np

from ..errors import DeadlineExceededError, OverloadedError
from ..models import dispatch_seam as _seam
from ..models.embedder import _bucket, next_pow2
from ..obs import phases as _phases
from ..obs.span import child_span
from ..resilience.deadline import current_deadline
from ..resilience.meshfault import PERSISTENT
from . import packing as _packing

log = logging.getLogger("lwc.torch.batcher")

PACKED_KEY = ("packed",)
LANES = ("latency", "offline")


class _ItemFuture(Future):
    """An item's future; ``span`` is its batcher span, finished by the
    caller that reads the result (``_caller_done``)."""

    span = None


def _caller_done(future: Future) -> None:
    span = getattr(future, "span", None)
    if span is not None:
        span.finish()


class _Item:
    __slots__ = (
        "kind", "key", "payload", "future", "deadline", "submitted",
        "prepared", "lane", "per_row", "span", "dspan", "redispatches",
    )

    def __init__(self, kind, key, payload, deadline=None, lane="latency",
                 per_row=False, span=None):
        # "consensus", "embed", "stream", "ring_embed" or "ring_vote"
        self.kind = kind
        self.key = key
        # consensus: (texts, temperature); embed: (texts, max_tokens);
        # stream: (text, buf, position, temperature, want_conf)
        self.payload = payload
        self.future: Future = _ItemFuture()
        self.deadline = deadline
        self.submitted = time.perf_counter()
        # the submit-time tokenization (a host-pool future), or None
        self.prepared = None
        self.lane = lane
        # embed: resolve with the token count of each row (the row cache
        # keeps them), not their sum
        self.per_row = per_row
        # the request's batcher:{kind} span and, once its group
        # dispatches, that span's device:dispatch child; None untraced
        self.span = span
        self.dspan = None
        # fault re-queues so far (bounded by REDISPATCH_LIMIT)
        self.redispatches = 0

    @property
    def texts(self) -> list:
        if self.kind == "stream":
            return [self.payload[0]]
        return self.payload[0]


class _StagedGroup:
    """What the dispatch hop hands the waiter hop: the group's sink and
    the closure that makes its results after readiness."""

    __slots__ = ("sink", "finalize")

    def __init__(self, sink, finalize) -> None:
        self.sink = sink
        self.finalize = finalize


def _value(out) -> np.ndarray:
    """A dispatch's output on the host: a ``models.graphs.Dispatch``
    handle's result (after readiness), or an array as it is."""
    result = getattr(out, "result", None)
    return result() if result is not None else np.asarray(out)


def _resolve(future: Future, result=None, exc=None) -> None:
    """Set a future that its caller may have cancelled meanwhile."""
    try:
        if exc is not None:
            future.set_exception(exc)
        else:
            future.set_result(result)
    except InvalidStateError:
        pass


def _settle(item, result=None, exc=None) -> None:
    """Finish the item's device span (and, on an error, its batcher
    span), then resolve it."""
    if item.span is not None:
        status = "error" if exc is not None else None
        if item.dspan is not None:
            item.dspan.finish(status)
        if exc is not None:
            item.span.finish(status)
    _resolve(item.future, result, exc)


def _finish_if_cancelled(span):
    """The caller left: its batcher span ends there, errored."""

    def done(future: Future) -> None:
        if future.cancelled():
            span.finish("error")

    return done


class DeviceBatcher:
    """Collects concurrent device work and dispatches it in batches.

    ``window_ms`` bounds the extra latency a lone request pays waiting for
    company; ``max_batch`` bounds padded items per dispatch and
    ``max_rows`` encoder rows.
    ``window_ms=0`` still batches whatever accumulates behind an in-flight
    dispatch.  ``fallback_embedder`` is the CPU twin and ``meshfault`` the
    device-fault manager (module doc)."""

    # each item survives at most this many fault re-queues before it
    # inherits the device exception: a backstop so that a fault loop can
    # never recycle one item forever
    REDISPATCH_LIMIT = 8

    def __init__(
        self,
        embedder,
        metrics=None,
        *,
        window_ms: float = 3.0,
        max_batch: int = 64,
        pipeline_depth: int = 2,
        max_rows: int = 512,
        max_queue_depth: int = 0,
        watchdog=None,
        packing: bool = False,
        packing_row_tokens: int = 512,
        packing_max_rows: int = 8,
        packing_max_segments: int = 64,
        prefix_dedup: bool = True,
        prefix_dedup_min_chars: int = 48,
        host_tokenizer_workers: int = 2,
        embed_cache=None,
        fallback_embedder=None,
        meshfault=None,
    ) -> None:
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.embedder = embedder
        self.metrics = metrics
        self.window_ms = float(window_ms)
        self.max_batch = int(max_batch)
        self.pipeline_depth = max(1, int(pipeline_depth))
        self.max_rows = max(1, int(max_rows))
        # the configured capacity, which ``rescale_capacity`` scales
        self._base_max_batch = self.max_batch
        self._base_max_rows = self.max_rows
        self.max_queue_depth = max(0, int(max_queue_depth))
        self.watchdog = watchdog
        # the reference's clamps (serve/config.py)
        self.packing = bool(packing) and bool(
            getattr(embedder, "supports_packing", lambda: False)()
        )
        self.packing_row_tokens = max(16, int(packing_row_tokens))
        self.packing_max_rows = max(1, int(packing_max_rows))
        self.packing_max_segments = max(1, int(packing_max_segments))
        self.prefix_dedup = bool(prefix_dedup)
        self.prefix_dedup_min_chars = max(1, int(prefix_dedup_min_chars))
        self.host_tokenizer_workers = max(0, int(host_tokenizer_workers))
        self.embed_cache = embed_cache
        self.fallback_embedder = fallback_embedder
        self._use_fallback = False
        self.meshfault = meshfault
        # row fingerprint -> the Future of the request computing it; the
        # lock guards this table, the cache and the collapse counter
        self._embed_lock = threading.Lock()
        self._embed_inflight: dict = {}
        self._embed_collapses = 0
        # one condition guards the queues, the in-flight table and every
        # counter below; the dispatch and waiter threads take it briefly
        self._cond = threading.Condition()
        self._pending: list = []
        self._pending_offline: list = []
        self._inflight: dict = {}  # token -> (start, lane)
        self._closed = False
        self._slots = threading.Semaphore(self.pipeline_depth)
        self._started = time.perf_counter()
        self._ewma_ms: dict = {}
        self.shed_queue_full = 0
        self.shed_deadline = 0
        self.shed_redispatch_limit = 0
        self.cancelled_items = 0
        self.fallback_dispatches = 0
        self._busy: deque = deque(maxlen=1024)
        self._dispatches = 0
        self._items = 0
        self._lane_dispatches = {lane: 0 for lane in LANES}
        self._lane_items = {lane: 0 for lane in LANES}
        self._lane_busy = {lane: deque(maxlen=1024) for lane in LANES}
        # the port's per-kind view (stats())
        self._kind_dispatches = {"consensus": 0, "embed": 0}
        self._requests = {"consensus": 0, "embed": 0}
        self._largest_group = 0
        self._stream_dispatches = 0
        self._stream_requests = 0
        self._stream_largest_group = 0
        self._packed_dispatches = 0
        self._pack_real_tokens = 0
        self._pack_slot_tokens = 0
        self._pad_real_tokens = 0
        self._pad_slot_tokens = 0
        self._dedup_hits = 0
        self._dedup_tokens_saved = 0
        self._fallback_items = 0
        self._occupancy: dict = {}  # packed call rows B -> calls
        self._call_shapes: dict = {}  # "BxL" -> packed calls
        self._dispatchers = ThreadPoolExecutor(
            self.pipeline_depth, thread_name_prefix="lwc-torch-device"
        )
        self._waiters = ThreadPoolExecutor(
            self.pipeline_depth, thread_name_prefix="lwc-torch-waiter"
        )
        self._tok_pool = (
            ThreadPoolExecutor(self.host_tokenizer_workers,
                               thread_name_prefix="lwc-torch-hosttok")
            if self.host_tokenizer_workers else None
        )
        self._flusher = threading.Thread(
            target=self._flush_loop, name="lwc-torch-flusher", daemon=True
        )
        self._flusher.start()
        if metrics is not None:
            metrics.register_provider("device_batcher", self.utilization)
            if embed_cache is not None:
                metrics.register_provider(
                    "embed_cache", self._embed_cache_stats
                )

    def _embed_cache_stats(self) -> dict:
        with self._embed_lock:
            stats = self.embed_cache.stats()
            stats["inflight_collapses"] = self._embed_collapses
        return stats

    # -- caller side ---------------------------------------------------------

    def submit_consensus(
        self, texts, temperature: float = 0.05, priority: str = "latency"
    ) -> Future:
        """-> Future of (confidence[N] np.ndarray, prompt token count).
        Over-length candidates on an sp mesh ride the ring (module doc)."""
        texts = list(texts)
        if self._route_ring(texts):
            return self._submit(
                "ring_vote", ("ring_vote", len(texts), float(temperature)),
                (texts, float(temperature)), priority,
            )
        key = (
            PACKED_KEY if self.packing
            else ("consensus", len(texts), float(temperature))
        )
        return self._submit(
            "consensus", key, (texts, float(temperature)), priority
        )

    def submit_embed(
        self, texts, max_tokens: Optional[int] = None,
        priority: str = "latency",
    ) -> Future:
        """-> Future of (embeddings[B, H] np.ndarray, prompt token
        count).  Padded embedding requests group by ``max_tokens``.  With
        an ``embed_cache``, rows resolve through it first (module doc)."""
        texts = list(texts)
        if self._route_ring(texts, max_tokens):
            return self._submit("ring_embed", ("ring_embed", max_tokens),
                                (texts, max_tokens), priority)
        cache = self.embed_cache
        if cache is None or not cache.enabled or not texts:
            return self._submit("embed", self._embed_key(max_tokens),
                                (texts, max_tokens), priority)
        return self._submit_embed_cached(texts, max_tokens, priority)

    def _embed_key(self, max_tokens):
        return PACKED_KEY if self.packing else ("embed", max_tokens)

    def _route_ring(self, texts: list, max_tokens=None) -> bool:
        """Whether this request rides the ring dispatch (module doc)."""
        embedder = self.embedder
        if not texts or not getattr(embedder, "ring_available",
                                    lambda: False)():
            return False
        cap = embedder.max_tokens
        if max_tokens is not None and int(max_tokens) <= cap:
            return False
        if all(len(t) + 2 <= cap for t in texts):
            return False
        _, mask = embedder.tokenize_ring(texts, max_tokens)
        return int(mask.sum(axis=1).max(initial=0)) > cap

    def _submit_embed_cached(self, texts, max_tokens, priority) -> Future:
        """The reference's per-row cache path of ``embed`` on threads:
        cached rows, joined rows and this call's own rows, combined into
        one Future when the last of them resolves."""
        from ..cache.fingerprint import embed_fingerprint

        model_id = getattr(self.embedder, "model_name", "") or ""
        fps = [embed_fingerprint(model_id, t, max_tokens) for t in texts]
        rows: list = [None] * len(texts)
        joins: list = []  # (row position, row Future: ours or a peer's)
        own: list = []  # (fingerprint, row Future) this call computes
        own_texts: list = []
        with self._embed_lock:
            for i, fp in enumerate(fps):
                hit = self.embed_cache.get(fp)
                if hit is not None:
                    rows[i] = hit
                    continue
                fut = self._embed_inflight.get(fp)
                if fut is None:
                    fut = Future()
                    self._embed_inflight[fp] = fut
                    own.append((fp, fut))
                    own_texts.append(texts[i])
                else:
                    # identical row already being computed (by a
                    # concurrent request, or earlier in THIS text list)
                    self._embed_collapses += 1
                joins.append((i, fut))
        out: Future = Future()
        if own:
            try:
                inner = self._submit(
                    "embed", self._embed_key(max_tokens),
                    (own_texts, max_tokens),
                    priority, per_row=True,
                )
            except BaseException as exc:
                self._settle_rows(own, exc=exc)
                raise
            inner.add_done_callback(
                lambda f: self._settle_rows(own, done=f))
            # the caller leaving drops its dispatch; rows a peer joined
            # fail (they are never cancelled) and the peer recomputes them
            out.add_done_callback(
                lambda f: inner.cancel() if f.cancelled() else None)
        mine = {id(fut) for _, fut in own}
        pending = [len(joins)]
        lock = threading.Lock()

        def combine() -> None:
            retry = []
            for i, fut in joins:
                exc = (CancelledError() if fut.cancelled()
                       else fut.exception())
                if exc is None:
                    rows[i] = fut.result()
                elif id(fut) in mine:
                    _resolve(out, exc=exc)  # this call's own dispatch
                    return
                else:
                    retry.append(i)  # a peer's dispatch failed: recompute
            if not retry:
                _resolve(out, self._stack_rows(rows))
                return
            try:
                again = self._submit(
                    "embed", self._embed_key(max_tokens),
                    ([texts[i] for i in retry], max_tokens), priority,
                    per_row=True,
                )
            except BaseException as exc:
                _resolve(out, exc=exc)
                return

            def refill(f: Future) -> None:
                if f.cancelled() or f.exception() is not None:
                    _resolve(out, exc=CancelledError() if f.cancelled()
                             else f.exception())
                    return
                vecs, row_tokens = f.result()
                for j, i in enumerate(retry):
                    rows[i] = (vecs[j], int(row_tokens[j]))
                _resolve(out, self._stack_rows(rows))

            again.add_done_callback(refill)

        def joined(_f) -> None:
            with lock:
                pending[0] -= 1
                last = pending[0] == 0
            if last:
                combine()

        if not joins:
            _resolve(out, self._stack_rows(rows))
        for _, fut in joins:
            fut.add_done_callback(joined)
        return out

    def _settle_rows(self, own: list, done: Future = None, exc=None) -> None:
        """Resolve this call's row Futures from its dispatch ``done`` (or
        fail them with ``exc``), caching the rows of a success and
        freeing their join-table entries."""
        if done is not None:
            exc = CancelledError() if done.cancelled() else done.exception()
            _caller_done(done)  # the rows' consumer is this callback
        values = None
        if exc is None:
            vecs, row_tokens = done.result()
            values = [(np.array(vecs[j], dtype=np.float32),
                       int(row_tokens[j])) for j in range(len(own))]
        with self._embed_lock:
            for j, (fp, _) in enumerate(own):
                if self._embed_inflight.get(fp) is own[j][1]:
                    del self._embed_inflight[fp]
                if values is not None:
                    self.embed_cache.put_row(fp, *values[j])
        for j, (_, fut) in enumerate(own):
            _resolve(fut, None if values is None else values[j], exc=exc)

    @staticmethod
    def _stack_rows(rows: list) -> tuple:
        return (np.stack([r[0] for r in rows]).astype(np.float32, copy=False),
                int(sum(r[1] for r in rows)))

    def submit_stream(
        self, text: str, buf, position: int, temperature: float = 0.05,
        want_conf: bool = True,
    ) -> Future:
        """One streaming-consensus update -> Future of confidence[CAP]
        (np.ndarray; None with ``want_conf=False``: a stream folding K
        candidates at once reads only the last, so the others skip the
        copy back).  Groups with other live streams' updates at the same
        capacity and temperature; ``buf`` stays on the device and is
        written in place."""
        temperature = float(temperature)
        key = ("stream", int(buf.shape[0]), temperature)
        return self._submit(
            "stream", key,
            (text, buf, int(position), temperature, bool(want_conf)),
            "latency",
        )

    def consensus(self, texts, temperature: float = 0.05,
                  priority: str = "latency"):
        return self.wait(self.submit_consensus(texts, temperature, priority))

    def embed(self, texts, max_tokens: Optional[int] = None,
              priority: str = "latency"):
        return self.wait(self.submit_embed(texts, max_tokens, priority))

    @staticmethod
    def wait(future: Future):
        """A submitted item's result, waited for on the caller's thread; a
        caller that leaves (an exception in its thread) cancels its item,
        which is then dropped before dispatch."""
        try:
            out = future.result()
        except BaseException:
            future.cancel()
            raise
        _caller_done(future)
        return out

    @staticmethod
    async def wait_async(future: Future):
        """A submitted item's result, awaited from a coroutine; a
        cancelled caller cancels the item."""
        out = await asyncio.wrap_future(future)
        _caller_done(future)
        return out

    def _submit(self, kind, key, payload, priority,
                per_row: bool = False) -> Future:
        offline = priority == "offline"
        # submit -> result for THIS request's item, a child of the caller's
        # ambient span (made here, on the caller's thread)
        with self._cond:
            if self._closed:
                raise RuntimeError("batcher is closed")
            depth = len(self._pending)
            # the queue bound guards the latency lane only: offline feeds
            # limit themselves by waiting on their futures
            shed = (not offline and self.max_queue_depth
                    and depth >= self.max_queue_depth)
            if shed:
                self.shed_queue_full += 1
        span = child_span(
            f"batcher:{kind}", queue_depth=depth,
            **({"lane": "offline"} if offline else {}),
        )
        if shed:
            if self.metrics is not None:
                self.metrics.observe("device:shed:queue_full", 0.0,
                                     error=True)
            if span is not None:
                span.annotate(shed="queue_full")
                span.finish("error")
            raise OverloadedError("batcher_queue_full")
        item = _Item(kind, key, payload, current_deadline(),
                     lane="offline" if offline else "latency",
                     per_row=per_row, span=span)
        if span is not None:
            item.future.span = span
            item.future.add_done_callback(_finish_if_cancelled(span))
        if self._tok_pool is not None:
            # submit-time tokenization: the rows (or the packed plan)
            # build now, overlapping earlier groups' device time
            item.prepared = self._tok_pool.submit(
                self._prepare_item, kind, key, payload, span
            )
        with self._cond:
            if self._closed:
                raise RuntimeError("batcher is closed")
            (self._pending_offline if offline else self._pending).append(item)
            self._cond.notify_all()
        return item.future

    # -- the flusher ---------------------------------------------------------

    # caller-holds-lock: DeviceBatcher._cond (the flusher's loop and _plan_round test the queues inside their with-_cond blocks)
    def _has_pending(self) -> bool:
        return bool(self._pending or self._pending_offline)

    def _flush_loop(self) -> None:
        while True:
            window = None
            with self._cond:
                while not self._has_pending() and not self._closed:
                    self._cond.wait()
                if not self._has_pending():
                    return  # closed and empty
                if self.window_ms > 0 and not self._inflight:
                    # the accumulation window: a lone arrival waits for
                    # company, arrivals behind in-flight work do not
                    window = _phases.phase("batch_window", ()).enter()
                    end = time.perf_counter() + self.window_ms / 1e3
                    while not self._closed and not self._head_group_full():
                        left = end - time.perf_counter()
                        if left <= 0:
                            break
                        self._cond.wait(left)
                    sat = [(item.span, item.submitted) for item in
                           self._pending + self._pending_offline]
            if window is not None:
                # each item that sat in it, from its arrival
                window.leave(sat)
            self._plan_round()

    def _plan_round(self) -> None:
        """Dispatch groups, one per pipeline slot, while items are
        queued: each group is planned only once its slot is free, from
        whatever is queued then."""
        while True:
            self._slots.acquire()
            # the slot and the in-flight entry pass to ``_run_group`` only
            # once it is submitted; every other way out gives them back
            group, token, handed = [], None, False
            try:
                with self._cond:
                    # shed after the slot wait: that queueing delay is
                    # where deadlines die under overload
                    group = self._shed_group(self._next_group())
                    if group:
                        token, t0 = object(), time.perf_counter()
                        self._inflight[token] = (t0, group[0].lane)
                        self._count_group(group)
                if group:
                    self._dispatchers.submit(self._run_group, group, token,
                                             t0)
                    handed = True
            except Exception as exc:
                # e.g. the dispatch executor refused the group (shut down
                # in a drain race): the group fails, the flusher lives on
                log.error("device group not dispatched", exc_info=exc)
                for item in group:
                    _settle(item, exc=exc)
            finally:
                if not handed:
                    if token is not None:
                        with self._cond:
                            self._inflight.pop(token, None)
                            self._cond.notify_all()
                    self._slots.release()
            with self._cond:
                if not self._has_pending():
                    return

    # caller-holds-lock: DeviceBatcher._cond (only called inside the flusher's with-_cond blocks)
    def _count_group(self, group: list) -> None:
        key = group[0].key
        if key == PACKED_KEY:
            self._packed_dispatches += 1
        elif key[0] == "stream":
            self._stream_dispatches += 1
            self._stream_requests += len(group)
            self._stream_largest_group = max(self._stream_largest_group,
                                             len(group))
            return
        else:
            # the ring kinds show once they have run
            self._kind_dispatches[key[0]] = (
                self._kind_dispatches.get(key[0], 0) + 1)
        for item in group:
            self._requests[item.kind] = self._requests.get(item.kind, 0) + 1
        self._largest_group = max(self._largest_group, len(group))

    @staticmethod
    def _est_kind(item) -> str:
        """The EWMA and metrics series of an item's dispatch: packed
        groups mix kinds and report as one "packed" series."""
        return "packed" if item.key == PACKED_KEY else item.kind

    @staticmethod
    def _rows(item) -> int:
        """Encoder rows (packed: estimated segments) one item adds."""
        return max(1, len(item.texts))

    def _budget(self, key) -> int:
        if key == PACKED_KEY:
            return self.packing_max_rows * self.packing_max_segments
        return self.max_rows

    # caller-holds-lock: DeviceBatcher._cond (only called inside the flusher's with-_cond blocks)
    def _head_group_full(self) -> bool:
        """Whether the head key already fills a group, so the window need
        not run out."""
        pending = self._pending or self._pending_offline
        key = pending[0].key
        budget, rows, count = self._budget(key), 0, 0
        for item in pending:
            if item.key != key:
                continue
            rows += self._rows(item)
            count += 1
            if rows >= budget or (key != PACKED_KEY
                                  and count >= self.max_batch):
                return True
        return False

    # caller-holds-lock: DeviceBatcher._cond (only called inside the flusher's with-_cond blocks)
    def _next_group(self) -> list:
        """Plan ONE group from the live queue: the head item's key,
        joined by every same-key item in arrival order up to
        ``max_batch`` items (padded only) and the row budget; the rest
        stays queued.  The latency lane is planned first; the offline lane
        only when the latency lane is empty.  A consensus group keeps the
        power-of-two chunk policy: the first chunk dispatches now, the
        rest returns to the front of the queue."""
        from_latency = bool(self._pending)
        pending = self._pending if from_latency else self._pending_offline
        if not pending:
            return []
        key = pending[0].key
        budget = self._budget(key)
        take, rest, rows = [], [], 0
        closed = False  # per-key FIFO: once one item misses, later ones wait
        for item in pending:
            r = self._rows(item)
            if (
                item.key == key
                and not closed
                and (key == PACKED_KEY or len(take) < self.max_batch)
                and (not take or rows + r <= budget)
            ):
                take.append(item)
                rows += r
            else:
                if item.key == key:
                    closed = True
                rest.append(item)
        if take and key[0] == "consensus":
            chunks = list(self._pow2_chunks(take))
            if len(chunks) > 1:
                rest = [i for c in chunks[1:] for i in c] + rest
                take = chunks[0]
        if from_latency:
            self._pending = rest
        else:
            self._pending_offline = rest
        return take

    @staticmethod
    def _pow2_chunks(group: list):
        """Split a consensus group into power-of-two chunks wherever its
        padded dispatch would waste over a quarter of the rows; otherwise
        pass it through whole."""
        if group[0].kind != "consensus":
            yield group
            return
        start, remaining = 0, len(group)
        while remaining:
            bucket = next_pow2(remaining)
            if (bucket - remaining) * 4 <= bucket:
                yield group[start:]
                return
            size = bucket // 2
            yield group[start : start + size]
            start += size
            remaining -= size

    # caller-holds-lock: DeviceBatcher._cond (only called inside the flusher's with-_cond blocks)
    def _shed_group(self, group: list) -> list:
        """The items still worth dispatching: items whose caller cancelled
        are dropped; items whose deadline has expired, or has less left
        than the kind's EWMA dispatch time, fail with 504."""
        live = []
        for item in group:
            if item.future.done():
                self.cancelled_items += 1
                continue
            deadline = item.deadline
            if deadline is not None:
                estimate = self._ewma_ms.get(self._est_kind(item))
                if deadline.expired() or (
                    estimate is not None
                    and deadline.remaining() * 1e3 < estimate
                ):
                    if item.span is not None:
                        item.span.annotate(shed="deadline")
                    _settle(item, exc=DeadlineExceededError(
                        "shed before device dispatch"))
                    self.shed_deadline += 1
                    if self.metrics is not None:
                        self.metrics.observe("device:shed:deadline", 0.0,
                                             error=True)
                    continue
            live.append(item)
        return live

    # -- the dispatch and waiter hops ------------------------------------------

    def _run_group(self, group: list, token, t0: float) -> None:
        for item in group:
            _phases.observe_phase(
                "batcher_queue", (t0 - item.submitted) * 1e3
            )
        # one device child per traced item, bracketing what the watchdog
        # brackets: staging, the launch and readiness on the waiter
        # the branch and the shape epoch this dispatch is stamped with: a
        # fault hands the epoch to ``downsize``, and a twin's failure is
        # never classified
        twin = self._use_fallback and self.fallback_embedder is not None
        epoch = self.meshfault.epoch if self.meshfault is not None else None
        extra = {"mesh_epoch": epoch} if epoch is not None else {}
        for item in group:
            if item.span is not None:
                item.dspan = item.span.child(
                    "device:dispatch", kind=item.kind,
                    batch_size=len(group), **extra)
        wd = (self.watchdog.begin(self._est_kind(group[0]))
              if self.watchdog is not None else None)
        try:
            staged = self._dispatch(group, twin)
            self._waiters.submit(self._await_group, group, staged, t0,
                                 token, wd, twin, epoch)
        except Exception as exc:
            self._failed(group, t0, token, wd, exc, twin, epoch)

    def _await_group(self, group, staged, t0, token, wd, twin=False,
                     epoch=None) -> None:
        finalize = _phases.phase("finalize", [item.span for item in group])
        try:
            results = self._finalize_group(staged, finalize)
        except Exception as exc:
            finalize.leave()
            self._failed(group, t0, token, wd, exc, twin, epoch)
            return
        answers = []
        for item, result in zip(group, results):
            if item.kind == "embed" and not item.per_row:
                result = (result[0], int(np.sum(result[1])))
            answers.append(result)
        self._finish(group, t0, token, wd, results=answers,
                     finalize=finalize)

    def _failed(self, group, t0, token, wd, exc, twin, epoch) -> None:
        """A dispatch raised on either hop: the device-fault triage
        (module doc), then the group's end."""
        kind = (self.meshfault.classify(exc)
                if self.meshfault is not None and not twin else None)
        if kind is None:
            log.error("device dispatch failed", exc_info=exc)
            self._finish(group, t0, token, wd, exc=exc)
            return
        log.warning("device fault (%s): %s", kind, exc)
        requeued = False
        try:
            requeued = self._handle_device_fault(kind, exc, group, epoch)
        finally:
            self._finish(group, t0, token, wd,
                         exc=None if requeued else exc, requeued=requeued)

    def _handle_device_fault(self, kind, exc, group, epoch) -> bool:
        """A classified fault: a persistent one walks the ladder, and a
        spent ladder switches to the CPU twin (the last resort) or,
        without a twin, fails the group (False).  Every surviving path
        re-queues the group's live items (True)."""
        if kind == PERSISTENT and not self.meshfault.downsize(
                observed_epoch=epoch):
            if self.fallback_embedder is None:
                return False
            self.use_fallback(True)
        self._requeue(group, exc)
        return True

    def _requeue(self, group, exc) -> None:
        """Put a faulted group's items back at the FRONT of their own
        lane (they are the oldest work), bounded by their deadlines (an
        item past its budget fails with 504, as the pre-dispatch shed
        does) and by ``REDISPATCH_LIMIT``."""
        live = []
        for item in group:
            if item.future.done():
                self._count(cancelled_items=1)
                continue
            if item.deadline is not None and item.deadline.expired():
                if item.span is not None:
                    item.span.annotate(shed="deadline")
                _settle(item, exc=DeadlineExceededError(
                    "deadline expired during re-dispatch"))
                self._count(shed_deadline=1)
                if self.metrics is not None:
                    self.metrics.observe("device:shed:deadline", 0.0,
                                         error=True)
                continue
            if item.redispatches >= self.REDISPATCH_LIMIT:
                # observable like the deadline shed: a fault loop that
                # exhausts items shows in /metrics, not only at clients
                if item.span is not None:
                    item.span.annotate(shed="redispatch_limit")
                _settle(item, exc=exc)
                self._count(shed_redispatch_limit=1)
                if self.metrics is not None:
                    self.metrics.observe("device:shed:redispatch", 0.0,
                                         error=True)
                continue
            item.redispatches += 1
            if item.dspan is not None:
                item.dspan.finish("error")
                item.dspan = None
            live.append(item)
        if not live:
            return
        with self._cond:
            self._pending[:0] = [i for i in live if i.lane != "offline"]
            self._pending_offline[:0] = [i for i in live
                                         if i.lane == "offline"]
            self._cond.notify_all()
        self.meshfault.note_redispatch(len(live))

    def _finish(self, group, t0, token, wd, *, results=None,
                exc=None, requeued=False, finalize=None) -> None:
        """Count the dispatch, then answer its items (``results``, or
        ``exc`` for every one; nothing when the fault triage re-queued
        them), then free its pipeline slot.  Counting first means a
        caller woken by its answer reads counters that include its
        dispatch, as on the reference's one loop (the offline drive's
        ``lanes``); a fault in the counting still answers the items and
        frees the slot.  The ``finalize`` phase ends as the answers go
        out."""
        try:
            self._observe(group, t0, token,
                          error=exc is not None or requeued)
        finally:
            if finalize is not None:
                finalize.leave()
            for k, item in enumerate(group):
                if requeued:
                    break
                if exc is not None:
                    _settle(item, exc=exc)
                else:
                    _settle(item, results[k])
            if wd is not None:
                self.watchdog.end(wd)
            self._slots.release()
            with self._cond:
                self._cond.notify_all()

    def _observe(self, group, t0, token, *, error: bool) -> None:
        end = time.perf_counter()
        series = self._est_kind(group[0])
        lane = group[0].lane
        with self._cond:
            self._inflight.pop(token, None)
            self._busy.append((t0, end))
            self._dispatches += 1
            self._items += len(group)
            self._lane_dispatches[lane] += 1
            self._lane_items[lane] += len(group)
            self._lane_busy[lane].append((t0, end))
            if not error:
                ms = (end - t0) * 1e3
                prev = self._ewma_ms.get(series)
                self._ewma_ms[series] = (
                    ms if prev is None else 0.8 * prev + 0.2 * ms
                )
        if self.metrics is not None:
            # exemplar: the first traced item links the series to a span
            # tree (the explicit handle: this thread has no ambient span)
            trace_id = next((item.span.trace.trace_id for item in group
                             if item.span is not None), None)
            self.metrics.observe(f"device:batch:{series}", (end - t0) * 1e3,
                                 error=error, trace_id=trace_id)

    def _dispatch(self, group: list, twin: bool = False) -> _StagedGroup:
        """Stage and enqueue the group under a deferred-readiness sink;
        the returned closure makes its results after readiness.  On the
        twin the results are made here, inline (no sink)."""
        if group[0].key == PACKED_KEY:
            fn = self._dispatch_packed
        else:
            fn = getattr(self, "_dispatch_" + group[0].kind)
        if twin:
            self._count(fallback_dispatches=1)
            with _seam.deferred_readiness(None):
                results = fn(group, self.fallback_embedder)()
            return _StagedGroup(None, lambda: results)
        sink = _seam.DispatchSink([item.span for item in group])
        guard = (self.meshfault.dispatch_guard()
                 if self.meshfault is not None else contextlib.nullcontext())
        with guard:
            if self.meshfault is not None:
                # the DEVICE_FAULT_PLAN seam: on the dispatch thread,
                # before anything is staged or launched
                self.meshfault.maybe_inject()
            try:
                with _seam.deferred_readiness(sink):
                    finalize = fn(group, self.embedder)
            except BaseException:
                # no waiter will see these launches ready
                for record in sink.pending:
                    if record.timed:
                        _phases.forget_device_launch(record.t0)
                raise
        return _StagedGroup(sink, finalize)

    def _finalize_group(self, staged: _StagedGroup, finalize) -> list:
        """Waiter hop: wait on the group's dispatches, record device time
        and intervals, recycle the staging buffers, make the results (the
        twin's are made already); the ``finalize`` phase starts once the
        wait has returned."""
        if staged.sink is None:
            finalize.enter()
            return staged.finalize()
        pool = getattr(self.embedder, "staging_pool", None)
        _seam.drain_sink(
            staged.sink,
            observe_device=_phases.observe_device,
            observe_interval=_phases.observe_device_interval,
            release=pool.release if pool is not None else None,
            retain=pool.retain if pool is not None else None,
            forget_launch=_phases.forget_device_launch,
        )
        finalize.enter()
        results = staged.finalize()
        if self.meshfault is not None:
            # a dispatch resets the transient streak once its device work
            # completed, not merely enqueued
            self.meshfault.note_dispatch_ok()
        return results

    # -- submit-time host work -------------------------------------------------

    def _prepare_item(self, kind, key, payload, span=None):
        """An item's padded rows, or its packed plan (host pool), timed
        as its ``tokenize`` phase."""
        with _phases.phase("tokenize", (span,)):
            if key == PACKED_KEY:
                return self._plan_packed_payload(kind, payload, self.embedder)
            if kind == "embed":
                texts, cap = payload
                return self.embedder.tokenize(texts, cap)
            if kind == "stream":
                return self.embedder.tokenize([payload[0]])
            if kind == "ring_embed":
                return self.embedder.tokenize_ring(*payload)
            if kind == "ring_vote":
                return self.embedder.tokenize_ring(payload[0])
            return self.embedder.tokenize(payload[0])

    def _prepared_rows(self, group: list, embedder):
        """The group's submit-time rows concatenated into the batch one
        group-level ``tokenize`` would give: each item's rows padded from
        its own sequence bucket to the group's (pad id, mask 0).  None
        when an item has no prepared rows, or on the twin (it tokenizes
        inline)."""
        if embedder is not self.embedder:
            return None
        rows = []
        for item in group:
            if item.prepared is None:
                return None
            with _phases.phase("prepare_wait", (item.span,)):
                rows.append(item.prepared.result())  # re-raises its errors
        if len(rows) == 1:
            return rows[0]
        width = max(ids.shape[1] for ids, _ in rows)
        pad_id = int(
            getattr(getattr(embedder, "tokenizer", None), "pad_id", 0) or 0
        )
        ids_parts, mask_parts = [], []
        for ids, mask in rows:
            gap = width - ids.shape[1]
            if gap:
                ids = np.pad(ids, ((0, 0), (0, gap)), constant_values=pad_id)
                mask = np.pad(mask, ((0, 0), (0, gap)))
            ids_parts.append(ids)
            mask_parts.append(mask)
        return np.concatenate(ids_parts), np.concatenate(mask_parts)

    # -- padded dispatches ------------------------------------------------------

    def _count(self, **deltas) -> None:
        with self._cond:
            for name, delta in deltas.items():
                setattr(self, name, getattr(self, name) + int(delta))

    def _dispatch_embed(self, group: list, embedder):
        max_tokens = group[0].payload[1]
        counts = [len(item.texts) for item in group]
        prepared = self._prepared_rows(group, embedder)
        if prepared is not None:
            ids, mask = prepared
        else:
            texts = [t for item in group for t in item.texts]
            with _phases.phase("tokenize", [item.span for item in group]):
                ids, mask = embedder.tokenize(texts, max_tokens)
        self._count(
            _pad_real_tokens=mask.sum(),
            _pad_slot_tokens=_bucket(ids.shape[0], embedder.MAX_DEVICE_BATCH)
            * ids.shape[1],
        )
        emb = embedder.embed_tokens(ids, mask)
        row_tokens = mask.sum(axis=1)

        def finalize() -> list:
            vecs = _value(emb)
            out, start = [], 0
            for count in counts:
                stop = start + count
                out.append((vecs[start:stop], row_tokens[start:stop]))
                start = stop
            return out

        return finalize

    def _dispatch_consensus(self, group: list, embedder):
        texts0, temperature = group[0].payload
        n = len(texts0)
        prepared = self._prepared_rows(group, embedder)
        if prepared is not None:
            ids, mask = prepared
        else:
            with _phases.phase("tokenize", [item.span for item in group]):
                ids, mask = embedder.tokenize(
                    [t for item in group for t in item.texts]
                )
        r, s = len(group), ids.shape[1]
        if r == 1:
            self._count(_pad_real_tokens=mask.sum(), _pad_slot_tokens=ids.size)
            conf = embedder.consensus_confidence_tokens(ids, mask, temperature)
            tok = int(mask.sum())
            return lambda: [(_value(conf), tok)]
        # the grouped dispatch pads the request axis to its pow2 bucket
        self._count(_pad_real_tokens=mask.sum(),
                    _pad_slot_tokens=next_pow2(r) * n * s)
        conf = embedder.consensus_confidence_tokens_many(
            ids.reshape(r, n, s), mask.reshape(r, n, s), temperature
        )
        tokens = mask.reshape(r, n * s).sum(axis=1)

        def finalize() -> list:
            conf_np = _value(conf)
            return [(conf_np[i], int(tokens[i])) for i in range(r)]

        return finalize

    # -- long-context ring dispatches --------------------------------------------

    def _dispatch_ring_embed(self, group: list, embedder):
        """Over-length embed items -> full-length vectors from one
        ``embed_tokens_ring``; on the twin, the dense dispatch."""
        if not embedder.ring_available():
            return self._dispatch_embed(group, embedder)
        max_tokens = group[0].payload[1]
        counts = [len(item.texts) for item in group]
        prepared = self._prepared_rows(group, embedder)
        if prepared is not None:
            ids, mask = prepared
        else:
            ids, mask = embedder.tokenize_ring(
                [t for item in group for t in item.texts], max_tokens)
        self._count(
            _pad_real_tokens=mask.sum(),
            _pad_slot_tokens=embedder._pad_to(
                _bucket(ids.shape[0], embedder.MAX_DEVICE_BATCH))
            * ids.shape[1],
        )
        emb = embedder.embed_tokens_ring(ids, mask)
        row_tokens = mask.sum(axis=1)

        def finalize() -> list:
            vecs = _value(emb)
            out, start = [], 0
            for count in counts:
                stop = start + count
                out.append((vecs[start:stop], row_tokens[start:stop]))
                start = stop
            return out

        return finalize

    def _dispatch_ring_vote(self, group: list, embedder):
        """Over-length consensus items, one
        ``consensus_confidence_tokens_ring`` dispatch each (no grouped
        ring vote, as in the reference); on the twin, the dense
        dispatch."""
        if not embedder.ring_available():
            return self._dispatch_consensus(group, embedder)
        staged = []
        for item in group:
            if item.prepared is not None:
                ids, mask = item.prepared.result()  # re-raises its errors
            else:
                ids, mask = embedder.tokenize_ring(item.texts)
            self._count(_pad_real_tokens=mask.sum(), _pad_slot_tokens=ids.size)
            conf = embedder.consensus_confidence_tokens_ring(
                ids, mask, item.payload[1])
            staged.append((conf, int(mask.sum())))
        return lambda: [(_value(conf), tok) for conf, tok in staged]

    def _dispatch_stream(self, group: list, embedder):
        """R streams' updates in one dispatch; only the wanted
        confidences come back, in one copy."""
        prepared = self._prepared_rows(group, embedder)
        if prepared is not None:
            ids, mask = prepared
        else:
            ids, mask = embedder.tokenize([item.payload[0] for item in group])
        bufs = [item.payload[1] for item in group]
        for buf in bufs:
            if buf.device.type != embedder.device.type:
                # the stream's state follows the model serving it (the
                # twin, or the card again), in place
                buf.data = buf.data.to(embedder.device)
        positions = [item.payload[2] for item in group]
        temperature = group[0].payload[3]
        wanted = [i for i, item in enumerate(group) if item.payload[4]]
        self._count(
            _pad_real_tokens=mask.sum(),
            _pad_slot_tokens=_bucket(ids.shape[0], embedder.MAX_DEVICE_BATCH)
            * ids.shape[1],
        )
        conf = embedder.stream_vote_update_tokens(
            ids, mask, bufs, positions, temperature, wanted=wanted
        )

        def finalize() -> list:
            rows = dict(zip(wanted, _value(conf)))
            return [rows.get(i) for i in range(len(group))]

        return finalize

    # -- packed (continuous-batching) dispatch ----------------------------------

    def _dispatch_packed(self, group: list, embedder):
        """One mixed group (embedding and consensus requests, any N, any
        temperature) -> per-request results through the ragged layout:
        each request's plan (built at submit time when the host pool is
        on), every segment packed into ("packed", B, L, K) calls
        (``packing.build_calls``), one ``embed_packed`` per call,
        enqueued here; reassembly and the host vote run after readiness.
        A request whose pieces do not fit a packed row takes its padded
        dispatch in the same group."""
        t_plan = time.perf_counter()
        segments: list = []
        plans = [self._plan_packed_item(item, embedder, segments)
                 for item in group]
        plan_ms = (time.perf_counter() - t_plan) * 1e3
        fallback = {}
        for i, plan in enumerate(plans):
            if plan[0] == "fallback":
                self._count(_fallback_items=1)
                fallback[i] = self._packed_item_fallback(group[i], embedder)
        call_outs = []
        if segments:
            t_plan = time.perf_counter()
            calls = _packing.build_calls(
                segments, self.packing_row_tokens, self.packing_max_rows,
                self.packing_max_segments,
            )
            plan_ms += (time.perf_counter() - t_plan) * 1e3
            for call in calls:
                out = embedder.embed_packed(
                    call.ids, call.segment_ids, call.positions,
                    call.seg_starts,
                )
                b, l = call.ids.shape
                with self._cond:
                    self._pack_real_tokens += call.real_tokens
                    self._pack_slot_tokens += call.slot_tokens
                    self._occupancy[b] = self._occupancy.get(b, 0) + 1
                    shape = f"{b}x{l}"
                    self._call_shapes[shape] = (
                        self._call_shapes.get(shape, 0) + 1
                    )
                call_outs.append((call, out))
        _phases.observe_phase("pack_plan", plan_ms)
        share_plan = plan_ms / len(group)
        for item in group:
            if item.span is not None:
                item.span.annotate(pack_plan_ms=round(share_plan, 3))

        def finalize() -> list:
            seg_vecs: list = [None] * len(segments)
            for call, out in call_outs:
                out_np = _value(out)
                for si, (r, slot) in call.slots.items():
                    seg_vecs[si] = out_np[r, slot]
            t_tally = time.perf_counter()
            results = []
            for i, (item, plan) in enumerate(zip(group, plans)):
                if plan[0] == "fallback":
                    out, tokens = fallback[i]
                    results.append((_value(out), tokens))
                else:
                    results.append(self._assemble(plan, segments, seg_vecs))
            tally_ms = (time.perf_counter() - t_tally) * 1e3
            _phases.observe_phase("host_tally", tally_ms)
            share_tally = tally_ms / len(group)
            for item in group:
                if item.span is not None:
                    item.span.annotate(host_tally_ms=round(share_tally, 3))
            return results

        return finalize

    def _plan_packed_item(self, item, embedder, segments: list):
        """One item's group-wide plan: its submit-time plan when there is
        one, else planned here; its rows join the group's segments and
        its dedup counters apply now."""
        if embedder is self.embedder and item.prepared is not None:
            plan, rows, stats = item.prepared.result()
        else:
            plan, rows, stats = self._plan_packed_payload(
                item.kind, item.payload, embedder
            )
        base = len(segments)
        segments.extend(rows)
        if stats is not None:
            _, hits, saved = stats
            self._count(_dedup_hits=hits, _dedup_tokens_saved=saved)
        return self._rebase(plan, base)

    def _plan_packed_payload(self, kind, payload, embedder):
        """Pure planning of one payload -> (plan over its own segments,
        its ragged token rows, dedup stats or None).  Each segment is
        capped at ``min(row_tokens, max_tokens)`` tokens; a plan of
        ("fallback",) sends the request to its padded dispatch."""
        row_tokens = self.packing_row_tokens
        seg_cap = min(row_tokens, embedder.max_tokens)

        def fits(rows):
            return all(0 < len(r) <= row_tokens for r in rows)

        if kind == "embed":
            texts, cap = payload
            rows = embedder.tokenize_ragged(
                texts, min(cap, seg_cap) if cap else seg_cap
            )
            if not fits(rows):
                return ("fallback",), [], None
            return ("embed", list(range(len(rows)))), rows, None
        texts, temperature = payload
        prefix = (
            _packing.shared_prefix(texts, self.prefix_dedup_min_chars)
            if self.prefix_dedup else None
        )
        if prefix is not None:
            parts = [prefix] + [t[len(prefix):] for t in texts]
            # an empty suffix (candidate == prefix) embeds nothing: its
            # candidate vector is the prefix vector
            rows = embedder.tokenize_ragged(
                [parts[0]] + [p for p in parts[1:] if p], seg_cap
            )
            # a prefix this short is all [CLS]/[SEP]: vote on full texts
            if len(rows[0]) >= 4 and fits(rows):
                nxt = iter(range(1, len(rows)))
                suffixes = [next(nxt) if p else None for p in parts[1:]]
                n = len(texts)
                return (
                    ("consensus_dedup", 0, suffixes, temperature), rows,
                    ("dedup", n - 1, (n - 1) * len(rows[0])),
                )
        rows = embedder.tokenize_ragged(texts, seg_cap)
        if not fits(rows):
            return ("fallback",), [], None
        return ("consensus", list(range(len(rows))), temperature), rows, None

    @staticmethod
    def _rebase(plan, base: int):
        """Shift a plan's segment indices by ``base``, where its rows
        landed among the group's segments."""
        if plan[0] == "embed":
            return ("embed", [base + i for i in plan[1]])
        if plan[0] == "consensus":
            return ("consensus", [base + i for i in plan[1]], plan[2])
        if plan[0] == "consensus_dedup":
            _, prefix, suffixes, temperature = plan
            return (
                "consensus_dedup", base + prefix,
                [None if i is None else base + i for i in suffixes],
                temperature,
            )
        return plan  # ("fallback",)

    def _assemble(self, plan, segments: list, seg_vecs: list) -> tuple:
        if plan[0] == "embed":
            # an empty request gets [0, H], as from the padded path
            idxs = plan[1]
            vecs = np.zeros(
                (len(idxs), self.embedder.config.hidden_size), np.float32
            )
            for row, i in enumerate(idxs):
                vecs[row] = seg_vecs[i]
            return vecs, [len(segments[i]) for i in idxs]
        if plan[0] == "consensus_dedup":
            _, prefix, suffixes, temperature = plan
            p_tok = len(segments[prefix])
            cand = np.stack([
                _packing.compose_prefix_suffix(
                    seg_vecs[prefix], p_tok,
                    None if i is None else seg_vecs[i],
                    0 if i is None else len(segments[i]),
                )
                for i in suffixes
            ])
            tokens = p_tok + sum(
                len(segments[i]) for i in suffixes if i is not None
            )
            return _packing.consensus_vote_np(cand, temperature), int(tokens)
        _, idxs, temperature = plan
        cand = np.stack([seg_vecs[i] for i in idxs])
        return (
            _packing.consensus_vote_np(cand, temperature),
            int(sum(len(segments[i]) for i in idxs)),
        )

    def _packed_item_fallback(self, item, embedder) -> tuple:
        """Stage one packed-key request through its padded dispatch ->
        (its output or handle, its token count)."""
        if item.kind == "embed":
            texts, cap = item.payload
            ids, mask = embedder.tokenize(texts, cap)
            self._count(
                _pad_real_tokens=mask.sum(),
                _pad_slot_tokens=_bucket(ids.shape[0],
                                         embedder.MAX_DEVICE_BATCH)
                * ids.shape[1],
            )
            return embedder.embed_tokens(ids, mask), mask.sum(axis=1)
        texts, temperature = item.payload
        ids, mask = embedder.tokenize(texts)
        self._count(_pad_real_tokens=mask.sum(), _pad_slot_tokens=ids.size)
        conf = embedder.consensus_confidence_tokens(ids, mask, temperature)
        return conf, int(mask.sum())

    # -- the twin ---------------------------------------------------------------

    def rescale_capacity(self, scale: float) -> None:
        """Scale per-dispatch capacity to the surviving device fraction (a
        ``MeshFaultManager`` rescale hook): a half-size mesh gets half the
        encoder rows and items per group, so a dispatch's wall time, and
        the deadline shed's estimate fed by it, stay roughly flat through
        a downsize.  ``scale=1.0`` restores the configured capacity."""
        scale = max(0.0, float(scale))
        with self._cond:
            self.max_rows = max(1, int(self._base_max_rows * scale))
            self.max_batch = max(1, int(self._base_max_batch * scale))

    def use_fallback(self, active: bool) -> None:
        """Route dispatches to the CPU twin (the watchdog's trip, or a
        spent ladder) or back to the card (the watchdog's recovery).  A
        flag the next dispatch reads; no effect without a twin."""
        self._use_fallback = bool(active)

    @property
    def fallback_active(self) -> bool:
        return self._use_fallback and self.fallback_embedder is not None

    def stream_buffer(self, capacity: int):
        """A new stream buffer on the device of the model that serves
        now (``TorchEmbedder.stream_buffer``)."""
        model = (self.fallback_embedder if self.fallback_active
                 else self.embedder)
        return model.stream_buffer(capacity)

    # -- lifecycle ---------------------------------------------------------------

    def idle(self) -> bool:
        """No queued item in either lane and no dispatch in flight."""
        with self._cond:
            return not self._has_pending() and not self._inflight

    def drain(self, timeout_sec: float) -> bool:
        """Wait (bounded) for every queued item to dispatch and every
        dispatch to finish; True if the batcher drained clean."""
        end = time.perf_counter() + max(0.0, float(timeout_sec))
        with self._cond:
            while self._has_pending() or self._inflight:
                left = end - time.perf_counter()
                if left <= 0:
                    return False
                self._cond.wait(min(left, 0.05))
        return True

    def close(self, timeout: float = 10.0) -> None:
        """Drain (bounded by ``timeout``), then stop the threads; work
        still queued after that fails with ``RuntimeError``."""
        self.drain(timeout)
        with self._cond:
            self._closed = True
            left = self._pending + self._pending_offline
            self._pending, self._pending_offline = [], []
            self._cond.notify_all()
        for item in left:
            _settle(item, exc=RuntimeError("batcher is closed"))
        self._flusher.join(timeout)
        self._dispatchers.shutdown(wait=False)
        self._waiters.shutdown(wait=False)
        if self._tok_pool is not None:
            self._tok_pool.shutdown(wait=False)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- observability -----------------------------------------------------------

    def stats(self) -> dict:
        """Dispatches and requests per kind, the packing efficiency
        counters (real tokens embedded against the token slots
        dispatched, per path), and under ``phases`` each phase's exact
        ``sum_ms`` and ``count`` (``obs/phases.py``, process-wide: the
        gateway's phases and ``held_idle`` too)."""
        out = self._counters()
        out["phases"] = _phases.aggregator().sums()
        return out

    def _counters(self) -> dict:
        with self._cond:
            pack_real, pack_slot = self._pack_real_tokens, self._pack_slot_tokens
            pad_real, pad_slot = self._pad_real_tokens, self._pad_slot_tokens
            return {
                "dispatches": dict(self._kind_dispatches),
                "requests": dict(self._requests),
                "largest_group": self._largest_group,
                "stream": {
                    "dispatches": self._stream_dispatches,
                    "requests": self._stream_requests,
                    "largest_group": self._stream_largest_group,
                },
                "queued": len(self._pending) + len(self._pending_offline),
                "packing": {
                    "enabled": self.packing,
                    "dispatches": self._packed_dispatches,
                    "real_tokens": pack_real,
                    "slot_tokens": pack_slot,
                    "padding_waste": round(1.0 - pack_real / pack_slot, 4)
                    if pack_slot else 0.0,
                    "prefix_dedup_hits": self._dedup_hits,
                    "prefix_dedup_tokens_saved": self._dedup_tokens_saved,
                    "fallback_items": self._fallback_items,
                    "bucket_occupancy": {
                        str(b): c for b, c in sorted(self._occupancy.items())
                    },
                    "call_shapes": dict(self._call_shapes),
                },
                "padded": {
                    "real_tokens": pad_real,
                    "slot_tokens": pad_slot,
                    "padding_waste": round(1.0 - pad_real / pad_slot, 4)
                    if pad_slot else 0.0,
                },
            }

    def utilization(self, window_sec: float = 60.0) -> dict:
        """The reference's ``device_batcher`` section: queue depth, busy
        fraction (overall and per lane), dispatch and item counts, the
        knobs, the sheds, and the packing counters."""
        now = time.perf_counter()
        lo = now - window_sec
        with self._cond:
            span = max(min(window_sec, now - self._started), 1e-9)
            inflight = list(self._inflight.values())

            def busy_fraction(intervals, lane=None):
                busy = sum(
                    max(0.0, min(end, now) - max(start, lo))
                    for start, end in intervals
                )
                for start, in_lane in inflight:
                    if lane is None or in_lane == lane:
                        busy += now - max(start, lo)
                return round(min(busy / span, 1.0), 4)

            stats = self._counters()
            out = {
                "queue_depth": len(self._pending),
                "busy_fraction": busy_fraction(self._busy),
                "lanes": {
                    lane: {
                        "queue_depth": len(
                            self._pending if lane == "latency"
                            else self._pending_offline
                        ),
                        "dispatches": self._lane_dispatches[lane],
                        "items": self._lane_items[lane],
                        "busy_fraction": busy_fraction(
                            self._lane_busy[lane], lane
                        ),
                    }
                    for lane in LANES
                },
                "dispatches": self._dispatches,
                "items": self._items,
                "items_per_dispatch": round(
                    self._items / self._dispatches, 2
                ) if self._dispatches else 0.0,
                "window_ms": self.window_ms,
                "max_batch": self.max_batch,
                "host_tokenizer_workers": self.host_tokenizer_workers,
                "max_queue_depth": self.max_queue_depth,
                "shed_queue_full": self.shed_queue_full,
                "shed_deadline": self.shed_deadline,
                "shed_redispatch_limit": self.shed_redispatch_limit,
                "cancelled_items": self.cancelled_items,
                "fallback_active": self._use_fallback,
                "fallback_dispatches": self.fallback_dispatches,
            }
        pool = getattr(self.embedder, "staging_pool", None)
        out["staging"] = pool.stats() if pool is not None else None
        packing = dict(stats["packing"])
        packing.pop("dispatches")
        packing.pop("call_shapes")
        out["packing"] = packing
        out["padded"] = stats["padded"]
        return out

    def lane_occupancy(
        self, lane: str, since: float, until: Optional[float] = None
    ) -> float:
        """Fraction of ``[since, until]`` the device path had ``lane``
        work in flight, overlapping pipelined intervals merged."""
        now = time.perf_counter() if until is None else until
        window = now - since
        if window <= 0:
            return 0.0
        with self._cond:
            intervals = [
                (max(start, since), min(end, now))
                for start, end in self._lane_busy.get(lane, ())
                if end > since and start < now
            ]
            intervals += [
                (max(start, since), now)
                for start, in_lane in self._inflight.values()
                if in_lane == lane and start < now
            ]
        if not intervals:
            return 0.0
        intervals.sort()
        covered = 0.0
        cur_lo, cur_hi = intervals[0]
        for lo, hi in intervals[1:]:
            if lo > cur_hi:
                covered += cur_hi - cur_lo
                cur_lo, cur_hi = lo, hi
            else:
                cur_hi = max(cur_hi, hi)
        covered += cur_hi - cur_lo
        return round(min(covered / window, 1.0), 4)


# the name the port's server and tests have used since its first slice
ConsensusBatcher = DeviceBatcher
