"""Deferred-readiness dispatch seam, on CUDA events.

Counterpart of ``llm_weighted_consensus_tpu/models/dispatch_seam.py``.
The batcher splits every dispatch into two hops:

* the **dispatch thread** enters ``deferred_readiness(sink)`` and calls
  the embedder, which stages the group's rows in pinned host buffers,
  copies them to the device (``non_blocking``), launches the forward (a
  CUDA graph replay, or the eager kernels), starts the device-to-host
  copy into a pinned output buffer and records a ``torch.cuda.Event``
  after it, then appends a ``PendingDispatch`` to the sink and returns
  without waiting;
* the batcher's **waiter thread** runs ``drain_sink``: it waits on each
  dispatch's event (``wait_device_ready``), records its device time per
  bucket and its (enqueue, ready) interval for the ``overlap`` gauge,
  and hands the staging buffers back to the ``StagingPool``.

``settle`` notes each timed dispatch at its launch
(``obs.phases.note_device_launch``), so that ``held_idle`` counts it
busy until its interval lands; a dispatch whose wait failed is
forgotten instead (``drain_sink``'s ``forget_launch``).  The batcher
hands the sink its group's item spans (``DispatchSink.spans``), which
the ``launch`` phase is observed for.

``wait_device_ready`` is the one sanctioned blocking call of the
dispatch path, and it runs on the waiter thread only.  A dispatch with
CUDA events reports the device time between them (``elapsed_time``); one
without (the CPU, test fakes) reports enqueue-to-ready host time, as the
reference does.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch


def wait_device_ready(out) -> None:
    """Block until ``out`` is ready: ``out.synchronize()`` for a CUDA
    event or a handle that has one; nothing for a result already on the
    host.  Runs on the batcher's waiter thread, never on the dispatch
    thread."""
    sync = getattr(out, "synchronize", None)
    if sync is not None:
        sync()


class PendingDispatch:
    """One enqueued-but-not-ready device dispatch.  ``events`` is the
    (start, end) pair of timing CUDA events recorded around it on the
    stream, or None."""

    __slots__ = ("label", "t0", "out", "wait", "timed", "events")

    def __init__(
        self,
        label: str,
        t0: float,
        out,
        wait: Callable = wait_device_ready,
        timed: bool = True,
        events: Optional[Tuple] = None,
    ) -> None:
        self.label = label
        self.t0 = t0
        self.out = out
        self.wait = wait
        # False when METRICS_DEVICE_TIMING=0: the waiter still waits but
        # records nothing
        self.timed = timed
        self.events = events

    def device_ms(self, t1: float) -> float:
        """The dispatch's device time: between its CUDA events when it
        has them (the waiter has waited on the later one), else enqueue
        to ready on the host clock."""
        if self.events is not None:
            start, end = self.events
            return float(start.elapsed_time(end))
        return (t1 - self.t0) * 1e3


class DispatchSink:
    """Per-group collector the dispatch thread fills under
    ``deferred_readiness``: the pending dispatches and the host staging
    buffers they read (handed back to the pool only after readiness: a
    ``non_blocking`` copy reads its pinned source until then).
    ``spans`` are the group's items, each its span or None untraced (by
    default one untraced item)."""

    __slots__ = ("pending", "staged", "spans")

    def __init__(self, spans=(None,)) -> None:
        self.pending: List[PendingDispatch] = []
        self.staged: list = []
        self.spans = tuple(spans)

    def add(self, record: PendingDispatch) -> PendingDispatch:
        self.pending.append(record)
        return record

    @classmethod
    def of(cls, record: PendingDispatch, staged: list) -> "DispatchSink":
        """A sink holding one dispatch and its staging buffers."""
        sink = cls()
        sink.pending.append(record)
        sink.staged = list(staged)
        return sink


_TLS = threading.local()


def active_sink() -> Optional[DispatchSink]:
    """The calling thread's deferred-readiness sink, or None when
    dispatches should wait inline (direct callers)."""
    return getattr(_TLS, "sink", None)


class deferred_readiness:
    """Context manager scoping a ``DispatchSink`` to the calling thread.
    ``deferred_readiness(None)`` suspends an outer scope."""

    __slots__ = ("sink", "_prev")

    def __init__(self, sink: Optional[DispatchSink]) -> None:
        self.sink = sink
        self._prev = None

    def __enter__(self) -> Optional[DispatchSink]:
        self._prev = getattr(_TLS, "sink", None)
        _TLS.sink = self.sink
        return self.sink

    def __exit__(self, *exc) -> bool:
        _TLS.sink = self._prev
        return False


def drain_sink(
    sink: DispatchSink,
    observe_device: Optional[Callable[[str, float], None]] = None,
    observe_interval: Optional[Callable[[float, float], None]] = None,
    release: Optional[Callable] = None,
    clock: Callable[[], float] = time.perf_counter,
    retain: Optional[Callable] = None,
    forget_launch: Optional[Callable[[float], None]] = None,
) -> None:
    """The waiter hop: wait on every pending dispatch in enqueue order,
    recording each timed one's device ms and its (enqueue, ready)
    interval.  Staging buffers go back to the pool only on a clean drain:
    a raising ``wait`` (a device fault) propagates, and the group's
    staging buffers and pinned outputs go to ``retain`` first
    (``StagingPool.retain``: after a sticky CUDA error, freeing a pinned
    buffer aborts the process), and each timed dispatch not yet ready to
    ``forget_launch``."""
    ready = 0
    try:
        for record in sink.pending:
            record.wait(record.out)
            t1 = clock()
            if record.timed:
                if observe_device is not None:
                    observe_device(record.label, record.device_ms(t1))
                if observe_interval is not None:
                    observe_interval(record.t0, t1)
            ready += 1
    except BaseException:
        if forget_launch is not None:
            for record in sink.pending[ready:]:
                if record.timed:
                    forget_launch(record.t0)
        if retain is not None:
            for buf in sink.staged:
                retain(buf)
            for record in sink.pending:
                host = getattr(record.out, "host", None)
                if host is not None:
                    retain(host)
        raise
    if release is not None:
        for buf in sink.staged:
            release(buf)
        sink.staged = []


class StagingPool:
    """Reusable host staging buffers per (shape, dtype) bucket: CPU torch
    tensors, pinned when ``pin`` (the card's path), so that a
    ``non_blocking`` copy is a real asynchronous DMA.  A buffer comes
    back through ``release`` only once the dispatch that reads it is
    ready.  ``per_bucket`` (``STAGING_BUFFERS``) caps the free buffers
    kept per bucket; 0 turns reuse off."""

    def __init__(self, per_bucket: int = 2, pin: bool = False) -> None:
        self.per_bucket = max(0, int(per_bucket))
        self.pin = bool(pin)
        self._lock = threading.Lock()
        self._free: Dict[Tuple[tuple, torch.dtype], list] = {}
        # buffers of failed dispatches past their bucket's cap (``retain``)
        self._retained: list = []
        self.hits = 0
        self.misses = 0

    @property
    def enabled(self) -> bool:
        return self.per_bucket > 0

    def acquire(self, shape, dtype: torch.dtype) -> torch.Tensor:
        """A host buffer of exactly ``shape``/``dtype``: recycled (its
        contents stale: the caller overwrites it) or fresh."""
        key = (tuple(shape), dtype)
        with self._lock:
            free = self._free.get(key)
            if free:
                self.hits += 1
                return free.pop()
            self.misses += 1
        return torch.empty(tuple(shape), dtype=dtype, pin_memory=self.pin)

    def release(self, buf: torch.Tensor) -> None:
        key = (tuple(buf.shape), buf.dtype)
        with self._lock:
            free = self._free.setdefault(key, [])
            if len(free) < self.per_bucket:
                free.append(buf)

    def retain(self, buf: torch.Tensor) -> None:
        """Hand back a buffer of a dispatch that failed: recycled as by
        ``release`` when its bucket has room, else kept, never freed.
        After a sticky CUDA error (an illegal address, a device-side
        assert) freeing a pinned buffer that served a copy records a CUDA
        event, which fails inside a destructor and aborts the process;
        the CPU twin can only take over in a process that lives."""
        key = (tuple(buf.shape), buf.dtype)
        with self._lock:
            free = self._free.setdefault(key, [])
            if len(free) < self.per_bucket:
                free.append(buf)
            else:
                self._retained.append(buf)

    def stats(self) -> dict:
        with self._lock:
            return {
                "per_bucket": self.per_bucket,
                "hits": self.hits,
                "misses": self.misses,
                "buckets": len(self._free),
                "pinned": self.pin,
            }


def settle(dispatch, pool: StagingPool, timed: bool = True):
    """Hand a launched dispatch (``models.graphs.Dispatch``: ``label``,
    ``t0``, ``events``, ``staged``, ``synchronize``, ``result``) to the
    active sink (the
    batcher's waiter materializes it after readiness; returns the
    dispatch) or, for a direct caller, wait for it here, record its
    device time and interval, hand its staging buffers back to ``pool``
    and return its output as numpy."""
    from ..obs import phases

    if timed:
        phases.note_device_launch(dispatch.t0)
    sink = active_sink()
    if sink is not None:
        sink.add(PendingDispatch(
            dispatch.label, dispatch.t0, dispatch, timed=timed,
            events=dispatch.events,
        ))
        sink.staged.extend(dispatch.staged)
        return dispatch
    record = PendingDispatch(dispatch.label, dispatch.t0, dispatch,
                             timed=timed, events=dispatch.events)
    drain_sink(
        DispatchSink.of(record, dispatch.staged),
        observe_device=phases.observe_device,
        observe_interval=phases.observe_device_interval,
        release=pool.release,
        retain=pool.retain,
        forget_launch=phases.forget_device_launch,
    )
    return dispatch.result()
