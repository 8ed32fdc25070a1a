"""Contextvar-carried span tree: the request-scoped side of tracing.

The port's copy of ``llm_weighted_consensus_tpu/obs/span.py``
(Dapper-style, Sigelman et al., 2010): every request gets at most one
``Trace`` (made at the gateway door), spans hang off it as a flat list
with parent pointers, and the *ambient* current span rides a contextvar
as ``resilience/deadline.py``'s deadline does.

Where the context reaches on the port's threads:

* a gateway handler thread activates its request's root span; each
  thread has its own context, so concurrent requests never share one;
* ``asyncio.run_coroutine_threadsafe`` (the chat routes) runs the
  coroutine's task in a copy of the submitting thread's context, and
  tasks copy their parent's, so the judge pumps see their request's span;
* ``loop.run_in_executor`` and the batcher's dispatch and waiter threads
  do NOT carry it: the batcher keeps each item's span on the item, and
  an executor hop wraps its function in ``carry`` to take the ambient
  span along.

Cost model (the "cheap no-op" contract): with no sink configured no root
span is ever activated, ``current_span()`` is ``None`` and every helper
below returns on that one contextvar read; no ids, no dicts, no
timestamps.  With a sink, spans are built even for requests head
sampling declined, because degraded, shed and errored outcomes force
retention at the sink and that verdict exists only at request end.

A span's attributes dict and its end time are written by whichever
thread holds the span (the handler, the loop, the batcher's dispatch and
waiter threads, one at a time per span); its trace's span list is
appended to under the GIL.  The gateway renders a trace only after its
root finished, when every child it waited for has finished too.
"""

from __future__ import annotations

import contextvars
import os
import random
import time
from typing import Optional

_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "lwc_span", default=None
)

# ids are correlation keys, not secrets: a urandom-seeded PRNG avoids a
# getrandom(2) syscall per span
_RNG = random.Random(os.urandom(16))


def _gen_id(nbytes: int) -> str:
    value = _RNG.getrandbits(8 * nbytes)
    while value == 0:  # all-zero ids are invalid in W3C
        value = _RNG.getrandbits(8 * nbytes)
    return format(value, f"0{2 * nbytes}x")


# Every span name the tree can contain; a trailing ``*`` covers a
# dynamic suffix (f-string call sites).  ``phase:*`` is the port's own:
# the spans of ``obs/phases.py``'s scopes, one per phase name.  Trace queries and the explain
# renderer match on these names; ``tests/test_torch_obs.py`` scans the
# port for span names outside this list.
KNOWN_SPANS = (
    "gateway:*",
    "batcher:*",
    "device:dispatch",
    "singleflight:wait",
    "cache:lookup",
    "consensus:tally",
    "judge:stream",
    "judge:attempt",
    "phase:*",
)


class Trace:
    """One request's span collection + the retention verdict inputs."""

    __slots__ = (
        "trace_id",
        "sampled",
        "forced",
        "force_reason",
        "spans",
        "started_epoch",
        "t0",
    )

    def __init__(self, trace_id: Optional[str], sampled: bool) -> None:
        self.trace_id = trace_id or _gen_id(16)
        self.sampled = bool(sampled)
        # degraded / shed / error outcomes set this: the sink keeps the
        # trace regardless of the head-sampling decision
        self.forced = False
        self.force_reason: Optional[str] = None
        self.spans: list = []
        self.started_epoch = time.time()
        self.t0 = time.perf_counter()

    def force(self, reason: str) -> None:
        if not self.forced:
            self.forced = True
            self.force_reason = reason

    def to_json_obj(self) -> dict:
        root = self.spans[0] if self.spans else None
        return {
            "trace_id": self.trace_id,
            "name": root.name if root is not None else None,
            "started_epoch": round(self.started_epoch, 6),
            "duration_ms": root.duration_ms() if root is not None else None,
            "status": root.status if root is not None else None,
            "sampled": self.sampled,
            "forced": self.forced,
            "force_reason": self.force_reason,
            "spans": [s.to_json_obj() for s in list(self.spans)],
        }


class Span:
    __slots__ = (
        "trace",
        "span_id",
        "parent_id",
        "name",
        "attributes",
        "status",
        "_start",
        "_end",
    )

    def __init__(
        self, trace: Trace, name: str, parent_id: Optional[str], **attrs
    ) -> None:
        self.trace = trace
        self.span_id = _gen_id(8)
        self.parent_id = parent_id
        self.name = name
        self.attributes = attrs
        self.status = "ok"
        self._start = time.perf_counter()
        self._end: Optional[float] = None
        trace.spans.append(self)

    # -- lifecycle ----------------------------------------------------------

    def child(self, name: str, **attrs) -> "Span":
        return Span(self.trace, name, self.span_id, **attrs)

    def annotate(self, **attrs) -> None:
        self.attributes.update(attrs)

    def set_error(self, detail) -> None:
        """Mark this span errored AND force trace retention: an error
        anywhere in the tree makes the whole trace worth keeping."""
        self.status = "error"
        self.attributes["error"] = str(detail)
        self.trace.force(f"error:{self.name}")

    def backdate(self, start: float) -> None:
        """Start the span at ``start`` (``time.perf_counter`` seconds):
        a phase whose span is made when it ends."""
        self._start = start

    def finish(self, status: Optional[str] = None) -> None:
        if self._end is None:
            self._end = time.perf_counter()
        if status is not None:
            self.status = status

    # -- ambient activation (deadline.py token pattern) ---------------------

    def activate(self) -> contextvars.Token:
        return _CURRENT.set(self)

    @staticmethod
    def deactivate(token: contextvars.Token) -> None:
        _CURRENT.reset(token)

    # -- rendering ----------------------------------------------------------

    def start_ms(self) -> float:
        return round((self._start - self.trace.t0) * 1e3, 3)

    def duration_ms(self) -> Optional[float]:
        if self._end is None:
            return None
        return round((self._end - self._start) * 1e3, 3)

    def to_json_obj(self) -> dict:
        return {
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "start_ms": self.start_ms(),
            "duration_ms": self.duration_ms(),
            "status": self.status,
            "attributes": dict(self.attributes),
        }


# ---------------------------------------------------------------------------
# Module-level ambient API (every call is safe with tracing off)
# ---------------------------------------------------------------------------


def start_trace(
    name: str,
    *,
    sampled: bool,
    trace_id: Optional[str] = None,
    parent_span_id: Optional[str] = None,
    **attrs,
) -> Span:
    """New trace + its root span (gateway door only).  ``trace_id`` /
    ``parent_span_id`` come from an extracted upstream ``traceparent``
    so external callers can stitch our tree under theirs."""
    trace = Trace(trace_id, sampled)
    return Span(trace, name, parent_span_id, **attrs)


def current_span() -> Optional[Span]:
    return _CURRENT.get()


def current_trace_id() -> Optional[str]:
    span = _CURRENT.get()
    return span.trace.trace_id if span is not None else None


def child_span(name: str, **attrs) -> Optional[Span]:
    """Child of the ambient span, or None when tracing is off; callers
    keep the reference and finish it themselves."""
    parent = _CURRENT.get()
    if parent is None:
        return None
    return parent.child(name, **attrs)


def annotate(**attrs) -> None:
    """Attach attributes to the ambient span; no-op when tracing is off."""
    span = _CURRENT.get()
    if span is not None:
        span.attributes.update(attrs)


def force_keep(reason: str) -> None:
    """Mark the ambient trace must-keep (degraded/shed/error outcomes)."""
    span = _CURRENT.get()
    if span is not None:
        span.trace.force(reason)


def carry(fn):
    """``fn`` to run on another thread (an executor hop) under the
    ambient span of the calling one; ``fn`` itself when tracing is off."""
    span = _CURRENT.get()
    if span is None:
        return fn

    def run(*args, **kwargs):
        token = _CURRENT.set(span)
        try:
            return fn(*args, **kwargs)
        finally:
            _CURRENT.reset(token)

    return run


class _SpanScope:
    """``with span("name") as s:`` — a real child span when tracing is
    on, an inert scope when off.  A sync context manager on purpose: it
    works identically inside coroutines, and never crosses a yield."""

    __slots__ = ("_name", "_attrs", "_span", "_token")

    def __init__(self, name: str, attrs: dict) -> None:
        self._name = name
        self._attrs = attrs
        self._span: Optional[Span] = None
        self._token = None

    def __enter__(self) -> Optional[Span]:
        parent = _CURRENT.get()
        if parent is None:
            return None
        self._span = parent.child(self._name, **self._attrs)
        self._token = self._span.activate()
        return self._span

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._span is not None:
            if exc is not None:
                if isinstance(exc, Exception):
                    self._span.set_error(exc)
                else:
                    # cancellation / GeneratorExit: the caller went away;
                    # mark the span, but don't force whole-trace retention
                    # (a disconnect is not a service error)
                    self._span.annotate(cancelled=True)
                    self._span.status = "error"
            Span.deactivate(self._token)
            self._span.finish()
        return False


def span(name: str, **attrs) -> _SpanScope:
    return _SpanScope(name, attrs)
