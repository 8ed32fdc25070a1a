"""Phase-attributed request timing.

Counterpart of ``llm_weighted_consensus_tpu/obs/phases.py``: every
served request's time is observed into one process-global aggregator
of mergeable log-bucket histograms (``obs/histogram.py``) under a fixed
phase vocabulary, in request order:

* ``admission_wait``  — gateway door to admission slot held
* ``gateway_read``    — slot held to the item submitted: the body read,
  parsed and validated (``serve/gateway.py``)
* ``tokenize``        — an item's rows built, on the host tokenizer pool,
  or inline on the dispatch thread when none were prepared
* ``batch_window``    — the accumulation window an item sat in, waiting
  for company while the device path was idle (the flusher)
* ``batcher_queue``   — item submitted to its group taking the device
  (the window included)
* ``prepare_wait``    — the dispatch thread blocked on an item's rows
* ``launch``          — pinned staging, the copy in, the replay and the
  copy out enqueued (``models/graphs.py``)
* ``pack_plan``       — the packed path's host planning
* ``device_dispatch`` — one dispatch's device time, per bucket: CUDA
  events recorded on the stream before the copy-in and after the copy-out
  (``models/dispatch_seam.py``), read by the batcher's waiter thread
* ``finalize``        — the waiter's drain returned to the item's future
  settled
* ``host_tally``      — the packed path's reassembly and host vote, and
  the score route's weighted-vote fold
* ``upstream_judge``  — a judge's ballot stream, door to last frame
* ``gateway_write``   — the answer returned to its last byte written
* ``held_idle``       — the device idle while a ``/consensus`` request
  was held: door to last byte, less the union of the dispatches' launch
  to ready intervals (one launched and not yet ready counts as busy)

Every phase after ``admission_wait`` but the existing ``batcher_queue``
and ``device_dispatch`` is timed by one scope, ``phase``, on the thread
doing the work; work done once for a group is observed once for each
item in it, so that every sum is in request-milliseconds.  A scope
observes into the aggregator; on a traced item it adds a
``phase:<name>`` child to the item's span; and only while a torch
profiler runs somewhere in the process it also enters
``record_function("lwc.<name>")`` on its thread, so that a capture
names the program's work beside the kernels.  That check reads the
profiler's process-wide flag: a profiler started on another thread
leaves this thread's own flag off, and an unguarded ``record_function``
costs microseconds with no profiler running.

``observe_device_interval`` keeps each dispatch's (enqueue, ready) host
interval for the ``overlap`` gauge and ``held_idle``: the seam notes a
dispatch at its launch (``note_device_launch``) and the interval lands
when the waiter sees it ready.  One lock guards the aggregator: the
gateway's handler threads, the batcher's flusher, dispatch and waiter
threads and the tokenizer pool all observe.  ``sums()`` gives each
phase's exact sum and count (``DeviceBatcher.stats()["phases"]``).

``phase_breakdown(trace)`` re-derives the same vocabulary for one
request from its finished span tree (``obs/span.py``), as the
reference's does: interval unions, so concurrent judge streams count
their wall time once.  The gateway stamps it on every traced request's
root span.
"""

from __future__ import annotations

import sys
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from .histogram import Histogram
from .span import current_span

# the phase vocabulary, in request order; the /metrics ``phases``
# section and the Prometheus exposition render exactly these keys
PHASES = (
    "admission_wait",
    "gateway_read",
    "tokenize",
    "batch_window",
    "batcher_queue",
    "prepare_wait",
    "launch",
    "pack_plan",
    "device_dispatch",
    "finalize",
    "host_tally",
    "upstream_judge",
    "gateway_write",
    "held_idle",
)

# left out of ``device_time_share``'s total: phases that run inside
# another's time or beside it (on the pool, under the device time), and
# ``held_idle``, which measures the device, not the request
OVERLAPPING = ("tokenize", "batch_window", "prepare_wait", "launch",
               "finalize", "held_idle")

# how far before a request's door ``held_idle`` looks back for dispatch
# intervals: the waiter threads land them in ready order give or take
# their wake-ups, far inside this
HELD_LOOKBACK_S = 1.0


class PhaseAggregator:
    """Process-global phase + per-bucket device-time histograms, one
    lock around each O(1) observe."""

    # retained (enqueue, ready) device intervals for the overlap gauge;
    # a rolling window so the gauge tracks the CURRENT pipelining
    # behavior, not the process lifetime average
    INTERVAL_WINDOW = 4096

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._phases: Dict[str, Histogram] = {}
        self._device: Dict[str, Histogram] = {}
        self._intervals: deque = deque(maxlen=self.INTERVAL_WINDOW)
        # launch time -> dispatches launched then and not yet ready
        self._launched: Dict[float, int] = {}

    def observe_phase(self, phase: str, ms: float) -> None:
        with self._lock:
            hist = self._phases.get(phase)
            if hist is None:
                hist = self._phases[phase] = Histogram()
            hist.observe(ms)

    def observe_phase_many(self, phase: str, values: List[float]) -> None:
        """One observation per value (a group's items), one lock."""
        with self._lock:
            hist = self._phases.get(phase)
            if hist is None:
                hist = self._phases[phase] = Histogram()
            for ms in values:
                hist.observe(ms)

    def observe_device(self, bucket: str, ms: float) -> None:
        """One dispatch at ``bucket`` (a label like ``vote1(n=8,s=16)``):
        feeds both the per-bucket table and the ``device_dispatch``
        phase aggregate."""
        with self._lock:
            hist = self._device.get(bucket)
            if hist is None:
                hist = self._device[bucket] = Histogram()
            hist.observe(ms)
            phist = self._phases.get("device_dispatch")
            if phist is None:
                phist = self._phases["device_dispatch"] = Histogram()
            phist.observe(ms)

    def observe_device_interval(self, start: float, end: float) -> None:
        """One dispatch's (enqueue, ready) interval in
        ``time.perf_counter`` seconds, for the ``overlap`` gauge and
        ``held_idle``; the dispatch launched at ``start`` is ready."""
        with self._lock:
            self._intervals.append((float(start), float(end)))
            self._land(start)

    def note_device_launch(self, start: float) -> None:
        """A dispatch launched at ``start``: busy until its interval
        lands (or ``forget_device_launch``, when it failed)."""
        with self._lock:
            self._launched[start] = self._launched.get(start, 0) + 1

    def forget_device_launch(self, start: float) -> None:
        with self._lock:
            self._land(start)

    # caller-holds-lock: PhaseAggregator._lock (observe_device_interval and forget_device_launch call it inside their with-lock blocks)
    def _land(self, start: float) -> None:
        left = self._launched.get(start)
        if left is None:
            return
        if left > 1:
            self._launched[start] = left - 1
        else:
            del self._launched[start]

    def observe_held_idle(self, door: float, end: float) -> float:
        """Observe and return the ``held_idle`` ms of a request held
        from ``door`` to ``end`` (``time.perf_counter`` seconds)."""
        with self._lock:
            recent = []
            for start, stop in reversed(self._intervals):
                if stop < door - HELD_LOOKBACK_S:
                    break
                recent.append((start, stop))
            ms = held_idle_ms(door, end, recent, list(self._launched))
            hist = self._phases.get("held_idle")
            if hist is None:
                hist = self._phases["held_idle"] = Histogram()
            hist.observe(ms)
        return ms

    def device_intervals(self) -> List[Tuple[float, float]]:
        """The retained interval window (tests and the gauge)."""
        with self._lock:
            return list(self._intervals)

    # -- read side ------------------------------------------------------------

    def snapshot(self) -> dict:
        """The /metrics ``phases`` section: per-phase histogram summary,
        the device share of all attributed time, and the ``overlap``
        gauge: the union of the retained dispatch intervals over the wall
        time they span.  ~1.0 means pipelined dispatches keep the device
        path busy; a serialized pipeline with host work between
        dispatches reads well below 1.  None until two dispatches have
        landed."""
        with self._lock:
            rows = {
                phase: hist.to_json_obj()
                for phase, hist in self._phases.items()
            }
            total = sum(h.sum for p, h in self._phases.items()
                        if p not in OVERLAPPING)
            device = self._phases.get("device_dispatch")
            device_sum = device.sum if device is not None else 0.0
            intervals = list(self._intervals)
        out: dict = {phase: rows[phase] for phase in PHASES if phase in rows}
        out["device_time_share"] = (
            round(device_sum / total, 4) if total > 0 else None
        )
        overlap = None
        if len(intervals) >= 2:
            wall = max(e for _, e in intervals) - min(s for s, _ in intervals)
            if wall > 0:
                overlap = round(min(_union_ms(intervals) / wall, 1.0), 4)
        out["overlap"] = overlap
        return out

    def sums(self) -> Dict[str, dict]:
        """Each phase's exact ``sum_ms`` and ``count`` (0 before its
        first observation), in ``PHASES`` order: what a reader
        differences over a window."""
        empty = Histogram()
        with self._lock:
            return {phase: {"sum_ms": hist.sum, "count": hist.count}
                    for phase in PHASES
                    for hist in (self._phases.get(phase, empty),)}

    def device_snapshot(self) -> Dict[str, dict]:
        """Per-bucket device-time summaries."""
        with self._lock:
            return {
                bucket: hist.to_json_obj()
                for bucket, hist in sorted(self._device.items())
            }

    def raw_histograms(self) -> Tuple[Dict[str, Histogram], Dict[str, Histogram]]:
        """Cloned (phases, device) histogram maps for the Prometheus
        renderer: clones, so rendering never races an observe."""
        with self._lock:
            return (
                {k: _clone(h) for k, h in self._phases.items()},
                {k: _clone(h) for k, h in self._device.items()},
            )

    def device_quantile(self, bucket: str, q: float) -> Optional[float]:
        with self._lock:
            hist = self._device.get(bucket)
            return hist.quantile(q) if hist is not None else None

    def reset(self) -> None:
        with self._lock:
            self._phases.clear()
            self._device.clear()
            self._intervals.clear()
            self._launched.clear()


def _clone(hist: Histogram) -> Histogram:
    return Histogram().merge(hist)


_AGG = PhaseAggregator()


def aggregator() -> PhaseAggregator:
    return _AGG


def observe_phase(phase: str, ms: float) -> None:
    _AGG.observe_phase(phase, ms)


def observe_device(bucket: str, ms: float) -> None:
    _AGG.observe_device(bucket, ms)


def observe_device_interval(start: float, end: float) -> None:
    _AGG.observe_device_interval(start, end)


def note_device_launch(start: float) -> None:
    _AGG.note_device_launch(start)


def forget_device_launch(start: float) -> None:
    _AGG.forget_device_launch(start)


def observe_held_idle(door: float, end: float) -> float:
    return _AGG.observe_held_idle(door, end)


def held_idle_ms(door: float, end: float, intervals, launched) -> float:
    """The ms of [door, end] covered by neither a dispatch's (launch,
    ready) interval nor a dispatch launched before ``end`` and not yet
    ready (``launched``: their launch times)."""
    busy = [(max(start, door), min(stop, end)) for start, stop in intervals
            if stop > door and start < end]
    busy += [(max(start, door), end) for start in launched if start < end]
    return max(0.0, (end - door) - _union_ms(busy)) * 1e3


def phases_snapshot() -> dict:
    return _AGG.snapshot()


def reset_phases() -> None:
    _AGG.reset()


# ---------------------------------------------------------------------------
# The phase scope
# ---------------------------------------------------------------------------


def _profiler_range(prof, name: str):
    """``record_function(name)``, held from the first ``next`` to the
    second, on the thread that makes both."""
    with prof.record_function(name):
        yield


def _running_profiler():
    """torch's autograd profiler module while a torch profiler runs
    anywhere in the process, else None.  Its module-global flag, not the
    calling thread's: a profiler started on another thread leaves this
    thread's own flag off.  No import: torch is loaded if one runs."""
    prof = sys.modules.get("torch.autograd.profiler")
    if prof is not None and prof._is_profiler_enabled:
        return prof
    return None


class phase:
    """``with phase("tokenize", spans):`` times one phase on the calling
    thread (module doc).  ``spans`` are the items the work is for, each
    an item's span or None when it is untraced: one observation each.
    Left out, the work is for the ambient request (one observation, a
    child of the ambient span).  ``enter``/``leave`` are the same scope
    where a ``with`` block does not fit; ``leave(arrivals)`` observes,
    instead, each ``(span, since)`` from the later of the scope's start
    and ``since`` (the items that sat in a window, each from its
    arrival).  A scope never entered, or left already, observes nothing
    when it is left."""

    __slots__ = ("name", "_spans", "_t0", "_range")

    def __init__(self, name: str, spans=None) -> None:
        self.name = name
        self._spans = spans
        self._t0 = None
        self._range = None

    def enter(self) -> "phase":
        if self._spans is None:
            self._spans = (current_span(),)
        prof = _running_profiler()
        if prof is not None:
            self._range = _profiler_range(prof, "lwc." + self.name)
            next(self._range)
        self._t0 = time.perf_counter()
        return self

    def leave(self, arrivals=None) -> None:
        end = time.perf_counter()
        t0, self._t0 = self._t0, None
        if t0 is None:
            return
        if self._range is not None:
            rng, self._range = self._range, None
            next(rng, None)
        if arrivals is None:
            items = [(span, t0) for span in self._spans]
        else:
            items = [(span, max(t0, since)) for span, since in arrivals]
        if not items:
            return
        _AGG.observe_phase_many(self.name,
                                [(end - since) * 1e3 for _, since in items])
        for span, since in items:
            if span is not None:
                child = span.child(f"phase:{self.name}")
                child.backdate(since)
                child.finish()

    def __enter__(self) -> "phase":
        return self.enter()

    def __exit__(self, *exc) -> bool:
        self.leave()
        return False


# ---------------------------------------------------------------------------
# Per-request breakdown from a finished span tree
# ---------------------------------------------------------------------------


def _union_ms(intervals: List[Tuple[float, float]]) -> float:
    """Total length of the union of (start, end) intervals — concurrent
    judge streams (or pipelined dispatches) attribute wall time once."""
    if not intervals:
        return 0.0
    intervals.sort()
    total = 0.0
    cur_start, cur_end = intervals[0]
    for start, end in intervals[1:]:
        if start > cur_end:
            total += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    return total + (cur_end - cur_start)


def phase_breakdown(trace) -> dict:
    """Attribute one finished trace's wall time to the phase vocabulary.

    Span-derived: ``batcher:*`` minus its ``device:dispatch`` children
    is queue time; the dispatch bracket minus the batcher span's
    annotated host sub-costs (``pack_plan_ms`` / ``host_tally_ms``,
    stamped per item by the packed dispatch) is device time;
    ``consensus:tally`` and ``judge:stream`` map directly;
    ``admission_wait_ms`` rides a root annotation (the admission
    middleware runs before any child span exists).  The scopes'
    ``phase:*`` spans are carved out of the phase they run inside, so
    that the named phases stay disjoint: ``batch_window`` and the
    tokenization outside the window and the dispatch out of the queue
    time, ``prepare_wait``, ``launch`` and ``finalize`` out of the
    dispatch bracket, and ``gateway_read`` counts until the batcher span
    opens (the submit inside it is queue time).  ``gateway_write`` ends
    after the root has closed and reads 0 here.  Returns ``{phase: ms}``
    (``held_idle`` aside) plus ``e2e_ms`` and the unattributed
    ``other_ms`` remainder — the acceptance bar is that the named phases
    sum to within 10% of ``e2e_ms`` on a served request."""
    batcher: List[Tuple[float, float]] = []
    device: List[Tuple[float, float]] = []
    tally: List[Tuple[float, float]] = []
    judge: List[Tuple[float, float]] = []
    scoped: Dict[str, List[Tuple[float, float]]] = {}
    pack_plan_ms = 0.0
    tally_attr_ms = 0.0
    root = trace.spans[0] if trace.spans else None
    for span in trace.spans:
        dur = span.duration_ms()
        if dur is None:
            continue
        start = span.start_ms()
        interval = (start, start + dur)
        name = span.name
        if name.startswith("batcher:"):
            batcher.append(interval)
            pack_plan_ms += float(span.attributes.get("pack_plan_ms", 0.0))
            tally_attr_ms += float(span.attributes.get("host_tally_ms", 0.0))
        elif name == "device:dispatch":
            device.append(interval)
        elif name == "consensus:tally":
            tally.append(interval)
        elif name == "judge:stream":
            judge.append(interval)
        elif name.startswith("phase:"):
            scoped.setdefault(name[len("phase:"):], []).append(interval)

    def own(name: str) -> float:
        return _union_ms(list(scoped.get(name, ())))

    device_ms = _union_ms(list(device))
    window = scoped.get("batch_window", [])
    tokenize = scoped.get("tokenize", [])
    window_ms = own("batch_window")
    # the tokenization an item waited for outside its window and its
    # dispatch; the rest ran under them
    tokenize_ms = (_union_ms(tokenize + window + device)
                   - _union_ms(window + device)) if tokenize else 0.0
    in_dispatch = own("prepare_wait") + own("launch") + own("finalize")
    batcher_ms = max(0.0, _union_ms(batcher) - device_ms - window_ms
                     - tokenize_ms)
    out = {
        "admission_wait": float(
            root.attributes.get("admission_wait_ms", 0.0)
        )
        if root is not None
        else 0.0,
        "gateway_read": (_union_ms(scoped.get("gateway_read", []) + batcher)
                         - _union_ms(list(batcher))),
        "tokenize": tokenize_ms,
        "batch_window": window_ms,
        "batcher_queue": batcher_ms,
        "prepare_wait": own("prepare_wait"),
        "launch": own("launch"),
        "pack_plan": pack_plan_ms,
        "device_dispatch": max(0.0, device_ms - pack_plan_ms - tally_attr_ms
                               - in_dispatch),
        "finalize": own("finalize"),
        "host_tally": _union_ms(tally) + tally_attr_ms,
        "upstream_judge": _union_ms(judge),
        "gateway_write": own("gateway_write"),
    }
    out = {k: round(v, 3) for k, v in out.items()}
    e2e = root.duration_ms() if root is not None else None
    if e2e is not None:
        attributed = sum(out.values())
        out["e2e_ms"] = e2e
        out["other_ms"] = round(max(0.0, e2e - attributed), 3)
    return out
