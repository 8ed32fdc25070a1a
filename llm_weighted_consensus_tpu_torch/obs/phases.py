"""Phase-attributed request timing.

Counterpart of ``llm_weighted_consensus_tpu/obs/phases.py``: every
served request's time is observed into one process-global aggregator
of mergeable log-bucket histograms (``obs/histogram.py``) under a fixed
phase vocabulary:

* ``admission_wait``  — gateway door to admission slot held
* ``batcher_queue``   — item submitted to its group taking the device
* ``pack_plan``       — the packed path's host planning
* ``device_dispatch`` — one dispatch's device time, per bucket: CUDA
  events recorded on the stream before the copy-in and after the copy-out
  (``models/dispatch_seam.py``), read by the batcher's waiter thread
* ``host_tally``      — the packed path's reassembly and host vote, and
  the score route's weighted-vote fold
* ``upstream_judge``  — a judge's ballot stream, door to last frame

``observe_device_interval`` keeps each dispatch's (enqueue, ready) host
interval for the ``overlap`` gauge: the union of the intervals over the
wall time they span.  One lock guards the aggregator: the gateway's
handler threads, the batcher's dispatch and waiter threads all observe.

``phase_breakdown(trace)`` re-derives the same vocabulary for one
request from its finished span tree (``obs/span.py``), as the
reference's does: interval unions, so concurrent judge streams count
their wall time once.  The gateway stamps it on every traced request's
root span.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Optional, Tuple

from .histogram import Histogram

# the phase vocabulary, in request order; the /metrics ``phases``
# section and the Prometheus exposition render exactly these keys
PHASES = (
    "admission_wait",
    "batcher_queue",
    "pack_plan",
    "device_dispatch",
    "host_tally",
    "upstream_judge",
)


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

    def observe_phase(self, phase: str, ms: float) -> None:
        with self._lock:
            hist = self._phases.get(phase)
            if hist is None:
                hist = self._phases[phase] = Histogram()
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
        ``time.perf_counter`` seconds, for the ``overlap`` gauge."""
        with self._lock:
            self._intervals.append((float(start), float(end)))

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
            total = sum(h.sum for h in self._phases.values())
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


def phases_snapshot() -> dict:
    return _AGG.snapshot()


def reset_phases() -> None:
    _AGG.reset()


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
    middleware runs before any child span exists).  Returns
    ``{phase: ms}`` plus ``e2e_ms`` and the unattributed ``other_ms``
    remainder — the acceptance bar is that the named phases sum to
    within 10% of ``e2e_ms`` on a served request."""
    batcher: List[Tuple[float, float]] = []
    device: List[Tuple[float, float]] = []
    tally: List[Tuple[float, float]] = []
    judge: List[Tuple[float, float]] = []
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
    device_ms = _union_ms(device)
    batcher_ms = max(0.0, _union_ms(batcher) - device_ms)
    out = {
        "admission_wait": float(
            root.attributes.get("admission_wait_ms", 0.0)
        )
        if root is not None
        else 0.0,
        "batcher_queue": batcher_ms,
        "pack_plan": pack_plan_ms,
        "device_dispatch": max(0.0, device_ms - pack_plan_ms - tally_attr_ms),
        "host_tally": _union_ms(tally) + tally_attr_ms,
        "upstream_judge": _union_ms(judge),
    }
    out = {k: round(v, 3) for k, v in out.items()}
    e2e = root.duration_ms() if root is not None else None
    if e2e is not None:
        attributed = sum(out.values())
        out["e2e_ms"] = e2e
        out["other_ms"] = round(max(0.0, e2e - attributed), 3)
    return out
