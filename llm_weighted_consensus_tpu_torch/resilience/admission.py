"""Admission control: shed excess work at the door, not in the queue.

Counterpart of ``llm_weighted_consensus_tpu/resilience/admission.py``'s
pure core.  Every request's device work funnels into one card, so
overload does not degrade gracefully on its own: it turns into unbounded
queueing and blown deadlines for everyone.  ``AdmissionController``
bounds concurrency at the gateway and rejects the excess early with a
retryable 503: a hard ``max_inflight`` cap, plus an optional AIMD limit
that tracks observed latency against a slowly drifting baseline (past
``latency_factor x baseline`` the limit decays multiplicatively; while
the pipe is full but healthy it recovers additively).  A
``max_inflight`` of 0 disables shedding; the controller then only tracks
in-flight work, the gauge the drain waits on.

The reference's controller is single-threaded (its event loop); here
the stdlib server's handler threads acquire and release, so one lock
guards the decision, the counters and the AIMD ``limit`` (which the
memory governor also shrinks, under the same lock).  The reference's aiohttp
middleware is ``serve.gateway``'s check before a device route runs (the
probes, ``/livez`` ``/readyz`` ``/metrics``, are never gated: a load
balancer must read them while the service sheds or drains), and
``shed_response`` gives the 503 as (status, headers, body).
"""

from __future__ import annotations

import json
import math
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

# routes the gate never sheds: the probes, which a load balancer must read
# while the service sheds or drains, and the reference's two admin routes,
# ``/v1/profile`` (an on-demand capture is the tool for diagnosing an
# overload) and ``/v1/weights`` (a tiny table swap); the gateway checks
# this set before it asks the gate
EXEMPT_PATHS = frozenset(
    {"/healthz", "/livez", "/readyz", "/metrics", "/v1/profile", "/v1/weights"}
)


@dataclass
class AdmissionConfig:
    """Knobs (``ADMISSION_*``, ``serve/config.py``)."""

    max_inflight: int = 0  # hard concurrency cap; 0 = no shedding
    max_queue_depth: int = 0  # the batcher's queue bound; 0 = unbounded
    adaptive: bool = False  # AIMD limit under the hard cap
    min_limit: int = 2  # adaptive floor
    latency_factor: float = 2.0  # congestion when ms > factor * baseline
    retry_after_ms: float = 1000.0  # Retry-After hint on sheds


class AdmissionController:
    """In-flight accounting and the shed decision, under one lock."""

    def __init__(
        self,
        config: AdmissionConfig,
        *,
        clock: Callable[[], float] = time.monotonic,
        device_gate: Optional[Callable[[], Optional[str]]] = None,
        mem_gate: Optional[Callable[[], Optional[str]]] = None,
    ) -> None:
        self.config = config
        self.clock = clock
        # extra shed policy for device work (the watchdog, the warmup):
        # a shed reason, or None to admit
        self.device_gate = device_gate
        # memory-pressure shed policy (``MemGuard.gate``): unlike
        # device_gate it applies to ALL non-exempt work — host-only
        # routes allocate too, and under hard memory pressure every new
        # request is one the OOM killer might answer instead of us
        self.mem_gate = mem_gate
        self._lock = threading.Lock()
        self.inflight = 0
        self.draining = False
        # the adaptive limit lives under the hard cap; without the
        # adaptive mode it mirrors max_inflight
        self.limit = float(config.max_inflight)
        self._baseline_ms: Optional[float] = None
        self._last_decrease = -math.inf
        self.admitted = 0
        self.shed: dict = {}
        # the surviving device fraction of a degraded mesh (``rescale``)
        self._mesh_scale = 1.0

    # -- the decision ---------------------------------------------------------

    def try_acquire(self, device_work: bool = False) -> Optional[str]:
        """Admit (returns None, slot held until ``release``) or the shed
        reason."""
        with self._lock:
            if self.draining:
                return self._shed("draining")
            if self.mem_gate is not None:
                reason = self.mem_gate()
                if reason is not None:
                    return self._shed(reason)
            if self.device_gate is not None and device_work:
                reason = self.device_gate()
                if reason is not None:
                    return self._shed(reason)
            cap = self.config.max_inflight
            if cap > 0:
                if self._mesh_scale != 1.0:
                    cap = max(1, int(cap * self._mesh_scale))
                effective = (
                    max(self.config.min_limit, int(self.limit))
                    if self.config.adaptive
                    else cap
                )
                if self.inflight >= min(cap, effective):
                    return self._shed("inflight_limit")
            self.inflight += 1
            self.admitted += 1
            return None

    def release(self, latency_ms: float, *, error: bool = False) -> None:
        with self._lock:
            self.inflight = max(0, self.inflight - 1)
            if self.config.adaptive and self.config.max_inflight > 0:
                self._adapt(latency_ms, error)

    def rescale(self, scale: float) -> None:
        """Scale admission to the surviving device fraction (a
        ``MeshFaultManager`` rescale hook): a downsized mesh admits
        proportionally less work instead of queueing the overflow into
        blown deadlines.  The AIMD limit is rescaled by the same ratio, so
        it starts the new regime near its value instead of decaying toward
        it one congestion sample at a time; ``scale=1.0`` (the upsize)
        restores the full cap."""
        scale = max(0.0, float(scale))
        with self._lock:
            prev = self._mesh_scale
            self._mesh_scale = scale
            if (self.config.adaptive and self.config.max_inflight > 0
                    and prev > 0):
                self.limit = min(
                    float(self.config.max_inflight),
                    max(float(self.config.min_limit),
                        self.limit * scale / prev),
                )

    # caller-holds-lock: AdmissionController._lock (only called inside with-lock blocks)
    def _shed(self, reason: str) -> str:
        self.shed[reason] = self.shed.get(reason, 0) + 1
        return reason

    # -- the AIMD/gradient limit ----------------------------------------------

    # caller-holds-lock: AdmissionController._lock (only called inside with-lock blocks)
    def _adapt(self, ms: float, error: bool) -> None:
        """The baseline is a decayed minimum of observed latency: it
        snaps down at once and drifts up 0.1% per sample.  A sample past
        ``latency_factor x baseline`` is congestion: multiplicative
        decrease, at most once per baseline interval.  Full but healthy:
        additive increase (+1/limit per sample)."""
        if self._baseline_ms is None:
            self._baseline_ms = ms
        else:
            self._baseline_ms = min(ms, self._baseline_ms * 1.001)
        congested = error or ms > self._baseline_ms * max(
            1.0, self.config.latency_factor
        )
        now = self.clock()
        if congested:
            hold_sec = max(0.05, self._baseline_ms / 1e3)
            if now - self._last_decrease >= hold_sec:
                self.limit = max(self.config.min_limit, self.limit * 0.9)
                self._last_decrease = now
        elif self.inflight >= int(self.limit) - 1:
            self.limit = min(
                float(self.config.max_inflight),
                self.limit + 1.0 / max(self.limit, 1.0),
            )

    # -- observability --------------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            out = {
                "inflight": self.inflight,
                "admitted": self.admitted,
                "shed": dict(self.shed),
                "draining": self.draining,
                "max_inflight": self.config.max_inflight,
                "max_queue_depth": self.config.max_queue_depth,
            }
            if self._mesh_scale != 1.0:
                out["mesh_scale"] = round(self._mesh_scale, 4)
            if self.config.adaptive:
                out["limit"] = round(self.limit, 2)
                if self._baseline_ms is not None:
                    out["baseline_ms"] = round(self._baseline_ms, 2)
        return out


def retry_after_seconds(retry_after_ms: float) -> str:
    """The ``Retry-After`` header value: whole seconds, at least 1."""
    return str(max(1, math.ceil(retry_after_ms / 1000.0)))


def shed_response(reason: str, retry_after_ms: float):
    """The uniform 503 shed as (status, headers, body bytes): a
    ``Retry-After`` header and the ``{code, message}`` envelope with a
    machine-readable ``shed_reason`` (the body ``OverloadedError`` gives
    on the batcher path), with the trace id of a traced request."""
    from ..errors import with_trace_id

    body = {
        "code": 503,
        "message": {"kind": "overloaded", "shed_reason": reason},
    }
    return (
        503,
        {"Retry-After": retry_after_seconds(retry_after_ms)},
        json.dumps(with_trace_id(body)).encode(),
    )
