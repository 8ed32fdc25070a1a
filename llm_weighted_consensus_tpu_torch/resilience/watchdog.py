"""Device dispatch watchdog: detect a wedged device before the operator
does.

Counterpart of ``llm_weighted_consensus_tpu/resilience/watchdog.py``.  A
hung dispatch (a kernel that never finishes, a fault below the CUDA
runtime) does not raise: it never becomes ready, and every request
queued behind it times out.  The batcher brackets each dispatch
(``begin`` at its start, ``end`` once its CUDA event reports ready) and
a monitor thread checks the open brackets against ``timeout_ms``: an
overdue dispatch marks the device unhealthy, which flips ``/readyz`` and
makes admission shed the device routes; when the overdue dispatch
completes, the device is healthy again.

Clock-injectable, with ``check()`` callable directly so that trips and
recoveries can be driven without the thread; one lock guards the bracket
table and the health flag (``begin``/``end`` run on the batcher's
threads, ``check`` on the monitor thread).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional


class DeviceWatchdog:
    def __init__(
        self,
        timeout_ms: float,
        *,
        interval_ms: float = 0.0,
        clock: Callable[[], float] = time.monotonic,
        on_trip: Optional[Callable[[str, float], None]] = None,
        on_recover: Optional[Callable[[], None]] = None,
    ) -> None:
        self.timeout_ms = float(timeout_ms)
        # 0 = auto: four checks per timeout window bounds detection
        # latency at ~1.25x the configured timeout
        self.interval_ms = float(interval_ms) or max(
            10.0, self.timeout_ms / 4.0
        )
        self.clock = clock
        self.on_trip = on_trip
        self.on_recover = on_recover
        self._lock = threading.Lock()
        self._active: dict = {}  # token -> (start, label)
        self._seq = 0
        self._healthy = True
        self.trips = 0
        self.recoveries = 0
        self.dispatches = 0
        self._last_overdue_ms = 0.0
        self._last_label: Optional[str] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- dispatch brackets (called from device-executor threads) --------------

    def begin(self, label: str = "dispatch") -> int:
        with self._lock:
            self._seq += 1
            token = self._seq
            self._active[token] = (self.clock(), label)
            self.dispatches += 1
        return token

    def end(self, token: int) -> None:
        fire_recover = False
        with self._lock:
            self._active.pop(token, None)
            if not self._healthy and not self._overdue_locked():
                # the wedged dispatch came back and nothing else is
                # overdue: the device answers again
                self._healthy = True
                self.recoveries += 1
                fire_recover = True
        if fire_recover and self.on_recover is not None:
            self.on_recover()

    # -- the check (monitor thread, or tests directly) ------------------------

    # caller-holds-lock: DeviceWatchdog._lock (only end/check call this, inside their with-lock blocks)
    def _overdue_locked(self):
        now = self.clock()
        worst = None
        for start, label in self._active.values():
            elapsed_ms = (now - start) * 1e3
            if elapsed_ms > self.timeout_ms and (
                worst is None or elapsed_ms > worst[0]
            ):
                worst = (elapsed_ms, label)
        return worst

    def check(self) -> bool:
        """One watchdog pass; returns the current health."""
        fire_trip = None
        with self._lock:
            worst = self._overdue_locked()
            if worst is not None and self._healthy:
                self._healthy = False
                self.trips += 1
                self._last_overdue_ms, self._last_label = worst
                fire_trip = worst
        if fire_trip is not None and self.on_trip is not None:
            self.on_trip(fire_trip[1], fire_trip[0])
        return self.healthy()

    def healthy(self) -> bool:
        with self._lock:
            return self._healthy

    # -- monitor thread -------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="lwc-watchdog", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=1.0)

    def _run(self) -> None:
        while not self._stop.wait(self.interval_ms / 1e3):
            self.check()

    # -- observability --------------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            out = {
                "healthy": self._healthy,
                "active_dispatches": len(self._active),
                "dispatches": self.dispatches,
                "trips": self.trips,
                "recoveries": self.recoveries,
                "timeout_ms": self.timeout_ms,
            }
            if not self._healthy:
                out["overdue_ms"] = round(self._last_overdue_ms, 1)
                out["overdue_kind"] = self._last_label
        return out
