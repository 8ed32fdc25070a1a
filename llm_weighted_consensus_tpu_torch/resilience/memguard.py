"""Host memory governor: bound RSS before the OOM killer does.

A serving host under hostile input or a slow leak does not fail
gracefully on its own — RSS climbs until the kernel kills the process
mid-stream, which reads as a crash to every in-flight client.  The
governor samples process RSS on the watchdog cadence and holds two
watermarks:

* **soft** (``MEM_SOFT_BYTES``) — shrink the knobs that trade memory
  for hit rate: cache byte budgets, the trace ring, and the AIMD
  admission limit all scale down by ``shrink`` (originals restored on
  recovery).  The service keeps serving everything.
* **hard** (``MEM_HARD_BYTES``) — shed all new non-exempt work with a
  retryable ``503 {"kind": "overloaded", "shed_reason": "memory"}``
  (the admission ``mem_gate``) and flip a ``degraded_mem`` flag on
  ``/readyz`` (still 200 — in-flight work is finishing and probes must
  keep answering).

Recovery is hysteretic: a level is left only when RSS falls below
``recover_fraction`` of its watermark, so a process hovering at the
boundary doesn't flap between shedding and admitting every sample.

Pure-core hygiene (the DeviceWatchdog pattern): ``rss_fn`` injectable,
``check()`` callable directly so tests drive trip/recovery with a fake
RSS sequence and no thread; the monitor thread is a thin ``check()``
loop.  One lock guards the level state — ``check()`` runs on the
monitor thread while snapshot/gate reads come from the handler threads.

The port's copy of ``llm_weighted_consensus_tpu/resilience/memguard.py``.
The reference shrinks its budgets next to one event loop; the port's
gateway is a threaded server, so a governed object that has a ``_lock``
(the admission controller, the trace sink) has its budget changed under
that lock.  The cache stores take a plain attribute store: their
``max_bytes`` is read once per ``put``.  The server stops the monitor
thread when it closes.

RSS source: ``/proc/self/status`` ``VmRSS`` (current resident set),
falling back to ``resource.getrusage`` ``ru_maxrss`` (peak, not
current — recovery never fires on a peak counter, so the fallback is
trip-only).  No new dependencies.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional

LEVEL_OK = 0
LEVEL_SOFT = 1
LEVEL_HARD = 2

_LEVEL_NAMES = {LEVEL_OK: "ok", LEVEL_SOFT: "soft", LEVEL_HARD: "hard"}


def read_rss_bytes() -> Optional[int]:
    """Current resident set size, or None when unmeasurable."""
    try:
        with open("/proc/self/status", "rb") as f:
            for line in f:
                if line.startswith(b"VmRSS:"):
                    return int(line.split()[1]) * 1024  # kB -> bytes
    except (OSError, ValueError, IndexError):
        pass
    try:
        import resource

        # Linux reports ru_maxrss in kilobytes; this is the PEAK rss,
        # good enough to trip on, useless for recovery (documented above)
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    except Exception:
        return None


def read_mem_total_bytes() -> Optional[int]:
    """Host MemTotal for auto watermarks, or None when unavailable."""
    try:
        with open("/proc/meminfo", "rb") as f:
            for line in f:
                if line.startswith(b"MemTotal:"):
                    return int(line.split()[1]) * 1024  # kB -> bytes
    except (OSError, ValueError, IndexError):
        pass
    return None


def resolve_watermarks(
    soft_bytes: int, hard_bytes: int
) -> Optional[tuple]:
    """Resolve the ``MEM_SOFT_BYTES``/``MEM_HARD_BYTES`` knobs: 0 means
    auto (80% / 90% of host MemTotal).  Returns ``(soft, hard)``, or
    None when an auto watermark is needed but MemTotal is unreadable —
    the governor is then disabled rather than guessing."""
    soft = int(soft_bytes)
    hard = int(hard_bytes)
    if soft > 0 and hard > 0:
        return soft, max(soft, hard)
    total = read_mem_total_bytes()
    if total is None:
        return None
    if soft <= 0:
        soft = int(total * 0.8)
    if hard <= 0:
        hard = int(total * 0.9)
    return soft, max(soft, hard)


def _owned(obj):
    """The governed object's own lock, when it has one: its budget then
    changes where its other threads read it."""
    lock = getattr(obj, "_lock", None)
    return lock if lock is not None else contextlib.nullcontext()


class MemGuard:
    """Two-watermark RSS governor with hysteretic recovery."""

    def __init__(
        self,
        soft_bytes: int,
        hard_bytes: int,
        *,
        interval_ms: float = 1000.0,
        recover_fraction: float = 0.9,
        shrink: float = 0.5,
        rss_fn: Callable[[], Optional[int]] = read_rss_bytes,
        on_soft: Optional[Callable[[int], None]] = None,
        on_soft_clear: Optional[Callable[[], None]] = None,
        on_hard: Optional[Callable[[int], None]] = None,
        on_hard_clear: Optional[Callable[[], None]] = None,
    ) -> None:
        self.soft_bytes = int(soft_bytes)
        self.hard_bytes = max(self.soft_bytes, int(hard_bytes))
        self.interval_ms = max(10.0, float(interval_ms))
        self.recover_fraction = min(1.0, max(0.0, float(recover_fraction)))
        self.shrink = min(1.0, max(0.01, float(shrink)))
        self.rss_fn = rss_fn
        self.on_soft = on_soft
        self.on_soft_clear = on_soft_clear
        self.on_hard = on_hard
        self.on_hard_clear = on_hard_clear
        self._lock = threading.Lock()
        self._level = LEVEL_OK
        self.last_rss: Optional[int] = None
        self.peak_rss = 0
        self.soft_trips = 0
        self.hard_trips = 0
        self.recoveries = 0
        # governed objects: (object, original budget) pairs captured by
        # govern(); soft pressure scales them, recovery restores them
        self._caches: list = []
        self._sinks: list = []
        self._admission = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- governed budgets ------------------------------------------------------

    def govern(self, *, caches=(), sinks=(), admission=None) -> None:
        """Register the memory-for-performance knobs soft pressure may
        shrink: cache stores (``max_bytes``), trace sinks
        (``capacity``), and the admission controller (AIMD ``limit``
        decays once per soft entry; AIMD's additive increase recovers it
        naturally).  Original budgets are captured here and restored on
        soft exit."""
        self._caches = [
            (c, c.max_bytes) for c in caches if c is not None
        ]
        self._sinks = [
            (s, s.capacity) for s in sinks if s is not None
        ]
        self._admission = admission

    def _apply_soft(self) -> None:
        for cache, orig in self._caches:
            # put-side eviction enforces the shrunk budget (store.py
            # tolerates max_bytes shrinking under live entries)
            cache.max_bytes = max(1, int(orig * self.shrink))
        for sink, orig in self._sinks:
            with _owned(sink):
                sink.capacity = max(1, int(orig * self.shrink))
        adm = self._admission
        if (
            adm is not None
            and adm.config.adaptive
            and adm.config.max_inflight > 0
        ):
            with _owned(adm):
                adm.limit = max(
                    float(adm.config.min_limit), adm.limit * self.shrink
                )

    def _restore_soft(self) -> None:
        for cache, orig in self._caches:
            cache.max_bytes = orig
        for sink, orig in self._sinks:
            with _owned(sink):
                sink.capacity = orig
        # the AIMD limit is NOT snapped back: additive increase probes it
        # back up against observed latency, which is the honest signal

    # -- the admission gate ----------------------------------------------------

    @property
    def shedding(self) -> bool:
        with self._lock:
            return self._level >= LEVEL_HARD

    def gate(self) -> Optional[str]:
        """Admission ``mem_gate`` hook: the shed reason under hard
        pressure, None otherwise."""
        return "memory" if self.shedding else None

    @property
    def degraded(self) -> bool:
        """The /readyz ``degraded_mem`` flag: any pressure level."""
        with self._lock:
            return self._level > LEVEL_OK

    # -- the check (monitor thread, or tests directly) ------------------------

    def check(self) -> int:
        """One governor pass; returns the current pressure level."""
        rss = self.rss_fn()
        if rss is None:
            with self._lock:
                return self._level
        fire: list = []
        with self._lock:
            self.last_rss = rss
            if rss > self.peak_rss:
                self.peak_rss = rss
            old = self._level
            new = self._transition(old, rss)
            if new != old:
                self._level = new
                if old == LEVEL_OK and new >= LEVEL_SOFT:
                    self.soft_trips += 1
                    fire.append(("soft", rss))
                if old < LEVEL_HARD and new == LEVEL_HARD:
                    self.hard_trips += 1
                    fire.append(("hard", rss))
                if old == LEVEL_HARD and new < LEVEL_HARD:
                    fire.append(("hard_clear", rss))
                if old >= LEVEL_SOFT and new == LEVEL_OK:
                    self.recoveries += 1
                    fire.append(("soft_clear", rss))
        # budget changes + user hooks run outside the lock (watchdog
        # discipline: never call out while holding it)
        for kind, observed in fire:
            if kind == "soft":
                self._apply_soft()
                if self.on_soft is not None:
                    self.on_soft(observed)
            elif kind == "soft_clear":
                self._restore_soft()
                if self.on_soft_clear is not None:
                    self.on_soft_clear()
            elif kind == "hard":
                if self.on_hard is not None:
                    self.on_hard(observed)
            elif kind == "hard_clear":
                if self.on_hard_clear is not None:
                    self.on_hard_clear()
        with self._lock:
            return self._level

    # caller-holds-lock: MemGuard._lock (only check() calls this)
    def _transition(self, level: int, rss: int) -> int:
        rf = self.recover_fraction
        if level == LEVEL_HARD:
            if rss >= self.hard_bytes * rf:
                return LEVEL_HARD
            return LEVEL_SOFT if rss >= self.soft_bytes * rf else LEVEL_OK
        if level == LEVEL_SOFT:
            if rss > self.hard_bytes:
                return LEVEL_HARD
            return LEVEL_SOFT if rss >= self.soft_bytes * rf else LEVEL_OK
        if rss > self.hard_bytes:
            return LEVEL_HARD
        return LEVEL_SOFT if rss > self.soft_bytes else LEVEL_OK

    def level(self) -> int:
        with self._lock:
            return self._level

    # -- monitor thread -------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="lwc-memguard", daemon=True
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
                "level": _LEVEL_NAMES[self._level],
                "soft_bytes": self.soft_bytes,
                "hard_bytes": self.hard_bytes,
                "soft_trips": self.soft_trips,
                "hard_trips": self.hard_trips,
                "recoveries": self.recoveries,
                "shedding": self._level >= LEVEL_HARD,
            }
            if self.last_rss is not None:
                out["rss_bytes"] = self.last_rss
                out["peak_rss_bytes"] = self.peak_rss
        return out
