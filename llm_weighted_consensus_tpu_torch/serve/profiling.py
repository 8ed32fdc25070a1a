"""Profiler control routes on ``torch.profiler`` (``PROFILE_DIR``).

Counterpart of the reference's ``_profile_handlers`` (JAX
``serve/gateway.py``): ``POST /profile/start``, ``POST /profile/stop``
and the one-shot ``POST /v1/profile {"duration_ms"}`` (default 500,
clamped to [10, 10000]: start, let live traffic run for the window,
stop).  The profiler is process-global, so one lock serializes start and
stop: a second start while a trace runs answers 400 ``trace already
active``, a stop without one 400 ``no active trace``.  The response
bodies are the reference's.

A capture records the CPU ops of every thread (Kineto's
``profile_all_threads``, where the installed torch has it) and, where
there is one, the card (CUDA activities: every kernel launched in the
window), and
is written as Chrome-trace JSON under ``PROFILE_DIR``
(``lwc-torch-<pid>-<n>.pt.trace.json``; ``traces`` lists them).  That is
the one divergence in format: the reference writes xprof.  Starting,
stopping and exporting run on a thread of their own, off the handler
thread that times the window, as the reference runs them on its
executor; ``close`` stops a trace still running.
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

PROFILE_DISABLED = {"code": 403, "message": "profiling disabled: set PROFILE_DIR"}
ALREADY_ACTIVE = {"code": 400, "message": "trace already active"}
NOT_ACTIVE = {"code": 400, "message": "no active trace"}
DEFAULT_DURATION_MS = 500.0
MIN_DURATION_MS, MAX_DURATION_MS = 10.0, 10_000.0


def _all_threads():
    """Kineto's config that records the CPU ops of every thread (the
    batcher's dispatch threads, not only the profiler's own), or None on
    a torch without it (the card's kernels are recorded from every
    thread either way)."""
    from torch._C._profiler import _ExperimentalConfig

    try:
        return _ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        return None


class ProfileRoutes:
    """The three routes over one ``torch.profiler.profile`` at a time;
    each handler returns (status, body obj) and raises what the profiler
    raised (the gateway renders it as its other routes do)."""

    def __init__(self, profile_dir: str) -> None:
        self.profile_dir = profile_dir
        self._lock = threading.Lock()
        self._active = False
        self._prof = None
        self._io = ThreadPoolExecutor(1, thread_name_prefix="lwc-torch-prof")
        self._seq = 0
        self.traces: list = []

    # -- on the profiler's thread ------------------------------------------------

    def _start_trace(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities,
                       experimental_config=_all_threads())
        prof.start()
        self._prof = prof

    def _stop_trace(self):
        prof, self._prof = self._prof, None
        if prof is None:  # stopped by close() meanwhile
            return None
        prof.stop()
        os.makedirs(self.profile_dir, exist_ok=True)
        self._seq += 1
        path = os.path.join(
            self.profile_dir,
            f"lwc-torch-{os.getpid()}-{self._seq}.pt.trace.json")
        prof.export_chrome_trace(path)
        self.traces.append(path)
        return path

    def _run(self, fn):
        return self._io.submit(fn).result()

    # -- the routes --------------------------------------------------------------

    def start(self, raw: bytes = b""):
        with self._lock:
            if self._active:
                return 400, ALREADY_ACTIVE
            self._run(self._start_trace)
            self._active = True
        return 200, {"ok": True, "dir": self.profile_dir}

    def stop(self, raw: bytes = b""):
        with self._lock:
            if not self._active:
                return 400, NOT_ACTIVE
            # cleared whatever the outcome: a failed export must not wedge
            # the routes
            self._active = False
            self._run(self._stop_trace)
        return 200, {"ok": True, "dir": self.profile_dir}

    def capture(self, raw: bytes = b""):
        """``POST /v1/profile``: one bounded capture while live traffic
        runs (a fat-fingered duration cannot leave the profiler on)."""
        from ..utils import jsonutil

        try:
            body = jsonutil.loads(raw.decode("utf-8") or "{}")
        except Exception:
            body = {}
        if not isinstance(body, dict):
            body = {}
        duration_ms = float(body.get("duration_ms", DEFAULT_DURATION_MS)
                            or DEFAULT_DURATION_MS)
        duration_ms = min(MAX_DURATION_MS, max(MIN_DURATION_MS, duration_ms))
        with self._lock:
            if self._active:
                return 400, ALREADY_ACTIVE
            self._active = True
        try:
            self._run(self._start_trace)
            time.sleep(duration_ms / 1e3)
            self._run(self._stop_trace)
        finally:
            with self._lock:
                self._active = False
        return 200, {"ok": True, "dir": self.profile_dir,
                     "duration_ms": duration_ms}

    def close(self) -> None:
        """Stop a trace still running (its file is written) and the
        profiler's thread."""
        with self._lock:
            running = self._prof is not None
            self._active = False
        try:
            if running:
                self._run(self._stop_trace)
        finally:
            self._io.shutdown(wait=True)
