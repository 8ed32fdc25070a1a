"""Serving lifecycle: liveness/readiness split and graceful drain.

Counterpart of ``llm_weighted_consensus_tpu/serve/lifecycle.py`` on
threads:

* ``GET /livez``: 200 while the process answers;
* ``GET /readyz``: 200 only while the service is ``READY`` and the
  device watchdog (when configured) holds the device healthy.  A server
  starts ``STARTING`` and turns ``READY`` once its CUDA graphs are
  captured (``mark_ready``), so a load balancer sends no traffic to a
  replica still warming.  Under memory pressure (``MemGuard``) it stays
  200 and flags ``degraded_mem`` with the ``mem_level``: soft pressure
  serves everything and hard pressure sheds at admission with a
  retryable 503, so the balancer should keep probing (``readyz``).  A
  downsized mesh (``MeshFaultManager.degraded``) likewise stays 200 and
  flags ``degraded_mesh`` with the ``mesh_shape`` it serves on; one card
  has no smaller shape, so the flag waits for the multi-device slice.  A
  card the watchdog holds unhealthy answers 503 ``device_unhealthy``
  with or without a CPU twin;
* SIGTERM/SIGINT -> ``begin_drain()``: with a fleet, first the hot-set
  handoff (step 0, at most half the budget, while readiness still reads
  200 and peers can still fetch from this replica); then readiness
  flips, admission stops (new requests shed with ``shed_reason:
  "draining"``), in-flight requests finish and the batcher's queue
  empties, all bounded by ``DRAIN_TIMEOUT_MILLIS``.  With a fleet,
  ``/readyz``'s 200 body carries the ``fleet`` membership snapshot.

State machine: STARTING -> READY -> DRAINING -> STOPPED, one way.
``begin_drain`` is idempotent: a repeated SIGTERM joins the drain in
progress.  The drain stops the watchdog and the memory governor.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Callable, Optional

STARTING = "starting"
READY = "ready"
DRAINING = "draining"
STOPPED = "stopped"


class Lifecycle:
    def __init__(
        self,
        *,
        admission=None,
        batcher=None,
        watchdog=None,
        memguard=None,
        meshfault=None,
        fleet=None,
        drain_timeout_ms: float = 10000.0,
        clock: Callable[[], float] = time.monotonic,
        state: str = READY,
    ) -> None:
        self.admission = admission
        self.batcher = batcher
        self.watchdog = watchdog
        self.memguard = memguard
        self.meshfault = meshfault
        # fleet.FleetRoutes (FLEET_*): the drain hands this replica's hot
        # set to its post-drain owners before readiness flips, and
        # /readyz shows the membership
        self.fleet = fleet
        self.handoff_entries: Optional[int] = None
        self.drain_timeout_ms = float(drain_timeout_ms)
        self.clock = clock
        self.state = state
        self.drained_clean: Optional[bool] = None
        self.drain_elapsed_ms: Optional[float] = None
        self._lock = threading.Lock()
        self._drain: Optional[Future] = None

    # -- readiness ------------------------------------------------------------

    def mark_ready(self) -> None:
        """STARTING -> READY (warmup finished); no effect in other
        states."""
        with self._lock:
            if self.state == STARTING:
                self.state = READY

    def ready(self):
        """(is_ready, reason): the /readyz decision."""
        if self.state != READY:
            return False, self.state
        if self.watchdog is not None and not self.watchdog.healthy():
            return False, "device_unhealthy"
        return True, None

    def readyz(self):
        """(status, body) of ``GET /readyz``: 200 ``{"ready": true}``,
        with ``degraded_mem`` and ``mem_level`` while the memory governor
        reports pressure; else 503 ``{"ready": false, "reason"}``."""
        ok, reason = self.ready()
        if not ok:
            return 503, {"ready": False, "reason": reason}
        body = {"ready": True}
        mf = self.meshfault
        if mf is not None and mf.degraded:
            body["degraded_mesh"] = True
            body["mesh_shape"] = list(mf.current_shape)
        mg = self.memguard
        if mg is not None and mg.degraded:
            body["degraded_mem"] = True
            body["mem_level"] = mg.snapshot()["level"]
        if self.fleet is not None:
            # the balancer-facing view of fleet membership: who this
            # replica is, the roster it sees, and the key-space share it
            # currently owns (full counters live in /metrics)
            body["fleet"] = self.fleet.membership_snapshot()
        return 200, body

    # -- drain ----------------------------------------------------------------

    def begin_drain(self) -> Future:
        """Start (or join) the drain on its own thread; the returned
        future resolves to whether it drained clean."""
        with self._lock:
            if self._drain is None:
                self._drain = Future()
                threading.Thread(
                    target=self._run_drain, name="lwc-torch-drain",
                    daemon=True,
                ).start()
            return self._drain

    def _run_drain(self) -> None:
        try:
            self._drain.set_result(self.drain())
        except BaseException as exc:  # the waiter sees it
            self._drain.set_exception(exc)

    def drain(self) -> bool:
        t0 = self.clock()
        deadline = t0 + self.drain_timeout_ms / 1e3
        # 0. fleet hot-set handoff BEFORE readiness flips: the entries
        #    this replica holds move to their post-drain owners while
        #    peers can still fetch from us, so a fleet-wide hot key stays
        #    a cache hit across the departure.  At most HALF the budget:
        #    the in-flight requests' share must survive a dark fleet
        if self.fleet is not None:
            self.handoff_entries = self.fleet.handoff_hot_set(
                max(0.05, (deadline - self.clock()) * 0.5)
            )
        # 1. stop admitting BEFORE waiting: readiness flips and the gate
        #    sheds everything new, so the in-flight set only shrinks
        with self._lock:
            self.state = DRAINING
        if self.admission is not None:
            self.admission.draining = True
        # 2. in-flight requests run to completion
        clean = True
        if self.admission is not None:
            while self.admission.inflight > 0:
                if self.clock() >= deadline:
                    clean = False
                    break
                time.sleep(0.01)
        # 3. the batcher's queue empties (nothing refills it)
        if self.batcher is not None:
            remaining = max(0.0, deadline - self.clock())
            clean = self.batcher.drain(remaining) and clean
        if self.watchdog is not None:
            self.watchdog.stop()
        if self.memguard is not None:
            self.memguard.stop()
        with self._lock:
            self.state = STOPPED
        self.drained_clean = clean
        self.drain_elapsed_ms = (self.clock() - t0) * 1e3
        return clean

    # -- observability --------------------------------------------------------

    def snapshot(self) -> dict:
        out = {
            "state": self.state,
            "drain_timeout_ms": self.drain_timeout_ms,
        }
        if self.drained_clean is not None:
            out["drained_clean"] = self.drained_clean
            out["drain_elapsed_ms"] = round(self.drain_elapsed_ms, 1)
        if self.handoff_entries is not None:
            out["fleet_handoff_entries"] = self.handoff_entries
        return out
