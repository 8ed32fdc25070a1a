"""Device fault domains: keep serving through a failing dispatch
(``MESH_FAULT_*``, ``DEVICE_FAULT_PLAN``).

Counterpart of ``llm_weighted_consensus_tpu/resilience/meshfault.py`` on
one CUDA card.  A dispatch on an H100 fails in the card's own ways: an
allocation fails (``torch.OutOfMemoryError``), a sticky error (an illegal
address, a device-side assert) poisons the CUDA context for the rest of
the process, or a launch wedges (the watchdog sees it overdue).  The
reference's answer, kept here:

* ``classify_dispatch_error`` sorts a dispatch failure at the
  batcher seam into *transient* (retry on the same shape), *persistent*
  (the device is gone) or not a device fault (an application error keeps
  the fail-the-group path).  It matches by type name and message, as the
  reference matches ``XlaRuntimeError`` by name (the table below);
* ``MeshFaultManager`` layers the policy over it: a transient streak past
  ``transient_retries`` (or a dispatch the watchdog found overdue)
  escalates to persistent, and a persistent fault walks the downsize
  ladder: dp halving from the full shape toward 1, tp and sp kept, each
  rung's devices a row-major prefix of the previous rung's list (the
  dropped tail is the faulted domain).  Each rung serves from its own
  ``parallel.sharding.MeshModel``, built once (``warm_ladder``, or at the
  first switch to a rung that was never warmed) and kept alive with the
  CUDA graphs captured over it: a graph holds its rung's tensors'
  addresses, so a rung rebuilt at downsize time would replay into freed
  memory or capture under fire.  ``downsize`` and ``try_recover`` switch
  the embedder between stored rungs (``TorchEmbedder.attach_mesh``) under
  the exclusive side of the shape gate: no weight is re-sharded and no
  graph captured.  Past the last rung the batcher switches to the CPU
  twin (``DEVICE_WATCHDOG_CPU_FALLBACK``) or fails the group.  An
  embedder without a mesh is the one-rung ladder ``[(1, 1)]``, spent from
  the start;
* ``DeviceFaultPlan`` is the deterministic injection seam: one
  ``random.Random(seed)`` drawn once per dispatch in dispatch order, or a
  script replayed verbatim.  ``hang`` sleeps ``hang_ms`` (the watchdog's
  overdue observation) and then raises, so no test blocks on a real
  wedge.

The CUDA classification (``classify_dispatch_error``):

================================================  ==========
``torch.OutOfMemoryError``, "CUDA out of memory",  transient
a wrapper's ``CUDA error 2`` (allocation)
a sticky context error: illegal address (700),     persistent
device-side assert (710), hardware stack error,
illegal instruction, misaligned address, invalid
address space, invalid PC (714-718), launch
failure (719), uncorrectable ECC (214), by its
text, its enum name or a wrapper's code
a wrapper's ``CUDA error 1`` (invalid value), any  None
exception that is not a CUDA error
any other CUDA error                               transient
================================================  ==========

Newer torch raises CUDA errors as ``torch.AcceleratorError``, older
torch as ``RuntimeError``; both are matched.  The module imports no
torch.
"""

from __future__ import annotations

import contextlib
import logging
import random
import re
import threading
import time
from typing import Dict, List, Optional

# device-fault kinds, in the fixed order the sampler walks (order is part
# of the determinism contract: do not reorder)
TRANSIENT = "transient"
PERSISTENT = "persistent"
HANG = "hang"

DEVICE_FAULT_KINDS = (TRANSIENT, PERSISTENT, HANG)

# a kernel wrapper's launch failure (ops/_build.py::check)
_WRAPPER_CODE = re.compile(r"CUDA error (\d+) at launch")
_ALLOCATION = 2  # cudaErrorMemoryAllocation
_INVALID_VALUE = 1  # cudaErrorInvalidValue: the caller's arguments
# the errors that leave the context unusable: every later CUDA call in
# the process fails, so a retry on the card cannot succeed
_STICKY_CODES = frozenset({214, 700, 710, 714, 715, 716, 717, 718, 719})
_STICKY_TEXTS = (
    "an illegal memory access was encountered",
    "device-side assert triggered",
    "hardware stack error",
    "an illegal instruction was encountered",
    "misaligned address",
    "operation not supported on global/shared address space",
    "invalid program counter",
    "unspecified launch failure",
    "uncorrectable ECC error encountered",
    "cudaErrorIllegalAddress",
    "cudaErrorAssert",
    "cudaErrorHardwareStackError",
    "cudaErrorIllegalInstruction",
    "cudaErrorMisalignedAddress",
    "cudaErrorInvalidAddressSpace",
    "cudaErrorInvalidPc",
    "cudaErrorLaunchFailure",
    "cudaErrorECCUncorrectable",
)


class InjectedTransientError(RuntimeError):
    """A ``DeviceFaultPlan`` transient dispatch failure."""


class InjectedPersistentError(RuntimeError):
    """A ``DeviceFaultPlan`` persistent device loss."""


class InjectedHangError(RuntimeError):
    """Raised after a ``DeviceFaultPlan`` hang's bounded sleep (the real
    failure never returns; the sleep gives the watchdog its overdue
    observation, then this raise unwedges the drill)."""


def classify_dispatch_error(exc: BaseException) -> Optional[str]:
    """Sort a dispatch exception: ``"transient"`` / ``"persistent"`` /
    ``None`` (not a device fault: an application error), by the table in
    the module doc.  An unknown CUDA error classifies transient: one free
    retry costs a dispatch, and the manager's streak escalation turns a
    transient run into persistent anyway."""
    if isinstance(exc, InjectedTransientError):
        return TRANSIENT
    if isinstance(exc, InjectedPersistentError):
        return PERSISTENT
    if isinstance(exc, InjectedHangError):
        return TRANSIENT  # escalated by the watchdog-overdue note
    name = type(exc).__name__
    if name == "OutOfMemoryError":
        return TRANSIENT
    if not isinstance(exc, RuntimeError) and name != "AcceleratorError":
        return None
    msg = str(exc)
    wrapper = _WRAPPER_CODE.search(msg)
    if wrapper is not None:
        code = int(wrapper.group(1))
        if code == _INVALID_VALUE:
            return None
        if code in _STICKY_CODES:
            return PERSISTENT
        return TRANSIENT
    if "CUDA out of memory" in msg:
        return TRANSIENT
    if any(text in msg for text in _STICKY_TEXTS):
        return PERSISTENT
    if name == "AcceleratorError" or "CUDA error" in msg:
        return TRANSIENT
    return None


class DeviceFaultPlan:
    """Per-dispatch device-fault schedule: seeded sampling or a script.

    The ``faults.FaultPlan`` contract verbatim (one ``random.Random(seed)``
    drawn once per dispatch in dispatch order, or ``scripted([...])``
    replay) at the batcher's dispatch boundary, with the device failure
    modes ``transient``, ``persistent`` and ``hang``."""

    def __init__(
        self,
        seed: int = 0,
        probabilities: Optional[Dict[str, float]] = None,
        hang_ms: float = 50.0,
        script: Optional[List[Optional[str]]] = None,
    ) -> None:
        self.seed = int(seed)
        self.rng = random.Random(self.seed)
        self.probabilities = {
            kind: float((probabilities or {}).get(kind, 0.0))
            for kind in DEVICE_FAULT_KINDS
        }
        self.hang_ms = float(hang_ms)
        self._script = list(script) if script is not None else None
        self._script_pos = 0
        self.requests = 0
        self.injected: Dict[str, int] = {kind: 0 for kind in DEVICE_FAULT_KINDS}

    @classmethod
    def scripted(
        cls, faults: List[Optional[str]], *, hang_ms: float = 50.0
    ) -> "DeviceFaultPlan":
        """Replay ``faults`` verbatim (None = healthy dispatch); healthy
        after exhaustion."""
        return cls(script=faults, hang_ms=hang_ms)

    @classmethod
    def parse(cls, spec: str) -> "DeviceFaultPlan":
        """Parse a ``DEVICE_FAULT_PLAN`` spec: comma-separated
        ``key=value``, ``seed``, ``hang_ms``, one key per fault kind with
        its probability, or ``script=a|b|ok|c`` (``ok``/empty = a healthy
        slot)."""
        seed = 0
        hang_ms = 50.0
        probs: Dict[str, float] = {}
        script: Optional[List[Optional[str]]] = None
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(
                    f"DEVICE_FAULT_PLAN: expected key=value, got {part!r}"
                )
            key, _, value = part.partition("=")
            key = key.strip()
            value = value.strip()
            if key == "seed":
                seed = int(value)
            elif key == "hang_ms":
                hang_ms = float(value)
            elif key == "script":
                script = [
                    None if slot in ("", "ok") else slot
                    for slot in value.split("|")
                ]
                for slot in script:
                    if slot is not None and slot not in DEVICE_FAULT_KINDS:
                        raise ValueError(
                            f"DEVICE_FAULT_PLAN: unknown fault {slot!r}"
                        )
            elif key in DEVICE_FAULT_KINDS:
                probs[key] = float(value)
            else:
                raise ValueError(f"DEVICE_FAULT_PLAN: unknown key {key!r}")
        return cls(seed=seed, probabilities=probs, hang_ms=hang_ms,
                   script=script)

    def next_fault(self) -> Optional[str]:
        """The fault for the next dispatch (None = healthy)."""
        self.requests += 1
        if self._script is not None:
            if self._script_pos >= len(self._script):
                return None
            fault = self._script[self._script_pos]
            self._script_pos += 1
            if fault is not None:
                self.injected[fault] += 1
            return fault
        draw = self.rng.random()
        edge = 0.0
        for kind in DEVICE_FAULT_KINDS:
            edge += self.probabilities[kind]
            if draw < edge:
                self.injected[kind] += 1
                return kind
        return None

    def snapshot(self) -> dict:
        return {
            "requests": self.requests,
            "injected": {k: v for k, v in self.injected.items() if v},
        }


class _ShapeGate:
    """Reader-writer gate serializing shape transitions with dispatches:
    every dispatch holds the shared side while it stages and enqueues
    (the batcher runs ``pipeline_depth`` dispatch threads), and
    ``downsize``/``try_recover`` hold the exclusive side across a
    re-shard.  Writer preference bounds a transition's wait to the
    dispatches already in flight."""

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0

    @contextlib.contextmanager
    def shared(self):
        with self._cond:
            while self._writer or self._writers_waiting:
                self._cond.wait()
            self._readers += 1
        try:
            yield
        finally:
            with self._cond:
                self._readers -= 1
                if not self._readers:
                    self._cond.notify_all()

    @contextlib.contextmanager
    def exclusive(self):
        with self._cond:
            self._writers_waiting += 1
            try:
                while self._writer or self._readers:
                    self._cond.wait()
            finally:
                self._writers_waiting -= 1
            self._writer = True
        try:
            yield
        finally:
            with self._cond:
                self._writer = False
                self._cond.notify_all()


class _Rung:
    """One ladder step: its shape, its mesh (None on the one-rung ladder
    of an embedder without a mesh), the devices it spans (a row-major
    prefix of the full list) and its ``MeshModel`` (``placed``), built
    once and kept for the manager's life (module doc)."""

    __slots__ = ("dp", "tp", "mesh", "devices", "placed")

    def __init__(self, dp: int, tp: int, mesh, devices: list,
                 placed=None) -> None:
        self.dp = dp
        self.tp = tp
        self.mesh = mesh
        self.devices = devices
        self.placed = placed


class MeshFaultManager:
    """The fault-domain brain: classify -> downsize -> re-dispatch ->
    probe -> upsize.

    ``classify``/``note_*``/``snapshot`` and the state properties run
    under a lock (the dispatch and waiter threads and the watchdog's
    monitor all call in).  ``dispatch_guard`` is the shared side of the
    shape gate, held by each dispatch while it stages and enqueues;
    ``downsize``/``try_recover`` hold the exclusive side across a rung
    switch, so a switch waits out the dispatches in flight.
    ``rung_pool_bytes`` maps each warmed rung's (dp, tp) to the graph
    pool bytes its warmup added."""

    def __init__(
        self,
        embedder,
        *,
        shape: tuple = (1, 1),
        transient_retries: int = 2,
        probe_millis: float = 0.0,
        fault_plan: Optional[DeviceFaultPlan] = None,
        clock=time.monotonic,
    ) -> None:
        self.embedder = embedder
        self.full_shape = (int(shape[0]), int(shape[1]))
        self.sp = int(getattr(embedder, "mesh_sp", 1) or 1)
        self.transient_retries = int(transient_retries)
        self.probe_millis = float(probe_millis)
        self.fault_plan = fault_plan
        self.clock = clock
        # callables(scale: float) run after every shape change
        self.rescale_hooks: list = []
        # optional zero-arg probe run on the full shape by try_recover
        self.probe_fn = None
        # re-entrant: snapshot() reads the locked properties under it
        self._lock = threading.RLock()
        self._shape_gate = _ShapeGate()
        self._rungs: List[_Rung] = []
        self._rung_index = 0
        self._epoch = 0
        self._downsizes = 0
        self._upsizes = 0
        self._re_dispatches = 0
        self._probe_failures = 0
        self._consecutive_probe_failures = 0
        self._warned_blind_upsize = False
        self._transient_streak = 0
        self._watchdog_overdue = False
        self._faulted_devices: list = []
        self.rung_pool_bytes: dict = {}

    # -- the ladder ------------------------------------------------------------

    def build_ladder(self) -> List[tuple]:
        """Declare the ladder (without warming it): dp halving from the
        full shape toward 1, tp and sp preserved, each rung's mesh over a
        row-major prefix of the previous rung's devices.  An embedder
        without a mesh has the one rung of the full shape, which must be
        1x1."""
        from ..parallel.mesh import make_mesh

        if self._rungs:
            return [(r.dp, r.tp) for r in self._rungs]
        dp, tp = self.full_shape
        full_mesh = getattr(self.embedder, "mesh", None)
        if full_mesh is None:
            if dp * tp * self.sp != 1:
                raise RuntimeError(
                    "MeshFaultManager needs a mesh-sharded embedder "
                    "(parallel.shard_embedder_mesh) before build_ladder"
                )
            device = getattr(self.embedder, "device", None)
            self._rungs = [_Rung(dp, tp, None, [device])]
            return [(r.dp, r.tp) for r in self._rungs]
        devices = full_mesh.flat()
        sp = self.sp
        rungs = [_Rung(dp, tp, full_mesh, devices,
                       getattr(self.embedder, "mesh_model", None))]
        step = dp // 2
        while step >= 1:
            sub = devices[: step * tp * sp]
            rungs.append(_Rung(step, tp,
                               make_mesh(dp=step, tp=tp, sp=sp, devices=sub),
                               sub))
            step //= 2
        self._rungs = rungs
        return [(r.dp, r.tp) for r in self._rungs]

    def _placed(self, rung: _Rung):
        """``rung``'s ``MeshModel``: the stored one, or (a rung never
        warmed) built now from the embedder's model and stored."""
        if rung.placed is None:
            from ..parallel.sharding import shard_bert_params

            rung.placed = shard_bert_params(
                self.embedder.model, rung.mesh, tp=rung.tp > 1)
        return rung.placed

    def _switch(self, rung: _Rung) -> None:
        """Serve from ``rung``: the embedder attaches the rung's stored
        ``MeshModel``; no weight moves and no graph is captured (its
        buckets' keys are the rung's own, warmed by ``warm_ladder``)."""
        if rung.mesh is None:
            return
        self.embedder.attach_mesh(self._placed(rung), mesh_mode=True)

    def warm_ladder(
        self,
        specs: list,
        r_buckets: list = (),
        packed_buckets: list = (),
        ring_buckets: list = (),
    ) -> list:
        """Warm every rung so a downsize never captures: bottom-up
        (smallest rung first, the full shape last), each rung's
        ``MeshModel`` is built once and the embedder warms the same bucket
        set the full shape got under that rung's ``("mesh", dp, tp)``
        keys.  The last step is the full shape, so the embedder leaves
        warmed and placed as it came.  Returns [(label, seconds)] for the
        buckets warmed by this call; ``rung_pool_bytes`` gets each rung's
        share of the graph pool."""
        self.build_ladder()
        timings = []
        with self._shape_gate.exclusive():
            for rung in reversed(self._rungs):
                self._switch(rung)
                before = self.embedder.graph_stats()["pool_bytes"]
                timings.extend(self.embedder.warmup(
                    specs, r_buckets, packed_buckets, ring_buckets))
                pool = self.embedder.graph_stats()["pool_bytes"] - before
                key = (rung.dp, rung.tp)
                self.rung_pool_bytes[key] = (
                    self.rung_pool_bytes.get(key, 0) + pool)
        return timings

    # -- dispatch/transition serialization -------------------------------------

    def dispatch_guard(self):
        """The shared side of the shape gate, held by one dispatch while
        it stages and enqueues."""
        return self._shape_gate.shared()

    # -- classification ----------------------------------------------------------

    def classify(self, exc: BaseException) -> Optional[str]:
        """Policy over ``classify_dispatch_error``: a watchdog overdue
        note or a transient streak past ``transient_retries`` escalates
        transient to persistent."""
        kind = classify_dispatch_error(exc)
        if kind is None:
            return None
        with self._lock:
            if kind == PERSISTENT:
                self._transient_streak = 0
                self._watchdog_overdue = False
                return PERSISTENT
            if self._watchdog_overdue:
                self._watchdog_overdue = False
                self._transient_streak = 0
                return PERSISTENT
            self._transient_streak += 1
            if self._transient_streak > self.transient_retries:
                self._transient_streak = 0
                return PERSISTENT
            return TRANSIENT

    def note_watchdog_trip(self) -> None:
        """Mark the next classified dispatch failure persistent: an
        overdue dispatch is a wedge, not a blip (the watchdog's
        ``on_trip``, ``serve/__main__.py``)."""
        with self._lock:
            self._watchdog_overdue = True

    def note_dispatch_ok(self) -> None:
        """A clean dispatch (at readiness) resets the transient streak."""
        with self._lock:
            self._transient_streak = 0
            self._watchdog_overdue = False

    def note_redispatch(self, count: int = 1) -> None:
        with self._lock:
            self._re_dispatches += int(count)

    # -- injection seam ------------------------------------------------------------

    def maybe_inject(self) -> None:
        """The ``DEVICE_FAULT_PLAN`` seam, at the top of every card
        dispatch on the dispatch thread (``serve/batcher.py``), before
        anything is staged or launched.  ``hang`` sleeps ``hang_ms``, long
        enough for the watchdog to see the dispatch overdue, then
        raises."""
        plan = self.fault_plan
        if plan is None:
            return
        with self._lock:
            fault = plan.next_fault()
        if fault == TRANSIENT:
            raise InjectedTransientError(
                "DEVICE_FAULT_PLAN: injected transient dispatch failure"
            )
        if fault == PERSISTENT:
            raise InjectedPersistentError(
                "DEVICE_FAULT_PLAN: injected persistent device loss"
            )
        if fault == HANG:
            time.sleep(plan.hang_ms / 1000.0)
            raise InjectedHangError("DEVICE_FAULT_PLAN: injected dispatch hang")

    # -- shape transitions ---------------------------------------------------------

    @property
    def degraded(self) -> bool:
        with self._lock:
            return self._rung_index > 0

    @property
    def exhausted(self) -> bool:
        """Past the last rung: the CPU twin is the only lever left (on
        the one-rung ladder, from the start)."""
        with self._lock:
            self.build_ladder()
            return self._rung_index >= len(self._rungs) - 1

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    @property
    def current_shape(self) -> tuple:
        with self._lock:
            if not self._rungs:
                return self.full_shape
            rung = self._rungs[self._rung_index]
            return (rung.dp, rung.tp)

    def _rescale(self) -> None:
        scale = self.current_shape[0] / self.full_shape[0]
        for hook in self.rescale_hooks:
            hook(scale)

    def downsize(self, observed_epoch: Optional[int] = None) -> bool:
        """Step down one rung: switch the embedder to the next rung's
        stored ``MeshModel``, record the dropped tail's shard indices as
        the faulted domain, bump the epoch and rescale admission and the
        batcher.  False when the ladder is spent (the caller switches to
        the CPU twin or fails the group).

        ``observed_epoch`` is the epoch the failed dispatch was stamped
        with.  Pipelined dispatches can fault on the same dead device
        together; only the first fault of an epoch steps the ladder, and
        a stale epoch re-queues onto the current shape (True, no step).

        Runs under the exclusive side of the shape gate: the switch waits
        out the dispatches in flight, so it is safe from any thread."""
        self.build_ladder()
        with self._shape_gate.exclusive():
            with self._lock:
                if observed_epoch is not None and observed_epoch != self._epoch:
                    return True
                if self._rung_index >= len(self._rungs) - 1:
                    return False
                old = self._rungs[self._rung_index]
                self._rung_index += 1
                rung = self._rungs[self._rung_index]
                self._faulted_devices.extend(
                    range(len(rung.devices), len(old.devices)))
                self._downsizes += 1
                self._epoch += 1
                self._transient_streak = 0
                self._watchdog_overdue = False
            self._switch(rung)
        self._rescale()
        return True

    def try_recover(self) -> bool:
        """The recovery probe: while degraded, re-validate the full shape
        and upsize back.  A ``DeviceFaultPlan`` draw models the probe (a
        still-faulty plan keeps the mesh down); with a ``probe_fn``
        (``serve/__main__.py`` wires a warmed-bucket full-mesh dispatch)
        the switch to the full rung happens first and a device-classified
        raise rolls it back.  With neither the upsize is unvalidated, and
        a one-time warning says so.  Holds the exclusive side of the shape
        gate across the switch, the probe and a rollback."""
        if not self.degraded:
            return False
        if self.fault_plan is not None:
            with self._lock:
                fault = self.fault_plan.next_fault()
            if fault is not None:
                with self._lock:
                    self._probe_failures += 1
                    self._consecutive_probe_failures += 1
                return False
        elif self.probe_fn is None:
            # test-and-set under the lock: two prober threads would
            # otherwise both warn
            with self._lock:
                warn = not self._warned_blind_upsize
                self._warned_blind_upsize = True
            if warn:
                logging.getLogger("lwc.torch.resilience").warning(
                    "mesh fault recovery has no probe_fn and no "
                    "DEVICE_FAULT_PLAN: upsizing to the full mesh without "
                    "validating it (a still-dead device faults the next "
                    "dispatch and downsizes again)")
        with self._shape_gate.exclusive():
            with self._lock:
                prev_index = self._rung_index
            self._switch(self._rungs[0])
            if self.probe_fn is not None:
                try:
                    self.probe_fn()
                except Exception as exc:
                    # roll back first either way: the manager still
                    # reports the surviving rung
                    self._switch(self._rungs[prev_index])
                    if classify_dispatch_error(exc) is None:
                        raise  # a probe bug, not a device fault
                    with self._lock:
                        self._probe_failures += 1
                        self._consecutive_probe_failures += 1
                    self._rescale()
                    return False
            with self._lock:
                self._rung_index = 0
                self._upsizes += 1
                self._epoch += 1
                self._faulted_devices.clear()
                self._consecutive_probe_failures = 0
                self._transient_streak = 0
                self._watchdog_overdue = False
        self._rescale()
        return True

    def probe_backoff_scale(self, cap: float = 32.0) -> float:
        """The prober's sleep multiplier: doubles per consecutive failed
        probe (capped), 1 after a successful upsize."""
        with self._lock:
            return float(min(2.0 ** self._consecutive_probe_failures, cap))

    # -- observability ---------------------------------------------------------------

    def snapshot(self) -> dict:
        """The ``meshfault`` /metrics section (the reference's keys)."""
        with self._lock:
            self.build_ladder()
            snap = {
                "current_shape": list(self.current_shape),
                "full_shape": list(self.full_shape),
                "sp": self.sp,
                "degraded": self.degraded,
                "epoch": self._epoch,
                "downsizes": self._downsizes,
                "upsizes": self._upsizes,
                "re_dispatches": self._re_dispatches,
                "probe_failures": self._probe_failures,
                "probe_backoff": self.probe_backoff_scale(),
                "faulted_devices": list(self._faulted_devices),
                "ladder": [[r.dp, r.tp] for r in self._rungs],
            }
            if self.fault_plan is not None:
                snap["fault_plan"] = self.fault_plan.snapshot()
        return snap
