"""The port's lock-model registry: every threading primitive it creates.

The port's own table, not a copy of the reference's
(``llm_weighted_consensus_tpu/analysis/concurrency_model.py``): the
reference runs its server on one asyncio loop, the port on threads — a
``ThreadingHTTPServer`` thread per request, the chat routes' loop thread,
the batcher's flusher, dispatch, waiter and tokenizer pools, and the
watchdog's and the memory governor's monitors.  ``CONCURRENCY_MODEL`` is
the declarative table the concurrency rules (LWC014–016,
``analysis/concurrency.py``) and the runtime ``LockWitness``
(``analysis/witness.py``, ``LOCK_WITNESS=1``) both consume.  It is
enforced BOTH ways:

* a ``threading.Lock``/``RLock``/``Condition`` created anywhere in the
  package — as a field, at module level, or in a function's local — that
  has no entry here fails LWC014 (unregistered lock);
* an entry whose creation site no longer exists fails LWC014 (stale
  registry row).

Per-lock entry fields (the reference's, plus ``held_as``):

``module``
    Path suffix of the file that creates the lock.
``kind``
    ``"lock"`` | ``"rlock"`` | ``"condition"``.
``guards``
    The instance fields this lock protects; LWC014 flags an access
    outside ``with <lock>`` once the field is reachable from >= 2 thread
    entry points.  Fields NOT listed are unguarded by design (notes
    below).
``acquire_via``
    Method names whose call inside a ``with`` acquires this lock
    indirectly (the shape gate's ``shared()``/``exclusive()`` and the
    manager's ``dispatch_guard()``).
``held_as``
    ``Class.attr`` fields holding a primitive another function created:
    ``GraphTable.lock`` holds the per-device launch lock, and ``guards``
    then names that class's fields.
``long_held``
    True where holding the lock across a device wait is the design, so
    LWC016 exempts it: the launch lock (held across a whole graph replay
    or eager enqueue, the copy-in and the copy-out's event record
    included: two dispatches of one bucket share its static tensors) and
    the shape gate (its shared side is held by a dispatch while it stages
    and enqueues; its condition only for bookkeeping instants).

Keys: ``Class.attr`` for a field; ``<function qualname>.<local>`` for a
primitive a function creates (``launch_lock.lock``: one ``RLock`` per
device, made lazily and kept in the module's ``_locks`` dict;
``DeviceBatcher._submit_embed_cached.lock``: the per-call combine lock
its row callbacks share); ``<file stem>.<name>`` for a module-level one.

``order`` declares the static acquisition-order DAG (LWC015 holds it
both ways and fails on any cycle); ``order_runtime`` the edges only the
witness sees, each with its reason.

Unguarded-by-design notes (fields deliberately absent from ``guards``):

* ``DeviceBatcher._use_fallback`` — a benign monotonic bool flag read by
  the dispatch hot path (``use_fallback`` writes it under ``_cond``); a
  torn read costs one card dispatch that fails over, never corruption.
* ``DeviceBatcher`` construction-time config (``max_batch``,
  ``window_ms``, ``packing``, ``max_queue_depth``, ...), the pools and
  ``embedder``/``fallback_embedder``/``meshfault`` — set in ``__init__``
  before the flusher starts.
* ``StagingPool.per_bucket`` / ``pin`` — construction-time capacity
  config; the embedder sizes the pool before the first dispatch thread
  starts.
* ``MeshFaultManager._rungs`` — built once (idempotent ``build_ladder``
  at serve-build time) and never appended to afterwards.
* ``MeshFaultManager.rescale_hooks`` / ``probe_fn`` / ``fault_plan`` —
  wired at serve-build time before any dispatch thread exists.
* ``DeviceWatchdog._thread`` / ``_stop`` and ``MemGuard._thread`` /
  ``_stop`` — monitor-thread lifecycle, mutated only by ``start``/
  ``stop`` on the owning side.
* ``MemGuard._caches`` / ``_sinks`` / ``_admission`` — wired by
  ``govern`` before ``start``.
* ``Lifecycle.state`` / ``_drain`` — the lock serializes the state
  transitions (``mark_ready``, ``begin_drain``, ``drain``); readiness
  and the snapshot read ``state`` bare (one reference read: a stale
  state costs one ``/readyz`` answer), and ``_drain`` is set under the
  lock before the drain thread that reads it starts.
"""

CONCURRENCY_MODEL = {
    "locks": {
        # -- the device path ---------------------------------------------
        "launch_lock.lock": {
            "module": "llm_weighted_consensus_tpu_torch/models/graphs.py",
            "kind": "rlock",
            "held_as": ("GraphTable.lock",),
            "guards": (
                "_entries",
                "_pool",
                "captures",
                "replays",
                "eager_dispatches",
                "pool_bytes",
            ),
            "long_held": True,
        },
        "graphs._locks_guard": {
            "module": "llm_weighted_consensus_tpu_torch/models/graphs.py",
            "kind": "lock",
        },
        "StagingPool._lock": {
            "module":
                "llm_weighted_consensus_tpu_torch/models/dispatch_seam.py",
            "kind": "lock",
            "guards": ("_free", "_retained", "hits", "misses"),
        },
        "DebertaModel._rel_lock": {
            "module": "llm_weighted_consensus_tpu_torch/models/deberta.py",
            "kind": "lock",
            "guards": ("_rel_cache",),
        },
        "launches._lock": {
            "module": "llm_weighted_consensus_tpu_torch/ops/launches.py",
            "kind": "lock",
        },
        "_build._lock": {
            "module": "llm_weighted_consensus_tpu_torch/ops/_build.py",
            "kind": "lock",
        },
        "native._lock": {
            "module": "llm_weighted_consensus_tpu_torch/utils/native.py",
            "kind": "lock",
        },
        # -- the batcher -------------------------------------------------
        "DeviceBatcher._cond": {
            "module": "llm_weighted_consensus_tpu_torch/serve/batcher.py",
            "kind": "condition",
            "guards": (
                "_pending",
                "_pending_offline",
                "_inflight",
                "_closed",
                "_ewma_ms",
                "shed_queue_full",
                "shed_deadline",
                "shed_redispatch_limit",
                "cancelled_items",
                "fallback_dispatches",
                "_busy",
                "_dispatches",
                "_items",
                "_lane_dispatches",
                "_lane_items",
                "_lane_busy",
                "_kind_dispatches",
                "_requests",
                "_largest_group",
                "_stream_dispatches",
                "_stream_requests",
                "_stream_largest_group",
                "_packed_dispatches",
                "_pack_real_tokens",
                "_pack_slot_tokens",
                "_pad_real_tokens",
                "_pad_slot_tokens",
                "_dedup_hits",
                "_dedup_tokens_saved",
                "_fallback_items",
                "_occupancy",
                "_call_shapes",
            ),
        },
        "DeviceBatcher._embed_lock": {
            "module": "llm_weighted_consensus_tpu_torch/serve/batcher.py",
            "kind": "lock",
            "guards": ("_embed_inflight", "_embed_collapses"),
        },
        "DeviceBatcher._submit_embed_cached.lock": {
            "module": "llm_weighted_consensus_tpu_torch/serve/batcher.py",
            "kind": "lock",
        },
        # -- device faults -----------------------------------------------
        "_ShapeGate._cond": {
            "module":
                "llm_weighted_consensus_tpu_torch/resilience/meshfault.py",
            "kind": "condition",
            "guards": ("_readers", "_writer", "_writers_waiting"),
            "acquire_via": ("shared", "exclusive", "dispatch_guard"),
            "long_held": True,
        },
        "MeshFaultManager._lock": {
            "module":
                "llm_weighted_consensus_tpu_torch/resilience/meshfault.py",
            "kind": "rlock",
            "guards": (
                "_rung_index",
                "_epoch",
                "_downsizes",
                "_upsizes",
                "_re_dispatches",
                "_probe_failures",
                "_consecutive_probe_failures",
                "_transient_streak",
                "_watchdog_overdue",
                "_faulted_devices",
                "_warned_blind_upsize",
            ),
        },
        "DeviceWatchdog._lock": {
            "module":
                "llm_weighted_consensus_tpu_torch/resilience/watchdog.py",
            "kind": "lock",
            "guards": (
                "_active",
                "_seq",
                "_healthy",
                "trips",
                "recoveries",
                "dispatches",
                "_last_overdue_ms",
                "_last_label",
            ),
        },
        # -- admission, memory, lifecycle ---------------------------------
        "AdmissionController._lock": {
            "module":
                "llm_weighted_consensus_tpu_torch/resilience/admission.py",
            "kind": "lock",
            "guards": (
                "inflight",
                "admitted",
                "limit",
                "_shed",
                "_baseline_ms",
                "_last_decrease",
            ),
        },
        "MemGuard._lock": {
            "module":
                "llm_weighted_consensus_tpu_torch/resilience/memguard.py",
            "kind": "lock",
            "guards": (
                "_level",
                "last_rss",
                "peak_rss",
                "soft_trips",
                "hard_trips",
                "recoveries",
            ),
        },
        "Lifecycle._lock": {
            "module": "llm_weighted_consensus_tpu_torch/serve/lifecycle.py",
            "kind": "lock",
        },
        # -- observability -----------------------------------------------
        "Metrics._lock": {
            "module": "llm_weighted_consensus_tpu_torch/serve/metrics.py",
            "kind": "lock",
            "guards": ("_series_store",),
        },
        "PhaseAggregator._lock": {
            "module": "llm_weighted_consensus_tpu_torch/obs/phases.py",
            "kind": "lock",
            "guards": ("_phases", "_device", "_intervals"),
        },
        "QualityAggregator._lock": {
            "module": "llm_weighted_consensus_tpu_torch/obs/quality.py",
            "kind": "lock",
            "guards": (
                "_judges",
                "_pairs",
                "_margin",
                "_outcomes",
                "_requests",
                "_exemplar",
                "window",
                "drift_threshold",
            ),
        },
        "TraceSink._lock": {
            "module": "llm_weighted_consensus_tpu_torch/obs/sink.py",
            "kind": "lock",
            "guards": (
                "_ring",
                "_disk_errors",
                "kept",
                "dropped",
                "forced",
                "capacity",
            ),
        },
        "OutcomeLedger._lock": {
            "module": "llm_weighted_consensus_tpu_torch/obs/ledger.py",
            "kind": "lock",
            "guards": (
                "_ring",
                "_disk_errors",
                "_active_bytes",
                "_rotate_seq",
                "kept",
                "rotations",
                "capacity",
            ),
        },
        "ProfileRoutes._lock": {
            "module": "llm_weighted_consensus_tpu_torch/serve/profiling.py",
            "kind": "lock",
            "guards": ("_active", "_prof"),
        },
        # -- weights, the offline lane, the fake provider ------------------
        "LiveWeightStore._lock": {
            "module": "llm_weighted_consensus_tpu_torch/weights/live.py",
            "kind": "lock",
            "guards": (
                "_active",
                "_shadow",
                "swaps",
                "applied",
                "shadow_compared",
                "shadow_confidence_delta_sum",
                "shadow_would_flip",
            ),
        },
        "OfflineRescore._lock": {
            "module": "llm_weighted_consensus_tpu_torch/serve/gateway.py",
            "kind": "lock",
        },
        "ChoiceIndexer._lock": {
            "module": "llm_weighted_consensus_tpu_torch/utils/__init__.py",
            "kind": "lock",
            "guards": ("_counter", "_indices"),
        },
        "_Server.lock": {
            "module":
                "llm_weighted_consensus_tpu_torch/serve/fake_upstream.py",
            "kind": "lock",
        },
        # -- the benches -----------------------------------------------
        # bench/host.py --witness-overhead's bare lock, the baseline its
        # wrapped twin is timed against (one thread, never shared)
        "witness_overhead_record.raw": {
            "module": "llm_weighted_consensus_tpu_torch/bench/host.py",
            "kind": "lock",
        },
        # -- the witness itself -----------------------------------------
        "LockWitness._mu": {
            "module": "llm_weighted_consensus_tpu_torch/analysis/witness.py",
            "kind": "lock",
            "guards": ("_edges", "_violations", "_acquisitions", "_counts"),
        },
    },
    # static acquisition-order DAG: "u before v" — LWC015 enforces these
    # both ways against the with/acquire graph and fails on any cycle
    "order": (
        # a dispatch's replay (or eager forward) runs under the launch
        # lock, and the kernel wrappers count their launches
        # (ops/launches.py) inside it
        ("launch_lock.lock", "launches._lock"),
        # on the card a dispatch takes its pinned copy-out buffer from
        # the staging pool under the launch lock
        ("launch_lock.lock", "StagingPool._lock"),
        # downsize holds the gate's exclusive side, then takes the manager
        # lock for the rung/epoch bookkeeping
        ("_ShapeGate._cond", "MeshFaultManager._lock"),
        # the flusher sheds a group's late items under the batcher's
        # condition and counts each shed in the metrics series
        ("DeviceBatcher._cond", "Metrics._lock"),
        # the dispatch thread holds the gate's shared side while it
        # stages and enqueues a group: the batcher's counters, the
        # staging pool, the launch lock (and the launch counters inside
        # it), and the packed path's plan-time phase and metrics
        # observations all nest inside it
        ("_ShapeGate._cond", "DeviceBatcher._cond"),
        ("_ShapeGate._cond", "StagingPool._lock"),
        ("_ShapeGate._cond", "launch_lock.lock"),
        ("_ShapeGate._cond", "launches._lock"),
        ("_ShapeGate._cond", "PhaseAggregator._lock"),
        ("_ShapeGate._cond", "Metrics._lock"),
        # a phase observation and a consensus outcome are mirrored into
        # the metrics series while the aggregator's lock is held
        ("PhaseAggregator._lock", "Metrics._lock"),
        ("QualityAggregator._lock", "Metrics._lock"),
        # the embed cache's stats are read under the join-table lock;
        # ``.stats()`` resolves statically to every ``stats`` method, so
        # these three edges are the over-approximation of a call into
        # EmbeddingCache.stats, which takes none of them
        ("DeviceBatcher._embed_lock", "DeviceBatcher._cond"),
        ("DeviceBatcher._embed_lock", "StagingPool._lock"),
        ("DeviceBatcher._embed_lock", "launch_lock.lock"),
    ),
    # edges only real interleavings exercise (the static call graph
    # cannot resolve these paths); validated by the LockWitness
    "order_runtime": (
        # admission asks its gates, callables wired at serve-build time
        # (the watchdog's health, the memory governor's level), while it
        # holds its own lock: the static graph cannot resolve a field
        # called as a function
        ("AdmissionController._lock", "DeviceWatchdog._lock",
         "device_gate is DeviceWatchdog.healthy, called under the "
         "admission lock"),
        ("AdmissionController._lock", "MemGuard._lock",
         "mem_gate is MemGuard's level check, called under the admission "
         "lock"),
    ),
}
