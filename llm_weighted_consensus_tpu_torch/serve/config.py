"""The serving knobs, read from the environment.

Counterpart of the batching, warmup, overload and timing knobs of
``llm_weighted_consensus_tpu/serve/config.py``, with its defaults,
clamps and error messages (``_parse_warmup``, ``_parse_warmup_r``):

* ``BATCH_WINDOW_MS`` — the batcher's accumulation window: a lone
  request waits this long for company (``0``: no idle wait; work still
  batches behind an in-flight dispatch).  Default 3;
* ``BATCH_MAX`` — items per padded dispatch.  Default 64;
* ``BATCH_PIPELINE`` — dispatches in flight at once (staging of group
  k+1 overlaps group k on the card).  Default 2, min 1;
* ``BATCH_MAX_ROWS`` — encoder rows per padded dispatch.  Default 512,
  min 1;
* ``HOST_TOKENIZER_WORKERS`` — host threads tokenizing (and packing)
  each item when it is submitted; ``0`` tokenizes on the dispatch
  thread.  Default 2;
* ``STAGING_BUFFERS`` — pinned host staging buffers kept per bucket by
  the embedder and by the reward model (``0``: no reuse).  Default 2;
* ``WARMUP`` — consensus shapes to capture CUDA graphs for at startup,
  ``NxS`` pairs (``64x128,16x512``); each warms the single-request and
  the embed forward of that shape, and with ``PACKING_ENABLED`` the
  packed buckets (every power-of-two row count up to
  ``PACKING_MAX_ROWS`` at full row width, one row at each narrower width).
  ``/readyz`` answers 503 until warmup has finished;
* ``WARMUP_R`` — request counts whose grouped forward is also captured
  per ``WARMUP`` shape (``8``), snapped to powers of two;
* ``RM_WARMUP`` — the reward model's ``NxS`` buckets to capture
  (``16x128``);
* ``ADMISSION_MAX_INFLIGHT`` — the hard cap on admitted requests (503
  past it; ``0``: no shedding).  Default 0;
* ``ADMISSION_MAX_QUEUE_DEPTH`` — the batcher's queue bound (503 past
  it; ``0``: unbounded).  Default 0;
* ``ADMISSION_ADAPTIVE`` — an AIMD limit under ``ADMISSION_MAX_INFLIGHT``
  (which must then be > 0) that shrinks while latency runs past
  ``ADMISSION_LATENCY_FACTOR`` (> 1, default 2) times its baseline and
  grows back while healthy, never below ``ADMISSION_MIN_LIMIT`` (default
  2, min 1).  Default 0;
* ``ADMISSION_RETRY_AFTER_MILLIS`` — the ``Retry-After`` hint of a shed.
  Default 1000;
* ``DRAIN_TIMEOUT_MILLIS`` — the SIGTERM/SIGINT drain budget.  Default
  10000;
* ``DEVICE_WATCHDOG_MILLIS`` — a dispatch past this marks the device
  unhealthy (``/readyz`` 503, device routes shed) until it completes;
  ``0`` disables the watchdog.  Default 0;
* ``DEVICE_WATCHDOG_INTERVAL_MILLIS`` — the watchdog's check period
  (``0``: a quarter of ``DEVICE_WATCHDOG_MILLIS``, at least 10).
  Default 0;
* ``DEVICE_WATCHDOG_CPU_FALLBACK`` — ``1`` builds a CPU twin of the
  embedder at startup (the same weights in f32, unquantized) and routes
  every dispatch to it while the watchdog holds the card unhealthy, or,
  under ``MESH_FAULT_ENABLED``, once a persistent fault has spent the
  ladder: degraded but alive beats shedding.  Needs
  ``DEVICE_WATCHDOG_MILLIS`` > 0, and with ``MESH_ENABLED`` also
  ``MESH_FAULT_ENABLED`` (the twin is the last resort after the
  ladder).  Default 0;
* ``LOCK_WITNESS`` — ``1`` turns on the runtime lockdep witness
  (``analysis/witness.py``): ``build_server`` wraps the registered
  threading primitives a served request reaches (the launch lock, the
  batcher's condition, the shape gate and the manager lock, the staging
  pool, the watchdog, the aggregators, the trace sink, the ledger, the
  live weights, the memory governor, ...) so every acquisition's order
  is checked against ``analysis/concurrency_model.py``; the snapshot
  rides ``/metrics`` as ``lock_witness`` and the drain prints its
  summary line.  Default 0: nothing is wrapped;
* ``PROFILE_DIR`` — turns on ``POST /profile/start``, ``POST
  /profile/stop`` and the one-shot ``POST /v1/profile {"duration_ms"}``
  (default 500, clamped to [10, 10000]): ``torch.profiler`` captures of
  the CPU and the card, written as Chrome-trace JSON under this
  directory.  Unset, ``/v1/profile`` answers 403;
* ``METRICS_DEVICE_TIMING`` — per-bucket device time from CUDA events
  and the overlap gauge (``0`` skips the recording).  Default 1;
* ``MAX_BODY_BYTES`` — the request-body cap of every route: a body of
  this many bytes or more is refused with ``413 {"code": 413,
  "message": {"kind": "payload_too_large"}}``, as the reference's
  aiohttp cap does.  Default 1048576 (1 MiB); ``0`` keeps that default;
* ``ADDRESS`` / ``PORT`` — where the server listens (``--address`` and
  ``--port`` override them).  Default ``0.0.0.0:5000``.

Device fault domains (``resilience/meshfault.py``), the reference's
knobs, defaults and refusals:

* ``MESH_ENABLED`` — the first-class serving mesh.  The port serves one
  card, so it takes the one-device shape ``1x1`` (the reference's
  "``MESH_SHAPE`` unset = every local device on dp" on a one-card host),
  and its device labels carry ``@dp1xtp1``.  Default 0;
* ``MESH_SHAPE`` — ``DPxTP`` or ``DPxTPxSP`` (needs ``MESH_ENABLED``);
  a shape spanning more than one device is refused: that is the
  multi-device slice (ROADMAP queue 1, item 9);
* ``MESH_DP`` / ``MESH_TP`` / ``MESH_SP`` (the legacy hooks) and
  ``LONG_CONTEXT_WARMUP`` (ring buckets) — read and refused past one
  card, for the same reason (``MESH_TP=1`` is accepted);
* ``MESH_FAULT_ENABLED`` — classify dispatch failures (transient /
  persistent / an application error), retry a transient one on the same
  shape and escalate a streak to persistent; a persistent fault with the
  one-rung ladder spent switches to the CPU twin when there is one, else
  fails its group.  Needs ``MESH_ENABLED``.  The ``meshfault`` /metrics
  section counts it.  Default 0;
* ``MESH_FAULT_TRANSIENT_RETRIES`` — consecutive transient faults retried
  before the streak escalates.  Default 2;
* ``MESH_FAULT_PROBE_MILLIS`` — the recovery prober's period (0 = none;
  on one card there is no smaller shape to recover from).  Default 0;
* ``DEVICE_FAULT_PLAN`` — deterministic device-fault injection at the
  batcher's dispatch seam, e.g. ``seed=42,persistent=0.05`` or
  ``script=ok|transient|hang|ok,hang_ms=50`` (kinds ``transient``,
  ``persistent``, ``hang``).  Needs ``MESH_FAULT_ENABLED``.  Drills only.

``python -m llm_weighted_consensus_tpu_torch.serve`` first loads a
``.env`` file from the working directory into the environment
(``load_dotenv``; variables already set win).

The upstream knobs of ``/chat/completions`` and ``/multichat/completions``
(the reference's, with its defaults; ``upstream_options``):

* ``OPENAI_APIS`` — a JSON list of ``{"api_base", "api_key"}``
  endpoints, tried in order; else ``OPENAI_API_BASE`` with
  ``OPENAI_API_KEY`` (both set) is the one endpoint.  None configured:
  the chat routes answer the client's 500 ``no api endpoints to
  attempt`` (``--fake-upstream`` supplies a loopback one);
* ``OPENAI_USER_AGENT``, ``OPENAI_X_TITLE``, ``OPENAI_REFERER`` — sent
  upstream as ``user-agent``, ``x-title`` and ``referer`` +
  ``http-referer``;
* ``FIRST_CHUNK_TIMEOUT_MILLIS`` (10000) and ``OTHER_CHUNK_TIMEOUT_MILLIS``
  (60000) — the two-tier stream timeouts;
* ``BACKOFF_INITIAL_INTERVAL_MILLIS`` (100), ``BACKOFF_RANDOMIZATION_FACTOR``
  (0.5), ``BACKOFF_MULTIPLIER`` (1.5), ``BACKOFF_MAX_INTERVAL_MILLIS``
  (1000), ``BACKOFF_MAX_ELAPSED_TIME_MILLIS`` (40000) — the retry backoff
  over the attempt matrix;
* ``CONNECT_TIMEOUT_MILLIS`` — TCP connect timeout of the upstream
  transport.  Default 30000;
* ``JUDGE_STREAM_MAX_BYTES`` — cumulative byte budget of one upstream
  stream, also the cap of a non-200 body read.  Default 33554432
  (32 MiB); ``0`` = uncapped;
* ``SSE_MAX_EVENT_BYTES`` — byte cap on one SSE event's ``data:`` payload
  and on the parser's newline-less residue.  Default 4194304 (4 MiB);
  ``0`` = uncapped;
* ``FAKE_UPSTREAM_DELAY_MS`` — with ``--fake-upstream``, a sleep before
  the scripted provider's first frame (read per request).

The score route's knobs (``/score/completions``), with the reference's
names and defaults:

* ``TABLES_PATH`` — ``.npz`` snapshot of the judges' training tables
  (``weights/training_table.py``, the reference's layout): loaded at
  startup when present, probed for writability at startup, saved when
  the server closes;
* ``HOST_FASTPATH`` — fold the tally on scaled-int64 vectors
  (``clients/tally.py``) with the Decimal fold as the authority; the
  bytes are the same either way.  Default ``0``;
* ``SCORE_CACHE_TTL`` — seconds a cached consensus result stays
  servable; ``0`` (the default) disables the result cache.  When > 0,
  identical score requests within the TTL replay the recorded frames,
  and identical concurrent requests collapse onto one judge fan-out
  (``"cache_bypass": true`` opts a request out);
* ``SCORE_CACHE_MAX_BYTES`` — byte budget of the score result LRU.
  Default 67108864 (64 MiB);
* ``SCORE_CACHE_DIR`` — append-only JSONL disk tier of the score cache;
  unset = memory only;
* ``SCORE_CACHE_EMBED`` — also memoize embedding rows per (model,
  truncation window, text) in the batcher.  Defaults on whenever
  ``SCORE_CACHE_TTL`` > 0; ``0`` disables;
* ``SCORE_CACHE_EMBED_MAX_BYTES`` — byte budget of the embedding row
  cache.  Default 33554432 (32 MiB).

The caches' counters are the ``score_cache`` and ``embed_cache`` sections
of ``GET /metrics``.

The completions archive (``archive/``), with the reference's names and
defaults:

* ``ARCHIVE_PATH`` — JSON snapshot of the archive: loaded at startup when
  the file exists (written there at once when it does not: the path must
  be writable), saved when the server closes.  Unset = in memory only;
* ``ARCHIVE_WRITE`` — archive every unary completion the server answers
  (a score completion with its judges' ballots and its request), so its
  id can be referenced by later requests, ``POST /archive/rescore`` can
  re-tally it and ``POST /weights/learn`` learn from it.  Defaults on
  when ``ARCHIVE_PATH`` is set;
* ``ARCHIVE_STREAMING`` — with ``ARCHIVE_WRITE``, also archive streamed
  completions: each stream is folded as it is served and archived at its
  clean end (an abandoned or failed stream archives nothing).  Default 0;
* ``ARCHIVE_MAX_COMPLETIONS`` — FIFO cap of each archive table (a score
  completion leaves with its ballots and request).  Default 65536; ``0``
  = unbounded.

Tracing (``obs/``; all opt-in — with every ``TRACE_*`` knob unset no root
span is ever created and the hot path pays one contextvar read), the
reference's knobs and defaults:

* ``TRACE_SAMPLE_RATE`` — head-based sampling probability in [0, 1]:
  the gateway flips this coin once per request at the door.  Shed,
  errored (5xx) and all-judges-failed requests are ALWAYS captured once
  tracing is enabled, whatever the rate.  ``> 0`` enables tracing;
* ``TRACE_ENABLED`` — ``1`` enables tracing even at rate 0 (capture only
  the forced traces — the cheapest useful setting);
* ``TRACE_RING`` — completed traces kept in memory for ``GET
  /v1/traces`` (index, newest first) and ``GET /v1/traces/{trace_id}``
  (the span tree); oldest evicted first.  Default 256;
* ``TRACE_DIR`` — JSONL disk tier: one JSON line per kept trace appended
  to ``traces-<pid>.jsonl`` under this directory (setting it also
  enables tracing).

A traced response carries ``x-trace-id``; a caller's ``traceparent`` is
adopted (its trace id, its span as the root's parent) and every upstream
judge call carries the request's.  The ``traces`` section of ``/metrics``
counts kept, forced and dropped traces.

Consensus quality and the outcome ledger (``obs/quality.py``,
``obs/ledger.py``; the scorecards are always on, like the phase
histograms, and ``GET /v1/judges`` / ``/v1/judges/{id}`` serve them):

* ``QUALITY_WINDOW`` — ballots in each judge's sliding drift window; a
  judge is flagged only once both the window and its pre-window baseline
  hold a full window.  Default 64;
* ``QUALITY_DRIFT_THRESHOLD`` — how far a judge's windowed agreement
  rate or vote mass on the winner may fall below its baseline before it
  is flagged, an absolute rate drop in (0, 1].  Default 0.25;
* ``LEDGER_RING`` — outcome records kept in memory (one per scored
  request: panel id, per-judge votes and weights, the confidence vector,
  the degraded verdict, the trace id).  ``0`` (the default) disables the
  ledger unless ``LEDGER_DIR`` is set (which implies a ring of 256);
* ``LEDGER_DIR`` — append-only JSONL disk tier of the ledger,
  ``ledger-<pid>.jsonl`` (setting it also enables the ledger);
* ``LEDGER_ROTATE_BYTES`` — seal the active ledger file under a
  timestamped name (``ledger-<pid>-<ts>-<seq>.jsonl``) once it reaches
  this size; ``0`` (the default) keeps one growing file.

Live weights and the offline lane (``weights/live.py``, ``train/``):

* ``WEIGHTS_ENABLED`` — arm the versioned live weight store and the
  ``GET/PUT /v1/weights`` hot-swap endpoints; per-judge overrides apply
  to every tally, the applied version is stamped on each
  ``consensus:tally`` span and ledger record, and a staged shadow table
  feeds the would-have-flipped counters.  Default off (the routes then
  answer 403);
* ``WEIGHTS_PATH`` — persist the live weight tables as JSON
  (``lwc.weights.v1``) so a hot-swapped table survives a restart;
  setting it implies ``WEIGHTS_ENABLED``;
* ``OFFLINE_ENABLED`` — expose ``POST /v1/train/rescore``: a drive of
  the batcher's offline priority class (synthetic candidate groups
  re-scored whenever the latency lane has no ready group).  Default off
  (403); the offline class itself always exists in the batcher;
* ``OFFLINE_INFLIGHT`` — candidate groups the offline feeder keeps in
  flight (its only backpressure: offline items skip the queue-depth
  shed).  Default 4, and at least 1 when ``OFFLINE_ENABLED``.

Judge-side resilience (``resilience/``; all opt-in — with every knob
unset ``resilience_policy()`` is None and the wire bytes are the
pre-resilience ones), the reference's knobs and defaults:

* ``RESILIENCE_BREAKER_THRESHOLD`` — failure rate in (0, 1] that opens
  a per-upstream circuit breaker (keyed ``api_base|model``).  ``0`` (the
  default) disables breakers entirely;
* ``RESILIENCE_BREAKER_WINDOW`` / ``RESILIENCE_BREAKER_MIN_SAMPLES`` /
  ``RESILIENCE_BREAKER_COOLDOWN_MILLIS`` — sliding-window size, the
  volume threshold before the rate is meaningful, and how long an open
  breaker refuses before half-open probing.  Defaults 20 / 5 / 5000;
* ``RESILIENCE_RETRY_BUDGET`` — retries one score request's judge
  fan-out may spend collectively (token bucket; a hedge spends one too).
  ``0`` = unlimited (no budget);
* ``RESILIENCE_HEDGE_MILLIS`` — static hedge delay: an attempt with no
  first chunk after this long races a backup against the next endpoint
  (the loser is cancelled).  ``0`` = no hedging;
* ``RESILIENCE_HEDGE_QUANTILE`` — hedge at an observed first-chunk
  latency quantile (e.g. ``0.95``) once enough samples exist, falling
  back to ``RESILIENCE_HEDGE_MILLIS`` before that; a quantile in [0, 1).
  ``0`` = static only;
* ``RESILIENCE_DEADLINE_MILLIS`` — default per-request deadline the
  gateway stamps on a request without ``x-deadline-ms``; it flows
  through the fan-out so timeouts, backoff sleeps and hedges respect
  the remaining budget.  ``0`` = none;
* ``RESILIENCE_QUORUM`` — fraction in [0, 1] of the panel's weight that
  must settle before the quorum early exit may cancel stragglers whose
  votes cannot flip the argmax; the final frame ships with ``degraded:
  true`` (and is never cached).  ``0`` = always wait for the full panel;
* ``FAULT_PLAN`` — fault injection at the transport seam, e.g.
  ``seed=42,connect=0.1,5xx=0.1,stall_first=0.1,stall_ms=200``
  (``resilience/faults.py``; the hostile-ingest kinds size their
  payloads with ``flood_bytes``, default 8 MiB).  Never set in
  production;
* ``JUDGE_BIAS_PLAN`` — deterministic per-judge vote perturbation at the
  extraction seam, e.g. ``judge=2,after=16,flip=1.0,seed=7`` with kinds
  ``flip`` / ``uniform`` / ``invert``.  Drills only.

The memory governor (``resilience/memguard.py``, on by default as in the
reference):

* ``MEMGUARD`` — ``1`` (default) samples the process RSS each
  ``MEMGUARD_INTERVAL_MILLIS`` against two watermarks: soft pressure
  halves the cache byte budgets, the trace ring and the AIMD admission
  limit (restored on recovery); hard pressure sheds every new POST with
  ``503 shed_reason: memory`` and flags ``degraded_mem`` on ``/readyz``
  (still 200).  Recovery is hysteretic.  ``0`` disables;
* ``MEM_SOFT_BYTES`` / ``MEM_HARD_BYTES`` — the watermarks; ``0`` (the
  default) = auto at 80% / 90% of ``/proc/meminfo`` MemTotal (the
  governor turns itself off when MemTotal is unreadable).  The RSS is
  the host process's (pinned staging buffers and the CUDA context count,
  the card's memory does not);
* ``MEMGUARD_INTERVAL_MILLIS`` — the sampling period.  Default 1000.

The ``resilience`` and ``memguard`` sections of ``GET /metrics`` show
the counters, breaker states and the governor's level.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

from ..utils import env_truthy


def _non_negative_int(env: dict, name: str, default: int) -> int:
    value = int(env.get(name, default))
    if value < 0:
        raise ValueError(f"{name}={value} must be >= 0 (0 = unbounded)")
    return value


def load_dotenv(path: str = ".env") -> None:
    """Load ``KEY=value`` lines of ``path`` into ``os.environ`` (the
    reference's reader: ``#`` comments, ``export`` prefixes, quoted
    values, inline `` #`` comments on unquoted ones); variables already
    set win.  No file, no change."""
    if not os.path.exists(path):
        return
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            if line.startswith("export "):
                line = line[len("export "):]
            key, _, value = line.partition("=")
            value = value.strip()
            if len(value) >= 2 and value[0] == value[-1] and value[0] in "'\"":
                value = value[1:-1]
            elif " #" in value:
                value = value.split(" #", 1)[0].rstrip()
            os.environ.setdefault(key.strip(), value)


def process_env() -> dict:
    """A copy of the process environment: the one read of it that the
    entry points (``serve``, ``train rescore``) hand to
    ``ServeConfig.from_env`` and to the model builders."""
    return dict(os.environ)


def staging_buffers(env: dict) -> int:
    """``STAGING_BUFFERS``: the models' pinned staging buffers per
    bucket (``build_embedder`` and ``build_reranker`` size both pools)."""
    return _non_negative_int(env, "STAGING_BUFFERS", 2)


def _parse_warmup(raw, var: str = "WARMUP") -> list:
    """"64x112,64x128" -> [(64, 112), (64, 128)].  Raises on malformed
    specs: a silently dropped warmup defeats its purpose."""
    if not raw:
        return []
    from .gateway import MAX_CONSENSUS_CANDIDATES

    out = []
    for part in str(raw).split(","):
        part = part.strip()
        if not part:
            continue
        try:
            n_s = part.split("x")
            n, s = int(n_s[0]), int(n_s[1])
            if (
                len(n_s) != 2
                or not 2 <= n <= MAX_CONSENSUS_CANDIDATES
                or s < 1
            ):
                raise ValueError
        except (ValueError, IndexError):
            raise ValueError(
                f"{var} spec {part!r}: expected NxS with 2 <= N <= "
                f"{MAX_CONSENSUS_CANDIDATES} candidates (the /consensus "
                "request ceiling — warming an unreachable shape burns "
                "startup time for nothing) and S >= 1 tokens (e.g. 64x112)"
            ) from None
        out.append((n, s))
    return out


def _parse_warmup_r(raw) -> list:
    """"2,4" -> [2, 4], snapped to the runtime's power-of-two R buckets
    and deduped ("3" warms the same bucket as "4").  Raises on malformed
    or non-positive values."""
    if not raw:
        return []
    buckets = []
    for part in str(raw).split(","):
        part = part.strip()
        if not part:
            continue
        try:
            r = int(part)
            if r < 1:
                raise ValueError
        except ValueError:
            raise ValueError(
                f"WARMUP_R value {part!r}: expected a positive integer "
                "concurrency bucket (e.g. 2)"
            ) from None
        from ..models.embedder import next_pow2

        bucket = next_pow2(r)
        if bucket not in buckets:
            buckets.append(bucket)
    return buckets


def _parse_long_context_warmup(raw) -> list:
    """"4x4096,1x8192" -> [(4, 4096), (1, 8192)], the reference's
    parser; raises on malformed specs."""
    if not raw:
        return []
    out = []
    for part in str(raw).split(","):
        part = part.strip()
        if not part:
            continue
        try:
            n_s = part.split("x")
            n, s = int(n_s[0]), int(n_s[1])
            if len(n_s) != 2 or n < 1 or s < 1:
                raise ValueError
        except (ValueError, IndexError):
            raise ValueError(
                f"LONG_CONTEXT_WARMUP spec {part!r}: expected NxS with "
                "N >= 1 candidates and S >= 1 tokens (e.g. 4x4096)"
            ) from None
        out.append((n, s))
    return out


def _parse_mesh_shape(raw) -> Optional[tuple]:
    """"4x2" -> (4, 2); "2x2x2" -> (2, 2, 2), the reference's parser:
    raises on malformed values, and an sp axis of 1 is the 2-axis
    shape."""
    if not raw:
        return None
    try:
        parts = [int(p) for p in str(raw).strip().split("x")]
        if len(parts) not in (2, 3) or any(p < 1 for p in parts):
            raise ValueError
    except (ValueError, IndexError):
        raise ValueError(
            f"MESH_SHAPE {raw!r}: expected DPxTP or DPxTPxSP with "
            "positive axes (e.g. 4x2 = batches split 4-way, encoder "
            "params 2-way; 2x2x2 adds 2-way sequence parallelism for "
            "long-context serving)"
        ) from None
    if len(parts) == 3 and parts[2] == 1:
        parts = parts[:2]
    return tuple(parts)


# the one-card refusals' common tail (the port's divergence from the
# reference until its multi-device slice)
ONE_CARD = (
    "the port serves one card; meshes past one device, the legacy "
    "MESH_DP/MESH_TP/MESH_SP hooks and ring buckets wait for its "
    "multi-device slice (ROADMAP queue 1, item 9)"
)


def packing_options(env) -> dict:
    """The batcher's packing keyword arguments, with the reference's
    defaults and clamps."""
    return {
        "packing": env_truthy(env.get("PACKING_ENABLED", "0")),
        "packing_row_tokens": max(16, int(env.get("PACKING_ROW_TOKENS", 512))),
        "packing_max_rows": max(1, int(env.get("PACKING_MAX_ROWS", 8))),
        "packing_max_segments": max(
            1, int(env.get("PACKING_MAX_SEGMENTS", 64))
        ),
        "prefix_dedup": env_truthy(env.get("PREFIX_DEDUP", "1")),
        "prefix_dedup_min_chars": max(
            1, int(env.get("PREFIX_DEDUP_MIN_CHARS", 48))
        ),
    }


def upstream_options(env) -> dict:
    """The chat client's settings from the upstream knobs (see module
    doc): ``api_bases`` (a list of ``{"api_base", "api_key"}``), then
    ``DefaultChatClient``'s keyword arguments, with ``backoff`` as
    ``BackoffPolicy``'s."""
    from ..utils import jsonutil

    def get_f(name, default):
        return float(env.get(name, default))

    apis_json = env.get("OPENAI_APIS")
    if apis_json:
        apis = jsonutil.loads(apis_json)
    else:
        base, key = env.get("OPENAI_API_BASE"), env.get("OPENAI_API_KEY")
        apis = [{"api_base": base, "api_key": key}] if base and key else []
    return {
        "api_bases": apis,
        "backoff": {
            "initial_interval_ms": get_f("BACKOFF_INITIAL_INTERVAL_MILLIS",
                                         100),
            "randomization_factor": get_f("BACKOFF_RANDOMIZATION_FACTOR",
                                          0.5),
            "multiplier": get_f("BACKOFF_MULTIPLIER", 1.5),
            "max_interval_ms": get_f("BACKOFF_MAX_INTERVAL_MILLIS", 1000),
            "max_elapsed_ms": get_f("BACKOFF_MAX_ELAPSED_TIME_MILLIS", 40000),
        },
        "user_agent": env.get("OPENAI_USER_AGENT"),
        "x_title": env.get("OPENAI_X_TITLE"),
        "referer": env.get("OPENAI_REFERER"),
        "first_chunk_timeout_ms": get_f("FIRST_CHUNK_TIMEOUT_MILLIS", 10000),
        "other_chunk_timeout_ms": get_f("OTHER_CHUNK_TIMEOUT_MILLIS", 60000),
        "connect_timeout_ms": get_f("CONNECT_TIMEOUT_MILLIS", 30000),
        "judge_stream_max_bytes": _non_negative_int(
            env, "JUDGE_STREAM_MAX_BYTES", 32 * 1024 * 1024
        ),
        "sse_max_event_bytes": _non_negative_int(
            env, "SSE_MAX_EVENT_BYTES", 4 * 1024 * 1024
        ),
    }


@dataclass
class ServeConfig:
    batch_window_ms: float = 3.0
    batch_max: int = 64
    batch_pipeline: int = 2
    batch_max_rows: int = 512
    host_tokenizer_workers: int = 2
    warmup: list = field(default_factory=list)
    warmup_r: list = field(default_factory=list)
    rm_warmup: list = field(default_factory=list)
    admission_max_inflight: int = 0
    admission_max_queue_depth: int = 0
    admission_adaptive: bool = False
    admission_min_limit: int = 2
    admission_latency_factor: float = 2.0
    admission_retry_after_millis: float = 1000.0
    drain_timeout_millis: float = 10000.0
    device_watchdog_millis: float = 0.0
    device_watchdog_interval_millis: float = 0.0
    device_watchdog_cpu_fallback: bool = False
    profile_dir: Optional[str] = None
    lock_witness: bool = False
    mesh_enabled: bool = False
    mesh_shape: Optional[tuple] = None
    mesh_dp: Optional[int] = None
    mesh_tp: int = 1
    mesh_sp: Optional[int] = None
    long_context_warmup: list = field(default_factory=list)
    mesh_fault_enabled: bool = False
    mesh_fault_transient_retries: int = 2
    mesh_fault_probe_millis: float = 0.0
    device_fault_plan: Optional[str] = None
    metrics_device_timing: bool = True
    max_body_bytes: int = 1024 * 1024
    address: str = "0.0.0.0"
    port: int = 5000
    packing: dict = field(default_factory=lambda: packing_options({}))
    upstream: dict = field(default_factory=lambda: upstream_options({}))
    tables_path: Optional[str] = None
    host_fastpath: bool = False
    score_cache_ttl_sec: float = 0.0
    score_cache_max_bytes: int = 64 * 1024 * 1024
    score_cache_dir: Optional[str] = None
    score_cache_embed: bool = False
    score_cache_embed_max_bytes: int = 32 * 1024 * 1024
    archive_path: Optional[str] = None
    archive_write: bool = False
    archive_streaming: bool = False
    archive_max_completions: int = 65536
    trace_sample_rate: float = 0.0
    trace_enabled: bool = False
    trace_ring: int = 256
    trace_dir: Optional[str] = None
    quality_window: int = 64
    quality_drift_threshold: float = 0.25
    ledger_ring: int = 0
    ledger_dir: Optional[str] = None
    ledger_rotate_bytes: int = 0
    weights_enabled: bool = False
    weights_path: Optional[str] = None
    offline_enabled: bool = False
    offline_inflight: int = 4
    resilience_breaker_threshold: float = 0.0
    resilience_breaker_window: int = 20
    resilience_breaker_min_samples: int = 5
    resilience_breaker_cooldown_millis: float = 5000.0
    resilience_retry_budget: int = 0
    resilience_hedge_millis: float = 0.0
    resilience_hedge_quantile: float = 0.0
    resilience_deadline_millis: float = 0.0
    resilience_quorum: float = 0.0
    fault_plan: Optional[str] = None
    judge_bias_plan: Optional[str] = None
    memguard_enabled: bool = True
    mem_soft_bytes: int = 0
    mem_hard_bytes: int = 0
    memguard_interval_millis: float = 1000.0

    @classmethod
    def from_env(cls, env: Optional[dict] = None) -> "ServeConfig":
        env = dict(os.environ if env is None else env)

        def get_f(name, default):
            return float(env.get(name, default))

        config = cls(
            batch_window_ms=get_f("BATCH_WINDOW_MS", 3.0),
            batch_max=int(env.get("BATCH_MAX", 64)),
            batch_pipeline=max(1, int(env.get("BATCH_PIPELINE", 2))),
            batch_max_rows=max(1, int(env.get("BATCH_MAX_ROWS", 512))),
            host_tokenizer_workers=_non_negative_int(
                env, "HOST_TOKENIZER_WORKERS", 2
            ),
            warmup=_parse_warmup(env.get("WARMUP")),
            warmup_r=_parse_warmup_r(env.get("WARMUP_R")),
            rm_warmup=_parse_warmup(env.get("RM_WARMUP"), "RM_WARMUP"),
            admission_max_inflight=_non_negative_int(
                env, "ADMISSION_MAX_INFLIGHT", 0
            ),
            admission_max_queue_depth=_non_negative_int(
                env, "ADMISSION_MAX_QUEUE_DEPTH", 0
            ),
            admission_adaptive=env_truthy(env.get("ADMISSION_ADAPTIVE", "0")),
            admission_min_limit=max(
                1, int(env.get("ADMISSION_MIN_LIMIT", 2))
            ),
            admission_latency_factor=get_f("ADMISSION_LATENCY_FACTOR", 2.0),
            admission_retry_after_millis=get_f(
                "ADMISSION_RETRY_AFTER_MILLIS", 1000
            ),
            drain_timeout_millis=get_f("DRAIN_TIMEOUT_MILLIS", 10000),
            device_watchdog_millis=get_f("DEVICE_WATCHDOG_MILLIS", 0),
            device_watchdog_interval_millis=get_f(
                "DEVICE_WATCHDOG_INTERVAL_MILLIS", 0
            ),
            device_watchdog_cpu_fallback=env_truthy(
                env.get("DEVICE_WATCHDOG_CPU_FALLBACK", "0")
            ),
            profile_dir=env.get("PROFILE_DIR"),
            lock_witness=env_truthy(env.get("LOCK_WITNESS", "0")),
            mesh_enabled=env_truthy(env.get("MESH_ENABLED", "0")),
            mesh_shape=_parse_mesh_shape(env.get("MESH_SHAPE")),
            mesh_dp=int(env["MESH_DP"]) if env.get("MESH_DP") else None,
            mesh_tp=int(env.get("MESH_TP", 1)),
            mesh_sp=int(env["MESH_SP"]) if env.get("MESH_SP") else None,
            long_context_warmup=_parse_long_context_warmup(
                env.get("LONG_CONTEXT_WARMUP")
            ),
            mesh_fault_enabled=env_truthy(
                env.get("MESH_FAULT_ENABLED", "0")
            ),
            mesh_fault_transient_retries=_non_negative_int(
                env, "MESH_FAULT_TRANSIENT_RETRIES", 2
            ),
            mesh_fault_probe_millis=get_f("MESH_FAULT_PROBE_MILLIS", 0),
            device_fault_plan=env.get("DEVICE_FAULT_PLAN"),
            metrics_device_timing=env_truthy(
                env.get("METRICS_DEVICE_TIMING", "1")
            ),
            max_body_bytes=_non_negative_int(
                env, "MAX_BODY_BYTES", 1024 * 1024
            ),
            address=env.get("ADDRESS", "0.0.0.0"),
            port=int(env.get("PORT", 5000)),
            packing=packing_options(env),
            upstream=upstream_options(env),
            tables_path=env.get("TABLES_PATH"),
            host_fastpath=env_truthy(env.get("HOST_FASTPATH", "0")),
            score_cache_ttl_sec=max(0.0, get_f("SCORE_CACHE_TTL", 0)),
            score_cache_max_bytes=_non_negative_int(
                env, "SCORE_CACHE_MAX_BYTES", 64 * 1024 * 1024
            ),
            score_cache_dir=env.get("SCORE_CACHE_DIR"),
            score_cache_embed=env_truthy(
                env.get(
                    "SCORE_CACHE_EMBED",
                    "1" if float(env.get("SCORE_CACHE_TTL", 0) or 0) > 0
                    else "0",
                )
            ),
            score_cache_embed_max_bytes=_non_negative_int(
                env, "SCORE_CACHE_EMBED_MAX_BYTES", 32 * 1024 * 1024
            ),
            archive_path=env.get("ARCHIVE_PATH"),
            archive_write=env_truthy(
                env.get("ARCHIVE_WRITE", "1" if env.get("ARCHIVE_PATH")
                        else "0")
            ),
            archive_streaming=env_truthy(env.get("ARCHIVE_STREAMING", "0")),
            archive_max_completions=_non_negative_int(
                env, "ARCHIVE_MAX_COMPLETIONS", 65536
            ),
            trace_sample_rate=get_f("TRACE_SAMPLE_RATE", 0),
            trace_enabled=env_truthy(env.get("TRACE_ENABLED", "0")),
            trace_ring=max(1, int(env.get("TRACE_RING", 256))),
            trace_dir=env.get("TRACE_DIR"),
            quality_window=int(env.get("QUALITY_WINDOW", 64)),
            quality_drift_threshold=get_f("QUALITY_DRIFT_THRESHOLD", 0.25),
            ledger_ring=_non_negative_int(env, "LEDGER_RING", 0),
            ledger_dir=env.get("LEDGER_DIR"),
            ledger_rotate_bytes=_non_negative_int(
                env, "LEDGER_ROTATE_BYTES", 0
            ),
            weights_enabled=env_truthy(env.get("WEIGHTS_ENABLED", "0")),
            weights_path=env.get("WEIGHTS_PATH"),
            offline_enabled=env_truthy(env.get("OFFLINE_ENABLED", "0")),
            offline_inflight=_non_negative_int(env, "OFFLINE_INFLIGHT", 4),
            resilience_breaker_threshold=get_f(
                "RESILIENCE_BREAKER_THRESHOLD", 0
            ),
            resilience_breaker_window=max(
                1, int(env.get("RESILIENCE_BREAKER_WINDOW", 20))
            ),
            resilience_breaker_min_samples=max(
                1, int(env.get("RESILIENCE_BREAKER_MIN_SAMPLES", 5))
            ),
            resilience_breaker_cooldown_millis=get_f(
                "RESILIENCE_BREAKER_COOLDOWN_MILLIS", 5000
            ),
            resilience_retry_budget=_non_negative_int(
                env, "RESILIENCE_RETRY_BUDGET", 0
            ),
            resilience_hedge_millis=get_f("RESILIENCE_HEDGE_MILLIS", 0),
            resilience_hedge_quantile=get_f("RESILIENCE_HEDGE_QUANTILE", 0),
            resilience_deadline_millis=get_f("RESILIENCE_DEADLINE_MILLIS", 0),
            resilience_quorum=get_f("RESILIENCE_QUORUM", 0),
            fault_plan=env.get("FAULT_PLAN"),
            judge_bias_plan=env.get("JUDGE_BIAS_PLAN"),
            memguard_enabled=env_truthy(env.get("MEMGUARD", "1")),
            mem_soft_bytes=_non_negative_int(env, "MEM_SOFT_BYTES", 0),
            mem_hard_bytes=_non_negative_int(env, "MEM_HARD_BYTES", 0),
            memguard_interval_millis=get_f("MEMGUARD_INTERVAL_MILLIS", 1000),
        )
        if config.quality_window < 1:
            raise ValueError(
                f"QUALITY_WINDOW={config.quality_window} must be >= 1 "
                "(ballots per judge in the sliding drift window)"
            )
        if not 0 < config.quality_drift_threshold <= 1:
            raise ValueError(
                f"QUALITY_DRIFT_THRESHOLD={config.quality_drift_threshold} "
                "must be an absolute rate drop in (0, 1]"
            )
        if not 0 <= config.resilience_quorum <= 1:
            raise ValueError(
                f"RESILIENCE_QUORUM={config.resilience_quorum} must be a "
                "weight fraction in [0, 1]"
            )
        if not 0 <= config.resilience_hedge_quantile < 1:
            raise ValueError(
                f"RESILIENCE_HEDGE_QUANTILE={config.resilience_hedge_quantile}"
                " must be a quantile in [0, 1)"
            )
        if not 0 <= config.trace_sample_rate <= 1:
            raise ValueError(
                f"TRACE_SAMPLE_RATE={config.trace_sample_rate} must be a "
                "probability in [0, 1]"
            )
        if config.admission_adaptive and config.admission_max_inflight <= 0:
            raise ValueError(
                "ADMISSION_ADAPTIVE=1 needs ADMISSION_MAX_INFLIGHT > 0: "
                "the adaptive limit operates UNDER the hard cap (set e.g. "
                "ADMISSION_MAX_INFLIGHT=64 ADMISSION_ADAPTIVE=1)"
            )
        if config.admission_latency_factor <= 1.0:
            raise ValueError(
                f"ADMISSION_LATENCY_FACTOR={config.admission_latency_factor} "
                "must be > 1 (it multiplies the latency baseline to form "
                "the congestion threshold)"
            )
        if (
            config.mem_soft_bytes > 0
            and config.mem_hard_bytes > 0
            and config.mem_hard_bytes < config.mem_soft_bytes
        ):
            raise ValueError(
                f"MEM_HARD_BYTES={config.mem_hard_bytes} must be >= "
                f"MEM_SOFT_BYTES={config.mem_soft_bytes}: the hard "
                "watermark sheds work the soft watermark only degrades"
            )
        if config.memguard_interval_millis <= 0:
            raise ValueError(
                f"MEMGUARD_INTERVAL_MILLIS={config.memguard_interval_millis}"
                " must be > 0 (the governor's RSS sampling period)"
            )
        if config.drain_timeout_millis < 0:
            raise ValueError(
                f"DRAIN_TIMEOUT_MILLIS={config.drain_timeout_millis} "
                "must be >= 0 (0 = shed immediately, no drain wait)"
            )
        if config.device_watchdog_millis < 0:
            raise ValueError(
                f"DEVICE_WATCHDOG_MILLIS={config.device_watchdog_millis} "
                "must be >= 0 (0 = watchdog disabled)"
            )
        if (
            config.device_watchdog_cpu_fallback
            and config.device_watchdog_millis <= 0
        ):
            raise ValueError(
                "DEVICE_WATCHDOG_CPU_FALLBACK=1 needs "
                "DEVICE_WATCHDOG_MILLIS > 0: without the watchdog nothing "
                "ever routes work to the fallback"
            )
        config._check_mesh()
        if config.warmup_r and not config.warmup:
            raise ValueError(
                "WARMUP_R is set but WARMUP is empty: the grouped-path "
                "warmup needs NxS shapes to compile (set WARMUP, e.g. "
                "WARMUP=64x112 WARMUP_R=2)"
            )
        if config.offline_enabled and config.offline_inflight < 1:
            raise ValueError(
                f"OFFLINE_INFLIGHT={config.offline_inflight} must be >= 1 "
                "(concurrent offline-lane groups; a zero-slot rescore "
                "drive can never make progress)"
            )
        return config

    def _check_mesh(self) -> None:
        """The reference's refusals of the mesh and fault knobs, in its
        order, then the one-card refusals."""
        if self.mesh_shape is not None and not self.mesh_enabled:
            raise ValueError(
                "MESH_SHAPE is set but MESH_ENABLED is not: the shape only "
                "configures the first-class mesh mode (set MESH_ENABLED=1 "
                "MESH_SHAPE=4x2)"
            )
        if self.mesh_enabled and (
            self.mesh_dp is not None
            or self.mesh_tp > 1
            or self.mesh_sp is not None
        ):
            raise ValueError(
                "MESH_ENABLED is mutually exclusive with the legacy "
                "MESH_DP/MESH_TP/MESH_SP hooks: the first-class mesh mode "
                "supersedes them (use MESH_SHAPE=DPxTP)"
            )
        if self.long_context_warmup and (
            self.mesh_shape is None or len(self.mesh_shape) != 3
        ):
            raise ValueError(
                "LONG_CONTEXT_WARMUP is set but MESH_SHAPE carries no sp "
                "axis: ring buckets only compile on a sequence-parallel "
                "mesh (set MESH_SHAPE=DPxTPxSP, e.g. 2x2x2, or unset "
                "LONG_CONTEXT_WARMUP)"
            )
        if self.mesh_fault_enabled and not self.mesh_enabled:
            raise ValueError(
                "MESH_FAULT_ENABLED=1 needs MESH_ENABLED=1: fault domains, "
                "the downsize ladder and re-dispatch all operate on the "
                "first-class serving mesh (set MESH_ENABLED=1, optionally "
                "MESH_SHAPE=DPxTP)"
            )
        if self.device_fault_plan and not self.mesh_fault_enabled:
            raise ValueError(
                "DEVICE_FAULT_PLAN is set but MESH_FAULT_ENABLED is not: "
                "the injection seam lives in the mesh fault-domain "
                "subsystem, so the plan would silently never fire (set "
                "MESH_FAULT_ENABLED=1, or unset DEVICE_FAULT_PLAN)"
            )
        if self.mesh_fault_probe_millis < 0:
            raise ValueError(
                f"MESH_FAULT_PROBE_MILLIS={self.mesh_fault_probe_millis} "
                "must be >= 0 (0 = no automatic recovery upsize)"
            )
        if (
            self.mesh_enabled
            and self.device_watchdog_cpu_fallback
            and not self.mesh_fault_enabled
        ):
            raise ValueError(
                "DEVICE_WATCHDOG_CPU_FALLBACK=1 with MESH_ENABLED=1 needs "
                "MESH_FAULT_ENABLED=1: the CPU twin is single-device, so "
                "in mesh mode it is the last resort AFTER the downsize "
                "ladder is exhausted — enabling it without the ladder "
                "would collapse the mesh to one CPU on the first trip"
            )
        # the one-card refusals: loud, never a silent ignore
        shape = self.mesh_shape or (1, 1)
        if shape[0] * shape[1] * (shape[2] if len(shape) > 2 else 1) > 1:
            raise ValueError(
                f"MESH_SHAPE={'x'.join(map(str, shape))} spans more than "
                f"one device: {ONE_CARD}"
            )
        if self.mesh_dp is not None:
            raise ValueError(f"MESH_DP={self.mesh_dp} is refused: {ONE_CARD}")
        if self.mesh_tp > 1:
            raise ValueError(f"MESH_TP={self.mesh_tp} is refused: {ONE_CARD}")
        if self.mesh_sp is not None:
            raise ValueError(f"MESH_SP={self.mesh_sp} is refused: {ONE_CARD}")
        if self.long_context_warmup:
            raise ValueError(f"LONG_CONTEXT_WARMUP is refused: {ONE_CARD}")

    def device_fault_injection_plan(self):
        """Parsed ``DEVICE_FAULT_PLAN``, or None (drills only)."""
        if not self.device_fault_plan:
            return None
        from ..resilience import DeviceFaultPlan

        return DeviceFaultPlan.parse(self.device_fault_plan)

    def admission_config(self):
        """The ``AdmissionConfig`` of the gateway's admission gate."""
        from ..resilience.admission import AdmissionConfig

        return AdmissionConfig(
            max_inflight=self.admission_max_inflight,
            max_queue_depth=self.admission_max_queue_depth,
            adaptive=self.admission_adaptive,
            min_limit=self.admission_min_limit,
            latency_factor=self.admission_latency_factor,
            retry_after_ms=self.admission_retry_after_millis,
        )

    def resilience_policy(self):
        """The configured ``ResiliencePolicy``, or None when every knob is
        off (None keeps the clients on their pre-resilience code paths)."""
        from ..resilience import (
            BreakerConfig,
            BreakerRegistry,
            HedgePolicy,
            ResiliencePolicy,
        )

        breakers = None
        if self.resilience_breaker_threshold > 0:
            breakers = BreakerRegistry(
                BreakerConfig(
                    threshold=self.resilience_breaker_threshold,
                    window=self.resilience_breaker_window,
                    min_samples=self.resilience_breaker_min_samples,
                    cooldown_ms=self.resilience_breaker_cooldown_millis,
                )
            )
        hedge = None
        if self.resilience_hedge_millis > 0 or self.resilience_hedge_quantile > 0:
            hedge = HedgePolicy(
                delay_ms=self.resilience_hedge_millis,
                quantile=self.resilience_hedge_quantile,
            )
        if (
            breakers is None
            and hedge is None
            and self.resilience_retry_budget <= 0
            and self.resilience_quorum <= 0
            and self.resilience_deadline_millis <= 0
        ):
            return None
        return ResiliencePolicy(
            breakers=breakers,
            hedge=hedge,
            retry_budget_tokens=self.resilience_retry_budget,
            quorum_fraction=self.resilience_quorum,
            deadline_ms=self.resilience_deadline_millis,
        )

    def fault_injection_plan(self):
        """Parsed ``FAULT_PLAN``, or None (chaos runs only)."""
        if not self.fault_plan:
            return None
        from ..resilience import FaultPlan

        return FaultPlan.parse(self.fault_plan)

    def judge_bias_injection_plan(self):
        """Parsed ``JUDGE_BIAS_PLAN``, or None (quality drills only)."""
        if not self.judge_bias_plan:
            return None
        from ..resilience import JudgeBiasPlan

        return JudgeBiasPlan.parse(self.judge_bias_plan)

    def memguard(self):
        """The configured ``MemGuard``, or None when ``MEMGUARD=0`` or an
        auto watermark is needed but MemTotal is unreadable (the governor
        never guesses)."""
        if not self.memguard_enabled:
            return None
        from ..resilience.memguard import MemGuard, resolve_watermarks

        marks = resolve_watermarks(self.mem_soft_bytes, self.mem_hard_bytes)
        if marks is None:
            return None
        return MemGuard(
            marks[0], marks[1], interval_ms=self.memguard_interval_millis
        )

    def trace_sink(self):
        """The configured ``TraceSink``, or None when nothing enables
        tracing (None keeps every instrumentation site on its
        one-contextvar-read no-op path)."""
        if not (
            self.trace_enabled
            or self.trace_sample_rate > 0
            or self.trace_dir
        ):
            return None
        from ..obs import TraceSink

        return TraceSink(
            capacity=self.trace_ring,
            sample_rate=self.trace_sample_rate,
            disk_dir=self.trace_dir,
        )

    def outcome_ledger(self):
        """The configured ``OutcomeLedger``, or None when nothing enables
        it (None keeps the tally seam ledger-free).  ``LEDGER_DIR`` alone
        implies the default ring of 256."""
        if self.ledger_ring <= 0 and not self.ledger_dir:
            return None
        from ..obs import OutcomeLedger

        return OutcomeLedger(
            capacity=self.ledger_ring if self.ledger_ring > 0 else 256,
            disk_dir=self.ledger_dir,
            rotate_bytes=self.ledger_rotate_bytes,
        )

    def live_weights(self):
        """The configured ``LiveWeightStore``, or None when nothing
        enables it (None keeps the scoring path on its fetched weights).
        ``WEIGHTS_PATH`` alone implies enabled: pointing at a table means
        serving it."""
        if not (self.weights_enabled or self.weights_path):
            return None
        from ..weights.live import LiveWeightStore

        return LiveWeightStore(path=self.weights_path)

    def packed_buckets(self) -> list:
        """The packed (B, L, K) buckets to warm, as the reference picks
        them: with ``WARMUP`` set and packing on, every power-of-two row
        count up to the per-call cap at full row width, then one row at
        each narrower width of the L ladder."""
        if not (self.warmup and self.packing["packing"]):
            return []
        from .packing import _L_BUCKETS

        l_top = self.packing["packing_row_tokens"]
        k = self.packing["packing_max_segments"]
        buckets, b = [], 1
        while b <= self.packing["packing_max_rows"]:
            buckets.append((b, l_top, k))
            b *= 2
        buckets.extend((1, l, k) for l in _L_BUCKETS if l < l_top)
        return buckets


def score_caches(config: ServeConfig) -> tuple:
    """(score cache, embedding row cache) of the configuration, each None
    when off, as the reference's server builds them."""
    if config.score_cache_ttl_sec <= 0:
        return None, None
    from ..cache import EmbeddingCache, ScoreCache

    score_cache = ScoreCache(
        config.score_cache_ttl_sec,
        config.score_cache_max_bytes,
        config.score_cache_dir,
    )
    embed_cache = None
    if config.score_cache_embed:
        embed_cache = EmbeddingCache(
            config.score_cache_ttl_sec, config.score_cache_embed_max_bytes
        )
    return score_cache, embed_cache
