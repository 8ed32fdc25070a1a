"""Out-of-band service metrics behind ``GET /metrics``.

Counterpart of ``llm_weighted_consensus_tpu/serve/metrics.py``
(``Metrics``, ``register_provider``, ``snapshot``,
``render_prometheus``) for the families the port serves:

* the request series (``http:<route>``, ``device:batch:<kind>``,
  ``device:rm_vote``, the batcher's ``device:shed:*``): count, errors
  and a latency histogram each;
* ``phases``: the phase and per-bucket device-time histograms
  (``obs/phases.py``);
* ``device_batcher``: the batcher's ``utilization()``, lanes included;
* ``graphs``: each model's ``graph_stats()`` (the counterpart of the
  reference's ``jit`` section);
* ``admission``, ``device_watchdog``, ``lifecycle`` and ``memguard``
  (overload; the governor's RSS, level and watermark trips);
* ``resilience``: the clients' counters (quorum and deadline degrades,
  hedges launched, won and denied, breaker rejections, retry denials,
  ingest-cap trips), each breaker's state keyed ``api_base|model``, the
  effective hedge delay, and under ``FAULT_PLAN`` the injected faults
  (``register_resilience``);
* ``kernels``: the kernel wrappers' launch and route counters
  (``ops/launches.py``), replays included;
* ``roofline``: per observed device-timing bucket, its count and device
  p50 and, for a bucket with a committed row
  (``analysis/roofline.json``), its speed-of-light time and
  ``attainment = sol_ms / device_p50_ms`` (``register_performance``);
* ``mesh`` and ``meshfault``: under ``MESH_ENABLED`` the serving shape
  (one card: ``1x1``), under ``MESH_FAULT_ENABLED`` the fault manager's
  shape, epoch, re-dispatch and ladder counters and the injection plan's
  tallies (``resilience/meshfault.py``);
* ``score_cache`` and ``embed_cache``: the caches' counters
  (``cache/store.py``) with their in-flight collapses, when
  ``SCORE_CACHE_TTL`` turns them on;
* ``traces``: the trace sink's counters (``obs/sink.py``), when tracing
  is on;
* ``quality``: judge scorecards, pairwise kappa, drift flags, the margin
  histogram and outcome rates (``obs/quality.py``, always on), and
  ``ledger``: the outcome ledger's counters, when ``LEDGER_*`` turns it
  on, and ``weights``: the live weight store's versions and counters,
  when ``WEIGHTS_*`` turns it on (``register_quality``).

A series observed with a ``trace_id`` keeps the newest as its exemplar:
the JSON snapshot names it, and the Prometheus text attaches it to the
bucket line its latency falls in.

Two expositions off one store: the JSON snapshot (the reference's shape)
and, with ``?format=prometheus``, OpenMetrics text whose shared families
(uptime, series, phase, device, the roofline gauges, the quality
families, the memory governor's, lanes, live weights) render as the
reference renders them.  One lock guards the series: the handler, dispatch and waiter
threads all observe.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from ..obs.histogram import Histogram, le_for

# every provider section the snapshot may carry
KNOWN_SECTIONS = (
    "resilience",
    "admission",
    "device_watchdog",
    "lifecycle",
    "device_batcher",
    "phases",
    "roofline",
    "mesh",
    "meshfault",
    "graphs",
    "kernels",
    "score_cache",
    "embed_cache",
    "traces",
    "quality",
    "ledger",
    "memguard",
    "weights",
    "lock_witness",
)

# Every Prometheus family the text exposition may emit (the reference's
# registry, serve/metrics.py, with the port's own families: the graph,
# kernel, admission, health and batcher-shed ones).  LWC012 holds it both
# ways: a `prom_family(...)` call with an unlisted name fails lint, and a
# listed family no call site emits is stale.  Counter families are
# declared WITHOUT the `_total` sample suffix (OpenMetrics convention).
KNOWN_PROM_FAMILIES = (
    "lwc_uptime_seconds",
    "lwc_series_requests",
    "lwc_series_errors",
    "lwc_series_latency_ms",
    "lwc_phase_latency_ms",
    "lwc_device_latency_ms",
    "lwc_roofline_sol_ms",
    "lwc_roofline_attainment",
    "lwc_confidence_margin",
    "lwc_consensus_outcomes",
    "lwc_judge_agreement",
    "lwc_judge_drift",
    "lwc_memguard_rss_bytes",
    "lwc_memguard_level",
    "lwc_memguard_trips",
    "lwc_lane_dispatches",
    "lwc_lane_items",
    "lwc_lane_busy_fraction",
    "lwc_batcher_shed",
    "lwc_weights_swaps",
    "lwc_weights_shadow",
    "lwc_graph_events",
    "lwc_graphs",
    "lwc_graph_pool_bytes",
    "lwc_admission_inflight",
    "lwc_admission_shed",
    "lwc_device_healthy",
    "lwc_kernel_launches",
    "lwc_kernel_route_launches",
)

PROM_CONTENT_TYPE = (
    "application/openmetrics-text; version=1.0.0; charset=utf-8"
)


class _Series:
    __slots__ = ("count", "errors", "hist", "exemplar")

    def __init__(self) -> None:
        self.count = 0
        self.errors = 0
        self.hist = Histogram()
        # (trace_id, latency_ms, unix_ts): the newest traced observation
        self.exemplar: Optional[Tuple[str, float, float]] = None


class Metrics:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._series_store: Dict[str, _Series] = {}
        self._providers: dict = {}
        self._started = time.monotonic()

    def observe(self, series: str, ms: float, *, error: bool = False,
                trace_id: Optional[str] = None) -> None:
        """One observation; ``trace_id`` (passed explicitly by the call
        site that knows its request's trace) becomes the exemplar."""
        with self._lock:
            s = self._series_store.get(series)
            if s is None:
                s = self._series_store[series] = _Series()
            s.count += 1
            if error:
                s.errors += 1
            s.hist.observe(ms)
            if trace_id is not None:
                s.exemplar = (trace_id, ms, time.time())

    def register_provider(self, name: str, fn) -> None:
        """Attach a live section (``KNOWN_SECTIONS``) to the snapshot."""
        if name not in KNOWN_SECTIONS:
            raise ValueError(
                f"unknown metrics section {name!r}; known: "
                + ", ".join(KNOWN_SECTIONS)
            )
        self._providers[name] = fn

    def snapshot(self) -> dict:
        out = {}
        for series, s in self.series_items():
            entry = {"count": s.count, "errors": s.errors}
            if s.hist.count:
                entry["p50_ms"] = round(s.hist.quantile(0.5), 2)
                entry["p99_ms"] = round(s.hist.quantile(0.99), 2)
            if s.exemplar is not None:
                entry["trace_id"] = s.exemplar[0]
            out[series] = entry
        snap = {
            "uptime_sec": round(time.monotonic() - self._started, 1),
            "series": out,
        }
        for name, fn in list(self._providers.items()):
            try:
                snap[name] = fn()
            except Exception as e:  # a broken gauge must not break /metrics
                snap[name] = {"error": str(e)}
        return snap

    def provider_section(self, name: str):
        """One provider section by name (None when absent or broken)."""
        fn = self._providers.get(name)
        if fn is None:
            return None
        try:
            return fn()
        except Exception:
            return None

    def uptime_sec(self) -> float:
        return time.monotonic() - self._started

    def series_items(self) -> List[Tuple[str, _Series]]:
        """Sorted (name, copy of the series): a copy, so that rendering
        never races an observe."""
        with self._lock:
            items = []
            for name, s in sorted(self._series_store.items()):
                c = _Series()
                c.count, c.errors = s.count, s.errors
                c.hist.merge(s.hist)
                c.exemplar = s.exemplar
                items.append((name, c))
        return items


def register_performance(metrics: Metrics, roofline=None) -> None:
    """The ``phases`` section (per-phase histograms, device share,
    overlap), the ``kernels`` section (launch and route counters) and,
    with a gauge (``analysis.roofline.RooflineGauge``), the ``roofline``
    section."""
    from ..obs import phases as _phases

    metrics.register_provider("phases", _phases.phases_snapshot)
    metrics.register_provider("kernels", kernel_counters)
    if roofline is not None:
        metrics.register_provider("roofline", roofline.snapshot)


def register_resilience(metrics: Metrics, policy, fault_plan=None) -> None:
    """The ``resilience`` section: per-upstream breaker states, the
    retry/hedge/degraded counters, the effective hedge delay, and — on
    chaos runs — the fault-injection tallies.  Nothing when both are
    None."""
    if policy is None and fault_plan is None:
        return

    def _snapshot() -> dict:
        snap = policy.snapshot() if policy is not None else {}
        if fault_plan is not None:
            snap["fault_plan"] = fault_plan.snapshot()
        return snap

    metrics.register_provider("resilience", _snapshot)


def register_overload(metrics: Metrics, admission=None, watchdog=None,
                      lifecycle=None, memguard=None) -> None:
    """The ``admission``, ``device_watchdog``, ``lifecycle`` and
    ``memguard`` sections."""
    if admission is not None:
        metrics.register_provider("admission", admission.snapshot)
    if watchdog is not None:
        metrics.register_provider("device_watchdog", watchdog.snapshot)
    if lifecycle is not None:
        metrics.register_provider("lifecycle", lifecycle.snapshot)
    if memguard is not None:
        metrics.register_provider("memguard", memguard.snapshot)


def register_quality(metrics: Metrics, ledger=None, live_weights=None
                     ) -> None:
    """The ``quality`` section (the process-global judge scorecards,
    pairwise kappa, drift flags, margin histogram and outcome rates),
    with an outcome ledger its ``ledger`` section, and with a live weight
    store its ``weights`` section (active and shadow versions, swap and
    shadow-comparison counters)."""
    from ..obs import quality as _quality

    metrics.register_provider("quality", _quality.quality_snapshot)
    if ledger is not None:
        metrics.register_provider("ledger", ledger.snapshot)
    if live_weights is not None:
        metrics.register_provider("weights", live_weights.snapshot)


def register_graphs(metrics: Metrics, **models) -> None:
    """The ``graphs`` section: ``graph_stats()`` of each named model
    (``embedder=``, ``reranker=``; None entries skipped)."""
    served = {name: m for name, m in models.items() if m is not None}
    metrics.register_provider(
        "graphs", lambda: {name: m.graph_stats() for name, m in served.items()}
    )


def kernel_counters() -> dict:
    """Every kernel wrapper's launches and launches per route."""
    from ..ops import attention, kernels

    out = {}
    for fn in (kernels.cosine_vote, attention.attention,
               attention.segment_attention, kernels.quantize_rows,
               kernels.w8a8_matmul, kernels.w4a8_matmul):
        row = {"launches": fn.launches}
        routes = getattr(fn, "routes", None)
        if routes is not None:
            row["routes"] = dict(routes)
        out[fn.__name__] = row
    return out


# -- Prometheus exposition -----------------------------------------------------


def prom_family(name: str, typ: str, help_text: str) -> List[str]:
    return [f"# HELP {name} {help_text}", f"# TYPE {name} {typ}"]


def _esc(label_value: str) -> str:
    return (
        label_value.replace("\\", "\\\\").replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _render_hist(name: str, label: str, value: str, hist: Histogram,
                 exemplar: Optional[Tuple[str, float, float]] = None
                 ) -> List[str]:
    """One labelled histogram as ``_bucket``/``_sum``/``_count`` lines,
    with the exemplar (when given) on the first bucket line whose range
    holds the exemplar's own latency."""
    sel = f'{label}="{_esc(value)}"'
    lines = []
    ex_le = le_for(exemplar[1]) if exemplar is not None else None
    for le, cum in hist.cumulative():
        line = f'{name}_bucket{{{sel},le="{le}"}} {cum}'
        if ex_le is not None and le == ex_le:
            trace_id, ms, ts = exemplar
            line += f' # {{trace_id="{_esc(trace_id)}"}} {ms:.6g} {ts:.3f}'
            ex_le = None
        lines.append(line)
    lines.append(f"{name}_sum{{{sel}}} {hist.sum:.6g}")
    lines.append(f"{name}_count{{{sel}}} {hist.count}")
    return lines


def render_prometheus(metrics: Metrics) -> str:
    """The process as OpenMetrics text: uptime, per-series counters and
    latency histograms, the phase and per-bucket device histograms, the
    lanes of the batcher, the graphs, the overload counters and the
    kernel counters.  Ends with ``# EOF``."""
    from ..obs import phases as _phases

    lines: List[str] = []
    lines += prom_family("lwc_uptime_seconds", "gauge",
                         "Process uptime (monotonic).")
    lines.append(f"lwc_uptime_seconds {metrics.uptime_sec():.3f}")

    items = metrics.series_items()
    lines += prom_family(
        "lwc_series_requests", "counter", "Requests observed per series."
    )
    for series, s in items:
        lines.append(
            f'lwc_series_requests_total{{series="{_esc(series)}"}} {s.count}'
        )
    lines += prom_family(
        "lwc_series_errors", "counter", "Errored requests per series."
    )
    for series, s in items:
        lines.append(
            f'lwc_series_errors_total{{series="{_esc(series)}"}} {s.errors}'
        )
    lines += prom_family(
        "lwc_series_latency_ms",
        "histogram",
        "Per-series latency, fixed log buckets (obs/histogram.py).",
    )
    for series, s in items:
        lines += _render_hist("lwc_series_latency_ms", "series", series,
                              s.hist, s.exemplar)

    phase_hists, device_hists = _phases.aggregator().raw_histograms()
    lines += prom_family(
        "lwc_phase_latency_ms",
        "histogram",
        "Request time attributed per phase (admission_wait .. upstream_judge).",
    )
    for phase in _phases.PHASES:
        hist = phase_hists.get(phase)
        if hist is not None:
            lines += _render_hist("lwc_phase_latency_ms", "phase", phase, hist)
    lines += prom_family(
        "lwc_device_latency_ms",
        "histogram",
        "Enqueue-to-ready device time per (mesh-shape, bucket).",
    )
    for bucket, hist in sorted(device_hists.items()):
        lines += _render_hist("lwc_device_latency_ms", "bucket", bucket, hist)

    roofline = metrics.provider_section("roofline")
    if isinstance(roofline, dict):
        rows = roofline.get("buckets", {})
        lines += prom_family(
            "lwc_roofline_sol_ms",
            "gauge",
            "Speed-of-light time per AOT bucket from analysis/roofline.json.",
        )
        for bucket, row in sorted(rows.items()):
            sol = row.get("sol_ms")
            if sol is not None:
                lines.append(
                    f'lwc_roofline_sol_ms{{bucket="{_esc(bucket)}"}} {sol:.6g}'
                )
        lines += prom_family(
            "lwc_roofline_attainment",
            "gauge",
            "sol_ms / measured device p50 per AOT bucket (1.0 = roofline).",
        )
        for bucket, row in sorted(rows.items()):
            att = row.get("attainment")
            if att is not None:
                lines.append(
                    f'lwc_roofline_attainment{{bucket="{_esc(bucket)}"}} '
                    f'{att:.6g}'
                )

    lines += _render_quality()

    memguard = metrics.provider_section("memguard")
    if isinstance(memguard, dict):
        lines += prom_family(
            "lwc_memguard_rss_bytes",
            "gauge",
            "Process RSS as last sampled by the memory governor.",
        )
        if "rss_bytes" in memguard:
            lines.append(f"lwc_memguard_rss_bytes {memguard['rss_bytes']}")
        lines += prom_family(
            "lwc_memguard_level",
            "gauge",
            "Memory pressure level (0 ok, 1 soft, 2 hard).",
        )
        level_num = {"ok": 0, "soft": 1, "hard": 2}.get(
            memguard.get("level"), 0
        )
        lines.append(f"lwc_memguard_level {level_num}")
        lines += prom_family(
            "lwc_memguard_trips",
            "counter",
            "Watermark crossings by kind (soft/hard/recovery).",
        )
        for kind, key in (
            ("soft", "soft_trips"),
            ("hard", "hard_trips"),
            ("recovery", "recoveries"),
        ):
            lines.append(
                f'lwc_memguard_trips_total{{kind="{kind}"}} '
                f"{memguard.get(key, 0)}"
            )

    batcher = metrics.provider_section("device_batcher")
    if isinstance(batcher, dict) and isinstance(batcher.get("lanes"), dict):
        lanes = sorted(batcher["lanes"].items())
        lines += prom_family(
            "lwc_lane_dispatches",
            "counter",
            "Device dispatches per priority class (latency/offline).",
        )
        for lane, row in lanes:
            lines.append(
                f'lwc_lane_dispatches_total{{lane="{_esc(lane)}"}} '
                f"{row.get('dispatches', 0)}"
            )
        lines += prom_family(
            "lwc_lane_items", "counter", "Items dispatched per priority class."
        )
        for lane, row in lanes:
            lines.append(
                f'lwc_lane_items_total{{lane="{_esc(lane)}"}} '
                f"{row.get('items', 0)}"
            )
        lines += prom_family(
            "lwc_lane_busy_fraction",
            "gauge",
            "Device busy fraction attributed per priority class.",
        )
        for lane, row in lanes:
            lines.append(
                f'lwc_lane_busy_fraction{{lane="{_esc(lane)}"}} '
                f"{row.get('busy_fraction', 0.0):.6g}"
            )
        lines += prom_family(
            "lwc_batcher_shed", "counter",
            "Batcher sheds by reason (queue_full 503, deadline 504) and "
            "cancelled items dropped before dispatch.",
        )
        for reason, key in (("queue_full", "shed_queue_full"),
                            ("deadline", "shed_deadline"),
                            ("cancelled", "cancelled_items")):
            lines.append(
                f'lwc_batcher_shed_total{{reason="{reason}"}} '
                f"{batcher.get(key, 0)}"
            )

    weights = metrics.provider_section("weights")
    if isinstance(weights, dict):
        lines += prom_family(
            "lwc_weights_swaps",
            "counter",
            "Live weight-table installs (active + shadow).",
        )
        lines.append(f"lwc_weights_swaps_total {weights.get('swaps', 0)}")
        lines += prom_family(
            "lwc_weights_shadow",
            "counter",
            "Shadow-table comparisons by kind (compared/would_flip).",
        )
        for kind, key in (
            ("compared", "shadow_compared"),
            ("would_flip", "shadow_would_flip"),
        ):
            lines.append(
                f'lwc_weights_shadow_total{{kind="{kind}"}} '
                f"{weights.get(key, 0)}"
            )

    graphs = metrics.provider_section("graphs")
    if isinstance(graphs, dict):
        lines += prom_family(
            "lwc_graph_events", "counter",
            "CUDA graph captures and replays, and eager dispatches at "
            "buckets not warmed, per model.",
        )
        for model, row in sorted(graphs.items()):
            for event in ("captures", "replays", "eager_dispatches"):
                lines.append(
                    f'lwc_graph_events_total{{model="{_esc(model)}",'
                    f'event="{event}"}} {row.get(event, 0)}'
                )
        lines += prom_family(
            "lwc_graphs", "gauge", "Warmed buckets per model."
        )
        for model, row in sorted(graphs.items()):
            lines.append(
                f'lwc_graphs{{model="{_esc(model)}"}} {row.get("graphs", 0)}'
            )
        lines += prom_family(
            "lwc_graph_pool_bytes", "gauge",
            "Device bytes of each model's shared CUDA graph memory pool.",
        )
        for model, row in sorted(graphs.items()):
            lines.append(
                f'lwc_graph_pool_bytes{{model="{_esc(model)}"}} '
                f'{row.get("pool_bytes", 0)}'
            )

    admission = metrics.provider_section("admission")
    if isinstance(admission, dict):
        lines += prom_family(
            "lwc_admission_inflight", "gauge", "Requests admitted and running."
        )
        lines.append(f"lwc_admission_inflight {admission.get('inflight', 0)}")
        lines += prom_family(
            "lwc_admission_shed", "counter", "Admission sheds by reason."
        )
        for reason, count in sorted(admission.get("shed", {}).items()):
            lines.append(
                f'lwc_admission_shed_total{{reason="{_esc(reason)}"}} {count}'
            )
    watchdog = metrics.provider_section("device_watchdog")
    if isinstance(watchdog, dict):
        lines += prom_family(
            "lwc_device_healthy", "gauge",
            "1 while the watchdog holds the device healthy.",
        )
        lines.append(f"lwc_device_healthy {int(bool(watchdog['healthy']))}")

    kernels = metrics.provider_section("kernels")
    if isinstance(kernels, dict):
        lines += prom_family(
            "lwc_kernel_launches", "counter",
            "Launches of each hand-written kernel, CUDA graph replays "
            "included.",
        )
        for name, row in sorted(kernels.items()):
            lines.append(
                f'lwc_kernel_launches_total{{kernel="{_esc(name)}"}} '
                f"{row['launches']}"
            )
        lines += prom_family(
            "lwc_kernel_route_launches", "counter",
            "Launches of each kernel per route.",
        )
        for name, row in sorted(kernels.items()):
            for route, count in sorted(row.get("routes", {}).items()):
                lines.append(
                    f'lwc_kernel_route_launches_total{{kernel="{_esc(name)}",'
                    f'route="{_esc(route)}"}} {count}'
                )

    lines.append("# EOF")
    return "\n".join(lines) + "\n"


def _render_quality() -> List[str]:
    """The consensus-quality families, as the reference renders them:
    the margin histogram (with the newest traced request as its
    exemplar), outcome counters, and per-judge agreement and drift."""
    from ..obs import quality as _quality

    qsnap = _quality.quality_aggregator().prom_snapshot()
    lines = prom_family(
        "lwc_confidence_margin",
        "histogram",
        "Consensus confidence margin (top1 - top2) per scored request.",
    )
    lines += _render_hist("lwc_confidence_margin", "kind", "margin",
                          qsnap["margin"], qsnap["exemplar"])
    lines += prom_family(
        "lwc_consensus_outcomes",
        "counter",
        "Scored requests by consensus outcome (scored/degraded/...).",
    )
    for outcome, count in qsnap["outcomes"].items():
        lines.append(
            f'lwc_consensus_outcomes_total{{outcome="{_esc(outcome)}"}} '
            f"{count}"
        )
    lines += prom_family(
        "lwc_judge_agreement",
        "gauge",
        "Per-judge agreement-with-final-consensus rate.",
    )
    for judge, rate in qsnap["agreement"].items():
        lines.append(f'lwc_judge_agreement{{judge="{_esc(judge)}"}} {rate:.6g}')
    lines += prom_family(
        "lwc_judge_drift",
        "gauge",
        "1 when the drift detector currently flags the judge, else 0.",
    )
    for judge, flagged in qsnap["drift_flagged"].items():
        lines.append(f'lwc_judge_drift{{judge="{_esc(judge)}"}} {flagged:.0f}')
    return lines
