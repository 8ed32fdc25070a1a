"""Observability of the port: request tracing, phase timing, consensus
quality and the outcome ledger.

The port's copy of ``llm_weighted_consensus_tpu/obs/``: ``span`` — the
contextvar-carried span tree; ``sink`` — the bounded ring + JSONL
retention with head sampling and forced capture of shed, errored and
all-failed requests; ``propagate`` — W3C ``traceparent`` inject at the
upstream judge calls and extract at the gateway door; ``histogram`` and
``phases`` — mergeable latency histograms, the process-global phase
aggregator behind ``/metrics`` and the ``phase`` scope that times the
host's phases of a request, with ``phase_breakdown`` per traced
request; ``quality`` — judge scorecards, pairwise kappa, drift and the
margin histogram (always on); ``ledger`` — one record per scored request.

Standard library only, below ``utils``, so any layer (cache, clients,
batcher, gateway) can instrument without cycles.  With no sink configured
nothing ever activates a root span, and every ambient helper here is a
single contextvar read returning None.
"""

from .histogram import Histogram  # noqa: F401
from .ledger import (  # noqa: F401
    LEDGER_SCHEMA,
    OutcomeLedger,
    ledger_shard_paths,
    load_ledger_records,
    read_shard_records,
)
from .phases import (  # noqa: F401
    PHASES,
    observe_device,
    observe_phase,
    phase,
    phase_breakdown,
    phases_snapshot,
    reset_phases,
)
from .propagate import (  # noqa: F401
    TRACEPARENT_HEADER,
    extract,
    format_traceparent,
    inject,
    parse_traceparent,
)
from .quality import (  # noqa: F401
    JudgeBallot,
    Outcome,
    QualityAggregator,
    configure_quality,
    observe_outcome,
    quality_aggregator,
    quality_snapshot,
    quality_summary,
    reset_quality,
)
from .sink import TraceSink  # noqa: F401
from .span import (  # noqa: F401
    KNOWN_SPANS,
    Span,
    Trace,
    annotate,
    carry,
    child_span,
    current_span,
    current_trace_id,
    force_keep,
    span,
    start_trace,
)
