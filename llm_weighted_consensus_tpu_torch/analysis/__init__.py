"""First-party invariant checker and performance analysis of the port.

Counterpart of the reference's ``llm_weighted_consensus_tpu/analysis/``.
One CLI (``python -m llm_weighted_consensus_tpu_torch.analysis``) runs:

* **the AST lint** (``engine.py`` + ``rules/``, LWC001–LWC018) — the
  async-cancellation / resource-release / contextvar-token /
  Decimal-purity / error-envelope / registry / ingest-bound invariants,
  with the reference's rule ids; LWC009 and LWC013 check torch calls and
  CUDA syncs where the reference's check ``jax.*`` and
  ``block_until_ready``;
* **the concurrency audit** (``concurrency.py``, LWC014–LWC016) over the
  port's own lock registry (``concurrency_model.py``: every threading
  primitive the port creates, its guarded fields and the acquisition
  order DAG); ``witness.py``'s ``LockWitness`` checks the same order at
  run time (``LOCK_WITNESS=1``);
* **the dispatch audit** (``dispatch_audit.py``, TXA001–TXA005, the
  counterpart of the reference's jaxpr audit): the aten ops of one
  dispatch of each served kind, recorded on the CPU, and on the card the
  enqueue under CUDA's sync debug mode, the graph bookkeeping and the
  kernels' routes;
* **the mesh audit** (``mesh_audit.py``, JXA006–JXA013) over
  ``[cpu] * 8``: the rule tables' coverage and replication, the
  collective plan, the committed shard budgets (``budgets.py``,
  ``budgets.json``), parity with one device, the fault ladder's warmed
  rungs and the roofline rows.

Findings are :class:`~.engine.Finding` objects; intentional deviations
live in ``analysis/baseline.json`` with a written ``reason``, and the CLI
fails on any non-baselined finding and on stale baseline entries.  The
lint imports nothing heavy (stdlib ``ast`` only); torch is imported only
when the dispatch or the mesh audit runs.

The performance half: the per-bucket speed-of-light roofline
(``roofline.py``, committed as ``roofline.json``), the FLOP and byte
counter that writes it (``cost.py``) and the profiler's time-stamp check
(``trace_stamps.py``).
"""

from __future__ import annotations

from .engine import (  # noqa: F401
    Finding,
    ParsedModule,
    apply_baseline,
    baseline_entry,
    default_baseline_path,
    load_baseline,
    package_root,
    parse_module,
    run_lint,
    source_files,
)

__all__ = [
    "Finding",
    "ParsedModule",
    "apply_baseline",
    "baseline_entry",
    "default_baseline_path",
    "load_baseline",
    "package_root",
    "parse_module",
    "run_lint",
    "source_files",
]
