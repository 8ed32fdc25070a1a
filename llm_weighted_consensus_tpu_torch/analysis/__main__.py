"""CLI: ``python -m llm_weighted_consensus_tpu_torch.analysis``.

Counterpart of ``python -m llm_weighted_consensus_tpu.analysis``, over
the port's package.  Runs the AST lint, the concurrency audit (LWC014–
016) as its own timed pass, then the dispatch audit's CPU half
(``dispatch_audit.py``, unless skipped), applies ``baseline.json``, and
reports.

Exit codes, as the reference's: **0** clean (every finding baselined or
none), **1** non-baselined findings, **2** baseline problems (a stale
suppression — the code it covered was fixed, so the entry must be
deleted — or an entry missing its mandatory ``reason``).

Flags/env, under the reference's names: ``--no-jaxpr`` or
``ANALYSIS_SKIP_JAXPR=1`` skips the dispatch audit, the port's
counterpart of the jaxpr audit (lint stays; without the audit the CLI
never imports torch); ``--no-concurrency`` or
``ANALYSIS_SKIP_CONCURRENCY=1`` skips LWC014–016; ``--baseline PATH`` /
``ANALYSIS_BASELINE`` overrides the baseline file; ``--rules
LWC001,...`` restricts lint rules; ``--json`` emits machine-readable
findings; positional paths lint specific files instead of the whole
package.  The dispatch audit's knobs (``ANALYSIS_JAXPR_MODEL`` /
``_SPECS`` / ``_R_BUCKETS`` / ``_PACKED_BUCKETS``) are documented in
``dispatch_audit.py``.  ``--no-mesh``, ``ANALYSIS_SKIP_MESH`` and the
mesh audit's knobs (``ANALYSIS_MESH_*``, ``ANALYSIS_BUDGETS``,
``ANALYSIS_ROOFLINE``) are accepted so that scripts written for the
reference keep working; the port serves one card, so the mesh audit
waits for the multi-device slice (ROADMAP queue 1, item 9), and the
report says so rather than skipping it in silence.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

from .engine import (
    apply_baseline,
    default_baseline_path,
    load_baseline,
    run_lint,
)

# the reference's mesh-audit knobs, read only to report them
MESH_KNOBS = (
    "ANALYSIS_MESH_MODEL",
    "ANALYSIS_MESH_DP",
    "ANALYSIS_MESH_TP",
    "ANALYSIS_MESH_SP",
    "ANALYSIS_MESH_SPECS",
    "ANALYSIS_MESH_R_BUCKETS",
    "ANALYSIS_MESH_PACKED_BUCKETS",
    "ANALYSIS_MESH_RING_BUCKETS",
    "ANALYSIS_BUDGETS",
    "ANALYSIS_ROOFLINE",
)
MESH_NOTE = (
    "mesh audit: not run — the port serves one card; the sharding/"
    "resource audit waits for the multi-device slice (ROADMAP queue 1, "
    "item 9)"
)


def mesh_status(skip: bool) -> dict:
    """What the CLI says of the mesh audit: skipped on request, or
    waiting for ROADMAP item 9 (with the mesh knobs that were set)."""
    knobs = sorted(k for k in MESH_KNOBS if os.environ.get(k))
    return {
        "run": False,
        "skipped": skip,
        "reason": "skipped" if skip else MESH_NOTE,
        "knobs_set": knobs,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m llm_weighted_consensus_tpu_torch.analysis",
        description="first-party invariant checker (AST lint + dispatch "
        "audit)",
    )
    parser.add_argument(
        "paths", nargs="*", type=Path,
        help="lint only these files (default: the whole package)",
    )
    parser.add_argument(
        "--no-jaxpr", action="store_true",
        help="skip the dispatch audit, the counterpart of the reference's "
        "jaxpr audit (ANALYSIS_SKIP_JAXPR=1)",
    )
    parser.add_argument(
        "--no-mesh", action="store_true",
        help="accepted for the reference's scripts; the mesh audit waits "
        "for ROADMAP item 9 (ANALYSIS_SKIP_MESH=1)",
    )
    parser.add_argument(
        "--no-concurrency", action="store_true",
        help="skip the concurrency-discipline audit, rules LWC014-016 "
        "(ANALYSIS_SKIP_CONCURRENCY=1)",
    )
    parser.add_argument(
        "--baseline", type=Path, default=None,
        help="suppression baseline (default analysis/baseline.json; "
        "ANALYSIS_BASELINE overrides)",
    )
    parser.add_argument(
        "--rules", default=None,
        help="comma-separated lint rule subset, e.g. LWC001,LWC003",
    )
    parser.add_argument(
        "--json", action="store_true", help="machine-readable output"
    )
    parser.add_argument(
        "--list-rules", action="store_true", help="print the rule catalogue"
    )
    args = parser.parse_args(argv)

    from .rules import ALL_RULES, RULES_BY_NAME

    if args.list_rules:
        for rule in ALL_RULES:
            print(f"{rule.name}  {rule.summary}")
        return 0

    rules = list(ALL_RULES)
    if args.rules:
        try:
            rules = [RULES_BY_NAME[n.strip()] for n in args.rules.split(",")]
        except KeyError as exc:
            print(f"unknown rule {exc}", file=sys.stderr)
            return 2

    # the concurrency trio runs as its own timed pass (bench/host.py
    # --analysis-time reports it beside the lint and the audit)
    conc_names = {"LWC014", "LWC015", "LWC016"}
    skip_conc = args.no_concurrency or bool(
        os.environ.get("ANALYSIS_SKIP_CONCURRENCY")
    )
    conc_rules = [r for r in rules if r.name in conc_names]
    base_rules = [r for r in rules if r.name not in conc_names]

    t0 = time.perf_counter()
    findings = run_lint(paths=args.paths or None, rules=base_rules)
    lint_s = time.perf_counter() - t0

    concurrency_s = 0.0
    if conc_rules and not skip_conc:
        t0 = time.perf_counter()
        findings += run_lint(paths=args.paths or None, rules=conc_rules)
        concurrency_s = time.perf_counter() - t0
        findings.sort(key=lambda f: (f.path, f.line, f.rule))

    audit_s = 0.0
    skip_audit = args.no_jaxpr or bool(os.environ.get("ANALYSIS_SKIP_JAXPR"))
    if not skip_audit:
        from .dispatch_audit import run_dispatch_audit

        t0 = time.perf_counter()
        findings += run_dispatch_audit()
        audit_s = time.perf_counter() - t0

    mesh = mesh_status(
        args.no_mesh or bool(os.environ.get("ANALYSIS_SKIP_MESH"))
    )

    baseline_path = args.baseline or (
        Path(os.environ["ANALYSIS_BASELINE"])
        if os.environ.get("ANALYSIS_BASELINE")
        else default_baseline_path()
    )
    try:
        baseline = load_baseline(baseline_path)
    except ValueError as exc:
        print(f"baseline error: {exc}", file=sys.stderr)
        return 2
    kept, suppressed, stale = apply_baseline(findings, baseline)

    if args.json:
        print(
            json.dumps(
                {
                    "findings": [vars(f) for f in kept],
                    "suppressed": [vars(f) for f in suppressed],
                    "stale_baseline": stale,
                    "lint_seconds": round(lint_s, 3),
                    "concurrency_seconds": round(concurrency_s, 3),
                    "audit_seconds": round(audit_s, 3),
                    "audit_run": not skip_audit,
                    "mesh": mesh,
                }
            )
        )
    else:
        for finding in kept:
            print(finding.render())
        summary = (
            f"analysis: {len(kept)} finding(s), {len(suppressed)} "
            f"baselined, lint {lint_s:.2f}s"
        )
        if conc_rules and not skip_conc:
            summary += f", concurrency audit {concurrency_s:.2f}s"
        if not skip_audit:
            summary += f", dispatch audit {audit_s:.2f}s"
        print(summary, file=sys.stderr)
        print(mesh["reason"] if not mesh["skipped"]
              else "mesh audit: skipped", file=sys.stderr)

    if stale:
        for entry in stale:
            print(
                "stale baseline entry (the finding it suppressed is "
                f"gone — delete it): {json.dumps(entry)}",
                file=sys.stderr,
            )
        return 2
    return 1 if kept else 0


if __name__ == "__main__":
    sys.exit(main())
