"""Per-bucket resource budgets for the mesh audit (JXA009/JXA010).

The port's copy of ``llm_weighted_consensus_tpu/analysis/budgets.py``,
with the port's own figures.  ``analysis/budgets.json`` commits, for
every padded, packed, ring and reward bucket the mesh audit dispatches,
one shard's resource envelope: ``hbm_bytes`` (the shard's parameter
bytes plus its argument and output bytes), ``flops`` and
``bytes_accessed`` (``analysis/cost.py``'s count of one shard's share,
the roofline's count: torch has no ``cost_analysis``).  The reference's
figures are XLA's and none is carried over.  The audit re-measures on
every run and compares here:

* **JXA009 budget breach**: a measured figure above its committed value
  by more than the tolerance band (the serving path grew); shrinking
  below the band is reported too, as a prompt to re-baseline;
* **JXA010 coverage drift**: an audited bucket with no committed budget,
  a committed bucket the audit no longer dispatches, or a scope (model,
  mesh shape, buckets) other than the audited one.

Re-baselining is deliberate: ``python -m
llm_weighted_consensus_tpu_torch.analysis.mesh_audit --write-budgets``
rewrites the file from fresh measurements (tolerance, threshold and
allowlist kept); the diff shows every figure that moved.

Stdlib only (json, pathlib, re); the measurement lives in
``mesh_audit.py``.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from .engine import Finding

# figures compared against the committed budget, in render order
METRICS = ("hbm_bytes", "flops", "bytes_accessed")

DEFAULT_TOLERANCE = 0.25  # the reference's band: the counts are exact,
# so the band only decides how large a change must be re-baselined


def default_budgets_path() -> Path:
    return Path(__file__).resolve().parent / "budgets.json"


def load_budgets(path: Optional[Path] = None) -> dict:
    path = path or default_budgets_path()
    if not path.exists():
        return {}
    return json.loads(path.read_text(encoding="utf-8"))


def scope_of(budgets: dict) -> dict:
    return budgets.get("scope", {})


def tolerance_of(budgets: dict, metric: str) -> float:
    return float(
        budgets.get("tolerance", {}).get(metric, DEFAULT_TOLERANCE)
    )


def compare_budgets(
    measured: Dict[str, Dict[str, float]],
    budgets: dict,
    scope: Optional[dict] = None,
) -> List[Finding]:
    """Measured per-bucket figures vs the committed file.

    ``measured`` maps bucket label -> {metric: value}.  ``scope`` is the
    audit's current (model, mesh, ...) identity; when it differs from
    the committed scope the figures aren't comparable and the whole file
    is reported as one JXA010 finding instead of N bogus breaches."""
    findings: List[Finding] = []
    committed = budgets.get("buckets", {})
    if not budgets:
        findings.append(
            Finding(
                rule="JXA010",
                path="analysis/budgets.json",
                line=0,
                message=(
                    "no committed budgets: run `python -m "
                    "llm_weighted_consensus_tpu_torch.analysis.mesh_audit "
                    "--write-budgets` and commit the result so capacity "
                    "regressions fail CI"
                ),
            )
        )
        return findings
    if scope is not None and scope_of(budgets) != scope:
        findings.append(
            Finding(
                rule="JXA010",
                path="analysis/budgets.json",
                line=0,
                message=(
                    f"committed budget scope {scope_of(budgets)} does not "
                    f"match the audited configuration {scope}; re-baseline "
                    "with --write-budgets under the new configuration"
                ),
            )
        )
        return findings
    for label, figures in sorted(measured.items()):
        entry = committed.get(label)
        if entry is None:
            findings.append(
                Finding(
                    rule="JXA010",
                    path="analysis/budgets.json",
                    line=0,
                    message=(
                        f"audited bucket `{label}` has no committed "
                        "budget entry; measure and commit it "
                        "(--write-budgets)"
                    ),
                )
            )
            continue
        for metric in METRICS:
            if metric not in figures or metric not in entry:
                continue
            got, want = float(figures[metric]), float(entry[metric])
            if want <= 0:
                continue
            band = tolerance_of(budgets, metric)
            ratio = got / want
            if ratio > 1.0 + band:
                findings.append(
                    Finding(
                        rule="JXA009",
                        path="analysis/budgets.json",
                        line=0,
                        symbol=label,
                        message=(
                            f"`{label}` {metric} measured {got:.0f} vs "
                            f"budget {want:.0f} ({ratio:.2f}x, band "
                            f"±{band:.0%}): the serving path outgrew its "
                            "committed resource envelope"
                        ),
                    )
                )
            elif ratio < 1.0 - band:
                findings.append(
                    Finding(
                        rule="JXA009",
                        path="analysis/budgets.json",
                        line=0,
                        symbol=label,
                        message=(
                            f"`{label}` {metric} measured {got:.0f} vs "
                            f"budget {want:.0f} ({ratio:.2f}x, band "
                            f"±{band:.0%}): the path shrank well below "
                            "budget — re-baseline so the envelope stays "
                            "tight"
                        ),
                    )
                )
    for label in sorted(committed):
        if label not in measured:
            findings.append(
                Finding(
                    rule="JXA010",
                    path="analysis/budgets.json",
                    line=0,
                    symbol=label,
                    message=(
                        f"stale budget entry `{label}`: the audit no "
                        "longer lowers this bucket — delete the entry "
                        "(budgets only ever shrink honestly)"
                    ),
                )
            )
    return findings


def replicated_allowlist(budgets: dict) -> List[dict]:
    return budgets.get("replicated_allowlist", [])


def replicated_threshold(budgets: dict) -> int:
    return int(budgets.get("replicated_threshold_bytes", 1 << 20))


def check_allowlist_stale(
    allowlist: Sequence[dict], matched_patterns: set
) -> List[Finding]:
    """Allowlist rows whose pattern matched no oversized-replicated leaf
    in the whole audit — stale permission that would silently cover a
    future regression (JXA010, same delete-it contract as budgets)."""
    findings: List[Finding] = []
    for entry in allowlist:
        if entry.get("pattern") not in matched_patterns:
            findings.append(
                Finding(
                    rule="JXA010",
                    path="analysis/budgets.json",
                    line=0,
                    symbol=entry.get("pattern"),
                    message=(
                        "stale replicated_allowlist entry "
                        f"`{entry.get('pattern')}`: it matches no "
                        "oversized replicated tensor anymore — delete it"
                    ),
                )
            )
    return findings


def allowlisted(path: str, allowlist: Sequence[dict]) -> Optional[str]:
    """First allowlist pattern fully matching the leaf path, or None."""
    for entry in allowlist:
        pattern = entry.get("pattern", "")
        if pattern and re.fullmatch(pattern, path):
            return pattern
    return None
