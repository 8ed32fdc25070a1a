"""Per-bucket speed-of-light roofline for the serving path.

The port's copy of ``llm_weighted_consensus_tpu/analysis/roofline.py``.
``roofline.json`` (beside this file) commits what is needed to compute
each serving bucket's speed-of-light (SoL) time on a backend:

* ``peaks``: per-device peak compute (``flops_per_sec``) and memory
  bandwidth (``hbm_bytes_per_sec``) per torch device type.  The ``cuda``
  row is one NVIDIA H100 SXM5 80GB from NVIDIA's data sheet (dense bf16
  989 TFLOP/s, HBM3 3.35 TB/s, at the full 700 W power limit); the
  ``cpu`` row is a deliberately rough figure so the gauge stays defined
  on a CPU run.  ``H100_PEAKS`` and ``H100_HBM_BYTES_PER_S`` are the
  card's peaks by type, the one source of the bounds ``chip_smoke.py``
  divides by;
* ``buckets``: per-bucket ``flops`` / ``bytes_accessed``, counted by
  ``cost.bucket_cost`` from the encoder's config and the bucket's shape.
  Rows are committed without a mesh suffix: the gauge scales the peaks
  by the device count parsed from a label's ``@dp{d}xtp{t}[xsp{s}]``
  suffix (``@dp1xtp1`` under ``MESH_ENABLED`` on one card).

``sol_ms = max(flops / (peak_flops * devices),
               bytes_accessed / (peak_bw * devices)) * 1e3``

The live gauge (``RooflineGauge``, the ``roofline`` /metrics section)
divides SoL by the measured device p50 per bucket from the phase
aggregator: ``attainment = sol_ms / device_p50_ms``; 1.0 is the
roofline, and more than 1.0 means a count or a timer is wrong.

``compare_roofline`` is the reference's JXA013 gate: a missing file, a
scope mismatch, a bucket without a row, a row without a bucket or a
figure drifted past the tolerance band all fail.  Re-baseline:
``python -m llm_weighted_consensus_tpu_torch.analysis.roofline --write``
(peaks and tolerance survive; figures do not); without ``--write`` it
checks the committed file against a fresh count.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

# figures a roofline row must carry
ROOFLINE_METRICS = ("flops", "bytes_accessed")

DEFAULT_TOLERANCE = 0.25

# NVIDIA H100 SXM5 80GB, data sheet, dense (no sparsity), at 700 W
H100_PEAKS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}
H100_HBM_BYTES_PER_S = 3.35e12

# committed starting peaks, per device, used when --write creates the
# file from scratch; the serving matmuls are bf16, so the bf16 peak
DEFAULT_PEAKS = {
    "cuda": {"flops_per_sec": H100_PEAKS["bfloat16"],
             "hbm_bytes_per_sec": H100_HBM_BYTES_PER_S},
    "cpu": {"flops_per_sec": 5.0e10, "hbm_bytes_per_sec": 2.0e10},
}

CLI = "python -m llm_weighted_consensus_tpu_torch.analysis.roofline --write"

# the committed scope: bge-large at the buckets chip_smoke.py's serving
# phase warms (WARMUP=64x128,16x512,32x64, WARMUP_R=2,4,8, and the
# packed buckets of its PACKING) and the fault phase's (8x32), and the
# buckets the mesh audit serves (analysis/mesh_audit.py JXA013: its
# specs, R buckets, packed and ring buckets)
DEFAULT_SCOPE = {
    "model": "bge-large-en",
    "dtype": "bfloat16",
    "max_tokens": 512,
    "specs": ["64x128", "16x512", "32x64", "8x32"],
    "r_buckets": [2, 4, 8],
    "packing": {"row_tokens": 512, "max_rows": 8, "max_segments": 64},
    "mesh_audit": {"specs": ["8x16"], "r_buckets": [2],
                   "packed_buckets": ["8x64x8"], "ring_buckets": ["2x64"]},
}

_MESH_SUFFIX = re.compile(
    r"^(?P<base>.+)@dp(?P<dp>\d+)xtp(?P<tp>\d+)(?:xsp(?P<sp>\d+))?$"
)


@dataclass
class Finding:
    """One violation of the roofline gate (the reference's
    ``analysis.engine.Finding`` fields)."""

    rule: str
    path: str
    line: int
    message: str
    symbol: Optional[str] = None


def default_roofline_path() -> Path:
    return Path(__file__).resolve().parent / "roofline.json"


def load_roofline(path: Optional[Path] = None) -> dict:
    path = path or default_roofline_path()
    if not path.exists():
        return {}
    return json.loads(path.read_text(encoding="utf-8"))


def split_label(label: str) -> Tuple[str, int]:
    """Device-timing label -> (committed row label, device count):
    ``vote1(n=8,s=16)@dp4xtp2`` -> (``vote1(n=8,s=16)``, 8), with the sp
    axis multiplying too; an unsuffixed label counts one device."""
    m = _MESH_SUFFIX.match(label)
    if m is None:
        return label, 1
    chips = int(m.group("dp")) * int(m.group("tp"))
    if m.group("sp"):
        chips *= int(m.group("sp"))
    return m.group("base"), chips


def sol_ms(figures: dict, peaks: dict, chips: int = 1) -> Optional[float]:
    """Speed-of-light time in ms of one bucket on ``chips`` devices of a
    backend described by ``peaks``; None when either side is
    unusable."""
    try:
        flops = float(figures["flops"])
        bytes_accessed = float(figures["bytes_accessed"])
        peak_flops = float(peaks["flops_per_sec"]) * max(1, chips)
        peak_bw = float(peaks["hbm_bytes_per_sec"]) * max(1, chips)
    except (KeyError, TypeError, ValueError):
        return None
    if peak_flops <= 0 or peak_bw <= 0:
        return None
    return max(flops / peak_flops, bytes_accessed / peak_bw) * 1e3


def tolerance_of(roofline: dict, metric: str) -> float:
    return float(roofline.get("tolerance", {}).get(metric, DEFAULT_TOLERANCE))


def _finding(message: str, symbol: Optional[str] = None) -> Finding:
    return Finding(rule="JXA013", path="analysis/roofline.json", line=0,
                   message=message, symbol=symbol)


def compare_roofline(
    measured: Dict[str, Dict[str, float]],
    roofline: dict,
    scope: Optional[dict] = None,
) -> List[Finding]:
    """Every counted bucket must have a live, in-band roofline row, both
    ways: the gauge is only as honest as this file."""
    findings: List[Finding] = []
    if not roofline:
        findings.append(_finding(
            f"no committed roofline: run `{CLI}` and commit the result so "
            "every AOT bucket reports a speed-of-light attainment gauge"))
        return findings
    if scope is not None and roofline.get("scope", {}) != scope:
        findings.append(_finding(
            f"committed roofline scope {roofline.get('scope', {})} does "
            f"not match the audited configuration {scope}; re-baseline "
            "with --write"))
        return findings
    peaks = roofline.get("peaks", {})
    for backend in DEFAULT_PEAKS:
        row = peaks.get(backend, {})
        if not all(float(row.get(k, 0)) > 0 for k in (
            "flops_per_sec", "hbm_bytes_per_sec"
        )):
            findings.append(_finding(
                f"peaks entry for backend `{backend}` is missing or "
                "non-positive; the attainment gauge needs per-chip "
                "flops_per_sec and hbm_bytes_per_sec", backend))
    committed = roofline.get("buckets", {})
    for label, figures in sorted(measured.items()):
        entry = committed.get(label)
        if entry is None:
            findings.append(_finding(
                f"audited bucket `{label}` has no roofline row; it would "
                "serve without an attainment gauge — re-baseline with "
                "--write", label))
            continue
        for metric in ROOFLINE_METRICS:
            if metric not in figures or metric not in entry:
                continue
            got, want = float(figures[metric]), float(entry[metric])
            if want <= 0:
                continue
            band = tolerance_of(roofline, metric)
            ratio = got / want
            if ratio > 1.0 + band or ratio < 1.0 - band:
                findings.append(_finding(
                    f"roofline row `{label}` {metric} is stale: measured "
                    f"{got:.0f} vs committed {want:.0f} ({ratio:.2f}x, "
                    f"band ±{band:.0%}) — the gauge would report "
                    "attainment against the wrong speed of light; "
                    "re-baseline with --write", label))
    for label in sorted(committed):
        if label not in measured:
            findings.append(_finding(
                f"stale roofline row `{label}`: the audit no longer "
                "lowers this bucket — delete the row", label))
    return findings


def write_roofline(
    path: Path,
    measured: Dict[str, Dict[str, float]],
    scope: dict,
    previous: dict,
) -> None:
    """Fresh figures under the committed policy knobs (peaks and
    tolerance survive a re-baseline; figures do not)."""
    payload = {
        "_doc": (
            "Committed per-bucket speed-of-light roofline (the JXA013 "
            "gate). peaks are PER-DEVICE; the runtime gauge scales by the "
            "dp*tp parsed from a serving label's mesh suffix. figures: "
            "analysis/cost.py's count from the encoder config and the "
            f"bucket shape. Re-baseline: {CLI}, then review the diff."
        ),
        "scope": scope,
        "tolerance": previous.get(
            "tolerance", {m: DEFAULT_TOLERANCE for m in ROOFLINE_METRICS}
        ),
        "peaks": previous.get("peaks", DEFAULT_PEAKS),
        "buckets": {
            label: {
                m: round(float(figures[m]), 1)
                for m in ROOFLINE_METRICS
                if m in figures
            }
            for label, figures in sorted(measured.items())
        },
    }
    path.write_text(json.dumps(payload, indent=2) + "\n", encoding="utf-8")


def scope_labels(scope: dict) -> List[str]:
    """The bucket labels a server warmed at ``scope`` dispatches
    (``TorchEmbedder.warmup``'s keys, as ``models/embedder.py`` labels
    them)."""
    from ..models.embedder import TorchEmbedder, _bucket, _seq_bucket
    from ..serve.config import ServeConfig

    cap = TorchEmbedder.MAX_DEVICE_BATCH
    labels = []
    for spec in scope["specs"]:
        n, s = (int(v) for v in spec.split("x"))
        s = _seq_bucket(s, scope["max_tokens"])
        labels.append(f"vote1(n={n},s={s})")
        labels.append(f"embed(b={_bucket(n, cap)},s={s})")
        labels += [f"many(r={r},n={n},s={s})"
                   for r in scope["r_buckets"] if r >= 2]
    packing = scope.get("packing")
    if packing:
        config = ServeConfig.from_env({
            "WARMUP": ",".join(scope["specs"]), "PACKING_ENABLED": "1",
            "PACKING_ROW_TOKENS": str(packing["row_tokens"]),
            "PACKING_MAX_ROWS": str(packing["max_rows"]),
            "PACKING_MAX_SEGMENTS": str(packing["max_segments"]),
        })
        labels += [f"packed(b={b},l={l},k={k})"
                   for b, l, k in config.packed_buckets()]
    audit = scope.get("mesh_audit")
    if audit:
        for spec in audit["specs"]:
            n, s = (int(v) for v in spec.split("x"))
            labels.append(f"vote1(n={n},s={s})")
            labels.append(f"embed(b={_bucket(n, cap)},s={s})")
            labels += [f"many(r={r},n={n},s={s})"
                       for r in audit["r_buckets"] if r >= 2]
        labels += ["packed(b={},l={},k={})".format(*spec.split("x"))
                   for spec in audit["packed_buckets"]]
        for spec in audit["ring_buckets"]:
            n, s = (int(v) for v in spec.split("x"))
            labels.append(f"ring_vote(n={n},s={s})")
            labels.append(f"ring(b={_bucket(n, cap)},s={s})")
    return sorted(set(labels))


def measure(scope: dict) -> Dict[str, Dict[str, float]]:
    """``cost.bucket_cost`` of every bucket of ``scope``."""
    from ..models.configs import PRESETS
    from .cost import bucket_cost

    config = PRESETS[scope["model"]]
    width = 2 if scope.get("dtype", "bfloat16") == "bfloat16" else 4
    return {label: bucket_cost(config, label, width)
            for label in scope_labels(scope)}


class RooflineGauge:
    """The live ``roofline`` /metrics section: per observed bucket
    device-time key, SoL time for the serving backend and ``attainment =
    sol_ms / device_p50_ms``."""

    def __init__(self, roofline: dict, backend: str) -> None:
        self._peaks = roofline.get("peaks", {}).get(backend)
        self._buckets = roofline.get("buckets", {})
        self._backend = backend

    def snapshot(self) -> dict:
        from ..obs import phases as _phases

        rows: Dict[str, dict] = {}
        for label, stats in _phases.aggregator().device_snapshot().items():
            base, chips = split_label(label)
            row = {"count": stats["count"]}
            p50 = stats.get("p50_ms")
            if p50 is not None:
                row["device_p50_ms"] = p50
            figures = self._buckets.get(base)
            if figures is not None and self._peaks is not None:
                sol = sol_ms(figures, self._peaks, chips)
                if sol is not None:
                    row["sol_ms"] = round(sol, 4)
                    if p50:
                        row["attainment"] = round(sol / p50, 4)
            rows[label] = row
        return {
            "backend": self._backend,
            "known_peaks": self._peaks is not None,
            "buckets": rows,
        }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m llm_weighted_consensus_tpu_torch.analysis.roofline",
        description="Check roofline.json against a fresh count of its "
        "scope's buckets, or re-write its rows (--write).")
    parser.add_argument("--write", action="store_true")
    args = parser.parse_args(argv)
    path = default_roofline_path()
    previous = load_roofline(path)
    scope = previous.get("scope", DEFAULT_SCOPE)
    measured = measure(scope)
    if args.write:
        write_roofline(path, measured, scope, previous)
        print(f"wrote {len(measured)} rows to {path}")
        return 0
    findings = compare_roofline(measured, previous, scope)
    for f in findings:
        print(f"{f.path}:{f.line}: {f.rule} [{f.symbol}]: {f.message}")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
