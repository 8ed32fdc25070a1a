"""Versioned live judge-weight tables behind atomic hot-swap.

The port's copy of ``llm_weighted_consensus_tpu/weights/live.py``.  The
learner (``train/fit.py``) emits a per-judge weight table; this module
serves it to the scoring path without a restart:

* the **active** table overrides each judge's fetched weight (static or
  training-table) by judge id inside ``ScoreClient``'s tally, and the
  table's version is stamped on every ``consensus:tally`` span and
  ledger record.  A hot swap mid-stream is race-safe because the tally
  captures ``(weights, version)`` in one read before scoring;
* the **shadow** table never changes served results: at tally time the
  same ballots are re-tallied under it and the would-have-flipped and
  confidence-delta counters feed ``GET /v1/weights`` and ``/metrics``,
  so an operator can stage a candidate table against live traffic
  before promoting it.

Threads, not one loop: in the port a ``PUT /v1/weights`` runs on an HTTP
handler thread while the tally runs on the chat routes' loop thread, and
both touch the counters.  So one lock guards every write (the table
slots, the persisted file, the counters).  ``put`` still binds one
``_Table`` object in a single assignment and readers grab the whole
object once, so a reader never sees half a table.

Versions are content-addressed (``wv-`` + the first 12 hex of the
SHA-256 over the canonically serialized weights), byte for byte the
reference's, so re-PUTting the same table is idempotent and two replicas
of either package fitting the same ledger agree on the version string.
A file either package writes (``lwc.weights.v1``) loads in the other.
"""

from __future__ import annotations

import hashlib
import os
import threading
from decimal import Decimal, InvalidOperation
from typing import Optional

from ..utils import jsonutil
from ..utils.io import atomic_write

# the version stamped when no live table overrode the fetched weights
BASE_VERSION = "base"
SCHEMA = "lwc.weights.v1"


def weights_version(weights: dict) -> str:
    """Deterministic content-addressed version for a weight table."""
    canon = jsonutil.dumps(
        {str(k): str(Decimal(str(v))) for k, v in sorted(weights.items())}
    )
    return "wv-" + hashlib.sha256(canon.encode("utf-8")).hexdigest()[:12]


class _Table:
    """One immutable-by-convention (version, weights) pair."""

    __slots__ = ("version", "weights")

    def __init__(self, version: str, weights: dict) -> None:
        self.version = version
        self.weights = weights  # judge id -> Decimal

    def as_wire(self) -> dict:
        return {
            "version": self.version,
            "weights": {k: str(v) for k, v in self.weights.items()},
        }


def _parse_weights(raw: dict) -> dict:
    out = {}
    for judge_id, value in raw.items():
        try:
            weight = Decimal(str(value))
        except (InvalidOperation, ValueError, TypeError):
            raise ValueError(
                f"weight for judge {judge_id!r} is not numeric: {value!r}"
            )
        if not weight.is_finite() or weight < 0:
            raise ValueError(
                f"weight for judge {judge_id!r} must be finite and >= 0,"
                f" got {value!r}"
            )
        out[str(judge_id)] = weight
    return out


def table_document(active: Optional[dict], shadow: Optional[dict] = None
                   ) -> bytes:
    """The ``lwc.weights.v1`` file body of an active (and shadow) table,
    each ``{"version", "weights": {id: str}}`` or None."""
    return jsonutil.dumps(
        {"schema": SCHEMA, "active": active, "shadow": shadow}
    ).encode("utf-8")


class LiveWeightStore:
    """The active and shadow tables, their counters and their file; safe
    to call from any thread."""

    def __init__(self, path: Optional[str] = None) -> None:
        # WEIGHTS_PATH: tables survive a restart; None keeps them
        # process-local (PUT-only)
        self.path = path
        self._lock = threading.Lock()
        self._active: Optional[_Table] = None
        self._shadow: Optional[_Table] = None
        self.swaps = 0
        self.applied = 0
        # shadow-mode counters: requests compared, verdicts the shadow
        # table would have flipped, and the summed |top-confidence delta|
        # between the two tallies
        self.shadow_compared = 0
        self.shadow_would_flip = 0
        self.shadow_confidence_delta_sum = 0.0
        if path and os.path.exists(path):
            self._load(path)

    # -- swap side ------------------------------------------------------------

    def put(
        self,
        weights: dict,
        version: Optional[str] = None,
        mode: str = "active",
    ) -> str:
        """Install a table (validated, one-assignment swap) and persist
        when a path is configured.  Returns the installed version."""
        parsed = _parse_weights(weights)
        if not parsed:
            raise ValueError("weights table must name at least one judge")
        table = _Table(version or weights_version(parsed), parsed)
        if mode not in ("active", "shadow"):
            raise ValueError(f"mode must be active|shadow, got {mode!r}")
        with self._lock:
            if mode == "shadow":
                self._shadow = table
            else:
                self._active = table
            self.swaps += 1
            if self.path:
                self._save()
        return table.version

    def clear(self, mode: str = "shadow") -> None:
        with self._lock:
            if mode == "shadow":
                self._shadow = None
            else:
                self._active = None
            if self.path:
                self._save()

    # -- scoring side ---------------------------------------------------------

    @property
    def version(self) -> str:
        table = self._active
        return table.version if table is not None else BASE_VERSION

    def apply(self, model, weights: list) -> tuple:
        """Override the fetched per-judge weights with the active table:
        ``(weights, version)``, captured in ONE table read so a
        concurrent hot swap can never mix two versions inside a tally.
        Judges absent from the table keep their fetched weight; with no
        active table the fetched list passes through under ``base``."""
        table = self._active
        if table is None:
            return weights, BASE_VERSION
        out = list(weights)
        for llm in model.llms:
            override = table.weights.get(llm.id)
            if override is not None:
                out[llm.index] = override
        with self._lock:
            self.applied += 1
        return out, table.version

    def observe_shadow(self, ballots, n_choices: int) -> None:
        """Re-tally the request's ballots under the shadow table and
        record whether the verdict would flip (plus the top-confidence
        delta).  Host float math on data the tally already built, never
        on the served result's Decimal contract."""
        table = self._shadow
        if table is None or not ballots or n_choices <= 0:
            return
        active = [0.0] * n_choices
        shadow = [0.0] * n_choices
        voted = False
        for ballot in ballots:
            vote = ballot.vote
            if not vote:
                continue
            voted = True
            w_active = float(ballot.weight)
            w_shadow = float(table.weights.get(ballot.model, ballot.weight))
            for i in range(min(n_choices, len(vote))):
                active[i] += w_active * float(vote[i])
                shadow[i] += w_shadow * float(vote[i])
        if not voted:
            return
        win_active = max(range(n_choices), key=active.__getitem__)
        win_shadow = max(range(n_choices), key=shadow.__getitem__)
        sum_active = sum(active) or 1.0
        sum_shadow = sum(shadow) or 1.0
        delta = abs(
            shadow[win_shadow] / sum_shadow - active[win_active] / sum_active
        )
        with self._lock:
            self.shadow_compared += 1
            if win_active != win_shadow:
                self.shadow_would_flip += 1
            self.shadow_confidence_delta_sum += delta

    # -- persistence ----------------------------------------------------------

    # caller holds self._lock
    def _save(self) -> None:
        payload = table_document(
            self._active.as_wire() if self._active else None,
            self._shadow.as_wire() if self._shadow else None,
        )
        atomic_write(self.path, lambda f: f.write(payload))

    def _load(self, path: str) -> None:
        with open(path, encoding="utf-8") as f:
            doc = jsonutil.loads(f.read())
        for mode in ("active", "shadow"):
            entry = doc.get(mode)
            if not isinstance(entry, dict):
                continue
            weights = _parse_weights(entry.get("weights") or {})
            if not weights:
                continue
            table = _Table(
                entry.get("version") or weights_version(weights), weights
            )
            if mode == "active":
                self._active = table
            else:
                self._shadow = table

    # -- observability (metrics section "weights") ----------------------------

    def snapshot(self) -> dict:
        with self._lock:
            active, shadow = self._active, self._shadow
            return {
                "version": active.version if active else BASE_VERSION,
                "judges": len(active.weights) if active else 0,
                "shadow_version": shadow.version if shadow else None,
                "swaps": self.swaps,
                "applied": self.applied,
                "shadow_compared": self.shadow_compared,
                "shadow_would_flip": self.shadow_would_flip,
                "shadow_confidence_delta_sum": round(
                    self.shadow_confidence_delta_sum, 6
                ),
                "path": self.path,
            }

    def wire(self) -> dict:
        """The GET /v1/weights body."""
        with self._lock:
            active, shadow = self._active, self._shadow
            return {
                "version": active.version if active else BASE_VERSION,
                "weights": (
                    {k: str(v) for k, v in active.weights.items()}
                    if active
                    else {}
                ),
                "shadow": shadow.as_wire() if shadow else None,
                "shadow_compared": self.shadow_compared,
                "shadow_would_flip": self.shadow_would_flip,
            }
