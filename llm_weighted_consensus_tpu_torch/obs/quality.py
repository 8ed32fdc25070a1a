"""Consensus-quality telemetry: judge scorecards, agreement, drift.

The port's copy of ``llm_weighted_consensus_tpu/obs/quality.py``, pure
Python over Decimal and float, so its snapshots equal the reference's on
the same outcomes.  Every scored request lands one ``observe_outcome``
at the tally seam in ``clients/score.py``, feeding:

* **Per-judge scorecards** — agreement-with-final-consensus rate,
  top-1 calibration bins (the ``top_logprobs`` vote mass a judge put on
  its own pick vs whether that pick won) and ECE, vote entropy, hedge,
  abstain, error and cancelled rates, and the judge's share of the
  consensus weight.  Weight sums stay ``Decimal`` and only the snapshot
  edge converts to float.
* **Pairwise inter-judge agreement** — Cohen's kappa over shared
  ballots, chance-corrected per pair by each judge's pick marginals.
* **Drift detection** — a sliding window of recent ballots per judge; a
  judge is flagged when its windowed agreement rate or windowed
  vote-mass-on-winner drops more than ``drift_threshold`` below its
  baseline (everything before the window).  Deterministic: no decay, no
  randomness.
* **Consensus-health SLIs** — the confidence-margin (top1 − top2)
  histogram on the shared log-bucket layout (``obs/histogram.py``), and
  the scored / degraded / quorum-degraded / all-failed outcome counters.

Aggregation is process-global, lock-guarded (the tally seam runs on the
chat routes' loop thread, the read side on handler threads) and
O(judges × choices) per request, the same work the tally already does.
It is always on, like the phase aggregate: ``QUALITY_WINDOW`` and
``QUALITY_DRIFT_THRESHOLD`` only tune it (``configure_quality``).
"""

from __future__ import annotations

import math
import threading
import time
from collections import Counter, deque
from decimal import Decimal
from typing import Dict, List, Optional, Tuple

from .histogram import Histogram

# fixed calibration layout: 10 equal-width bins over vote mass [0, 1]
N_CALIBRATION_BINS = 10

# outcome vocabulary rendered by the ``quality`` /metrics section and
# the ``lwc_consensus_outcomes`` Prometheus counter
OUTCOMES = ("scored", "degraded", "quorum_degraded", "all_failed")


class JudgeBallot:
    """One judge's contribution to one scored request, captured at the
    tally seam BEFORE the per-chunk deltas are cleared.

    ``vote`` is the soft-vote vector as *floats*: the seam converts the
    Decimal vote exactly once (shared with the ledger record) because
    every per-ballot statistic here is float math — only ``weight``
    stays Decimal, it feeds the exact weight-contribution share."""

    __slots__ = ("model", "model_index", "weight", "vote", "error_code")

    def __init__(
        self,
        model: str,
        model_index: int,
        weight: Decimal,
        vote: Optional[List[float]],
        error_code: Optional[int] = None,
    ) -> None:
        self.model = model
        self.model_index = model_index
        self.weight = weight
        self.vote = vote
        self.error_code = error_code


class Outcome:
    """One scored request's consensus verdict, as seen by the tally."""

    __slots__ = (
        "winner",
        "margin",
        "weight_sum",
        "n_choices",
        "degraded",
        "quorum_degraded",
        "all_failed",
        "trace_id",
        "judges",
    )

    def __init__(
        self,
        winner: Optional[int],
        margin: Optional[float],
        weight_sum: Decimal,
        n_choices: int,
        degraded: bool,
        quorum_degraded: bool,
        all_failed: bool,
        trace_id: Optional[str],
        judges: List[JudgeBallot],
    ) -> None:
        self.winner = winner
        self.margin = margin
        self.weight_sum = weight_sum
        self.n_choices = n_choices
        self.degraded = degraded
        self.quorum_degraded = quorum_degraded
        self.all_failed = all_failed
        self.trace_id = trace_id
        self.judges = judges


class _JudgeCard:
    """Running per-judge aggregates; all counters O(1) per ballot."""

    __slots__ = (
        "model",
        "seen",
        "voted",
        "agreements",
        "abstains",
        "errors",
        "cancelled",
        "hedges",
        "entropy_sum",
        "weight_contrib",
        "panel_weight",
        "bins",
        "window",
        "agree_total",
        "mass_total",
    )

    def __init__(self, model: str, window: int) -> None:
        self.model = model
        self.seen = 0  # ballots the judge appeared in at all
        self.voted = 0  # ballots with a usable vote vector
        self.agreements = 0
        self.abstains = 0
        self.errors = 0
        self.cancelled = 0
        self.hedges = 0
        self.entropy_sum = 0.0
        # Decimal-exact running sums: converted to float only at the
        # snapshot edge
        self.weight_contrib = Decimal(0)
        self.panel_weight = Decimal(0)
        # top-1 calibration: per-bin [count, top-pick mass sum, wins]
        self.bins = [[0, 0.0, 0] for _ in range(N_CALIBRATION_BINS)]
        # drift: recent (agree_bit, mass_on_winner) pairs
        self.window: deque = deque(maxlen=max(1, int(window)))
        self.agree_total = 0
        self.mass_total = 0.0

    # -- drift ---------------------------------------------------------------

    def drift(self, threshold: float) -> dict:
        """Windowed-vs-baseline comparison; flagged only once both the
        window AND the baseline hold a full window of ballots, so a
        cold judge is never flagged on noise."""
        filled = len(self.window)
        cap = self.window.maxlen or 1
        recent_agree = sum(b for b, _ in self.window)
        recent_mass = sum(m for _, m in self.window)
        base_n = self.voted - filled
        out: dict = {
            "flagged": False,
            "window_fill": filled,
            "window": cap,
        }
        if filled:
            out["recent_agreement"] = round(recent_agree / filled, 4)
            out["recent_mass_on_winner"] = round(recent_mass / filled, 4)
        if base_n > 0:
            base_agree = (self.agree_total - recent_agree) / base_n
            base_mass = (self.mass_total - recent_mass) / base_n
            out["baseline_agreement"] = round(base_agree, 4)
            out["baseline_mass_on_winner"] = round(base_mass, 4)
            if filled >= cap and base_n >= cap:
                agree_drop = base_agree - recent_agree / filled
                mass_drop = base_mass - recent_mass / filled
                out["flagged"] = (
                    agree_drop > threshold or mass_drop > threshold
                )
                out["agreement_drop"] = round(agree_drop, 4)
                out["mass_drop"] = round(mass_drop, 4)
        return out

    # -- snapshot ------------------------------------------------------------

    def calibration(self) -> dict:
        """Top-1 reliability diagram + ECE: each voted ballot lands in
        the bin of the mass the judge put on its own pick; ``win_rate``
        is how often that pick was the consensus winner."""
        total = sum(b[0] for b in self.bins)
        rows = []
        ece = 0.0
        for i, (count, p_sum, wins) in enumerate(self.bins):
            if not count:
                continue
            p_avg = p_sum / count
            win_rate = wins / count
            ece += (count / total) * abs(p_avg - win_rate)
            rows.append(
                {
                    "le": round((i + 1) / N_CALIBRATION_BINS, 1),
                    "count": count,
                    "p_avg": round(p_avg, 4),
                    "win_rate": round(win_rate, 4),
                }
            )
        return {
            "samples": total,
            "ece": round(ece, 4) if total else None,
            "bins": rows,
        }

    def scorecard(self, threshold: float) -> dict:
        seen = self.seen
        voted = self.voted
        out = {
            "model": self.model,
            "ballots": seen,
            "voted": voted,
            "agreement_rate": (
                round(self.agreements / voted, 4) if voted else None
            ),
            "entropy_mean": (
                round(self.entropy_sum / voted, 4) if voted else None
            ),
            "hedge_rate": round(self.hedges / voted, 4) if voted else None,
            "abstain_rate": round(self.abstains / seen, 4) if seen else None,
            "error_rate": round(self.errors / seen, 4) if seen else None,
            "cancelled_rate": (
                round(self.cancelled / seen, 4) if seen else None
            ),
            "weight_share": (
                float(self.weight_contrib / self.panel_weight)
                if self.panel_weight > 0
                else None
            ),
            "calibration": self.calibration(),
            "drift": self.drift(threshold),
        }
        return out


class _PairStats:
    """Shared-ballot tallies for one (judge, judge) pair's kappa."""

    __slots__ = ("count", "agree", "marg_a", "marg_b")

    def __init__(self) -> None:
        self.count = 0
        self.agree = 0
        self.marg_a: Counter = Counter()
        self.marg_b: Counter = Counter()

    def kappa(self) -> Optional[float]:
        """Cohen's kappa: observed agreement corrected for the chance
        agreement implied by each judge's own pick marginals."""
        if not self.count:
            return None
        po = self.agree / self.count
        pe = sum(
            (self.marg_a[k] / self.count) * (self.marg_b[k] / self.count)
            for k in self.marg_a
            if k in self.marg_b
        )
        if pe >= 1.0:
            # degenerate marginals (both judges always pick the same
            # single candidate): agreement is total, chance is total
            return 1.0 if po >= 1.0 else 0.0
        return (po - pe) / (1.0 - pe)


class QualityAggregator:
    """Process-global consensus-quality aggregates.

    Lock-guarded like ``PhaseAggregator``: the tally seam runs on the
    chat routes' loop thread, and the read side (the metrics renderer,
    ``/v1/judges``) on handler threads must never race an observe."""

    def __init__(
        self, window: int = 64, drift_threshold: float = 0.25
    ) -> None:
        self._lock = threading.Lock()
        self.window = max(1, int(window))
        self.drift_threshold = float(drift_threshold)
        self._judges: Dict[str, _JudgeCard] = {}
        self._pairs: Dict[Tuple[str, str], _PairStats] = {}
        self._margin = Histogram()
        self._outcomes: Counter = Counter()
        self._requests = 0
        self._exemplar: Optional[Tuple[str, float, float]] = None

    def configure(
        self,
        window: Optional[int] = None,
        drift_threshold: Optional[float] = None,
    ) -> None:
        """Apply config knobs to the singleton; existing drift windows
        are re-bounded in place."""
        with self._lock:
            if window is not None:
                self.window = max(1, int(window))
                for card in self._judges.values():
                    card.window = deque(card.window, maxlen=self.window)
            if drift_threshold is not None:
                self.drift_threshold = float(drift_threshold)

    # -- write side (the tally seam) -----------------------------------------

    def observe_outcome(self, outcome: Outcome) -> None:
        with self._lock:
            self._requests += 1
            if outcome.all_failed:
                self._outcomes["all_failed"] += 1
            else:
                self._outcomes["scored"] += 1
            if outcome.degraded:
                self._outcomes["degraded"] += 1
            if outcome.quorum_degraded:
                self._outcomes["quorum_degraded"] += 1
            if outcome.margin is not None:
                self._margin.observe(outcome.margin)
                if outcome.trace_id:
                    self._exemplar = (
                        outcome.trace_id,
                        outcome.margin,
                        time.time(),
                    )
            winner = outcome.winner
            n = outcome.n_choices
            picks: List[Tuple[str, int]] = []
            for ballot in outcome.judges:
                card = self._judges.get(ballot.model)
                if card is None:
                    card = self._judges[ballot.model] = _JudgeCard(
                        ballot.model, self.window
                    )
                card.seen += 1
                vote = ballot.vote
                if vote is None:
                    if ballot.error_code == 499:
                        card.cancelled += 1
                    elif ballot.error_code is not None:
                        card.errors += 1
                    else:
                        card.abstains += 1
                    continue
                card.voted += 1
                card.weight_contrib += ballot.weight
                card.panel_weight += outcome.weight_sum
                # the vote is already floats (converted once at the
                # seam); per-ballot statistics are two O(n) passes
                # (argmax + entropy) and O(1) updates, once per judge
                # per scored request
                pick = 0
                best = vote[0]
                entropy = 0.0
                for i in range(1, len(vote)):
                    p = vote[i]
                    if p > best:
                        pick = i
                        best = p
                if n > 1:
                    for p in vote:
                        if p > 0.0:
                            entropy -= p * math.log(p)
                    entropy /= math.log(n)
                card.entropy_sum += entropy
                picks.append((ballot.model, pick))
                if best < 0.5:
                    card.hedges += 1
                agree = 1 if winner is not None and pick == winner else 0
                card.agreements += agree
                mass = vote[winner] if winner is not None else 0.0
                card.window.append((agree, mass))
                card.agree_total += agree
                card.mass_total += mass
                if winner is not None:
                    # top-1 calibration (standard ECE): bin the mass
                    # the judge put on its own pick vs "was the pick
                    # the consensus winner" — the "says 0.9, right 60%
                    # of the time" signal, O(1) per ballot
                    p = 0.0 if best < 0.0 else (1.0 if best > 1.0 else best)
                    idx = int(p * N_CALIBRATION_BINS)
                    if idx >= N_CALIBRATION_BINS:
                        idx = N_CALIBRATION_BINS - 1
                    b = card.bins[idx]
                    b[0] += 1
                    b[1] += p
                    b[2] += agree
            # pairwise agreement over shared ballots
            picks.sort()
            for i in range(len(picks)):
                model_a, pick_a = picks[i]
                for j in range(i + 1, len(picks)):
                    model_b, pick_b = picks[j]
                    pair = self._pairs.get((model_a, model_b))
                    if pair is None:
                        pair = self._pairs[(model_a, model_b)] = (
                            _PairStats()
                        )
                    pair.count += 1
                    pair.marg_a[pick_a] += 1
                    pair.marg_b[pick_b] += 1
                    if pick_a == pick_b:
                        pair.agree += 1

    # -- read side ------------------------------------------------------------

    def scorecard(self, model: str) -> Optional[dict]:
        with self._lock:
            card = self._judges.get(model)
            if card is None:
                return None
            return card.scorecard(self.drift_threshold)

    def scorecards(self) -> List[dict]:
        with self._lock:
            threshold = self.drift_threshold
            return [
                card.scorecard(threshold)
                for _, card in sorted(self._judges.items())
            ]

    def snapshot(self) -> dict:
        """The /metrics ``quality`` section."""
        with self._lock:
            requests = self._requests
            outcomes = {k: self._outcomes.get(k, 0) for k in OUTCOMES}
            margin = self._margin.to_json_obj()
            threshold = self.drift_threshold
            judges = {
                model: card.scorecard(threshold)
                for model, card in sorted(self._judges.items())
            }
            kappa = {
                f"{a}|{b}": {
                    "ballots": pair.count,
                    "kappa": (
                        round(pair.kappa(), 4)
                        if pair.kappa() is not None
                        else None
                    ),
                }
                for (a, b), pair in sorted(self._pairs.items())
            }
        out = {
            "requests": requests,
            "outcomes": outcomes,
            "degraded_rate": (
                round(outcomes["degraded"] / requests, 4) if requests else None
            ),
            "quorum_degraded_rate": (
                round(outcomes["quorum_degraded"] / requests, 4)
                if requests
                else None
            ),
            "all_failed_rate": (
                round(outcomes["all_failed"] / requests, 4)
                if requests
                else None
            ),
            "confidence_margin": margin,
            "window": self.window,
            "drift_threshold": threshold,
            "judges": judges,
            "pairwise_kappa": kappa,
            "flagged": [
                m for m, c in judges.items() if c["drift"]["flagged"]
            ],
        }
        return out

    def summary(self) -> dict:
        """Compact consensus-quality summary for BENCH records: the
        three numbers a bench reader wants next to a latency figure."""
        with self._lock:
            requests = self._requests
            degraded = self._outcomes.get("degraded", 0)
            median = self._margin.quantile(0.5)
            threshold = self.drift_threshold
            rates = [
                card.agreements / card.voted
                for card in self._judges.values()
                if card.voted
            ]
            flagged = [
                card.model
                for card in self._judges.values()
                if card.drift(threshold)["flagged"]
            ]
        return {
            "requests": requests,
            "degraded_rate": (
                round(degraded / requests, 4) if requests else None
            ),
            "median_confidence_margin": (
                round(median, 4) if median is not None else None
            ),
            "judge_agreement_spread": (
                round(max(rates) - min(rates), 4) if rates else None
            ),
            "flagged_judges": sorted(flagged),
        }

    def prom_snapshot(self) -> dict:
        """Cloned margin histogram + flat per-judge gauges for the
        Prometheus renderer — clones and plain floats, so rendering
        never races an observe."""
        with self._lock:
            threshold = self.drift_threshold
            return {
                "margin": Histogram().merge(self._margin),
                "exemplar": self._exemplar,
                "outcomes": {k: self._outcomes.get(k, 0) for k in OUTCOMES},
                "agreement": {
                    model: card.agreements / card.voted
                    for model, card in sorted(self._judges.items())
                    if card.voted
                },
                "drift_flagged": {
                    model: 1.0 if card.drift(threshold)["flagged"] else 0.0
                    for model, card in sorted(self._judges.items())
                },
            }

    def reset(self) -> None:
        with self._lock:
            self._judges.clear()
            self._pairs.clear()
            self._margin = Histogram()
            self._outcomes.clear()
            self._requests = 0
            self._exemplar = None


_AGG = QualityAggregator()


def quality_aggregator() -> QualityAggregator:
    return _AGG


def observe_outcome(outcome: Outcome) -> None:
    _AGG.observe_outcome(outcome)


def quality_snapshot() -> dict:
    return _AGG.snapshot()


def quality_summary() -> dict:
    return _AGG.summary()


def configure_quality(
    window: Optional[int] = None,
    drift_threshold: Optional[float] = None,
) -> None:
    _AGG.configure(window=window, drift_threshold=drift_threshold)


def reset_quality() -> None:
    _AGG.reset()
