"""Weight-quorum graceful degradation.

The consensus argmax is over ``choice_weight[i] = Σ vote_j[i] · w_j``.
A judge that has not settled yet can move any single candidate by at
most its full weight (votes are distributions, each component ≤ 1), so
once

    settled_weight ≥ fraction · total_weight          (quorum reached)
    leader_weight  >  runner_up + remaining_weight    (argmax locked)

no combination of straggler votes can flip the winner and the fan-out
may cancel them.  The flip test is strict (``>``): on a potential tie
we keep waiting — conservative, because a tie would renormalize to a
different confidence vector even if the argmax index survived.

Arithmetic is ``Decimal`` end to end, matching the host-side tally in
``clients/score.py`` exactly — the early-exit decision must agree with
the number the full panel would have produced.

The port's copy of ``llm_weighted_consensus_tpu/resilience/quorum.py``.
"""

from __future__ import annotations

from decimal import Decimal
from typing import Dict, Iterable, Optional, Set


class QuorumTracker:
    def __init__(
        self,
        weights_by_judge: Dict[int, Decimal],
        n_choices: int,
        fraction: float,
    ) -> None:
        self.weights = {int(k): Decimal(v) for k, v in weights_by_judge.items()}
        self.n_choices = int(n_choices)
        self.fraction = Decimal(str(fraction))
        self.total_weight = sum(self.weights.values(), Decimal(0))
        self.choice_weight = [Decimal(0)] * self.n_choices
        self._settled: Set[int] = set()
        self.settled_weight = Decimal(0)
        self.voted: Set[int] = set()
        self.errored: Set[int] = set()

    # -- outcome recording ----------------------------------------------------

    def record_vote(self, judge_index: int, vote: Iterable) -> None:
        """A judge's final frame arrived with a vote distribution."""
        if judge_index in self._settled:
            return
        self._mark_settled(judge_index)
        self.voted.add(judge_index)
        w = self.weights.get(judge_index, Decimal(0))
        for i, v in enumerate(vote):
            if i < self.n_choices:
                self.choice_weight[i] += Decimal(v) * w

    def record_error(self, judge_index: int) -> None:
        """A judge failed terminally: its outcome is known (contributes
        nothing) and its weight leaves the remaining pool."""
        if judge_index in self._settled:
            return
        self._mark_settled(judge_index)
        self.errored.add(judge_index)

    def _mark_settled(self, judge_index: int) -> None:
        self._settled.add(judge_index)
        self.settled_weight += self.weights.get(judge_index, Decimal(0))

    # -- the decision ---------------------------------------------------------

    def settled(self, judge_index: int) -> bool:
        return judge_index in self._settled

    @property
    def remaining_weight(self) -> Decimal:
        return self.total_weight - self.settled_weight

    def pending(self) -> Set[int]:
        return set(self.weights) - self._settled

    def leader(self) -> Optional[int]:
        if not any(w > 0 for w in self.choice_weight):
            return None
        return max(range(self.n_choices), key=lambda i: self.choice_weight[i])

    def decided(self) -> bool:
        """True when the stragglers mathematically cannot flip the argmax."""
        if self.fraction <= 0 or self.total_weight <= 0:
            return False
        if not self.pending():
            return False  # nothing left to cancel; let the merge finish
        if self.settled_weight < self.fraction * self.total_weight:
            return False
        lead = self.leader()
        if lead is None:
            return False
        runner_up = max(
            (w for i, w in enumerate(self.choice_weight) if i != lead),
            default=Decimal(0),
        )
        return self.choice_weight[lead] > runner_up + self.remaining_weight

    # -- observability --------------------------------------------------------

    def explain(self) -> dict:
        """The quorum decision as a trace attribute: why the fan-out was
        (or was not) cut.  Decimals stringified so the record survives
        JSON serialization without precision loss."""
        return {
            "settled_weight": str(self.settled_weight),
            "total_weight": str(self.total_weight),
            "remaining_weight": str(self.remaining_weight),
            "leader": self.leader(),
            "decided": self.decided(),
            "voted": sorted(self.voted),
            "errored": sorted(self.errored),
            "pending": sorted(self.pending()),
        }
