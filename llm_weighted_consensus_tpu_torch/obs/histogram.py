"""Mergeable log-bucketed latency histograms.

Counterpart of ``llm_weighted_consensus_tpu/obs/histogram.py``, the same
fixed exponential bucket layout, so two histograms merge exactly by
adding counts and the Prometheus exposition of both packages is the same
text for the same observations:

* ``observe`` is O(1): one ``log2``, one index increment;
* quantiles carry a bounded relative error: with growth ``2**(1/4)`` per
  bucket and the geometric-midpoint estimate the worst case is
  ``2**(1/8) - 1`` (~9.05%).

Every call site passes milliseconds; the layout spans 1 microsecond to
~17 minutes with an overflow bucket above.  Standard library only.
"""

from __future__ import annotations

import math
from typing import Iterator, List, Optional, Tuple

# Fixed layout shared by every instance: bucket ``i`` holds values in
# (BASE * GROWTH**(i-1), BASE * GROWTH**i]; bucket 0 holds (0, BASE].
# 4 buckets per octave = relative quantile error <= 2**(1/8) - 1.
BASE_MS = 1e-3
BUCKETS_PER_OCTAVE = 4
GROWTH = 2.0 ** (1.0 / BUCKETS_PER_OCTAVE)
# 30 octaves above BASE_MS: 1e-3 ms .. ~2**30 * 1e-3 ms (~17.9 min)
N_BUCKETS = 30 * BUCKETS_PER_OCTAVE + 1
_TOP_MS = BASE_MS * GROWTH ** (N_BUCKETS - 1)

# upper bound of bucket i, precomputed once (quantile + exposition)
_BOUNDS = tuple(BASE_MS * GROWTH**i for i in range(N_BUCKETS))


def bucket_index(value: float) -> int:
    """The fixed-layout bucket for ``value``: O(1), no search."""
    if value <= BASE_MS:
        return 0
    if value > _TOP_MS:
        return N_BUCKETS  # overflow (le = +Inf)
    idx = math.ceil(math.log2(value / BASE_MS) * BUCKETS_PER_OCTAVE)
    # float round-trip guard: log2 can land a boundary value one bucket
    # low/high; the invariant is bounds[idx-1] < value <= bounds[idx]
    if idx > 0 and value <= _BOUNDS[idx - 1]:
        idx -= 1
    elif value > _BOUNDS[min(idx, N_BUCKETS - 1)]:
        idx += 1
    return min(idx, N_BUCKETS)


class Histogram:
    """Counts + sum over the fixed log-bucket layout.

    Not thread-safe alone: ``serve.metrics.Metrics`` and the phase
    aggregator (``obs/phases.py``) observe under their own locks."""

    __slots__ = ("counts", "count", "sum")

    def __init__(self) -> None:
        # N_BUCKETS finite buckets + 1 overflow
        self.counts: List[int] = [0] * (N_BUCKETS + 1)
        self.count = 0
        self.sum = 0.0

    def observe(self, value: float) -> None:
        self.counts[bucket_index(value)] += 1
        self.count += 1
        self.sum += value

    def merge(self, other: "Histogram") -> "Histogram":
        """Elementwise-add ``other`` into self (exact: shared layout)."""
        counts = self.counts
        for i, c in enumerate(other.counts):
            if c:
                counts[i] += c
        self.count += other.count
        self.sum += other.sum
        return self

    def quantile(self, q: float) -> Optional[float]:
        """Bounded-error quantile: the geometric midpoint of the bucket
        containing rank ``ceil(q * count)``; None when empty."""
        if self.count == 0:
            return None
        rank = max(1, math.ceil(min(max(q, 0.0), 1.0) * self.count))
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank:
                if i >= N_BUCKETS:
                    return _TOP_MS  # overflow: the honest lower bound
                upper = _BOUNDS[i]
                lower = _BOUNDS[i - 1] if i > 0 else upper / GROWTH
                return math.sqrt(lower * upper)
        return _TOP_MS  # unreachable with a consistent count

    def mean(self) -> Optional[float]:
        return self.sum / self.count if self.count else None

    # -- exposition -----------------------------------------------------------

    def cumulative(self) -> Iterator[Tuple[str, int]]:
        """(le, cumulative count) pairs for Prometheus ``_bucket``
        rendering: only occupied buckets plus the mandatory ``+Inf``
        terminator, so the exposition stays proportional to the spread
        actually observed, not the 121-bucket layout."""
        seen = 0
        for i, c in enumerate(self.counts):
            if c:
                seen += c
                le = "+Inf" if i >= N_BUCKETS else _format_le(_BOUNDS[i])
                if i < N_BUCKETS:
                    yield le, seen
        yield "+Inf", self.count

    def to_json_obj(self) -> dict:
        """Compact JSON summary (the /metrics ``phases`` section rows)."""
        out = {
            "count": self.count,
            "sum_ms": round(self.sum, 3),
        }
        if self.count:
            out["p50_ms"] = round(self.quantile(0.5), 3)
            out["p99_ms"] = round(self.quantile(0.99), 3)
        return out


def _format_le(bound: float) -> str:
    """A stable short decimal for a bucket bound label."""
    return format(bound, ".6g")


def le_for(value: float) -> str:
    """The ``le`` label of the bucket ``value`` lands in, the bucket an
    exemplar of that latency belongs on."""
    idx = bucket_index(value)
    return "+Inf" if idx >= N_BUCKETS else _format_le(_BOUNDS[idx])
