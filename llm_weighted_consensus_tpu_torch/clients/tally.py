"""Fixed-point vectorized tally — the HOST_FASTPATH consensus fold.

The streaming tally folds every judge ballot into per-candidate weights:
``choice_weight[i] = Σ_k vote[k][i] * weight[k]`` over Decimal values
(clients/score.py, mirroring reference client.rs:384-416).  At panel
sizes that loop is J×N Decimal multiply-adds on the host critical path.
This module runs the same fold on scaled-int64 numpy vectors over
(judges × candidates) and reconstructs exact Decimals — the Decimal
fold stays the authority: any input the fixed-point lane cannot PROVE
it reproduces byte-for-byte makes :func:`fixed_point_fold` return None
and the caller re-runs the Decimal loop.  Exactness is proven, never
assumed; overflow falls back loudly, never drifts silently.

Why the reconstruction is exact (and byte-identical through
``format(d, "f")`` on the final frame):

* every ballot value ``d`` is gated to a finite int/Decimal and read as
  ``(coeff, exp)`` with ``d = coeff * 10**exp``;
* with ``Pv/Pw`` the largest vote/weight downscales, each value maps to
  the integer ``coeff * 10**(P + exp)`` (``P = Pv`` or ``Pw``), so the
  integer matrix product computes ``Σ v*w`` scaled by ``10**(Pv+Pw)``
  with no rounding anywhere;
* the Decimal fold is exact too **iff** no intermediate coefficient
  outgrows the context precision.  ``Σ_k max_i |v'| * |w'|`` bounds
  every intermediate sum *and* every product coefficient, so one gate —
  that bound must fit both the Decimal context precision and int64 —
  covers the whole fold.  A fold the gate rejects is one the Decimal
  loop may round, exactly when the fast lane must stand down;
* exact Decimal arithmetic lands on ideal exponents (``e1+e2`` for
  multiply, ``min(e1, e2)`` for add), so the fold's result exponent is
  ``E_i = min(0, min_k(exp_v[k][i] + exp_w[k]))`` — the 0 is the
  ``Decimal(0)`` accumulator the loop starts from.  The result is
  rebuilt at that exponent from the integer sum via the context-free
  ``Decimal((sign, digits, E_i))`` constructor (``scaleb`` would apply
  context rounding), preserving trailing zeros: ``0.5 + 0.5`` renders
  ``1.0``, not ``1``.

Parity with the Decimal fold across pathological weights (tiny, huge,
repeating-decimal, mixed exponents) is property-tested in
tests/test_host_fastpath.py; the port's copy of
``llm_weighted_consensus_tpu/clients/tally.py`` is held against it in
tests/test_torch_score.py.

The gate reads ``decimal.getcontext().prec``, which is per thread: the
port's tally runs on the chat routes' loop thread, whose context is the
default (28 digits) unless something sets it, as on the reference's loop.
"""

from __future__ import annotations

from decimal import Decimal, getcontext
from itertools import chain

import numpy as np

_D0 = Decimal(0)
# the scaled-product sum must stay provably below int64 wraparound
# (numpy overflows silently); 2**62 leaves headroom over the gate's
# own bound arithmetic
_I64_GUARD = 1 << 62


class _Unfit(Exception):
    """A ballot value the fixed-point lane cannot prove exact."""


def _scan(value, memo: dict):
    """``(coefficient, exponent)`` with ``value == coeff * 10**exp``,
    exact — or :class:`_Unfit`.  Memoized on the Decimal's *string
    representation* (not its value: ``Decimal("1")`` and
    ``Decimal("1.0")`` are equal but carry different exponents, and the
    exponent decides the rendered bytes)."""
    if type(value) is Decimal:
        key = str(value)
        hit = memo.get(key)
        if hit is not None:
            return hit
        sign, digits, exp = value.as_tuple()
        if not isinstance(exp, int):
            raise _Unfit(key)  # NaN / Infinity
        coeff = 0
        for d in digits:
            coeff = coeff * 10 + d
        if sign:
            coeff = -coeff
        memo[key] = hit = (coeff, exp)
        return hit
    if type(value) is int:
        # int * Decimal is exact in the Decimal fold with exponent 0
        return (value, 0)
    # float (TypeError in the Decimal fold), bool, anything else: the
    # slow path is the authority on how to fail
    raise _Unfit(type(value).__name__)


def fixed_point_fold(tail, n_choices: int):
    """``choice_weight`` of the Decimal tally fold, computed on
    scaled-int64 numpy vectors — or None when byte-identity cannot be
    proven (the caller MUST then run the Decimal fold; the fast lane
    never ships an unproven number).

    ``tail`` is the aggregate's judge choices; ballots are the choices
    with a non-None ``delta.vote`` folded with their ``weight``
    (missing weight = 0), exactly like the slow loop.
    """
    if n_choices <= 0:
        return None
    votes = []
    weights = []
    for choice in tail:
        vote = choice.delta.vote
        if vote is None:
            continue
        if type(vote) is not list or len(vote) != n_choices:
            # short ballots fold partially and long ones IndexError in
            # the slow loop; both shapes belong to the authority
            return None
        votes.append(vote)
        w = choice.weight
        weights.append(w if w is not None else _D0)
    if not votes:
        # the fold never ran: the accumulator list itself is the result
        return [Decimal(0)] * n_choices
    # Votes repeat a handful of distinct objects — hard ballots share
    # ONE zero Decimal via ``[Decimal(0)] * n`` (ballot/vote.py) — so
    # the whole matrix dedups at C speed over object ids (objects stay
    # alive in ``tail`` for the whole call, ids are stable), only the
    # distinct objects are scanned, and the scaled-int64 matrix is a
    # numpy gather over that tiny table.
    J = len(votes)
    ids = np.fromiter(
        map(id, chain.from_iterable(votes)),
        dtype=np.int64,
        count=J * n_choices,
    )
    _, first, inv = np.unique(ids, return_index=True, return_inverse=True)
    memo: dict = {}
    try:
        table = [
            _scan(votes[i // n_choices][i % n_choices], memo)
            for i in first.tolist()
        ]
        sw = [_scan(w, memo) for w in weights]
    except _Unfit:
        return None
    pv = max(0, max(-e for (_, e) in table))
    pw = max(0, max(-e for (_, e) in sw))
    # scaled integers as Python ints first: the exactness/overflow gates
    # must run before anything narrows to int64
    v_distinct = [c * 10 ** (pv + e) for (c, e) in table]
    wscaled = [c * 10 ** (pw + e) for (c, e) in sw]
    max_v = max(abs(v) for v in v_distinct)
    max_w = max(abs(w) for w in wscaled)
    # max_v * Σ|w| bounds every product and every intermediate sum of
    # the Decimal fold (scaled): within it, the fold is exact under the
    # context precision and the int64 matrix cannot wrap.  The raw
    # elements are gated on their own too — a huge scaled value beside
    # a zero vote/weight vanishes from the product bound.
    s_bound = max_v * sum(abs(w) for w in wscaled)
    if (
        s_bound >= _I64_GUARD
        or max_v >= _I64_GUARD
        or max_w >= _I64_GUARD
        or len(str(s_bound)) > getcontext().prec
    ):
        # int64 could wrap / the Decimal fold itself may round — loud
        # fallback to the authority, never silent drift
        return None
    idx_mat = inv.reshape(J, n_choices)
    vmat = np.take(np.array(v_distinct, dtype=np.int64), idx_mat)
    wvec = np.array(wscaled, dtype=np.int64)
    sums = (vmat * wvec[:, None]).sum(axis=0).tolist()
    vote_exps = {e for (_, e) in table}
    weight_exps = {e for (_, e) in sw}
    if len(vote_exps) == 1 and len(weight_exps) == 1:
        # one quantum each (hard votes + a uniform weight table): the
        # result exponent is the same scalar for every candidate
        e0 = min(0, next(iter(vote_exps)) + next(iter(weight_exps)))
        exps = [e0] * n_choices
    else:
        evote = np.take(
            np.array([e for (_, e) in table], dtype=np.int64), idx_mat
        )
        evec = np.array([e for (_, e) in sw], dtype=np.int64)
        exps = np.minimum((evote + evec[:, None]).min(axis=0), 0).tolist()
    p = pv + pw
    out = []
    # candidate sums repeat heavily (hard ballots leave most candidates
    # at zero), so reconstructed Decimals are shared through a memo
    rebuilt: dict = {}
    for s, e in zip(sums, exps):
        d = rebuilt.get((s, e))
        if d is None:
            # every term carries 10**(P + ev + ew) with ev+ew >= E_i, so
            # the division is exact by construction and the E-notation
            # literal reconstructs the exact coefficient+exponent pair
            # ("1000E-3" parses to 1.000, trailing zeros preserved)
            # without the context rounding scaleb would apply
            shift = p + e
            coeff = s if shift == 0 else s // 10 ** shift
            rebuilt[(s, e)] = d = Decimal("%dE%d" % (coeff, e))
        out.append(d)
    return out
