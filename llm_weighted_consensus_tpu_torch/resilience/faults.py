"""Deterministic fault injection at the Transport seam.

``FaultInjectionTransport`` wraps any real ``Transport`` and, per
request, consults a seeded ``FaultPlan`` for one of ten fault kinds —
the failure modes an OpenAI-compatible SSE upstream actually exhibits:

* ``connect``      — connection refused (``TransportError`` before any
  response exists);
* ``5xx``          — synthetic 503 with a JSON error body (the bad-status
  path, no stream);
* ``stall_first``  — delay before the first byte chunk (trips the
  first-chunk timeout tier / the hedge delay);
* ``stall_mid``    — delay mid-stream after bytes have flowed (trips the
  other-chunk tier — the committed-stream failure mode);
* ``malformed``    — an invalid SSE data frame injected mid-stream
  (exercises per-frame decode-error tolerance);
* ``truncate``     — stream ends early without ``[DONE]``.

Hostile-ingest kinds (the byte-budget plane's adversaries,
all sized by the ``flood_bytes`` plan knob, default 8 MiB):

* ``giant_line``         — one complete, terminated ``data:`` line of
  ``flood_bytes`` payload injected after the first real chunk (trips
  the SSE event byte budget);
* ``newline_less_flood`` — ``flood_bytes`` of newline-less bytes
  streamed in chunks, then the stream cuts (trips the SSE residue
  buffer cap or the per-judge stream budget, whichever is tighter);
* ``oversized_unary``    — a synthetic bad-status response whose body
  is ``flood_bytes`` long (trips the unary body cap on the bad-status
  read path);
* ``binary_garbage``     — seeded random binary chunks injected
  mid-stream (exercises decode tolerance: garbage lines are not
  ``data:`` fields, mid-UTF-8 cuts must not crash the decoder).

Determinism: one ``random.Random(seed)`` drawn once per request in
request order, so a single-threaded test driving requests in a fixed
order sees the exact same fault sequence every run.  For tests that
want full control, ``FaultPlan.scripted([...])`` replays an explicit
fault list instead of sampling.

Selectable in production-shaped runs via the ``FAULT_PLAN`` env spec,
e.g. ``seed=42,connect=0.1,5xx=0.1,stall_first=0.1,stall_ms=200``.

The port's copy of ``llm_weighted_consensus_tpu/resilience/faults.py``,
over the port's ``Transport`` (``clients/chat.py``: ``post_sse``, and a
response's ``read_body`` / ``byte_stream`` / ``close``).
"""

from __future__ import annotations

import asyncio
import random
from typing import AsyncIterator, Dict, List, Optional

# fault kinds, in the fixed order the sampler walks (order is part of
# the determinism contract — do not reorder)
CONNECT = "connect"
BAD_STATUS = "5xx"
STALL_FIRST = "stall_first"
STALL_MID = "stall_mid"
MALFORMED = "malformed"
TRUNCATE = "truncate"
GIANT_LINE = "giant_line"
NEWLINE_LESS_FLOOD = "newline_less_flood"
OVERSIZED_UNARY = "oversized_unary"
BINARY_GARBAGE = "binary_garbage"

KINDS = (
    CONNECT,
    BAD_STATUS,
    STALL_FIRST,
    STALL_MID,
    MALFORMED,
    TRUNCATE,
    GIANT_LINE,
    NEWLINE_LESS_FLOOD,
    OVERSIZED_UNARY,
    BINARY_GARBAGE,
)

_MALFORMED_FRAME = b"data: {this is not json\n\n"

# chunk size hostile floods stream in — large enough that an 8 MiB flood
# is ~128 chunks, small enough to exercise incremental byte accounting
_FLOOD_CHUNK = 64 * 1024


def iter_plan_spec(spec: str, label: str):
    """Yield ``(key, value)`` pairs from a comma-separated ``key=value``
    plan spec — the shared grammar of every ``*_PLAN`` env knob
    (``FAULT_PLAN``, ``JUDGE_BIAS_PLAN``).
    ``label`` names the knob in error messages so a bad spec points at
    the env var the operator actually set."""
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"{label}: expected key=value, got {part!r}")
        key, _, value = part.partition("=")
        yield key.strip(), value.strip()


class FaultPlan:
    """Per-request fault schedule: seeded sampling or an explicit script."""

    def __init__(
        self,
        seed: int = 0,
        probabilities: Optional[Dict[str, float]] = None,
        stall_ms: float = 100.0,
        flood_bytes: int = 8 << 20,
        script: Optional[List[Optional[str]]] = None,
    ) -> None:
        self.seed = int(seed)
        self.rng = random.Random(self.seed)
        self.probabilities = {
            kind: float((probabilities or {}).get(kind, 0.0)) for kind in KINDS
        }
        self.stall_ms = float(stall_ms)
        self.flood_bytes = max(1, int(flood_bytes))
        self._script = list(script) if script is not None else None
        self._script_pos = 0
        self.requests = 0
        self.injected: Dict[str, int] = {kind: 0 for kind in KINDS}

    @classmethod
    def scripted(
        cls, faults: List[Optional[str]], *, stall_ms: float = 100.0
    ) -> "FaultPlan":
        """Replay ``faults`` verbatim (None = healthy request); healthy
        after exhaustion."""
        return cls(script=faults, stall_ms=stall_ms)

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """Parse a ``FAULT_PLAN`` env spec.

        Comma-separated ``key=value``: ``seed``, ``stall_ms``,
        ``flood_bytes`` (hostile-ingest payload size), one key per fault
        kind with its probability, or ``script=a|b|ok|c`` (``ok``/empty
        = healthy slot).
        """
        seed = 0
        stall_ms = 100.0
        flood_bytes = 8 << 20
        probs: Dict[str, float] = {}
        script: Optional[List[Optional[str]]] = None
        for key, value in iter_plan_spec(spec, "FAULT_PLAN"):
            if key == "seed":
                seed = int(value)
            elif key == "stall_ms":
                stall_ms = float(value)
            elif key == "flood_bytes":
                flood_bytes = int(value)
            elif key == "script":
                script = [
                    None if slot in ("", "ok") else slot
                    for slot in value.split("|")
                ]
                for slot in script:
                    if slot is not None and slot not in KINDS:
                        raise ValueError(f"FAULT_PLAN: unknown fault {slot!r}")
            elif key in KINDS:
                probs[key] = float(value)
            else:
                raise ValueError(f"FAULT_PLAN: unknown key {key!r}")
        return cls(
            seed=seed,
            probabilities=probs,
            stall_ms=stall_ms,
            flood_bytes=flood_bytes,
            script=script,
        )

    def next_fault(self) -> Optional[str]:
        """The fault for the next request (None = healthy)."""
        self.requests += 1
        if self._script is not None:
            if self._script_pos >= len(self._script):
                return None
            fault = self._script[self._script_pos]
            self._script_pos += 1
            if fault is not None:
                self.injected[fault] += 1
            return fault
        draw = self.rng.random()
        edge = 0.0
        for kind in KINDS:
            edge += self.probabilities[kind]
            if draw < edge:
                self.injected[kind] += 1
                return kind
        return None

    def snapshot(self) -> dict:
        return {
            "requests": self.requests,
            "injected": {k: v for k, v in self.injected.items() if v},
        }


# judge-bias kinds, in the fixed order the sampler walks (order is part
# of the determinism contract — do not reorder).  All three perturb a
# soft vote vector Decimal-in, Decimal-out:
#
# * ``flip``    — rotate the vote vector one candidate left: the judge
#   systematically prefers "the next" candidate, so it disagrees with
#   consensus on any peaked ballot;
# * ``uniform`` — replace the vote with 1/n everywhere: a maximally
#   hedged, uninformative judge (calibration drifts, agreement decays
#   toward chance);
# * ``invert``  — reverse the vote vector: strong votes become strong
#   votes for the opposite end of the candidate list.
BIAS_FLIP = "flip"
BIAS_UNIFORM = "uniform"
BIAS_INVERT = "invert"

BIAS_KINDS = (BIAS_FLIP, BIAS_UNIFORM, BIAS_INVERT)


class JudgeBiasPlan:
    """Deterministic per-judge vote perturbation (``JUDGE_BIAS_PLAN``).

    The consensus-quality analogue of ``FaultPlan``: where FaultPlan
    breaks the transport, this miscalibrates a *judge* — so the drift
    detector in ``obs/quality.py`` can be drilled with a reproducibly
    biased panel member instead of waiting for a real model to rot.

    Determinism does not depend on judge-stream interleaving: each
    judge keeps its own ballot ordinal, and the per-ballot decision is
    drawn from ``random.Random((seed << 16) ^ (judge << 8) ^ ordinal)``
    — the same judge sees the same perturbation sequence no matter how
    the async fan-out schedules it.  ``after`` healthy ballots are
    passed through first so the drift baseline can form before the
    bias begins.
    """

    def __init__(
        self,
        judge: int = 0,
        seed: int = 0,
        after: int = 0,
        probabilities: Optional[Dict[str, float]] = None,
        script: Optional[List[Optional[str]]] = None,
    ) -> None:
        self.judge = int(judge)
        self.seed = int(seed)
        self.after = max(0, int(after))
        self.probabilities = {
            kind: float((probabilities or {}).get(kind, 0.0))
            for kind in BIAS_KINDS
        }
        self._script = list(script) if script is not None else None
        self._ordinals: Dict[int, int] = {}
        self.injected: Dict[str, int] = {kind: 0 for kind in BIAS_KINDS}

    @classmethod
    def parse(cls, spec: str) -> "JudgeBiasPlan":
        """Parse a ``JUDGE_BIAS_PLAN`` env spec.

        Comma-separated ``key=value``: ``judge`` (target judge index),
        ``seed``, ``after`` (healthy ballots before bias begins), one
        key per bias kind with its probability, or ``script=flip|ok``
        (``ok``/empty = honest ballot), e.g.
        ``judge=2,after=16,flip=1.0,seed=7``.
        """
        judge = 0
        seed = 0
        after = 0
        probs: Dict[str, float] = {}
        script: Optional[List[Optional[str]]] = None
        for key, value in iter_plan_spec(spec, "JUDGE_BIAS_PLAN"):
            if key == "judge":
                judge = int(value)
            elif key == "seed":
                seed = int(value)
            elif key == "after":
                after = int(value)
            elif key == "script":
                script = [
                    None if slot in ("", "ok") else slot
                    for slot in value.split("|")
                ]
                for slot in script:
                    if slot is not None and slot not in BIAS_KINDS:
                        raise ValueError(
                            f"JUDGE_BIAS_PLAN: unknown bias {slot!r}"
                        )
            elif key in BIAS_KINDS:
                probs[key] = float(value)
            else:
                raise ValueError(f"JUDGE_BIAS_PLAN: unknown key {key!r}")
        return cls(
            judge=judge,
            seed=seed,
            after=after,
            probabilities=probs,
            script=script,
        )

    def _next_bias(self, judge_index: int) -> Optional[str]:
        ordinal = self._ordinals.get(judge_index, 0)
        self._ordinals[judge_index] = ordinal + 1
        if judge_index != self.judge or ordinal < self.after:
            return None
        slot = ordinal - self.after
        if self._script is not None:
            if slot >= len(self._script):
                return None
            bias = self._script[slot]
            if bias is not None:
                self.injected[bias] += 1
            return bias
        draw = random.Random(
            (self.seed << 16) ^ (judge_index << 8) ^ slot
        ).random()
        edge = 0.0
        for kind in BIAS_KINDS:
            edge += self.probabilities[kind]
            if draw < edge:
                self.injected[kind] += 1
                return kind
        return None

    def perturb(self, judge_index: int, vote: list) -> list:
        """The (possibly perturbed) vote for ``judge_index``'s next
        ballot.  Decimal-in, Decimal-out: every kind permutes or
        replaces entries without any float arithmetic."""
        bias = self._next_bias(judge_index)
        if bias is None or len(vote) < 2:
            return vote
        if bias == BIAS_FLIP:
            return list(vote[1:]) + [vote[0]]
        if bias == BIAS_INVERT:
            return list(reversed(vote))
        # BIAS_UNIFORM
        from decimal import Decimal

        n = Decimal(len(vote))
        return [Decimal(1) / n for _ in vote]

    def snapshot(self) -> dict:
        return {
            "judge": self.judge,
            "after": self.after,
            "ballots": dict(self._ordinals),
            "injected": {k: v for k, v in self.injected.items() if v},
        }


class _SyntheticBadStatus:
    """A response-shaped 503 that never touched the network."""

    status = 503

    async def read_body(self) -> bytes:
        return b'{"error":{"code":503,"message":"fault-injected upstream error"}}'

    async def byte_stream(self) -> AsyncIterator[bytes]:
        return
        yield b""  # pragma: no cover — makes this an async generator

    async def close(self) -> None:
        pass


class _SyntheticOversizedBody:
    """A bad-status response whose body is a ``flood_bytes`` blob — the
    hostile upstream that answers a failed request with a memory bomb
    instead of an error envelope (trips the unary body cap)."""

    status = 503

    def __init__(self, n_bytes: int) -> None:
        self._n_bytes = n_bytes

    async def read_body(self) -> bytes:
        return b"x" * self._n_bytes

    async def byte_stream(self) -> AsyncIterator[bytes]:
        return
        yield b""  # pragma: no cover — makes this an async generator

    async def close(self) -> None:
        pass


class _FaultedResponse:
    """Delegates to the real response, perturbing the byte stream."""

    def __init__(
        self,
        inner,
        fault: Optional[str],
        stall_s: float,
        flood_bytes: int = 8 << 20,
        garbage_rng: Optional[random.Random] = None,
    ) -> None:
        self._inner = inner
        self._fault = fault
        self._stall_s = stall_s
        self._flood_bytes = flood_bytes
        self._garbage_rng = garbage_rng
        self.status = inner.status

    async def read_body(self) -> bytes:
        return await self._inner.read_body()

    async def byte_stream(self) -> AsyncIterator[bytes]:
        seen = 0
        async for data in self._inner.byte_stream():
            if seen == 0 and self._fault == STALL_FIRST:
                await asyncio.sleep(self._stall_s)
            if seen == 1 and self._fault == STALL_MID:
                await asyncio.sleep(self._stall_s)
            yield data
            seen += 1
            if seen == 1:
                if self._fault == MALFORMED:
                    yield _MALFORMED_FRAME
                elif self._fault == GIANT_LINE:
                    # one complete, terminated data line: the parser sees
                    # the newline and trips the *event* budget (not the
                    # residue cap) on a deterministic byte boundary
                    yield b"data: " + b"A" * self._flood_bytes + b"\n\n"
                elif self._fault == NEWLINE_LESS_FLOOD:
                    # newline-less chunks accumulate as parser residue
                    # (or burn the per-judge stream budget), then the
                    # stream cuts without [DONE]
                    remaining = self._flood_bytes
                    while remaining > 0:
                        n = min(remaining, _FLOOD_CHUNK)
                        yield b"B" * n
                        remaining -= n
                    return
                elif self._fault == BINARY_GARBAGE:
                    # seeded random chunks: newlines land anywhere, lines
                    # are not data: fields, UTF-8 cuts mid-sequence — the
                    # decode-tolerance gauntlet
                    for _ in range(4):
                        yield self._garbage_rng.randbytes(4096)
            if self._fault == TRUNCATE and seen >= 1:
                return

    async def close(self) -> None:
        await self._inner.close()


class FaultInjectionTransport:
    """A ``Transport`` decorator: same interface, scheduled misbehavior."""

    def __init__(self, inner, plan: FaultPlan) -> None:
        self.inner = inner
        self.plan = plan

    async def post_sse(self, url: str, headers: dict, body: bytes):
        from ..errors import TransportError

        fault = self.plan.next_fault()
        if fault == CONNECT:
            raise TransportError("fault-injected connection refused")
        if fault == BAD_STATUS:
            return _SyntheticBadStatus()
        if fault == OVERSIZED_UNARY:
            return _SyntheticOversizedBody(self.plan.flood_bytes)
        resp = await self.inner.post_sse(url, headers, body)
        if fault is None:
            return resp
        garbage_rng = None
        if fault == BINARY_GARBAGE:
            # fresh per-request rng keyed on (seed, request ordinal): the
            # garbage is deterministic without disturbing the plan rng's
            # next_fault draw sequence
            garbage_rng = random.Random(
                (self.plan.seed << 16) ^ self.plan.requests
            )
        return _FaultedResponse(
            resp,
            fault,
            self.plan.stall_ms / 1000.0,
            flood_bytes=self.plan.flood_bytes,
            garbage_rng=garbage_rng,
        )

    async def close(self) -> None:
        await self.inner.close()
