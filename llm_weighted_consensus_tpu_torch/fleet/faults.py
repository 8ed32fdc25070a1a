"""Deterministic peer-to-peer fault injection: the fleet's failure seam.

``resilience/faults.py`` breaks the judge transport and
``DEVICE_FAULT_PLAN`` breaks the mesh; this module breaks the *fleet
wire* — the peer legs ``FleetClient`` drives (entry fetch, lease claim,
publish, handoff, liveness probe).  Six kinds, the failure modes a
replica actually sees from a sick or partitioned peer:

* ``blackhole`` — the peer is unreachable and packets vanish: the leg
  burns its full clamped budget, then times out.  The building block of
  partition schedules (a cut is a set of blackholed pairs).
* ``slow``      — the leg stalls ``slow_ms`` before the request leaves
  (a congested or GC-pausing peer).
* ``connect``   — connection refused immediately (the peer's port is
  closed: crash, restart, drain).
* ``5xx``       — the peer answers 503 (overloaded or draining).
* ``corrupt``   — the peer's *payload* arrives mangled: the chunk
  record is garbled so the wire guard (fleet/wire.py) must refuse it.
* ``flap``      — the pair's health TOGGLES: a seeded coin flips the
  pair between healthy and blackholed-at-connect, producing the
  up/down/up pattern that drives peer quarantine.

Determinism does not depend on request interleaving: every decision for
the ordered pair ``(src, dst)`` is drawn from
``random.Random(xxh3(seed, src, dst, ordinal))`` where ``ordinal`` is
that pair's own call counter — the same pair sees the same fault
sequence no matter how the event loop schedules other pairs.  Scripted
control is per-pair too: ``set_pair``/``partition`` install explicit
rules (the split-brain drill's schedule), and ``script=`` in the env
spec replays a fault list per pair by ordinal.

Selectable in production-shaped runs via ``FLEET_FAULT_PLAN``, e.g.
``seed=7,blackhole=0.05,slow=0.1,slow_ms=150`` or
``blackhole=1.0,to=http://10.0.0.2:5000`` (faults only on legs toward
the listed peers — how a bench carves a partition out of env config).

Unset ⇒ ``FleetClient`` never consults this module: the seam is one
``is None`` check, byte-identical to the pre-fault-plan fleet.  The
port's copy of ``llm_weighted_consensus_tpu/fleet/faults.py``: the
per-pair seed is the port's own XXH3-64, so a seed draws the reference's
fault sequence decision for decision.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Tuple

from ..identity.xxh3 import xxh3_64_intdigest

# fault kinds, in the fixed order the sampler walks (order is part of
# the determinism contract — do not reorder)
BLACKHOLE = "blackhole"
SLOW = "slow"
CONNECT = "connect"
BAD_STATUS = "5xx"
CORRUPT = "corrupt"
FLAP = "flap"

KINDS = (BLACKHOLE, SLOW, CONNECT, BAD_STATUS, CORRUPT, FLAP)


def _pair_rng(seed: int, src: str, dst: str, ordinal: int) -> random.Random:
    label = f"{seed}:{src}>{dst}:{ordinal}"
    return random.Random(xxh3_64_intdigest(label.encode("utf-8")))


class FleetFaultPlan:
    """Per-peer-pair fault schedule: seeded sampling, a per-pair script,
    or explicit rules (``set_pair``/``partition``)."""

    def __init__(
        self,
        seed: int = 0,
        probabilities: Optional[Dict[str, float]] = None,
        slow_ms: float = 100.0,
        script: Optional[List[Optional[str]]] = None,
        to: Optional[List[str]] = None,
    ) -> None:
        self.seed = int(seed)
        self.probabilities = {
            kind: float((probabilities or {}).get(kind, 0.0)) for kind in KINDS
        }
        self.slow_ms = float(slow_ms)
        self._script = list(script) if script is not None else None
        self._to = {u.rstrip("/") for u in to} if to else None
        # explicit rules installed by drills: (src, dst) -> [kind, count]
        # (count None = until cleared)
        self._rules: Dict[Tuple[str, str], list] = {}
        self._ordinals: Dict[Tuple[str, str], int] = {}
        self._flapped: set = set()
        self.requests = 0
        self.injected: Dict[str, int] = {kind: 0 for kind in KINDS}

    # -- explicit schedules (the drill API) -----------------------------------

    def set_pair(
        self, src: str, dst: str, kind: str, count: Optional[int] = None
    ) -> None:
        """Install an explicit fault rule for the ordered pair: every
        leg ``src -> dst`` gets ``kind`` (for ``count`` legs, or until
        cleared)."""
        if kind not in KINDS:
            raise ValueError(f"unknown fleet fault {kind!r}")
        self._rules[(src.rstrip("/"), dst.rstrip("/"))] = [kind, count]

    def clear_pair(self, src: str, dst: str) -> None:
        self._rules.pop((src.rstrip("/"), dst.rstrip("/")), None)

    def partition(self, groups: List[List[str]], kind: str = BLACKHOLE) -> None:
        """Install a partition: every ordered pair whose endpoints lie
        in different groups gets ``kind``.  ``heal()`` removes it."""
        for i, a_group in enumerate(groups):
            for j, b_group in enumerate(groups):
                if i == j:
                    continue
                for a in a_group:
                    for b in b_group:
                        self.set_pair(a, b, kind)

    def heal(self) -> None:
        """Remove every explicit rule and reset flap state (seeded
        probabilities keep sampling; a pure-scripted plan goes fully
        healthy)."""
        self._rules.clear()
        self._flapped.clear()

    # -- the sampling seam ----------------------------------------------------

    def next_fault(self, src: str, dst: str) -> Optional[str]:
        """The fault for the next ``src -> dst`` leg (None = healthy)."""
        self.requests += 1
        src = src.rstrip("/")
        dst = dst.rstrip("/")
        pair = (src, dst)
        ordinal = self._ordinals.get(pair, 0)
        self._ordinals[pair] = ordinal + 1
        rule = self._rules.get(pair)
        if rule is not None:
            kind, count = rule
            if count is not None:
                if count <= 1:
                    del self._rules[pair]
                else:
                    rule[1] = count - 1
            self.injected[kind] += 1
            return kind
        if self._to is not None and dst not in self._to:
            return None
        if self._script is not None:
            if ordinal >= len(self._script):
                return None
            fault = self._script[ordinal]
            if fault is not None:
                self.injected[fault] += 1
            return fault
        rng = _pair_rng(self.seed, src, dst, ordinal)
        # flap is a TOGGLE draw, independent of the per-leg kind draw: a
        # flapped pair stays down (connect-refused) until the next toggle
        if rng.random() < self.probabilities[FLAP]:
            if pair in self._flapped:
                self._flapped.discard(pair)
            else:
                self._flapped.add(pair)
        if pair in self._flapped:
            self.injected[FLAP] += 1
            return FLAP
        draw = rng.random()
        edge = 0.0
        for kind in KINDS:
            if kind == FLAP:
                continue
            edge += self.probabilities[kind]
            if draw < edge:
                self.injected[kind] += 1
                return kind
        return None

    @classmethod
    def parse(cls, spec: str) -> "FleetFaultPlan":
        """Parse a ``FLEET_FAULT_PLAN`` env spec.

        Comma-separated ``key=value``: ``seed``, ``slow_ms``, one key
        per fault kind with its probability, ``script=a|b|ok`` (per-pair
        replay, ``ok``/empty = healthy leg), or ``to=url|url`` limiting
        sampled faults to legs toward the listed peers.
        """
        from ..resilience.faults import iter_plan_spec

        seed = 0
        slow_ms = 100.0
        probs: Dict[str, float] = {}
        script: Optional[List[Optional[str]]] = None
        to: Optional[List[str]] = None
        for key, value in iter_plan_spec(spec, "FLEET_FAULT_PLAN"):
            if key == "seed":
                seed = int(value)
            elif key == "slow_ms":
                slow_ms = float(value)
            elif key == "script":
                script = [
                    None if slot in ("", "ok") else slot
                    for slot in value.split("|")
                ]
                for slot in script:
                    if slot is not None and slot not in KINDS:
                        raise ValueError(
                            f"FLEET_FAULT_PLAN: unknown fault {slot!r}"
                        )
            elif key == "to":
                to = [u for u in value.split("|") if u]
            elif key in KINDS:
                probs[key] = float(value)
            else:
                raise ValueError(f"FLEET_FAULT_PLAN: unknown key {key!r}")
        return cls(
            seed=seed,
            probabilities=probs,
            slow_ms=slow_ms,
            script=script,
            to=to,
        )

    def snapshot(self) -> dict:
        return {
            "requests": self.requests,
            "injected": {k: v for k, v in self.injected.items() if v},
            "flapped_pairs": sorted(f"{a}>{b}" for a, b in self._flapped),
            "rules": len(self._rules),
        }


def corrupt_payload(payload):
    """Mangle a peer response the way a buggy or truncating peer would:
    the chunk record loses its tail frame and grows a frame the typed
    decode must refuse, so ``clean_chunk_objs`` rejects the record and
    the receiver degrades instead of serving garbage.  Non-record
    payloads pass through (corruption targets the data plane)."""
    if (
        isinstance(payload, dict)
        and isinstance(payload.get("chunks"), list)
        and payload["chunks"]
    ):
        payload = dict(payload)
        payload["chunks"] = payload["chunks"][:-1] + [
            {"corrupt": "fleet-fault-injected"}
        ]
    return payload
