"""LockWitness: runtime lockdep against the declared acquisition DAG.

Counterpart of ``llm_weighted_consensus_tpu/analysis/witness.py``.
The static rules (LWC014–016) prove what the call graph can see; the
witness checks what actually happens.  Opt-in (``LOCK_WITNESS=1`` on
the server, or explicit wiring in a test), it wraps the
registered threading primitives in thin proxies that record, per
thread, the order locks are really taken in, and validates every new
edge against the union of the registry's ``order`` + ``order_runtime``
DAG and the edges observed so far:

* acquiring B while holding A records edge ``A -> B``; if ``B -> A``
  is already reachable in the union graph, two threads can walk the
  cycle from opposite ends and deadlock — an **inversion** violation;
* re-acquiring a non-reentrant ``Lock`` the same thread already holds
  is a **reentrant** violation (a guaranteed self-deadlock — the
  static rule catches the lexical case, the witness the dynamic one);
* an observed edge absent from the declared DAG lands in
  ``undeclared`` — the drills assert it stays empty, which is the
  runtime half of the registry's both-ways contract;
* ``Condition.wait`` atomically releases the condition for the sleep:
  the proxy pops the held entry before waiting and re-pushes on wake,
  so edges are judged against what the thread REALLY holds.

The witness never blocks the application: proxies delegate to the real
primitive first and record after, so a violation is reported, not
injected.  Overhead is one dict update per acquisition (``bench/host.py
--witness-overhead`` measures it on the host path); cross-thread state
lives behind the witness's own leaf mutex, held only for the
bookkeeping instant.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Set, Tuple

Edge = Tuple[str, str]


class _LockProxy:
    """Wraps a ``threading.Lock``/``RLock``/``Condition``; records
    acquire/release order through the owning witness.  Supports the
    ``with`` protocol, raw acquire/release, and the condition surface
    (``wait``/``wait_for``/``notify``/``notify_all``)."""

    def __init__(self, witness: "LockWitness", key: str, lock) -> None:
        self._witness = witness
        self._key = key
        self._lock = lock

    def acquire(self, *args, **kwargs):
        got = self._lock.acquire(*args, **kwargs)
        if got:
            self._witness._on_acquire(self._key)
        return got

    def release(self) -> None:
        self._witness._on_release(self._key)
        self._lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    # -- condition surface (delegated; wait releases the held entry) ---------

    def wait(self, timeout: Optional[float] = None):
        self._witness._on_release(self._key)
        try:
            return self._lock.wait(timeout)
        finally:
            self._witness._on_acquire(self._key)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        self._witness._on_release(self._key)
        try:
            return self._lock.wait_for(predicate, timeout)
        finally:
            self._witness._on_acquire(self._key)

    def __getattr__(self, name):
        return getattr(self._lock, name)


class LockWitness:
    def __init__(self, model: Optional[dict] = None) -> None:
        if model is None:
            from .concurrency_model import CONCURRENCY_MODEL as model
        self._kinds: Dict[str, str] = {
            key: entry.get("kind", "lock")
            for key, entry in model["locks"].items()
        }
        self._declared: Set[Edge] = {
            tuple(e) for e in model.get("order", ())
        } | {tuple(e[:2]) for e in model.get("order_runtime", ())}
        self._local = threading.local()
        self._mu = threading.Lock()
        self._edges: Dict[Edge, int] = {}
        self._violations: List[dict] = []
        self._acquisitions = 0
        # the port's additions: acquisitions per lock key (``counts``)
        # and the keys wrapped so far (``wrapped``)
        self._counts: Dict[str, int] = {}
        self._wrapped: Set[str] = set()

    # -- wiring --------------------------------------------------------------

    def wrap_lock(self, key: str, lock) -> _LockProxy:
        """``obj._lock = witness.wrap_lock("Class._lock", obj._lock)``."""
        self._wrapped.add(key)
        return _LockProxy(self, key, lock)

    def wrap_gate(self, gate, key: str = "_ShapeGate._cond"):
        """Patch a ``_ShapeGate`` instance so holding its shared or
        exclusive side counts as holding the gate's logical lock
        (``dispatch_guard`` delegates to ``shared`` and is covered).
        The internal condition is NOT separately wrapped — the gate is
        one logical lock, bookkeeping instants included."""
        from contextlib import contextmanager

        self._wrapped.add(key)
        for name in ("shared", "exclusive"):
            orig = getattr(gate, name)

            @contextmanager
            def wrapped(_orig=orig):
                with _orig():
                    self._on_acquire(key)
                    try:
                        yield
                    finally:
                        self._on_release(key)

            setattr(gate, name, wrapped)
        return gate

    # -- recording -----------------------------------------------------------

    def _stack(self) -> List[str]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _on_acquire(self, key: str) -> None:
        stack = self._stack()
        if key in stack and self._kinds.get(key, "lock") == "lock":
            with self._mu:
                self._acquisitions += 1
                self._counts[key] = self._counts.get(key, 0) + 1
                self._violations.append(
                    {
                        "kind": "reentrant",
                        "lock": key,
                        "thread": threading.current_thread().name,
                        "held": list(stack),
                    }
                )
            stack.append(key)
            return
        new_edges = [(h, key) for h in dict.fromkeys(stack) if h != key]
        stack.append(key)
        with self._mu:
            self._acquisitions += 1
            self._counts[key] = self._counts.get(key, 0) + 1
            for edge in new_edges:
                first = edge not in self._edges
                self._edges[edge] = self._edges.get(edge, 0) + 1
                if first and self._reachable_locked(edge[1], edge[0]):
                    self._violations.append(
                        {
                            "kind": "inversion",
                            "edge": list(edge),
                            "thread": threading.current_thread().name,
                            "held": list(stack[:-1]),
                        }
                    )

    def _on_release(self, key: str) -> None:
        stack = self._stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == key:
                del stack[i]
                return

    # caller-holds-lock: LockWitness._mu (only _on_acquire calls this, inside its with-_mu block)
    def _reachable_locked(self, src: str, dst: str) -> bool:
        """Whether ``src -> ... -> dst`` exists in declared+observed
        edges (caller holds ``self._mu``; the new edge is excluded by
        construction — it was just inserted, reverse reach means
        cycle)."""
        adj: Dict[str, Set[str]] = {}
        for u, v in self._declared | set(self._edges):
            adj.setdefault(u, set()).add(v)
        frontier, seen = [src], {src}
        while frontier:
            node = frontier.pop()
            if node == dst:
                return True
            for nxt in adj.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    frontier.append(nxt)
        return dst in seen

    # -- reporting -----------------------------------------------------------

    def snapshot(self) -> dict:
        with self._mu:
            edges = {e: c for e, c in self._edges.items()}
            violations = [dict(v) for v in self._violations]
            acquisitions = self._acquisitions
        undeclared = sorted(e for e in edges if e not in self._declared)
        return {
            "acquisitions": acquisitions,
            "edges": [
                {"edge": list(e), "count": c}
                for e, c in sorted(edges.items())
            ],
            "undeclared": [list(e) for e in undeclared],
            "violations": violations,
        }

    def counts(self) -> Dict[str, int]:
        """Acquisitions per lock key (the port's addition; the snapshot
        keeps the reference's keys)."""
        with self._mu:
            return dict(self._counts)

    def wrapped(self) -> List[str]:
        """The lock keys this witness has wrapped (the port's addition)."""
        return sorted(self._wrapped)

    def summary_line(self) -> str:
        snap = self.snapshot()
        return (
            f"lock witness: {snap['acquisitions']} acquisitions, "
            f"{len(snap['edges'])} edge(s), "
            f"{len(snap['undeclared'])} undeclared, "
            f"{len(snap['violations'])} violation(s)"
        )
