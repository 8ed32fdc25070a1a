"""LWC015 — static lock-acquisition order vs. the declared DAG.

Lockdep, statically: every ``with``/``.acquire()`` site contributes
"held -> acquired" edges — both lexically nested ``with`` blocks and
call-mediated acquisitions (holding the shape gate, the dispatch path
calls into the staging pool, which takes its own lock; the call graph's
transitive lock closure makes that edge visible).  The registry's
``order`` tuple declares the intended DAG, enforced both ways:

* an **observed edge not declared** fails — new nesting must be written
  into the registry, where the next reader (and the runtime witness)
  can see it;
* a **declared edge no longer observed** fails — stale order rows would
  let the witness bless interleavings the code no longer produces;
* a **cycle** anywhere over declared + ``order_runtime`` + observed
  edges fails — two threads walking the cycle's locks in program order
  deadlock;
* lexically **re-entering a non-reentrant ``Lock``** fails — that is a
  self-deadlock, not an ordering question (``RLock``/``Condition``
  re-entry is legal and ignored).

Project-scoped; no declared ``CONCURRENCY_MODEL`` means no checks.
"""

from __future__ import annotations

from typing import Dict, List, Set, Tuple

from ..concurrency import project_index
from ..engine import Finding, ParsedModule
from . import Rule

Edge = Tuple[str, str]


def _observed_edges(idx) -> Tuple[Dict[Edge, tuple], List[Finding]]:
    """-> ({(held, acquired): (path, line, symbol, how)}, re-entry
    findings)."""
    model = idx.model
    edges: Dict[Edge, tuple] = {}
    findings: List[Finding] = []
    for fkey, entry in idx.funcs.items():
        for lock, node, held in entry.facts.acquisitions:
            for h in held:
                if h == lock:
                    if model.locks[lock].get("kind") == "lock":
                        findings.append(
                            Finding(
                                rule=RULE.name,
                                path=fkey[0],
                                line=node.lineno,
                                symbol=entry.qualname,
                                message=(
                                    f"`{lock}` is a non-reentrant "
                                    "threading.Lock already held here: "
                                    "this nested acquisition deadlocks "
                                    "the thread against itself"
                                ),
                            )
                        )
                    continue
                edges.setdefault(
                    (h, lock),
                    (fkey[0], node.lineno, entry.qualname, "nested with"),
                )
    # call-mediated: holding H, a call reaches code that acquires M
    for callee, sites in idx.call_sites.items():
        locks = idx.trans_locks.get(callee, set())
        if not locks:
            continue
        for caller, call in sites:
            held = idx.funcs[caller].held_by_node().get(id(call), ())
            if not held:
                continue
            for h in held:
                for m in locks:
                    if m == h:
                        continue
                    edges.setdefault(
                        (h, m),
                        (
                            caller[0],
                            call.lineno,
                            idx.funcs[caller].qualname,
                            f"call into `{callee[1]}`",
                        ),
                    )
    return edges, findings


def _cycles(edge_set: Set[Edge]) -> List[Tuple[str, ...]]:
    adj: Dict[str, List[str]] = {}
    for u, v in edge_set:
        adj.setdefault(u, []).append(v)
    seen_cycles: Set[Tuple[str, ...]] = set()
    out: List[Tuple[str, ...]] = []

    def dfs(node: str, stack: List[str], on_stack: Set[str]) -> None:
        for nxt in adj.get(node, ()):
            if nxt in on_stack:
                cycle = tuple(stack[stack.index(nxt):])
                pivot = cycle.index(min(cycle))
                canon = cycle[pivot:] + cycle[:pivot]
                if canon not in seen_cycles:
                    seen_cycles.add(canon)
                    out.append(canon)
                continue
            if nxt in visited:
                continue
            visited.add(nxt)
            stack.append(nxt)
            on_stack.add(nxt)
            dfs(nxt, stack, on_stack)
            stack.pop()
            on_stack.remove(nxt)

    visited: Set[str] = set()
    for start in sorted(adj):
        if start in visited:
            continue
        visited.add(start)
        dfs(start, [start], {start})
    return out


def project(modules: List[ParsedModule]) -> List[Finding]:
    idx = project_index(modules)
    if idx is None:
        return []
    model = idx.model
    observed, findings = _observed_edges(idx)
    declared = {tuple(e) for e in model.order}
    runtime = {tuple(e[:2]) for e in model.order_runtime}
    for edge, (path, line, symbol, how) in sorted(observed.items()):
        if edge in declared or edge in runtime:
            continue
        findings.append(
            Finding(
                rule=RULE.name,
                path=path,
                line=line,
                symbol=symbol,
                message=(
                    f"lock-order edge `{edge[0]}` -> `{edge[1]}` "
                    f"({how}) is not declared in the registry's "
                    "`order`: declare it so the DAG (and the runtime "
                    "witness) audit this nesting"
                ),
            )
        )
    for edge in sorted(declared):
        if edge in observed:
            continue
        if not (
            edge[0] in model.locks
            and edge[1] in model.locks
            and model.in_scope(edge[0], modules)
            and model.in_scope(edge[1], modules)
        ):
            continue
        findings.append(
            Finding(
                rule=RULE.name,
                path=model.module.rel,
                line=model.line,
                symbol=f"{edge[0]}->{edge[1]}",
                message=(
                    f"declared order edge `{edge[0]}` -> `{edge[1]}` "
                    "is no longer observed at any with/acquire site: "
                    "delete the stale row (or move it to "
                    "`order_runtime` with a reason if only real "
                    "interleavings exercise it)"
                ),
            )
        )
    for cycle in _cycles(set(observed) | declared | runtime):
        path = " -> ".join(cycle + (cycle[0],))
        findings.append(
            Finding(
                rule=RULE.name,
                path=model.module.rel,
                line=model.line,
                symbol=cycle[0],
                message=(
                    f"lock-order cycle {path}: two threads walking "
                    "these acquisitions in program order deadlock — "
                    "break the cycle by reordering one site (declared "
                    "+ observed edges considered together)"
                ),
            )
        )
    return findings


RULE = Rule(
    name="LWC015",
    summary="lock-acquisition order inverts or escapes the declared DAG",
    check=None,
    project=project,
)
