"""LWC014 — lock registry consistency + cross-thread guarded fields.

The lock-model registry (``analysis/concurrency_model.py``) declares
every threading primitive in the package and the instance fields each
one guards.  This rule enforces it both ways, LWC010-style, then runs
the RacerX-shaped lockset check over the owning classes:

* an **unregistered lock** — a ``threading.Lock``/``RLock``/
  ``Condition`` creation site with no registry entry — fails: a lock
  nobody declared guards nothing anybody can audit;
* a **stale registry row** — an entry whose creation site is gone —
  fails: the registry only ever shrinks honestly;
* a **guarded-field access outside its lock** fails once the field is
  cross-thread: the union of thread entry points (Thread targets,
  executor submits — each worth 2, every pool has >= 2 workers — the
  port's HTTP handler methods — each worth 2, a thread per request — and
  the asyncio loop) reaching the class's accessing methods weighs >= 2.
  ``__init__`` is exempt (construction precedes publication);
* the escape hatch is an explicit ``# caller-holds-lock: <Lock.key>
  (reason)`` comment on the method — which itself requires every
  resolved caller to hold that lock at the call site (or be exempted
  for it in turn), and requires the written reason.

Project-scoped; a parsed set that declares no ``CONCURRENCY_MODEL``
checks nothing (single-file lint invocations stay self-contained).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set, Tuple

from ..concurrency import (
    FKey,
    entries_weight,
    lock_sites,
    method_exemptions,
    project_index,
)
from ..engine import Finding, ParsedModule, enclosing_symbol
from . import Rule


def _registry_findings(idx, modules) -> List[Finding]:
    model = idx.model
    findings: List[Finding] = []
    matched: Set[str] = set()
    for site in lock_sites(modules, model):
        entry = model.locks.get(site.key)
        if entry is not None and site.module.rel.endswith(
            entry.get("module", "")
        ):
            matched.add(site.key)
            continue
        findings.append(
            Finding(
                rule=RULE.name,
                path=site.module.rel,
                line=site.node.lineno,
                symbol=enclosing_symbol(site.module, site.node),
                message=(
                    f"threading primitive `{site.key}` is not in the "
                    f"lock-model registry ({model.module.rel}): declare "
                    "it with the fields it guards and any acquisition-"
                    "order edges, or nothing audits its discipline"
                ),
            )
        )
    for key in model.locks:
        if key in matched or not model.in_scope(key, modules):
            continue
        findings.append(
            Finding(
                rule=RULE.name,
                path=model.module.rel,
                line=model.line,
                symbol=key,
                message=(
                    f"lock-model registry entry `{key}` has no creation "
                    "site: the lock it described is gone — delete the "
                    "stale row (guards and order edges die with it)"
                ),
            )
        )
    return findings


def _owners(model, modules):
    """(lock key, entry, (module, class)) for each class whose fields a
    lock guards: the class that creates it (``Class.attr`` keys) and, in
    the port, each class of its ``held_as`` fields (any module: the
    holder takes the lock from a function that made it)."""
    for key, entry in model.locks.items():
        holders = [(entry.get("module", ""), key.rsplit(".", 1)[0])]
        holders += [("", h.rsplit(".", 1)[0]) for h in entry.get(
            "held_as", ())]
        for suffix, class_name in holders:
            owner = None
            for module in modules:
                if not module.rel.endswith(suffix):
                    continue
                for cls in module.classes():
                    if cls.name == class_name:
                        owner = (module, cls)
            if owner is not None:
                yield key, entry, owner


def _guard_findings(idx, modules) -> List[Finding]:
    model = idx.model
    findings: List[Finding] = []
    # owning class per registered lock (via its declared module)
    for key, entry, owner in _owners(model, modules):
        guards = tuple(entry.get("guards", ()))
        if not guards:
            continue
        module, cls = owner
        guard_set = set(guards)
        # accesses[field] -> [(method fkey, node, locked, exempted)]
        accesses: Dict[str, List[Tuple[FKey, ast.AST, bool, bool]]] = {}
        exempt_by_method: Dict[FKey, List] = {}
        for method in cls.methods:
            fkey = (module.rel, method.qualname)
            fentry = idx.funcs.get(fkey)
            if fentry is None:
                continue
            exemptions = [
                e
                for e in method_exemptions(module, method.node)
                if e.lock == key
            ]
            if exemptions:
                exempt_by_method[fkey] = exemptions
                for e in exemptions:
                    if not e.reason:
                        findings.append(
                            Finding(
                                rule=RULE.name,
                                path=module.rel,
                                line=e.line,
                                symbol=method.qualname,
                                message=(
                                    "caller-holds-lock exemption for "
                                    f"`{key}` has no written reason: "
                                    "say WHY the caller chain holds it, "
                                    "e.g. `# caller-holds-lock: X._lock "
                                    "(only called from locked Y)`"
                                ),
                            )
                        )
            if method.node.name == "__init__":
                continue  # construction precedes publication
            for node, held in fentry.facts.nodes:
                if (
                    isinstance(node, ast.Attribute)
                    and isinstance(node.value, ast.Name)
                    and node.value.id == "self"
                    and node.attr in guard_set
                ):
                    accesses.setdefault(node.attr, []).append(
                        (fkey, node, key in held, bool(exemptions))
                    )
        for fld, sites in accesses.items():
            entry_ids: Set[str] = set()
            for fkey, _, _, _ in sites:
                entry_ids |= idx.entry_sets.get(fkey, set())
            weight = entries_weight(entry_ids)
            if weight < 2:
                continue  # statically single-threaded state
            for fkey, node, locked, exempted in sites:
                if locked or exempted:
                    continue
                findings.append(
                    Finding(
                        rule=RULE.name,
                        path=fkey[0],
                        line=node.lineno,
                        symbol=fkey[1],
                        message=(
                            f"`self.{fld}` is guarded by `{key}` and "
                            "cross-thread (reached from "
                            f"{sorted(entry_ids)}), but this access "
                            f"holds no `with` on it: wrap it, or exempt "
                            "the method with `# caller-holds-lock: "
                            f"{key} (reason)` if every caller locks"
                        ),
                    )
                )
        # exemption honesty: every resolved caller must hold the lock
        for fkey, exemptions in exempt_by_method.items():
            for caller, call in idx.call_sites.get(fkey, ()):
                centry = idx.funcs[caller]
                held = centry.held_by_node().get(id(call), ())
                if key in held:
                    continue
                if caller in exempt_by_method:
                    continue  # the chain's own exemption covers it
                if centry.qualname.split(".")[-1] == "__init__":
                    continue
                findings.append(
                    Finding(
                        rule=RULE.name,
                        path=caller[0],
                        line=call.lineno,
                        symbol=centry.qualname,
                        message=(
                            f"call into `{fkey[1]}` (exempted via "
                            f"caller-holds-lock: {key}) without holding "
                            f"`{key}`: the exemption's contract is that "
                            "EVERY caller locks — take the lock here or "
                            "extend the exemption up the chain"
                        ),
                    )
                )
    return findings


def project(modules: List[ParsedModule]) -> List[Finding]:
    idx = project_index(modules)
    if idx is None:
        return []
    return _registry_findings(idx, modules) + _guard_findings(
        idx, modules
    )


RULE = Rule(
    name="LWC014",
    summary="lock registry drift / guarded field accessed outside its lock",
    check=None,
    project=project,
)
