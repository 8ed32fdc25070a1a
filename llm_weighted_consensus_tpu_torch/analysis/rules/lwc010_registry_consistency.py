"""LWC010 — metric-section and span-name registries vs. their uses.

``serve/metrics.py`` declares ``KNOWN_SECTIONS`` (every
``register_provider`` name that may appear in the ``/metrics``
snapshot) and ``obs/span.py`` declares ``KNOWN_SPANS`` (every span name
a trace tree can contain; trailing ``*`` covers a dynamic f-string
suffix).  Dashboards, alert queries, and the explain renderer all match
on these literal keys, so an undeclared name is telemetry that silently
falls off every consumer — and a declared-but-unused name is a dead
registry row that keeps a stale dashboard panel looking healthy.

Project-scoped (the invariant spans modules): collects every
``register_provider("name", ...)`` call and every span-creating call
(``child_span`` / ``start_trace`` / ``span`` / ``.child``) with a
literal or f-string name across the parsed set, then checks both
directions against whichever registries the set declares.  A run whose
module set declares neither registry checks nothing — single-file lint
invocations stay self-contained.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Tuple

from ..engine import Finding, ParsedModule, enclosing_symbol
from . import Rule

_SPAN_CALLS = {"child_span", "start_trace", "span", "child"}


def _literal_or_prefix(node: ast.AST) -> Optional[str]:
    """String constant -> itself; f-string -> its literal prefix + "*";
    anything else -> None (not statically checkable)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.JoinedStr):
        prefix = ""
        for part in node.values:
            if isinstance(part, ast.Constant) and isinstance(
                part.value, str
            ):
                prefix += part.value
            else:
                break
        return prefix + "*"
    return None


def _declared(module: ParsedModule, name: str):
    """(line, tuple-of-names) for a module-level ``name = (...)``."""
    for node in module.tree.body:
        if not isinstance(node, ast.Assign):
            continue
        if not any(
            isinstance(t, ast.Name) and t.id == name for t in node.targets
        ):
            continue
        if isinstance(node.value, (ast.Tuple, ast.List, ast.Set)):
            names = tuple(
                el.value
                for el in node.value.elts
                if isinstance(el, ast.Constant)
                and isinstance(el.value, str)
            )
            return node.lineno, names
    return None


def _matches(declared: str, use: str) -> bool:
    """``use`` may itself be a prefix pattern (f-string call site)."""
    if declared.endswith("*"):
        d = declared[:-1]
        u = use[:-1] if use.endswith("*") else use
        return u.startswith(d) or d.startswith(u)
    if use.endswith("*"):
        return declared.startswith(use[:-1])
    return declared == use


def _check_registry(
    registry: str,
    declared_at: Tuple[ParsedModule, int, Tuple[str, ...]],
    uses: List[Tuple[ParsedModule, ast.AST, str]],
    what: str,
) -> List[Finding]:
    module, line, names = declared_at
    findings: List[Finding] = []
    used = {name: False for name in names}
    for use_mod, node, use_name in uses:
        hits = [d for d in names if _matches(d, use_name)]
        for d in hits:
            used[d] = True
        if not hits:
            findings.append(
                Finding(
                    rule=RULE.name,
                    path=use_mod.rel,
                    line=node.lineno,
                    symbol=enclosing_symbol(use_mod, node),
                    message=(
                        f"{what} `{use_name}` is not declared in "
                        f"{registry} ({module.rel}): undeclared names "
                        "fall off every dashboard/query that matches on "
                        "the registry"
                    ),
                )
            )
    for name, was_used in used.items():
        if not was_used:
            findings.append(
                Finding(
                    rule=RULE.name,
                    path=module.rel,
                    line=line,
                    # the entry name, so (rule, path, symbol) baselining
                    # can target one stale row
                    symbol=name,
                    message=(
                        f"{registry} entry `{name}` has no call site: "
                        "delete the stale registry row (or the dashboard "
                        "panel it backs is already dark)"
                    ),
                )
            )
    return findings


def project(modules: List[ParsedModule]) -> List[Finding]:
    sections_decl = spans_decl = None
    section_uses: List[Tuple[ParsedModule, ast.AST, str]] = []
    span_uses: List[Tuple[ParsedModule, ast.AST, str]] = []
    for module in modules:
        decl = _declared(module, "KNOWN_SECTIONS")
        if decl is not None:
            sections_decl = (module, decl[0], decl[1])
        decl = _declared(module, "KNOWN_SPANS")
        if decl is not None:
            spans_decl = (module, decl[0], decl[1])
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            func = node.func
            attr = (
                func.attr
                if isinstance(func, ast.Attribute)
                else func.id if isinstance(func, ast.Name) else None
            )
            if attr is None:
                continue
            name = _literal_or_prefix(node.args[0])
            if name is None:
                continue
            if attr == "register_provider":
                section_uses.append((module, node, name))
            elif attr in _SPAN_CALLS:
                span_uses.append((module, node, name))
    findings: List[Finding] = []
    if sections_decl is not None:
        findings += _check_registry(
            "KNOWN_SECTIONS", sections_decl, section_uses, "metric section"
        )
    if spans_decl is not None:
        findings += _check_registry(
            "KNOWN_SPANS", spans_decl, span_uses, "span name"
        )
    return findings


RULE = Rule(
    name="LWC010",
    summary="metric-section/span-name registry out of sync with uses",
    check=None,
    project=project,
)
