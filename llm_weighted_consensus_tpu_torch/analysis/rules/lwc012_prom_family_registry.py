"""LWC012 — Prometheus family names vs. the declared registry.

``serve/metrics.py`` declares ``KNOWN_PROM_FAMILIES`` (every family
name the ``GET /metrics?format=prometheus`` exposition may emit) and
``prom_family(name, typ, help)`` is the single choke point that renders
a family header.  Grafana dashboards and recording rules match on these
literal family names, so an emitted-but-undeclared family is a series
no dashboard knows to scrape — and a declared-but-unemitted family is a
panel that flatlines while looking configured.  Same shape as LWC010's
section/span registries, specialized to the text exposition: collect
every ``prom_family(...)`` call with a literal first argument across
the parsed set, then check both directions.

Project-scoped; a run whose module set does not declare
``KNOWN_PROM_FAMILIES`` checks nothing (single-file lint invocations
stay self-contained).
"""

from __future__ import annotations

import ast
from typing import List, Tuple

from ..engine import Finding, ParsedModule, enclosing_symbol
from . import Rule


def _declared(module: ParsedModule):
    """(line, tuple-of-names) for module-level KNOWN_PROM_FAMILIES."""
    for node in module.tree.body:
        if not isinstance(node, ast.Assign):
            continue
        if not any(
            isinstance(t, ast.Name) and t.id == "KNOWN_PROM_FAMILIES"
            for t in node.targets
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


def project(modules: List[ParsedModule]) -> List[Finding]:
    decl = None
    uses: List[Tuple[ParsedModule, ast.Call, str]] = []
    for module in modules:
        found = _declared(module)
        if found is not None:
            decl = (module, found[0], found[1])
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            func = node.func
            attr = (
                func.attr
                if isinstance(func, ast.Attribute)
                else func.id if isinstance(func, ast.Name) else None
            )
            if attr != "prom_family":
                continue
            first = node.args[0]
            if isinstance(first, ast.Constant) and isinstance(
                first.value, str
            ):
                uses.append((module, node, first.value))
            else:
                # the contract is literal-only: a computed family name
                # is invisible to this check AND to every dashboard
                # that greps the registry, so it fails outright
                uses.append((module, node, "<non-literal>"))
    if decl is None:
        return []
    decl_mod, decl_line, names = decl
    findings: List[Finding] = []
    used = {name: False for name in names}
    for use_mod, node, use_name in uses:
        if use_name in used:
            used[use_name] = True
            continue
        findings.append(
            Finding(
                rule=RULE.name,
                path=use_mod.rel,
                line=node.lineno,
                symbol=enclosing_symbol(use_mod, node),
                message=(
                    f"prometheus family `{use_name}` is not declared in "
                    f"KNOWN_PROM_FAMILIES ({decl_mod.rel}): undeclared "
                    "families are series no dashboard knows to scrape "
                    "(family names must be string literals)"
                ),
            )
        )
    for name, was_used in used.items():
        if not was_used:
            findings.append(
                Finding(
                    rule=RULE.name,
                    path=decl_mod.rel,
                    line=decl_line,
                    symbol=name,
                    message=(
                        f"KNOWN_PROM_FAMILIES entry `{name}` has no "
                        "prom_family call site: delete the stale row (the "
                        "dashboard panel it backs is already flatlined)"
                    ),
                )
            )
    return findings


RULE = Rule(
    name="LWC012",
    summary="prometheus family registry out of sync with exposition",
    check=None,
    project=project,
)
