"""LWC005 — no float contamination in the Decimal tally math.

The paper's consensus semantics depend on *exact* weighted tallies
(``Decimal`` end to end — weights, quorum thresholds, per-choice
sums).  Two contamination shapes are flagged:

* ``Decimal(0.1)`` — constructing a Decimal from a float literal bakes
  the binary-float error into the "exact" value (``Decimal("0.1")`` is
  the correct spelling);
* arithmetic mixing a Decimal-bound name with a float literal
  (``weight * 0.5`` where ``weight = Decimal(...)``) — in Python this
  raises TypeError at runtime on the serving path, or silently
  degrades if somebody "fixes" it with a float() cast upstream.

Explicit, labelled exports like ``float(w)`` for the explain/metrics
surface are fine and not flagged — the rule looks at construction and
binary ops only.
"""

from __future__ import annotations

import ast
from typing import List, Set

from ..engine import Finding, ParsedModule, body_nodes
from . import Rule


def _is_float_literal(node: ast.AST) -> bool:
    if isinstance(node, ast.UnaryOp):
        node = node.operand
    return isinstance(node, ast.Constant) and isinstance(node.value, float)


def _is_decimal_ctor(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    func = node.func
    name = (
        func.id
        if isinstance(func, ast.Name)
        else func.attr
        if isinstance(func, ast.Attribute)
        else None
    )
    return name == "Decimal"


def check(module: ParsedModule) -> List[Finding]:
    findings: List[Finding] = []
    for fn in module.functions():
        decimal_names: Set[str] = set()
        for node in body_nodes(fn.node):
            if isinstance(node, ast.Assign) and _is_decimal_ctor(node.value):
                for target in node.targets:
                    if isinstance(target, ast.Name):
                        decimal_names.add(target.id)
        for node in body_nodes(fn.node):
            if _is_decimal_ctor(node) and node.args and _is_float_literal(
                node.args[0]
            ):
                findings.append(
                    Finding(
                        rule=RULE.name,
                        path=module.rel,
                        line=node.lineno,
                        symbol=fn.qualname,
                        message=(
                            "Decimal(<float literal>) bakes binary-float "
                            'error into the exact tally; use Decimal("...") '
                            "with a string literal"
                        ),
                    )
                )
            elif isinstance(node, ast.BinOp):
                sides = (node.left, node.right)
                if any(_is_float_literal(s) for s in sides) and any(
                    isinstance(s, ast.Name) and s.id in decimal_names
                    for s in sides
                ):
                    findings.append(
                        Finding(
                            rule=RULE.name,
                            path=module.rel,
                            line=node.lineno,
                            symbol=fn.qualname,
                            message=(
                                "float literal mixed into Decimal "
                                "arithmetic; keep tally math Decimal-pure "
                                "(float() only at the explain/metrics edge)"
                            ),
                        )
                    )
            elif isinstance(node, ast.AugAssign):
                if (
                    isinstance(node.target, ast.Name)
                    and node.target.id in decimal_names
                    and _is_float_literal(node.value)
                ):
                    findings.append(
                        Finding(
                            rule=RULE.name,
                            path=module.rel,
                            line=node.lineno,
                            symbol=fn.qualname,
                            message=(
                                "float literal folded into a Decimal "
                                "accumulator; keep tally math Decimal-pure"
                            ),
                        )
                    )
    return findings


RULE = Rule(
    name="LWC005",
    summary="float literal contaminating Decimal math",
    check=check,
)
