"""LWC002 — ``asyncio.create_task`` result discarded.

A task whose handle is dropped can never be awaited or cancelled: its
exceptions vanish into "Task exception was never retrieved" and drain/
shutdown cannot reap it.  The rule flags create_task/ensure_future
calls used as bare expression statements (result discarded).  Binding
the handle — assignment, ``tasks.append(...)``, passing it onward —
satisfies the rule; whether the holder then awaits-or-cancels is
enforced by review plus the drain tests, not by this pass.

``TaskGroup.create_task`` receivers are exempt: the group owns the
handle structurally.
"""

from __future__ import annotations

import ast
from typing import List

from ..engine import Finding, ParsedModule, body_nodes, call_base
from . import Rule

_SPAWN_ATTRS = {"create_task", "ensure_future"}


def _is_orphaning_spawn(call: ast.Call) -> bool:
    if not isinstance(call.func, ast.Attribute):
        # plain ensure_future(...) / create_task(...) from a star-import
        return isinstance(call.func, ast.Name) and call.func.id in _SPAWN_ATTRS
    if call.func.attr not in _SPAWN_ATTRS:
        return False
    base = call_base(call) or ""
    # asyncio.TaskGroup retains the handle itself
    if "taskgroup" in base.lower() or base == "tg":
        return False
    return True


def check(module: ParsedModule) -> List[Finding]:
    findings: List[Finding] = []
    for fn in module.functions():
        for node in body_nodes(fn.node):
            if not isinstance(node, ast.Expr):
                continue
            value = node.value
            if isinstance(value, ast.Await):
                continue  # awaited inline: retained by definition
            if isinstance(value, ast.Call) and _is_orphaning_spawn(value):
                findings.append(
                    Finding(
                        rule=RULE.name,
                        path=module.rel,
                        line=value.lineno,
                        symbol=fn.qualname,
                        message=(
                            "create_task result discarded; keep the handle "
                            "so the task can be awaited or cancelled "
                            "(drain/shutdown cannot reap orphans)"
                        ),
                    )
                )
    return findings


RULE = Rule(
    name="LWC002",
    summary="create_task handle dropped",
    check=check,
)
