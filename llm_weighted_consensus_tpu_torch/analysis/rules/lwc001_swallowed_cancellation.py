"""LWC001 — handlers that can swallow ``asyncio.CancelledError``.

Since Python 3.8 ``CancelledError`` derives from ``BaseException``, so
``except Exception`` is safe; what swallows cancellation in an
``async def`` is a bare ``except:``, an ``except BaseException:``, or
an explicit ``except asyncio.CancelledError:`` — unless the handler
re-raises.

One structural exemption: a function that calls ``.cancel()`` on a
task is a *canceller* reaping its own cancellation (the
``_discard_attempts`` / stream-merge-cleanup shape), and absorbing the
resulting ``CancelledError`` there is the whole point.
"""

from __future__ import annotations

import ast
from typing import List

from ..engine import Finding, ParsedModule, body_nodes
from . import Rule


def _names_base_exception(node: ast.AST) -> bool:
    if isinstance(node, ast.Name):
        return node.id == "BaseException"
    if isinstance(node, ast.Attribute):
        return node.attr == "BaseException"
    return False


def _names_cancelled(node: ast.AST) -> bool:
    if isinstance(node, ast.Name):
        return node.id == "CancelledError"
    if isinstance(node, ast.Attribute):
        return node.attr == "CancelledError"
    return False


def _handler_reraises(handler: ast.ExceptHandler) -> bool:
    for stmt in handler.body:
        for node in ast.walk(stmt):
            if isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
            ):
                break
            if isinstance(node, ast.Raise):
                return True
    return False


def check(module: ParsedModule) -> List[Finding]:
    findings: List[Finding] = []
    for fn in module.functions():
        if not fn.is_async:
            continue
        is_canceller = any(
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "cancel"
            for node in body_nodes(fn.node)
        )
        for node in body_nodes(fn.node):
            if not isinstance(node, ast.ExceptHandler):
                continue
            types = []
            if node.type is None:
                kind = "bare except:"
            elif isinstance(node.type, ast.Tuple):
                types = list(node.type.elts)
                kind = None
            else:
                types = [node.type]
                kind = None
            if kind is None:
                if any(_names_base_exception(t) for t in types):
                    kind = "except BaseException"
                elif any(_names_cancelled(t) for t in types):
                    if is_canceller:
                        continue
                    kind = "except CancelledError"
                else:
                    continue
            if _handler_reraises(node):
                continue
            findings.append(
                Finding(
                    rule=RULE.name,
                    path=module.rel,
                    line=node.lineno,
                    symbol=fn.qualname,
                    message=(
                        f"{kind} in async function without re-raise can "
                        "swallow asyncio.CancelledError; re-raise, narrow "
                        "to Exception, or cancel-and-reap explicitly"
                    ),
                )
            )
    return findings


RULE = Rule(
    name="LWC001",
    summary="async handler can swallow CancelledError",
    check=check,
)
