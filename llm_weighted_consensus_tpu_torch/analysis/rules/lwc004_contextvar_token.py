"""LWC004 — contextvar tokens must be reset in ``finally``.

The deadline/span/budget idiom: ``token = thing.activate()`` (or
``token = _VAR.set(value)``) establishes ambient context, and the
matching ``deactivate(token)``/``reset(token)`` must sit in a
``finally`` so a cancellation mid-request can't leave a stale
deadline/span/budget bound to the event-loop context.

Exemptions (ownership leaves the function, so pairing happens
elsewhere):

* the token is returned (``return _VAR.set(self)`` — the
  ``activate()`` implementations themselves);
* the token is stored on an object (``self._token = ...`` — the
  ``_SpanScope.__enter__``/``__exit__`` cross-method bracket);
* ``__enter__``/``__aenter__`` methods generally.
"""

from __future__ import annotations

import ast
from typing import List, Set

from ..engine import Finding, ParsedModule, body_nodes, call_base, finally_nodes
from . import Rule

_RESET_ATTRS = {"reset", "deactivate"}


def _module_contextvars(module: ParsedModule) -> Set[str]:
    names: Set[str] = set()
    for node in module.tree.body:
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
            value = node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [node.target]
            value = node.value
        else:
            continue
        if not isinstance(value, ast.Call):
            continue
        func = value.func
        name = (
            func.id
            if isinstance(func, ast.Name)
            else func.attr
            if isinstance(func, ast.Attribute)
            else None
        )
        if name != "ContextVar":
            continue
        for target in targets:
            if isinstance(target, ast.Name):
                names.add(target.id)
    return names


def _token_call(node: ast.Call, ctxvars: Set[str]) -> bool:
    """Is this call one that mints a context token?"""
    if not isinstance(node.func, ast.Attribute):
        return False
    if node.func.attr == "activate":
        return True
    if node.func.attr == "set":
        return (call_base(node) or "") in ctxvars
    return False


def check(module: ParsedModule) -> List[Finding]:
    ctxvars = _module_contextvars(module)
    findings: List[Finding] = []
    for fn in module.functions():
        name = fn.qualname.rsplit(".", 1)[-1]
        if name in ("__enter__", "__aenter__"):
            continue
        in_finally = finally_nodes(fn.node)
        # token name -> the minting call (only simple-Name bindings; an
        # attribute target means ownership escaped the function)
        minted = {}
        for node in body_nodes(fn.node):
            if not isinstance(node, ast.Assign):
                continue
            if not (
                len(node.targets) == 1 and isinstance(node.targets[0], ast.Name)
            ):
                continue
            value = node.value
            if isinstance(value, ast.Await):
                value = value.value
            if isinstance(value, ast.Call) and _token_call(value, ctxvars):
                minted[node.targets[0].id] = value
        if not minted:
            continue
        # reset/deactivate calls in finally blocks, by token-arg name
        reset_tokens: Set[str] = set()
        for node in body_nodes(fn.node):
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _RESET_ATTRS
                and id(node) in in_finally
            ):
                continue
            for arg in node.args:
                for sub in ast.walk(arg):
                    if isinstance(sub, ast.Name):
                        reset_tokens.add(sub.id)
        for token, mint in minted.items():
            if token in reset_tokens:
                continue
            findings.append(
                Finding(
                    rule=RULE.name,
                    path=module.rel,
                    line=mint.lineno,
                    symbol=fn.qualname,
                    message=(
                        f"context token `{token}` from "
                        f"`{call_base(mint)}.{mint.func.attr}()` has no "
                        "reset/deactivate in a finally: block — a "
                        "cancellation here leaks ambient context into the "
                        "event-loop"
                    ),
                )
            )
    return findings


RULE = Rule(
    name="LWC004",
    summary="contextvar token not reset in finally",
    check=check,
)
