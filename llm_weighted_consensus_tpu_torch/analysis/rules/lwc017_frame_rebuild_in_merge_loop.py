"""LWC017 — full-frame serialization inside a per-chunk merge loop.

The streaming serve path used to rebuild every SSE frame from scratch —
``chunk.to_json_obj()`` + ``jsonutil.dumps`` per merged chunk — which is
exactly the O(frame) work the HOST_FASTPATH splice lane
(serve/frames.py, types/base.py SpliceEncoder) exists to avoid: the
splice encoder re-renders only the bytes a chunk changed.  This rule
keeps the slow pattern from creeping back: any ``to_json_obj(...)`` or
``jsonutil.dumps(...)`` call lexically inside an ``async for`` body is
a finding.

Exempt modules (full-frame serialization IS their contract):

* ``serve/frames.py`` — the fast-lane module itself; its slow-lane
  fallback and the splice encoder's dynamic subtrees both legitimately
  call the full writer per frame;
* ``cache/replay.py`` — the response-cache recorder stores complete
  canonical frames; serializing every chunk of a cacheable stream is
  the feature, not the bug.

Per the engine contract, nested ``def``/``lambda`` bodies inside the
loop are not flagged (they run in another dynamic context and are
linted as their own functions).
"""

from __future__ import annotations

import ast
from typing import List

from ..engine import Finding, ParsedModule, body_nodes, dotted_name
from . import Rule

_EXEMPT_SUFFIXES = (
    "serve/frames.py",
    "cache/replay.py",
)

_FULL_FRAME_CALLS = ("to_json_obj", "dumps")


def _loop_calls(loop: ast.AsyncFor):
    """Calls lexically inside the loop body (nested defs excluded)."""
    stack: List[ast.AST] = list(loop.body)
    while stack:
        node = stack.pop()
        if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
        ):
            continue
        if isinstance(node, ast.Call):
            yield node
        stack.extend(ast.iter_child_nodes(node))


def check(module: ParsedModule) -> List[Finding]:
    if module.rel.endswith(_EXEMPT_SUFFIXES):
        return []
    findings: List[Finding] = []
    for fn in module.functions():
        for node in body_nodes(fn.node):
            if not isinstance(node, ast.AsyncFor):
                continue
            for call in _loop_calls(node):
                func = call.func
                if isinstance(func, ast.Attribute):
                    name = func.attr
                elif isinstance(func, ast.Name):
                    name = func.id
                else:
                    continue
                if name not in _FULL_FRAME_CALLS:
                    continue
                dotted = dotted_name(func) or name
                findings.append(
                    Finding(
                        rule=RULE.name,
                        path=module.rel,
                        line=call.lineno,
                        symbol=fn.qualname,
                        message=(
                            f"`{dotted}(...)` inside an `async for` "
                            "body rebuilds the full frame per chunk — "
                            "splice-encode through serve/frames.py "
                            "(FrameEncoder) instead, or serialize "
                            "outside the merge loop"
                        ),
                    )
                )
    return findings


RULE = Rule(
    name="LWC017",
    summary="full-frame to_json_obj/dumps inside a per-chunk merge loop",
    check=check,
)
