"""LWC018 — unbounded growable containers on ingest/serve paths.

The hostile-upstream hardening bounds every byte an upstream
can make us hold: SSE parser caps, per-judge stream budgets, the unary
body cap, ``client_max_size`` at the gateway door, and the archive's
capped orphan queue.  This rule keeps the *shape* of those bugs from
creeping back.  Three patterns are findings:

* ``deque()`` constructed without a ``maxlen`` keyword — an unbounded
  FIFO is exactly how the archive orphan queue leaked before it was
  capped; every deque in this package must state its bound (or
  explicitly pass ``maxlen=None`` into a baseline entry that says why);
* a bytes accumulator (a name assigned ``bytearray()`` or a bytes
  literal in the same function) grown inside a loop — ``buf += chunk``
  or ``buf.extend(chunk)`` — with no ``len(buf)`` check anywhere in that
  loop body: the newline-less-flood bug (clients/sse.py checks
  ``len(self._buffer)`` against ``max_buffer_bytes`` for this reason);
* the raw network iterators (``byte_stream``/``iter_chunked``/
  ``iter_any``) drained into a container — appending or ``+=``-ing the
  loop target — with no ``len(...)`` check on the container in the loop
  body: "read the whole stream into memory" with no cap.

Heuristic limits (documented, deliberate): accumulators are recognized
per-function and by local name only (``self._buf`` growth is governed by
the class-scoped concurrency rules' module set, not here), and a cap
check is recognized as a lexical ``len(<acc>)`` call in the loop body —
the idiom every bounded reader in this package uses.  Per the engine
contract, nested ``def``/``lambda`` bodies are not descended into.
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Set

from ..engine import Finding, ParsedModule, body_nodes, dotted_name
from . import Rule

# async-for iterables that yield raw network bytes: draining one into a
# container without a length check is the whole-stream-in-memory bug
_RAW_STREAM_ITERS = ("byte_stream", "iter_chunked", "iter_any")

_GROW_CALLS = ("extend", "append", "appendleft")


def _loop_body_nodes(loop: ast.AST) -> Iterator[ast.AST]:
    """Nodes lexically inside the loop body (nested defs excluded)."""
    stack: List[ast.AST] = list(loop.body)
    while stack:
        node = stack.pop()
        if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
        ):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _call_name(call: ast.Call) -> str:
    func = call.func
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""


def _is_bytes_init(value: ast.AST) -> bool:
    if isinstance(value, ast.Call) and _call_name(value) == "bytearray":
        return True
    return isinstance(value, ast.Constant) and isinstance(
        value.value, bytes
    )


def _len_guarded_names(loop: ast.AST) -> Set[str]:
    """Local names N with a ``len(N)`` call in the loop body — the cap
    check every bounded reader performs before (or while) growing."""
    out: Set[str] = set()
    for node in _loop_body_nodes(loop):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Name)
            and node.func.id == "len"
            and len(node.args) == 1
            and isinstance(node.args[0], ast.Name)
        ):
            out.add(node.args[0].id)
    return out


def _raw_stream_loop(loop: ast.AST) -> bool:
    if not isinstance(loop, ast.AsyncFor):
        return False
    it = loop.iter
    if isinstance(it, ast.Call):
        it = it.func
    name = dotted_name(it) or ""
    return name.rpartition(".")[2] in _RAW_STREAM_ITERS


def check(module: ParsedModule) -> List[Finding]:
    findings: List[Finding] = []
    for fn in module.functions():
        bytes_accs: Set[str] = set()
        for node in body_nodes(fn.node):
            if isinstance(node, ast.Assign) and _is_bytes_init(node.value):
                for target in node.targets:
                    if isinstance(target, ast.Name):
                        bytes_accs.add(target.id)
        flagged: Set[int] = set()

        def flag(node: ast.AST, message: str) -> None:
            if id(node) in flagged:
                return
            flagged.add(id(node))
            findings.append(
                Finding(
                    rule=RULE.name,
                    path=module.rel,
                    line=node.lineno,
                    symbol=fn.qualname,
                    message=message,
                )
            )

        for node in body_nodes(fn.node):
            if isinstance(node, ast.Call) and _call_name(node) == "deque":
                if not any(k.arg == "maxlen" for k in node.keywords):
                    flag(
                        node,
                        "`deque()` without `maxlen` on a serve-path "
                        "module — state the bound (the archive orphan "
                        "queue leaked exactly this way)",
                    )
            if not isinstance(node, (ast.For, ast.AsyncFor, ast.While)):
                continue
            guarded = _len_guarded_names(node)
            raw_chunks: Set[str] = set()
            if _raw_stream_loop(node) and isinstance(
                node.target, ast.Name
            ):
                raw_chunks.add(node.target.id)
            for sub in _loop_body_nodes(node):
                if (
                    isinstance(sub, ast.AugAssign)
                    and isinstance(sub.op, ast.Add)
                    and isinstance(sub.target, ast.Name)
                ):
                    acc = sub.target.id
                    grows_bytes = acc in bytes_accs
                    grows_raw = isinstance(
                        sub.value, ast.Name
                    ) and sub.value.id in raw_chunks
                    if (grows_bytes or grows_raw) and acc not in guarded:
                        flag(
                            sub,
                            f"`{acc} += ...` grows an ingest buffer "
                            f"inside a loop with no `len({acc})` cap "
                            "check — bound it (IngestCapError) or "
                            "check the budget in the loop body",
                        )
                if (
                    isinstance(sub, ast.Call)
                    and isinstance(sub.func, ast.Attribute)
                    and sub.func.attr in _GROW_CALLS
                    and isinstance(sub.func.value, ast.Name)
                ):
                    acc = sub.func.value.id
                    grows_bytes = acc in bytes_accs
                    grows_raw = any(
                        isinstance(a, ast.Name) and a.id in raw_chunks
                        for a in sub.args
                    )
                    if (grows_bytes or grows_raw) and acc not in guarded:
                        what = (
                            "raw network chunks"
                            if grows_raw
                            else "an ingest buffer"
                        )
                        flag(
                            sub,
                            f"`{acc}.{sub.func.attr}(...)` accumulates "
                            f"{what} inside a loop with no "
                            f"`len({acc})` cap check — a hostile "
                            "upstream controls how big this gets",
                        )
    return findings


RULE = Rule(
    name="LWC018",
    summary="unbounded growable container on an ingest/serve path",
    check=check,
)
