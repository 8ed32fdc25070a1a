"""LWC003 — slot releases must live in ``finally``.

The codebase's resource brackets: asyncio ``acquire``/``release``
(semaphores, locks), admission ``try_acquire``/``release``, breaker
``allow``/``release_probe``-or-settle, watchdog ``begin``/``end``.
If a function both claims and releases the same receiver, the release
must be reachable on every exit — i.e. inside a ``finally`` block —
or an exception (most often a cancellation) between the two leaks the
slot.

Deliberately NOT flagged: functions that claim without any matching
release call (ownership handed to another scope — e.g.
``RetryBudget.try_acquire`` is a token *spend* with no release at
all), and ``with``/``async with`` blocks (the context manager is the
finally).
"""

from __future__ import annotations

import ast
from typing import List

from ..engine import Finding, ParsedModule, body_nodes, call_base, finally_nodes
from . import Rule

# claim attr -> the attrs that settle it
_PAIRS = {
    "acquire": {"release"},
    "try_acquire": {"release"},
    "allow": {"release_probe", "record_success", "record_failure"},
    "begin": {"end"},
}


def check(module: ParsedModule) -> List[Finding]:
    findings: List[Finding] = []
    for fn in module.functions():
        in_finally = finally_nodes(fn.node)
        calls = [
            node
            for node in body_nodes(fn.node)
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
        ]
        for claim in calls:
            settles = _PAIRS.get(claim.func.attr)
            if settles is None:
                continue
            base = call_base(claim)
            releases = [
                c
                for c in calls
                if c.func.attr in settles and call_base(c) == base
            ]
            if not releases:
                continue  # ownership escapes this function: not ours to judge
            if any(id(c) in in_finally for c in releases):
                continue
            findings.append(
                Finding(
                    rule=RULE.name,
                    path=module.rel,
                    line=claim.lineno,
                    symbol=fn.qualname,
                    message=(
                        f"`{base}.{claim.func.attr}()` is settled by "
                        f"`{'`/`'.join(sorted(settles))}` in this function "
                        "but never inside a finally: block — a cancellation "
                        "between claim and release leaks the slot"
                    ),
                )
            )
    return findings


RULE = Rule(
    name="LWC003",
    summary="resource release not in finally",
    check=check,
)
