"""LWC006 — blocking calls inside ``async def``.

One synchronous sleep / file read / HTTP round-trip inside a coroutine
stalls the whole event loop — every in-flight request on the gateway
pays it.  Flagged inside async function bodies (nested ``def``s and
lambdas are exempt — they run wherever they're shipped, usually an
executor): ``time.sleep``, plain ``open``, ``subprocess.*``,
``os.system``, ``requests.*``, ``urllib.request.urlopen``,
``socket.create_connection``.

The fix is the repo's existing idiom: ``await asyncio.sleep``,
``run_in_executor`` (see the gateway profile handlers), or aiohttp.
"""

from __future__ import annotations

import ast
from typing import List

from ..engine import Finding, ParsedModule, body_nodes, dotted_name
from . import Rule

_BLOCKING_DOTTED = {
    "time.sleep",
    "subprocess.run",
    "subprocess.call",
    "subprocess.check_call",
    "subprocess.check_output",
    "subprocess.Popen",
    "os.system",
    "os.popen",
    "requests.get",
    "requests.post",
    "requests.put",
    "requests.delete",
    "requests.request",
    "requests.Session",
    "urllib.request.urlopen",
    "socket.create_connection",
}

_BLOCKING_PLAIN = {"open"}


def check(module: ParsedModule) -> List[Finding]:
    findings: List[Finding] = []
    for fn in module.functions():
        if not fn.is_async:
            continue
        for node in body_nodes(fn.node):
            if not isinstance(node, ast.Call):
                continue
            dotted = dotted_name(node.func)
            if dotted is None:
                continue
            hit = (
                dotted in _BLOCKING_DOTTED
                or dotted in _BLOCKING_PLAIN
            )
            if not hit:
                continue
            findings.append(
                Finding(
                    rule=RULE.name,
                    path=module.rel,
                    line=node.lineno,
                    symbol=fn.qualname,
                    message=(
                        f"blocking call `{dotted}(...)` inside async def "
                        "stalls the event loop for every in-flight request; "
                        "use asyncio.sleep / run_in_executor / aiohttp"
                    ),
                )
            )
    return findings


RULE = Rule(
    name="LWC006",
    summary="blocking call inside async def",
    check=check,
)
