"""LWC009 — ``torch.*`` calls and device-tensor syncs inside ``async def``.

The reference's LWC009 flags ``jax.*`` / ``jnp.*`` calls in coroutines;
the port's rule keeps its id and its reason with torch's names.  Device
work belongs behind the batcher/embedder boundary: the batcher's dispatch
threads stage the rows and launch the kernels (or replay a CUDA graph),
and its waiter threads wait on the CUDA events.  The port's chat routes
run every stream on ONE asyncio loop thread (``serve/chat_routes.py``),
so a CUDA call there — a launch behind the launch lock, an allocation, a
host sync — stalls every stream at once.  Flagged inside ``async def``:

* any call whose dotted name starts at ``torch`` (``torch.cuda.*``
  included): ``torch.tensor(...)``, ``torch.cuda.synchronize()``;
* the device-tensor methods that copy to the host or wait on the card,
  by name, whatever the receiver: ``.item()``, ``.cpu()``,
  ``.tolist()``, ``.numpy()`` and ``.synchronize()``.  The receiver's
  type is not known statically, so a numpy ``.tolist()`` in a coroutine
  is flagged too: convert outside the coroutine, or baseline the site
  with the reason it is host memory.

Exempt modules (they ARE the boundary): ``serve/batcher.py`` and
``models/embedder.py``.  Nested ``def``s/lambdas inside coroutines are
not flagged (function-scoped contract — they usually run on an executor
thread), but are linted as their own functions if async.
"""

from __future__ import annotations

import ast
from typing import List

from ..engine import Finding, ParsedModule, body_nodes, dotted_name
from . import Rule

_EXEMPT_SUFFIXES = (
    "serve/batcher.py",
    "models/embedder.py",
)

# tensor methods that copy device memory to the host or wait on the card
_SYNC_METHODS = ("item", "cpu", "tolist", "numpy", "synchronize")


def _what(call: ast.Call):
    dotted = dotted_name(call.func)
    if dotted is not None and dotted.split(".", 1)[0] == "torch":
        return f"`{dotted}(...)`"
    if (
        isinstance(call.func, ast.Attribute)
        and call.func.attr in _SYNC_METHODS
    ):
        return f"`.{call.func.attr}()`"
    return None


def check(module: ParsedModule) -> List[Finding]:
    if module.rel.endswith(_EXEMPT_SUFFIXES):
        return []
    findings: List[Finding] = []
    for fn in module.functions():
        if not fn.is_async:
            continue
        for node in body_nodes(fn.node):
            if not isinstance(node, ast.Call):
                continue
            what = _what(node)
            if what is None:
                continue
            findings.append(
                Finding(
                    rule=RULE.name,
                    path=module.rel,
                    line=node.lineno,
                    symbol=fn.qualname,
                    message=(
                        f"{what} inside async def: a CUDA call (a launch, "
                        "an allocation or a host sync) blocks the event "
                        "loop and every stream on it — route it through "
                        "the batcher/embedder executor boundary"
                    ),
                )
            )
    return findings


RULE = Rule(
    name="LWC009",
    summary="torch call or device sync inside async def outside the "
    "batcher/embedder",
    check=check,
)
