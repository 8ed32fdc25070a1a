"""LWC016 — blocking while holding a threading lock.

A threading lock held across an ``await``, a ``wait_device_ready`` /
``.synchronize()`` device wait, or an upstream HTTP call turns one
slow device/peer into a package-wide stall: every thread that touches
the same critical section parks behind a sleeper that is not even
running.  Flagged, for any held registered lock:

* lexically blocking operations inside the ``with`` body — including
  ``await`` (an async def that takes a *threading* lock parks the whole
  event loop behind it);
* ``Condition.wait`` / ``wait_for`` on a condition OTHER than one
  currently held — waiting on B while holding A blocks A for the full
  sleep.  Waiting on the held condition itself is the designed idiom
  (``wait`` atomically releases it) and is never flagged;
* calls that resolve to a method whose own body directly blocks — the
  one-hop call-mediated case (``self._probe()`` under the manager lock
  where ``_probe`` waits on the device).

Locks registered ``long_held: True`` (the reader/writer shape gate —
designed to be held across an entire device staging — and the port's
per-device launch lock, held across a whole graph replay or eager
enqueue) are exempt; the registry states each one's reason.

Project-scoped; no declared ``CONCURRENCY_MODEL`` means no checks.
"""

from __future__ import annotations

import ast
from typing import List, Tuple

from ..concurrency import (
    _resolve_lock_expr,
    blocking_call,
    project_index,
)
from ..engine import Finding, ParsedModule
from . import Rule


def _fmt(keys: Tuple[str, ...]) -> str:
    return ", ".join(f"`{k}`" for k in keys)


def project(modules: List[ParsedModule]) -> List[Finding]:
    idx = project_index(modules)
    if idx is None:
        return []
    model = idx.model
    long_held = {
        key
        for key, entry in model.locks.items()
        if entry.get("long_held")
    }
    findings: List[Finding] = []
    for fkey, entry in idx.funcs.items():
        for node, held in entry.facts.nodes:
            eff = tuple(h for h in held if h not in long_held)
            if not eff:
                continue
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("wait", "wait_for")
            ):
                key = _resolve_lock_expr(
                    node.func.value,
                    entry.class_name,
                    model,
                    idx.via,
                    (fkey[0], entry.qualname),
                )
                if (
                    key is not None
                    and model.locks.get(key, {}).get("kind")
                    == "condition"
                ):
                    if key in held:
                        continue  # wait() releases the held condition
                    findings.append(
                        Finding(
                            rule=RULE.name,
                            path=fkey[0],
                            line=node.lineno,
                            symbol=entry.qualname,
                            message=(
                                f"waiting on `{key}` while holding "
                                f"{_fmt(eff)}: `wait` only releases its "
                                "OWN condition — the held lock stays "
                                "taken for the whole sleep; restructure "
                                "so the wait happens outside it"
                            ),
                        )
                    )
                    continue
            desc = blocking_call(node)
            if desc is None:
                continue
            findings.append(
                Finding(
                    rule=RULE.name,
                    path=fkey[0],
                    line=node.lineno,
                    symbol=entry.qualname,
                    message=(
                        f"{desc} while holding {_fmt(eff)}: every "
                        "thread touching that critical section parks "
                        "behind this sleep — move the blocking step "
                        "outside the `with`, or snapshot state and "
                        "release first"
                    ),
                )
            )
    # one hop of call-mediation: holding a lock, calling a method whose
    # own body directly blocks
    for callee, sites in idx.call_sites.items():
        desc = idx.direct_blocking.get(callee)
        if desc is None:
            continue
        for caller, call in sites:
            held = idx.funcs[caller].held_by_node().get(id(call), ())
            eff = tuple(h for h in held if h not in long_held)
            if not eff:
                continue
            findings.append(
                Finding(
                    rule=RULE.name,
                    path=caller[0],
                    line=call.lineno,
                    symbol=idx.funcs[caller].qualname,
                    message=(
                        f"call into `{callee[1]}` — which performs "
                        f"{desc} — while holding {_fmt(eff)}: the lock "
                        "is held across the callee's blocking wait; "
                        "hoist the call out of the `with`"
                    ),
                )
            )
    return findings


RULE = Rule(
    name="LWC016",
    summary="blocking operation performed while holding a threading lock",
    check=None,
    project=project,
)
