"""LWC013 — blocking readiness call outside the sanctioned waiter.

The reference's LWC013 flags ``block_until_ready`` / ``device_get``
outside its waiter seam; the port's rule keeps its id and its reason with
CUDA's names.  The host<->device overlap contract
(``models/dispatch_seam.py``) is that the dispatch hot path returns at
ENQUEUE: the staged copy-in, the graph replay and the copy-out's CUDA
event are queued under the launch lock, and readiness belongs to the
batcher's waiter thread, reached only through ``wait_device_ready``.  One
stray sync on the dispatch path silently re-serializes the pipeline
without failing any functional test, so the gate is static.  Flagged:

* ``torch.cuda.synchronize(...)`` and any ``.synchronize()`` call (a
  CUDA ``Event``'s, a ``Stream``'s, a pending dispatch's) anywhere in
  the linted set;
* ``.item()``, ``.cpu()`` and ``.tolist()`` — a device-to-host copy that
  waits for the stream — in the dispatch-path modules, where the
  receiver is a dispatch's output: ``models/`` and ``ops/``.

Allowed:

* ``wait_device_ready`` itself (``models/dispatch_seam.py``) — the ONE
  sanctioned blocking readiness call, run by waiter threads — and the
  pending dispatch's own ``Dispatch.synchronize`` / ``Dispatch.result``
  (``models/graphs.py``), which it calls;
* ``GraphTable._capture`` (``models/graphs.py``): warmup and capture run
  before the server is ready and must sync around the capture (the
  eager run on a side stream, the captured graph's memory);
* ``train/``, ``bench/`` and ``analysis/``: the trainers, the benches
  and the audits are not the dispatch path; they block on purpose, to
  step an optimizer or to measure;
* a host copy whose receiver is host memory (a CPU tensor, a numpy
  array) is not a device wait, but the rule cannot tell it from one: each
  such site is baselined with that reason rather than exempted by path.

``np.asarray`` on a device tensor also blocks, but flagging every
asarray would drown the signal — the finalize-closure convention
(``serve/batcher.py``) covers those by construction.
"""

from __future__ import annotations

import ast
from typing import List

from ..engine import Finding, ParsedModule, body_nodes, dotted_name
from . import Rule

_EXEMPT_SUBSTRS = (
    "llm_weighted_consensus_tpu_torch/train/",
    "llm_weighted_consensus_tpu_torch/bench/",
    "llm_weighted_consensus_tpu_torch/analysis/",
)

# the dispatch-path modules where a host copy reads a dispatch's output
_DISPATCH_SUBSTRS = (
    "llm_weighted_consensus_tpu_torch/models/",
    "llm_weighted_consensus_tpu_torch/ops/",
)

_HOST_COPIES = ("item", "cpu", "tolist")

# function qualnames allowed to block (the waiter seam itself)
_ALLOWED_SYMBOLS = {"wait_device_ready"}
# (module suffix, qualname) allowed to block: the pending dispatch the
# waiter seam waits on, and warmup/capture
_ALLOWED_SITES = {
    ("models/graphs.py", "Dispatch.synchronize"),
    ("models/graphs.py", "Dispatch.result"),
    ("models/graphs.py", "GraphTable._capture"),
}


def _allowed(rel: str, qualname: str) -> bool:
    if qualname in _ALLOWED_SYMBOLS:
        return True
    return any(
        rel.endswith(suffix) and qualname == name
        for suffix, name in _ALLOWED_SITES
    )


def check(module: ParsedModule) -> List[Finding]:
    if any(sub in module.rel for sub in _EXEMPT_SUBSTRS):
        return []
    dispatch_path = any(sub in module.rel for sub in _DISPATCH_SUBSTRS)
    findings: List[Finding] = []
    for fn in module.functions():
        if _allowed(module.rel, fn.qualname):
            continue
        for node in body_nodes(fn.node):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if not isinstance(func, ast.Attribute):
                continue
            what = None
            if func.attr == "synchronize":
                what = f"`{dotted_name(func) or '.synchronize'}(...)`"
            elif dispatch_path and func.attr in _HOST_COPIES:
                what = f"`.{func.attr}()` (a device-to-host copy)"
            if what is None:
                continue
            findings.append(
                Finding(
                    rule=RULE.name,
                    path=module.rel,
                    line=node.lineno,
                    symbol=fn.qualname,
                    message=(
                        f"{what} blocks on device readiness outside the "
                        "waiter seam: the dispatch path must return at "
                        "enqueue — defer through dispatch_seam "
                        "(wait_device_ready runs on the waiter thread)"
                    ),
                )
            )
    return findings


RULE = Rule(
    name="LWC013",
    summary="blocking device-readiness call outside the waiter seam",
    check=check,
)
