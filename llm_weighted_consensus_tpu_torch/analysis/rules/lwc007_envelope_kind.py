"""LWC007 — structured error envelopes must carry a ``kind``.

The HTTP error contract (``errors.py``): a dict-shaped ``message``
always carries a ``kind`` discriminator so clients and the resilience
layer can branch without string-matching prose.  Two shapes are
checked:

* any ``message()`` method returning a dict literal must include a
  ``"kind"`` key;
* any dict literal with both ``"code"`` and ``"message"`` keys (the
  wire envelope shape) whose ``"message"`` value is itself a dict
  literal must include ``"kind"`` in that inner dict.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from ..engine import Finding, ParsedModule, body_nodes
from . import Rule


def _dict_keys(node: ast.Dict) -> List[Optional[str]]:
    keys = []
    for key in node.keys:
        if isinstance(key, ast.Constant) and isinstance(key.value, str):
            keys.append(key.value)
        else:
            keys.append(None)  # **spread or computed key: unknowable
    return keys


def _has_unknowable(node: ast.Dict) -> bool:
    return any(k is None for k in _dict_keys(node))


def check(module: ParsedModule) -> List[Finding]:
    findings: List[Finding] = []
    for fn in module.functions():
        is_message_method = fn.qualname.rsplit(".", 1)[-1] == "message"
        for node in body_nodes(fn.node):
            if is_message_method and isinstance(node, ast.Return):
                value = node.value
                if isinstance(value, ast.Dict):
                    keys = _dict_keys(value)
                    if "kind" not in keys and not _has_unknowable(value):
                        findings.append(
                            Finding(
                                rule=RULE.name,
                                path=module.rel,
                                line=value.lineno,
                                symbol=fn.qualname,
                                message=(
                                    "message() returns a dict without a "
                                    '"kind" discriminator; clients branch '
                                    "on kind, not on prose"
                                ),
                            )
                        )
            if isinstance(node, ast.Dict):
                keys = _dict_keys(node)
                if "code" in keys and "message" in keys:
                    inner = node.values[keys.index("message")]
                    if (
                        isinstance(inner, ast.Dict)
                        and "kind" not in _dict_keys(inner)
                        and not _has_unknowable(inner)
                    ):
                        findings.append(
                            Finding(
                                rule=RULE.name,
                                path=module.rel,
                                line=inner.lineno,
                                symbol=fn.qualname,
                                message=(
                                    "error envelope carries a dict message "
                                    'without a "kind" discriminator'
                                ),
                            )
                        )
    return findings


RULE = Rule(
    name="LWC007",
    summary='error envelope missing "kind"',
    check=check,
)
