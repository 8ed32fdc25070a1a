"""LWC011 — config-knob ↔ README documentation drift.

The README's env-var table is the operator interface; ``Config.from_env``
is the implementation.  They drift in both directions: a knob added to
``from_env`` but never documented is invisible to operators, and a
README entry whose knob no code reads anymore teaches operators a
no-op.  Both directions are mechanical, so both are lint:

* **undocumented** — an ALL_CAPS env-name literal read inside a
  ``from_env`` function that the nearest README never mentions;
* **stale** — a backticked ALL_CAPS token in that README whose family
  prefix (text up to the first ``_``: ``TRACE_``, ``PACKING_``,
  ``ANALYSIS_``, ...) matches some knob the parsed set *does* read, but
  which itself appears in no parsed module — families the repo has
  never owned (``JAX_*``, ``XLA_*`` platform vars) are out of scope.

The README is found by walking up from the ``from_env`` module's
directory (fixture configs ship their own sibling README; the real
``serve/config.py`` resolves to the repo root's).  Project-scoped: the
stale check needs every module's literals, since ``ANALYSIS_*`` knobs
are read far from ``serve/config.py``.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import List, Optional, Set

from ..engine import Finding, ParsedModule, repo_root
from . import Rule

# an env-knob name: ALL_CAPS with at least one underscore segment
_KNOB_RE = re.compile(r"[A-Z][A-Z0-9]*(?:_[A-Z0-9]+)+")
_README_TOKEN_RE = re.compile(r"`([A-Z][A-Z0-9]*(?:_[A-Z0-9]+)+)`")


def _find_readme(start: Path) -> Optional[Path]:
    root = repo_root().resolve()
    node = start.resolve()
    while True:
        candidate = node / "README.md"
        if candidate.exists():
            return candidate
        if node == root or node.parent == node:
            return None
        node = node.parent


def _from_env_knobs(module: ParsedModule):
    """[(name, line)] for every knob literal inside a from_env body."""
    out = []
    for fn in module.functions():
        if fn.qualname.split(".")[-1] != "from_env":
            continue
        for node in ast.walk(fn.node):
            if isinstance(node, ast.Constant) and isinstance(
                node.value, str
            ):
                if _KNOB_RE.fullmatch(node.value):
                    out.append((node.value, node.lineno))
    return out


def _all_knob_literals(modules: List[ParsedModule]) -> Set[str]:
    """Every knob-shaped string literal anywhere in the parsed set —
    the "somebody reads this" evidence for the stale check."""
    out: Set[str] = set()
    for module in modules:
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Constant) and isinstance(
                node.value, str
            ):
                for match in _KNOB_RE.findall(node.value):
                    out.add(match)
    return out


def project(modules: List[ParsedModule]) -> List[Finding]:
    config_modules = [
        (m, _from_env_knobs(m)) for m in modules
    ]
    config_modules = [(m, k) for m, k in config_modules if k]
    if not config_modules:
        return []
    findings: List[Finding] = []
    all_literals = _all_knob_literals(modules)
    root = repo_root().resolve()
    stale_checked = set()
    for module, knobs in config_modules:
        readme = _find_readme(module.path.parent)
        if readme is None:
            continue
        readme_text = readme.read_text(encoding="utf-8")
        try:
            readme_rel = readme.resolve().relative_to(root).as_posix()
        except ValueError:
            readme_rel = readme.name
        seen = set()
        for name, line in knobs:
            if name in seen:
                continue
            seen.add(name)
            if name not in readme_text:
                findings.append(
                    Finding(
                        rule=RULE.name,
                        path=module.rel,
                        line=line,
                        symbol=name,
                        message=(
                            f"env knob `{name}` is read by from_env but "
                            f"{readme_rel} never documents it — "
                            "operators can't discover it"
                        ),
                    )
                )
        if readme_rel in stale_checked:
            continue
        stale_checked.add(readme_rel)
        families = {n.split("_", 1)[0] + "_" for n in all_literals}
        for i, text in enumerate(readme_text.splitlines(), start=1):
            for token in _README_TOKEN_RE.findall(text):
                family = token.split("_", 1)[0] + "_"
                if family not in families:
                    continue  # a family the code never owned (JAX_, …)
                if token not in all_literals:
                    findings.append(
                        Finding(
                            rule=RULE.name,
                            path=readme_rel,
                            line=i,
                            symbol=token,
                            message=(
                                f"README documents `{token}` but no "
                                "module reads it — stale knob docs "
                                "teach operators a no-op"
                            ),
                        )
                    )
    return findings


RULE = Rule(
    name="LWC011",
    summary="config knob vs README documentation drift",
    check=None,
    project=project,
)
