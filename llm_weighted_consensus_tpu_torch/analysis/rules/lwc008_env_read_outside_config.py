"""LWC008 — ``os.environ`` / ``os.getenv`` reads outside the config door.

Every serving knob flows through ``serve/config.py``'s ``Config.from_env``
(one documented, testable surface: pass an ``env`` dict, get a frozen
``Config``).  A direct ``os.environ`` read anywhere else is a knob the
README never lists, tests can't inject, and ``/healthz`` can't report —
exactly the drift LWC011 then fails to see.

Exempt by construction (they ARE the env boundary, not consumers of it):
``serve/config.py`` itself, the ``analysis/`` package (the checker's own
``ANALYSIS_*`` knobs run before any Config exists), and
``parallel/dist.py`` / ``parallel/multihost_smoke.py`` (pre-``Config``
process bootstrap: they *write* child-process environments).  The port
adds two: the ``bench/`` package, which is the port's copy of the
reference's root benches (those lie outside the linted package): a bench
is a process bootstrap that writes the environment of the servers it
drives and reads its own harness settings, never a serving knob; and
``ops/_build.py``, the toolchain bootstrap, whose ``CUDA_HOME`` locates
the compiler that builds the kernels and configures nothing served.

Two env-var NAMESPACES are also exempt, by the same logic: ``LWC_*``
(process-environment interlocks — the random-params safety gate and the
native-library gates — deliberately NOT Config fields so a config file
or ``.env`` can never flip them, and readable at module-load time before
any Config exists) and ``FAKE_UPSTREAM_*`` (knobs of the built-in fake
provider, read per request on purpose so fault drills can change
injected judge latency without restarting the process).  The exemption
only applies when the name is a string literal with one of those
prefixes — a computed name is still flagged.
"""

from __future__ import annotations

import ast
from typing import List

from ..engine import Finding, ParsedModule, dotted_name, enclosing_symbol
from . import Rule

_EXEMPT_SUFFIXES = (
    "serve/config.py",
    "parallel/dist.py",
    "parallel/multihost_smoke.py",
    "llm_weighted_consensus_tpu_torch/ops/_build.py",
)
_EXEMPT_SUBSTR = "llm_weighted_consensus_tpu_torch/bench/"
_PACKAGES = ("llm_weighted_consensus_tpu", "llm_weighted_consensus_tpu_torch")
_EXEMPT_ENV_PREFIXES = ("LWC_", "FAKE_UPSTREAM_")


def _exempt(rel: str) -> bool:
    parts = rel.split("/")
    # the linted package's own analysis/ (the port's, or the reference's
    # when the port's engine lints the reference tree)
    in_analysis = (
        len(parts) > 2 and parts[0] in _PACKAGES and parts[1] == "analysis"
    )
    return (
        rel.endswith(_EXEMPT_SUFFIXES)
        or in_analysis
        or _EXEMPT_SUBSTR in rel
    )


def _exempt_name(node: ast.expr) -> bool:
    return (
        isinstance(node, ast.Constant)
        and isinstance(node.value, str)
        and node.value.startswith(_EXEMPT_ENV_PREFIXES)
    )


def _namespace_exempt_nodes(tree: ast.AST) -> set:
    """ids of nodes whose read targets an exempt-namespace literal.

    ``ast.walk`` is breadth-first (parents before children), so marking
    the inner ``os.environ`` attribute of an exempt ``os.environ.get``
    call here happens before the flagging pass visits it."""
    skip: set = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            fn = dotted_name(node.func)
            if fn == "os.getenv" and node.args and _exempt_name(node.args[0]):
                skip.add(id(node))
            elif (
                fn == "os.environ.get"
                and node.args
                and _exempt_name(node.args[0])
            ):
                skip.add(id(node.func.value))
        elif isinstance(node, ast.Subscript):
            if dotted_name(node.value) == "os.environ" and _exempt_name(
                node.slice
            ):
                skip.add(id(node.value))
    return skip


def check(module: ParsedModule) -> List[Finding]:
    if _exempt(module.rel):
        return []
    skip = _namespace_exempt_nodes(module.tree)
    findings: List[Finding] = []
    for node in ast.walk(module.tree):
        if id(node) in skip:
            continue
        what = None
        if isinstance(node, ast.Attribute):
            if dotted_name(node) == "os.environ":
                what = "os.environ"
        elif isinstance(node, ast.Call):
            if dotted_name(node.func) == "os.getenv":
                what = "os.getenv"
        if what is None:
            continue
        findings.append(
            Finding(
                rule=RULE.name,
                path=module.rel,
                line=node.lineno,
                symbol=enclosing_symbol(module, node),
                message=(
                    f"`{what}` read outside serve/config.py: knobs enter "
                    "through Config.from_env(env) so they stay documented, "
                    "injectable in tests, and visible to the LWC011 "
                    "README-drift check"
                ),
            )
        )
    # one finding per (symbol, line): `os.environ` inside an
    # `os.environ.get(...)` call is a single read, not two
    seen = set()
    unique = []
    for f in findings:
        key = (f.line, f.symbol)
        if key not in seen:
            seen.add(key)
            unique.append(f)
    return unique


RULE = Rule(
    name="LWC008",
    summary="os.environ read outside the serve/config.py boundary",
    check=check,
)
