"""The AST lint engine: parse once, run every rule, apply the baseline.

Counterpart of ``llm_weighted_consensus_tpu/analysis/engine.py``, over
the port's package.  Design constraints that shaped this module:

* **stdlib only** — the test suite runs this over the whole package, so
  it must cost parse time, not import time (no torch; ``rules/``
  modules are equally import-light);
* **function-scoped analysis** — every rule reasons about one function
  body at a time and does NOT descend into nested ``def``/``lambda``
  (those execute in a different dynamic context: an executor thread, a
  later task, a callback).  Nested definitions are visited as their own
  functions instead;
* **symbol-stable baselining** — suppressions match on
  ``(rule, path, symbol)``, never on line numbers, so unrelated edits
  above a known-intentional site don't churn ``baseline.json``.
"""

from __future__ import annotations

import ast
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

# directories never linted inside the package tree
_EXCLUDED_DIRS = {"__pycache__"}


@dataclass
class Finding:
    """One invariant violation (or audit failure).

    ``path`` is repo-relative posix for lint findings and a virtual
    ``dispatch:<label>`` path for dispatch-audit findings; ``symbol`` is the
    enclosing function's qualname (``Class.method``) when one exists —
    the baseline matching key alongside rule and path.
    """

    rule: str
    path: str
    line: int
    message: str
    symbol: Optional[str] = None

    def render(self) -> str:
        where = f"{self.path}:{self.line}"
        sym = f" [{self.symbol}]" if self.symbol else ""
        return f"{where}: {self.rule}{sym}: {self.message}"


@dataclass
class FunctionInfo:
    """One function definition, with the context rules need."""

    qualname: str
    node: ast.AST  # FunctionDef | AsyncFunctionDef
    is_async: bool
    # immediately enclosing class name, if any ("" at module scope)
    class_name: str = ""


@dataclass
class ClassInfo:
    """One class definition with its direct methods — the unit the
    class-scoped concurrency rules (LWC014–016) reason over, where the
    per-function rules reason over one body at a time."""

    name: str
    qualname: str
    node: ast.ClassDef
    # direct methods only (nested defs inside a method are separate
    # FunctionInfo entries in ``functions()``, per the engine contract)
    methods: List[FunctionInfo] = field(default_factory=list)


@dataclass
class ParsedModule:
    path: Path
    rel: str  # repo-relative posix path
    source: str
    tree: ast.Module
    _functions: Optional[List[FunctionInfo]] = field(
        default=None, repr=False
    )
    _classes: Optional[List[ClassInfo]] = field(default=None, repr=False)

    def functions(self) -> List[FunctionInfo]:
        """Every function/method in the module (nested ones included,
        each as its own entry), with dotted qualnames."""
        if self._functions is None:
            self._functions = list(_collect_functions(self.tree))
        return self._functions

    def classes(self) -> List[ClassInfo]:
        """Every class in the module (nested ones included), each with
        its direct methods as FunctionInfo entries."""
        if self._classes is None:
            self._classes = list(_collect_classes(self.tree))
        return self._classes


def _collect_functions(
    tree: ast.Module,
) -> Iterator[FunctionInfo]:
    def walk(node: ast.AST, prefix: str, class_name: str):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}{child.name}" if prefix else child.name
                yield FunctionInfo(
                    qualname=qual,
                    node=child,
                    is_async=isinstance(child, ast.AsyncFunctionDef),
                    class_name=class_name,
                )
                yield from walk(child, f"{qual}.", class_name)
            elif isinstance(child, ast.ClassDef):
                qual = f"{prefix}{child.name}" if prefix else child.name
                yield from walk(child, f"{qual}.", child.name)
            else:
                yield from walk(child, prefix, class_name)

    yield from walk(tree, "", "")


def _collect_classes(tree: ast.Module) -> Iterator[ClassInfo]:
    def walk(node: ast.AST, prefix: str):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                qual = f"{prefix}{child.name}" if prefix else child.name
                methods = [
                    FunctionInfo(
                        qualname=f"{qual}.{m.name}",
                        node=m,
                        is_async=isinstance(m, ast.AsyncFunctionDef),
                        class_name=child.name,
                    )
                    for m in child.body
                    if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                ]
                yield ClassInfo(
                    name=child.name,
                    qualname=qual,
                    node=child,
                    methods=methods,
                )
                yield from walk(child, f"{qual}.")
            elif isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)
            ):
                qual = f"{prefix}{child.name}" if prefix else child.name
                yield from walk(child, f"{qual}.")
            else:
                yield from walk(child, prefix)

    yield from walk(tree, "")


def body_nodes(func: ast.AST) -> Iterator[ast.AST]:
    """Walk a function body WITHOUT descending into nested function or
    lambda definitions — the function-scoped analysis contract."""
    stack: List[ast.AST] = list(ast.iter_child_nodes(func))
    while stack:
        node = stack.pop()
        if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
        ):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def finally_nodes(func: ast.AST) -> set:
    """The set of nodes (by id) living under any ``finally:`` block of
    this function — where releases/resets must land."""
    out: set = set()
    for node in body_nodes(func):
        if isinstance(node, ast.Try) and node.finalbody:
            for stmt in node.finalbody:
                for sub in ast.walk(stmt):
                    out.add(id(sub))
    return out


def call_attr(call: ast.Call) -> Optional[str]:
    """``x.y.z(...)`` -> ``"z"``; None for plain-name calls."""
    if isinstance(call.func, ast.Attribute):
        return call.func.attr
    return None


def call_base(call: ast.Call) -> Optional[str]:
    """``x.y.z(...)`` -> ``"x.y"`` (the receiver expression's source)."""
    if isinstance(call.func, ast.Attribute):
        try:
            return ast.unparse(call.func.value)
        except Exception:  # malformed/exotic node: no receiver match
            return None
    return None


def enclosing_symbol(
    module: ParsedModule, node: ast.AST
) -> Optional[str]:
    """Qualname of the innermost function whose span contains ``node``
    (None for module/class-level code) — the baseline symbol key for
    rules that walk the whole tree instead of per-function bodies."""
    line = getattr(node, "lineno", 0)
    best = None
    best_span = None
    for fn in module.functions():
        end = getattr(fn.node, "end_lineno", fn.node.lineno)
        if fn.node.lineno <= line <= end:
            span = end - fn.node.lineno
            if best_span is None or span < best_span:
                best, best_span = fn.qualname, span
    return best


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` / ``a`` -> its dotted source; None otherwise."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted_name(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


# ---------------------------------------------------------------------------
# Walking + running
# ---------------------------------------------------------------------------


def package_root() -> Path:
    """The ``llm_weighted_consensus_tpu_torch`` package directory."""
    return Path(__file__).resolve().parent.parent


def repo_root() -> Path:
    return package_root().parent


def source_files(root: Optional[Path] = None) -> List[Path]:
    root = root or package_root()
    files = []
    for path in sorted(root.rglob("*.py")):
        if any(part in _EXCLUDED_DIRS for part in path.parts):
            continue
        files.append(path)
    return files


def parse_module(path: Path, rel_to: Optional[Path] = None) -> ParsedModule:
    source = path.read_text(encoding="utf-8")
    tree = ast.parse(source, filename=str(path))
    base = rel_to or repo_root()
    try:
        rel = path.resolve().relative_to(base.resolve()).as_posix()
    except ValueError:
        rel = path.name
    return ParsedModule(path=path, rel=rel, source=source, tree=tree)


def run_lint(
    paths: Optional[Sequence[Path]] = None,
    rules: Optional[Sequence] = None,
    rel_to: Optional[Path] = None,
) -> List[Finding]:
    """Parse every file once, run every rule over each parsed module,
    then every project-scoped rule over the whole parsed set (rules
    whose invariant spans modules — e.g. declared-vs-used registries —
    set ``Rule.project`` instead of/alongside ``check``)."""
    from .rules import ALL_RULES

    rules = list(rules) if rules is not None else list(ALL_RULES)
    files = list(paths) if paths is not None else source_files()
    modules = [parse_module(path, rel_to=rel_to) for path in files]
    findings: List[Finding] = []
    for module in modules:
        for rule in rules:
            if rule.check is not None:
                findings.extend(rule.check(module))
    for rule in rules:
        if getattr(rule, "project", None) is not None:
            findings.extend(rule.project(modules))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


# ---------------------------------------------------------------------------
# Baseline: (rule, path, symbol) suppressions with written reasons
# ---------------------------------------------------------------------------


def default_baseline_path() -> Path:
    return Path(__file__).resolve().parent / "baseline.json"


def load_baseline(path: Optional[Path] = None) -> List[dict]:
    path = path or default_baseline_path()
    if not path.exists():
        return []
    data = json.loads(path.read_text(encoding="utf-8"))
    entries = data["suppressions"] if isinstance(data, dict) else data
    for entry in entries:
        if "reason" not in entry or not str(entry["reason"]).strip():
            raise ValueError(
                f"baseline entry {entry!r} has no reason: every "
                "suppression must say WHY the pattern is intentional"
            )
    return entries


def baseline_entry(finding: Finding, reason: str) -> dict:
    return {
        "rule": finding.rule,
        "path": finding.path,
        "symbol": finding.symbol,
        "reason": reason,
    }


def _matches(entry: dict, finding: Finding) -> bool:
    return (
        entry.get("rule") == finding.rule
        and entry.get("path") == finding.path
        and entry.get("symbol") == finding.symbol
    )


def apply_baseline(
    findings: Iterable[Finding], baseline: Sequence[dict]
) -> Tuple[List[Finding], List[Finding], List[dict]]:
    """-> (kept, suppressed, stale_entries).

    ``stale_entries`` are baseline rows that matched nothing — the
    underlying code was fixed, so the suppression must be deleted (the
    CLI fails on them; a baseline only ever shrinks honestly)."""
    kept: List[Finding] = []
    suppressed: List[Finding] = []
    used = [False] * len(baseline)
    for finding in findings:
        hit = False
        for i, entry in enumerate(baseline):
            if _matches(entry, finding):
                used[i] = True
                hit = True
        (suppressed if hit else kept).append(finding)
    stale = [entry for entry, u in zip(baseline, used) if not u]
    return kept, suppressed, stale
