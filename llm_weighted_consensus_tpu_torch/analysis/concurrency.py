"""Shared machinery for the concurrency-discipline rules (LWC014–016).

Counterpart of ``llm_weighted_consensus_tpu/analysis/concurrency.py``,
extended for the port, which runs on threads where the reference runs
on one loop:

* a primitive a function creates in a local (``lock = threading.Lock()``,
  also ``lock = table[key] = threading.RLock()``) is a creation site
  keyed ``<function qualname>.<local>``, and a bare name inside that
  function or a function nested in it resolves to it;
* a module-level primitive whose bare name the registry does not hold is
  keyed ``<file stem>.<name>`` (three of the port's modules each
  create a module-level ``_lock``);
* a local bound to a lock expression (``guard = mf.dispatch_guard() if
  mf is not None else nullcontext()``) and then entered (``with
  guard:``) acquires that lock;
* a registry entry's ``held_as`` names the ``Class.attr`` fields that
  hold a primitive created elsewhere (``GraphTable.lock`` holds the
  per-device launch lock that ``launch_lock`` creates), so ``with
  self.lock`` in that class resolves to it;
* ``do_*`` methods of a ``BaseHTTPRequestHandler`` subclass are thread
  entries (``ThreadingHTTPServer`` runs each request on its own thread),
  weighted like an executor root;
* LWC016's blocking calls gain the port's device waits
  (``.synchronize()``: a CUDA event's, a stream's, a pending dispatch's,
  ``torch.cuda.synchronize``) and ``http.client``.

The per-function lints never cross function boundaries; the concurrency
auditor must — a data race is by definition a property of two call
paths.  This module builds, once per parsed set, a ``ProjectIndex``:

* the **lock model** (``CONCURRENCY_MODEL``, declared by
  ``analysis/concurrency_model.py`` for the package or inline by a
  fixture — a parsed set that declares no model checks nothing, so
  single-file lint invocations stay self-contained);
* every **lock creation site** (``self.x = threading.Lock()`` et al.)
  for the both-ways registry check;
* per-function **lock facts**: which registered locks each statement
  lexically holds (``with`` nesting), and every acquisition event with
  the locks held at that instant — the static lock-order graph's raw
  edges;
* a name-resolved **call graph** with transitive lock closure, so
  "holding the gate, the dispatch calls into the staging pool which
  takes its own lock" becomes a visible order edge.  Resolution is
  deliberately over-approximate (attribute calls resolve to every
  same-named method/function in the package, minus a blacklist of
  container/stdlib method names that would wire dict.get to
  ``ChoiceIndexer.get``) — over-approximation can only add edges to
  declare, never hide a real one.  Local aliases (``fn = self._x``)
  and the batcher's ``getattr(self, "_dispatch_" + kind)`` prefix
  dispatch are resolved so the guarded dispatch path stays visible;
* **thread entry points**: ``threading.Thread(target=...)`` roots,
  executor ``submit``/``run_in_executor`` roots (an executor root
  counts double — every pool here has >= 2 workers), and the asyncio
  loop (all ``async def`` share ONE entry — the loop is one thread),
  propagated over the call graph.  A field whose accessing methods are
  reached from >= 2 entry weights is cross-thread state.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .engine import ParsedModule, body_nodes

MODEL_NAME = "CONCURRENCY_MODEL"

# threading constructors that create a registrable primitive
_LOCK_CTORS = {"Lock", "RLock", "Condition"}
_CTOR_KIND = {"Lock": "lock", "RLock": "rlock", "Condition": "condition"}

# attribute names never resolved through the call graph: container /
# stdlib / future methods whose package-level namesakes (dict.get vs
# ChoiceIndexer.get) would wire false edges through every critical
# section that touches a dict
_GENERIC_ATTRS = {
    "get",
    "pop",
    "popleft",
    "append",
    "appendleft",
    "extend",
    "extendleft",
    "insert",
    "items",
    "keys",
    "values",
    "setdefault",
    "update",
    "add",
    "clear",
    "remove",
    "discard",
    "sort",
    "copy",
    "count",
    "index",
    "join",
    "split",
    "strip",
    "startswith",
    "endswith",
    "format",
    "encode",
    "decode",
    "lower",
    "upper",
    "replace",
    "put",
    "done",
    "cancel",
    "cancelled",
    "set",
    "is_set",
    "snapshot",
    "render",
    "total_seconds",
    # the port's threads add the threading / concurrent.futures surface
    # (a Future's result() is not Dispatch.result, a Thread's start() is
    # not ProfileRoutes.start, a Condition's wait() is not
    # SingleFlight.wait) and the wire types' serialization protocol and
    # span lifecycle, which every type and span implements.  acquire/
    # release stay resolved: the staging pool's are real order edges
    "wait",
    "wait_for",
    "notify",
    "notify_all",
    "result",
    "exception",
    "set_result",
    "set_exception",
    "add_done_callback",
    "submit",
    "shutdown",
    "start",
    "join",
    "is_alive",
    "finish",
    "to_json_obj",
    "from_json_obj",
}

# entry categories that are concurrent with themselves (a pool of >= 2
# workers, a thread per HTTP request): each counts double
_SELF_CONCURRENT = ("executor:", "http:")

_HTTP_HANDLER_BASES = {"BaseHTTPRequestHandler"}
_HTTP_HANDLER_PREFIX = "do_"

# modules whose functions are never bare-name call-resolution TARGETS:
# the witness's proxies are injected dynamically (never statically
# reachable), and over-approximate resolution would otherwise wire
# every ``cond.wait()``/``lock.acquire()`` in the package into the
# proxy's bookkeeping (and its leaf mutex), fabricating order edges.
# Their own bodies are still indexed and checked (LWC014 guards the
# witness's fields; ``self.m()`` resolution inside them stays precise).
_OUT_OF_GRAPH_SUFFIXES = ("analysis/witness.py",)

_EXEMPT_RE = re.compile(
    r"#\s*caller-holds-lock:\s*(?P<lock>[\w.]+)\s*(?:[(\[—–-]\s*"
    r"(?P<reason>[^)\]]*\S)\s*[)\]]?)?"
)


# ---------------------------------------------------------------------------
# Lock model
# ---------------------------------------------------------------------------


@dataclass
class LockModel:
    locks: Dict[str, dict]
    order: List[Tuple[str, str]]
    order_runtime: List[tuple]
    module: ParsedModule
    line: int

    def in_scope(self, key: str, modules: Sequence[ParsedModule]) -> bool:
        """Whether the entry's declaring module is part of this parsed
        set — staleness is only judged when it is (single-file runs
        must not call every other entry stale)."""
        suffix = self.locks[key].get("module", "")
        return any(m.rel.endswith(suffix) for m in modules)

    def lock_for(self, class_name: str, attr: str) -> Optional[str]:
        key = f"{class_name}.{attr}"
        if key in self.locks:
            return key
        return self.held_as().get(key)

    def held_as(self) -> Dict[str, str]:
        """``Class.attr`` holder field -> the lock key it holds."""
        out: Dict[str, str] = {}
        for key, entry in self.locks.items():
            for holder in entry.get("held_as", ()):
                out[holder] = key
        return out

    def name_key(
        self, name: str, module_rel: str, qualname: str = ""
    ) -> Optional[str]:
        """A bare name inside function ``qualname`` of ``module_rel`` ->
        the lock key it names: a local of that function or of one it is
        nested in, else a module-level lock (``<stem>.<name>``, or the
        bare name)."""
        parts = qualname.split(".") if qualname else []
        for i in range(len(parts), 0, -1):
            key = ".".join(parts[:i]) + "." + name
            if key in self.locks and module_rel.endswith(
                self.locks[key].get("module", "")
            ):
                return key
        stem = module_rel.rsplit("/", 1)[-1].rsplit(".", 1)[0]
        for key in (f"{stem}.{name}", name):
            if key in self.locks and module_rel.endswith(
                self.locks[key].get("module", "")
            ):
                return key
        return name if name in self.locks else None

    def via(self) -> Dict[str, str]:
        """acquire_via method name -> lock key."""
        out: Dict[str, str] = {}
        for key, entry in self.locks.items():
            for name in entry.get("acquire_via", ()):
                out[name] = key
        return out


def load_model(modules: Sequence[ParsedModule]) -> Optional[LockModel]:
    """The parsed set's ``CONCURRENCY_MODEL`` literal, if any module
    declares one at module level (last declaration wins)."""
    found = None
    for module in modules:
        for node in module.tree.body:
            if not isinstance(node, ast.Assign):
                continue
            if not any(
                isinstance(t, ast.Name) and t.id == MODEL_NAME
                for t in node.targets
            ):
                continue
            try:
                data = ast.literal_eval(node.value)
            except (ValueError, SyntaxError):
                continue
            if isinstance(data, dict) and isinstance(
                data.get("locks"), dict
            ):
                found = LockModel(
                    locks=dict(data["locks"]),
                    order=[tuple(e) for e in data.get("order", ())],
                    order_runtime=[
                        tuple(e) for e in data.get("order_runtime", ())
                    ],
                    module=module,
                    line=node.lineno,
                )
    return found


@dataclass
class LockSite:
    """One ``<target> = threading.Lock()`` creation site."""

    key: str  # "Class.attr" (or bare name at module level)
    kind: str  # "lock" | "rlock" | "condition"
    module: ParsedModule
    node: ast.AST
    class_name: str  # "" for module-level locks


def _ctor_kind(value: ast.AST) -> Optional[str]:
    """``threading.Lock()`` / ``Lock()`` -> "lock"; None otherwise."""
    if not isinstance(value, ast.Call):
        return None
    func = value.func
    name = None
    if isinstance(func, ast.Attribute) and isinstance(
        func.value, ast.Name
    ):
        if func.value.id == "threading":
            name = func.attr
    elif isinstance(func, ast.Name):
        name = func.id
    return _CTOR_KIND.get(name) if name in _LOCK_CTORS else None


def _module_key(
    name: str, module: ParsedModule, model: Optional[LockModel]
) -> str:
    """A module-level lock's key: its bare name when the registry holds
    it for this module (or there is no registry), else
    ``<file stem>.<name>``."""
    entry = model.locks.get(name) if model is not None else None
    if model is None or (
        entry is not None and module.rel.endswith(entry.get("module", ""))
    ):
        return name
    stem = module.rel.rsplit("/", 1)[-1].rsplit(".", 1)[0]
    return f"{stem}.{name}"


def lock_sites(
    modules: Sequence[ParsedModule], model: Optional[LockModel] = None
) -> List[LockSite]:
    """Every threading-primitive creation site in the parsed set."""
    sites: List[LockSite] = []
    for module in modules:
        # module-level: NAME = threading.Lock()
        for node in module.tree.body:
            if isinstance(node, ast.Assign):
                kind = _ctor_kind(node.value)
                if kind and isinstance(node.targets[0], ast.Name):
                    sites.append(
                        LockSite(
                            key=_module_key(
                                node.targets[0].id, module, model
                            ),
                            kind=kind,
                            module=module,
                            node=node,
                            class_name="",
                        )
                    )
        # function locals: name = threading.Lock() (a dict may hold it
        # too: name = table[key] = threading.RLock())
        for fn in module.functions():
            for node in body_nodes(fn.node):
                if not isinstance(node, ast.Assign):
                    continue
                kind = _ctor_kind(node.value)
                if kind is None or not isinstance(node.targets[0], ast.Name):
                    continue
                sites.append(
                    LockSite(
                        key=f"{fn.qualname}.{node.targets[0].id}",
                        kind=kind,
                        module=module,
                        node=node,
                        class_name=fn.class_name,
                    )
                )
        # instance fields: self.x = threading.Lock() in any method
        for cls in module.classes():
            for method in cls.methods:
                for node in body_nodes(method.node):
                    if not isinstance(node, ast.Assign):
                        continue
                    kind = _ctor_kind(node.value)
                    if kind is None:
                        continue
                    target = node.targets[0]
                    if (
                        isinstance(target, ast.Attribute)
                        and isinstance(target.value, ast.Name)
                        and target.value.id == "self"
                    ):
                        sites.append(
                            LockSite(
                                key=f"{cls.name}.{target.attr}",
                                kind=kind,
                                module=module,
                                node=node,
                                class_name=cls.name,
                            )
                        )
    return sites


# ---------------------------------------------------------------------------
# Per-function lock facts
# ---------------------------------------------------------------------------


@dataclass
class LockFacts:
    """Lexical lock state for one function body."""

    # (lock key, acquisition node, locks held just before)
    acquisitions: List[Tuple[str, ast.AST, Tuple[str, ...]]] = field(
        default_factory=list
    )
    # every body node with the registered locks lexically held there
    nodes: List[Tuple[ast.AST, Tuple[str, ...]]] = field(
        default_factory=list
    )


def _resolve_lock_expr(
    expr: ast.AST,
    class_name: str,
    model: LockModel,
    via: Dict[str, str],
    scope: Tuple[str, str] = ("", ""),
) -> Optional[str]:
    """A with-item context expression (or acquire receiver) -> lock key.

    ``self._lock`` resolves inside the owning class (or through a
    registry entry's ``held_as``); ``x.shared()`` / ``x.exclusive()`` /
    ``x.dispatch_guard()`` resolve through ``acquire_via``; a bare name
    resolves to a local of the enclosing function chain or a
    module-level lock key (``scope`` is the (module rel, qualname) the
    expression lives in).
    """
    if isinstance(expr, ast.Call):
        if isinstance(expr.func, ast.Attribute):
            hit = via.get(expr.func.attr)
            if hit is not None:
                return hit
        if isinstance(expr.func, ast.Name):
            hit = via.get(expr.func.id)
            if hit is not None:
                return hit
        return None
    if (
        isinstance(expr, ast.Attribute)
        and isinstance(expr.value, ast.Name)
        and expr.value.id == "self"
        and class_name
    ):
        return model.lock_for(class_name, expr.attr)
    if isinstance(expr, ast.Name):
        return model.name_key(expr.id, scope[0], scope[1])
    return None


def lock_facts(
    func_node: ast.AST,
    class_name: str,
    model: LockModel,
    via: Dict[str, str],
    scope: Tuple[str, str] = ("", ""),
) -> LockFacts:
    facts = LockFacts()
    # the port's addition: a local bound to a lock expression (``guard =
    # mf.dispatch_guard() if mf is not None else nullcontext()``), then
    # entered as ``with guard:``
    local_locks: Dict[str, str] = {}
    for node in body_nodes(func_node):
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
        ):
            values = (
                [node.value.body, node.value.orelse]
                if isinstance(node.value, ast.IfExp)
                else [node.value]
            )
            for value in values:
                key = _resolve_lock_expr(value, class_name, model, via, scope)
                if key is not None:
                    local_locks[node.targets[0].id] = key

    def resolve(expr: ast.AST) -> Optional[str]:
        if isinstance(expr, ast.Name) and expr.id in local_locks:
            return local_locks[expr.id]
        return _resolve_lock_expr(expr, class_name, model, via, scope)

    def note(node: ast.AST, held: Tuple[str, ...]) -> None:
        facts.nodes.append((node, held))
        # raw lock.acquire() call: an acquisition event for the order
        # graph (no held-region tracking — `with` is the idiom)
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "acquire"
        ):
            key = resolve(node.func.value)
            if key is not None:
                facts.acquisitions.append((key, node, held))

    def visit(node: ast.AST, held: Tuple[str, ...]) -> None:
        if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
        ):
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            inner = held
            for item in node.items:
                for sub in ast.walk(item.context_expr):
                    note(sub, inner)
                key = resolve(item.context_expr)
                if key is not None:
                    facts.acquisitions.append((key, node, inner))
                    inner = inner + (key,)
            for stmt in node.body:
                visit(stmt, inner)
            return
        note(node, held)
        for child in ast.iter_child_nodes(node):
            visit(child, held)

    for stmt in func_node.body:
        visit(stmt, ())
    return facts


# ---------------------------------------------------------------------------
# Exemption comments
# ---------------------------------------------------------------------------


@dataclass
class Exemption:
    lock: str
    reason: Optional[str]
    line: int


def method_exemptions(
    module: ParsedModule, func_node: ast.AST
) -> List[Exemption]:
    """``# caller-holds-lock: <Lock.key> (reason)`` on the ``def`` line
    or the line immediately above it."""
    lines = module.source.splitlines()
    out: List[Exemption] = []
    for lineno in (func_node.lineno - 1, func_node.lineno):
        if 1 <= lineno <= len(lines):
            match = _EXEMPT_RE.search(lines[lineno - 1])
            if match:
                reason = match.group("reason")
                out.append(
                    Exemption(
                        lock=match.group("lock"),
                        reason=reason.strip() if reason else None,
                        line=lineno,
                    )
                )
    return out


# ---------------------------------------------------------------------------
# Project index: call graph, entry points, transitive locks
# ---------------------------------------------------------------------------

FKey = Tuple[str, str]  # (module.rel, qualname)


@dataclass
class FuncEntry:
    module: ParsedModule
    qualname: str
    node: ast.AST
    is_async: bool
    class_name: str
    facts: LockFacts
    _held_map: Optional[Dict[int, Tuple[str, ...]]] = None

    def held_by_node(self) -> Dict[int, Tuple[str, ...]]:
        """id(node) -> registered locks lexically held at that node."""
        if self._held_map is None:
            self._held_map = {
                id(node): held for node, held in self.facts.nodes
            }
        return self._held_map


class ProjectIndex:
    def __init__(
        self, modules: Sequence[ParsedModule], model: LockModel
    ) -> None:
        self.modules = list(modules)
        self.model = model
        self.via = model.via()
        self.funcs: Dict[FKey, FuncEntry] = {}
        self.methods_by_name: Dict[str, List[FKey]] = {}
        self.module_funcs_by_name: Dict[str, List[FKey]] = {}
        self.class_methods: Dict[Tuple[str, str], Dict[str, FKey]] = {}
        for module in modules:
            in_graph = not module.rel.endswith(_OUT_OF_GRAPH_SUFFIXES)
            for cls in module.classes():
                table: Dict[str, FKey] = {}
                for m in cls.methods:
                    fkey = (module.rel, m.qualname)
                    table[m.node.name] = fkey
                    if in_graph:
                        self.methods_by_name.setdefault(
                            m.node.name, []
                        ).append(fkey)
                self.class_methods[(module.rel, cls.name)] = table
            for fn in module.functions():
                fkey = (module.rel, fn.qualname)
                self.funcs[fkey] = FuncEntry(
                    module=module,
                    qualname=fn.qualname,
                    node=fn.node,
                    is_async=fn.is_async,
                    class_name=fn.class_name,
                    facts=lock_facts(
                        fn.node,
                        fn.class_name,
                        model,
                        self.via,
                        (module.rel, fn.qualname),
                    ),
                )
                if (
                    in_graph
                    and fn.class_name == ""
                    and "." not in fn.qualname
                ):
                    self.module_funcs_by_name.setdefault(
                        fn.qualname, []
                    ).append(fkey)
        self.call_edges: Dict[FKey, Set[FKey]] = {}
        self.entry_sets: Dict[FKey, Set[str]] = {
            k: set() for k in self.funcs
        }
        self._build_graph()
        self._note_http_entries()
        self.direct_locks: Dict[FKey, Set[str]] = {
            k: {key for key, _, _ in e.facts.acquisitions}
            for k, e in self.funcs.items()
        }
        self.trans_locks = self._closure(self.direct_locks)
        self.direct_blocking: Dict[FKey, Optional[str]] = {
            k: _first_blocking(e.node) for k, e in self.funcs.items()
        }
        self._propagate_entries()

    # -- resolution ---------------------------------------------------------

    def _local_aliases(
        self, fkey: FKey, entry: FuncEntry
    ) -> Dict[str, Set[FKey]]:
        """``fn = self._dispatch_packed`` / ``fn = getattr(self,
        "_dispatch_" + kind)`` local single-name aliases."""
        aliases: Dict[str, Set[FKey]] = {}
        table = self.class_methods.get(
            (entry.module.rel, entry.class_name), {}
        )
        for node in body_nodes(entry.node):
            if not isinstance(node, ast.Assign):
                continue
            if len(node.targets) != 1 or not isinstance(
                node.targets[0], ast.Name
            ):
                continue
            name = node.targets[0].id
            targets = self._ref_targets(node.value, entry, table)
            if targets:
                aliases.setdefault(name, set()).update(targets)
        return aliases

    def _prefix_methods(
        self, table: Dict[str, FKey], prefix: str
    ) -> Set[FKey]:
        return {
            fkey
            for mname, fkey in table.items()
            if mname.startswith(prefix)
        }

    def _ref_targets(
        self,
        expr: ast.AST,
        entry: FuncEntry,
        table: Dict[str, FKey],
    ) -> Set[FKey]:
        """A callable *reference* (not a call) -> candidate functions:
        ``self.m``, ``x.m``, a bare name, ``functools.partial(f, ...)``
        or ``getattr(self, "prefix" + dynamic)``."""
        if isinstance(expr, ast.Attribute):
            if (
                isinstance(expr.value, ast.Name)
                and expr.value.id == "self"
                and expr.attr in table
            ):
                return {table[expr.attr]}
            if expr.attr in _GENERIC_ATTRS:
                return set()
            out = set(self.methods_by_name.get(expr.attr, ()))
            out.update(self.module_funcs_by_name.get(expr.attr, ()))
            return out
        if isinstance(expr, ast.Name):
            hits = self.module_funcs_by_name.get(expr.id, ())
            same = {k for k in hits if k[0] == entry.module.rel}
            return same or set(hits)
        if isinstance(expr, ast.Call):
            func = expr.func
            fname = (
                func.id
                if isinstance(func, ast.Name)
                else func.attr if isinstance(func, ast.Attribute) else None
            )
            if fname == "partial" and expr.args:
                return self._ref_targets(expr.args[0], entry, table)
            if fname == "getattr" and len(expr.args) >= 2:
                prefix = _literal_prefix(expr.args[1])
                if prefix is not None:
                    return self._prefix_methods(table, prefix)
        return set()

    def _call_targets(
        self,
        call: ast.Call,
        entry: FuncEntry,
        table: Dict[str, FKey],
        aliases: Dict[str, Set[FKey]],
    ) -> Set[FKey]:
        func = call.func
        if isinstance(func, ast.Name):
            if func.id in aliases:
                return aliases[func.id]
            if func.id in _parameters(entry.node):
                return set()  # a callable the caller passed in
            hits = self.module_funcs_by_name.get(func.id, ())
            same = {k for k in hits if k[0] == entry.module.rel}
            return same or set(hits)
        if isinstance(func, ast.Attribute):
            if (
                isinstance(func.value, ast.Name)
                and func.value.id == "self"
                and func.attr in table
            ):
                return {table[func.attr]}
            if func.attr in _GENERIC_ATTRS:
                return set()
            out = set(self.methods_by_name.get(func.attr, ()))
            out.update(self.module_funcs_by_name.get(func.attr, ()))
            return out
        if isinstance(func, ast.Call):  # getattr(self, "...")(args)
            return self._ref_targets(func, entry, table)
        return set()

    # -- graph construction -------------------------------------------------

    def _build_graph(self) -> None:
        self.call_sites: Dict[FKey, List[Tuple[FKey, ast.Call]]] = {}
        for fkey, entry in self.funcs.items():
            table = self.class_methods.get(
                (entry.module.rel, entry.class_name), {}
            )
            aliases = self._local_aliases(fkey, entry)
            edges: Set[FKey] = set()
            for node in body_nodes(entry.node):
                if not isinstance(node, ast.Call):
                    continue
                targets = self._call_targets(node, entry, table, aliases)
                for target in targets:
                    self.call_sites.setdefault(target, []).append(
                        (fkey, node)
                    )
                edges |= targets
                self._note_entry_roots(node, entry, table, aliases)
            edges.discard(fkey)
            self.call_edges[fkey] = edges
            if entry.is_async:
                self.entry_sets[fkey].add("loop")

    def _note_entry_roots(
        self,
        call: ast.Call,
        entry: FuncEntry,
        table: Dict[str, FKey],
        aliases: Dict[str, Set[FKey]],
    ) -> None:
        func = call.func
        fname = (
            func.id
            if isinstance(func, ast.Name)
            else func.attr if isinstance(func, ast.Attribute) else None
        )
        ref = None
        category = None
        if fname == "Thread":
            for kw in call.keywords:
                if kw.arg == "target":
                    ref, category = kw.value, "thread"
        elif fname == "submit" and call.args:
            ref, category = call.args[0], "executor"
        elif fname == "run_in_executor" and len(call.args) >= 2:
            ref, category = call.args[1], "executor"
        if ref is None:
            return
        if isinstance(ref, ast.Name) and ref.id in aliases:
            targets = aliases[ref.id]
        else:
            targets = self._ref_targets(ref, entry, table)
        for fkey in targets:
            self.entry_sets[fkey].add(f"{category}:{fkey[1]}")

    def _note_http_entries(self) -> None:
        """``do_*`` methods of ``BaseHTTPRequestHandler`` subclasses: a
        ``ThreadingHTTPServer`` runs each request on a thread of its
        own."""
        for module in self.modules:
            for cls in module.classes():
                bases = {
                    b.id if isinstance(b, ast.Name)
                    else b.attr if isinstance(b, ast.Attribute) else ""
                    for b in cls.node.bases
                }
                if not bases & _HTTP_HANDLER_BASES:
                    continue
                for m in cls.methods:
                    if m.node.name.startswith(_HTTP_HANDLER_PREFIX):
                        fkey = (module.rel, m.qualname)
                        self.entry_sets[fkey].add(f"http:{m.qualname}")

    def _closure(
        self, direct: Dict[FKey, Set[str]]
    ) -> Dict[FKey, Set[str]]:
        """Caller inherits every lock its callees (transitively)
        acquire — fixpoint over the call graph."""
        trans = {k: set(v) for k, v in direct.items()}
        changed = True
        while changed:
            changed = False
            for fkey, callees in self.call_edges.items():
                mine = trans[fkey]
                before = len(mine)
                for callee in callees:
                    mine |= trans.get(callee, set())
                changed = changed or len(mine) != before
        return trans

    def _propagate_entries(self) -> None:
        changed = True
        while changed:
            changed = False
            for fkey, callees in self.call_edges.items():
                src = self.entry_sets[fkey]
                if not src:
                    continue
                for callee in callees:
                    dst = self.entry_sets.get(callee)
                    if dst is None or src <= dst:
                        continue
                    dst |= src
                    changed = True

    # -- queries ------------------------------------------------------------

    def entry_weight(self, fkey: FKey) -> int:
        """Distinct thread-entry weight reaching this function: each
        Thread target and the loop count 1; an executor root or an HTTP
        handler counts 2 (one root is already concurrent with
        itself)."""
        return entries_weight(self.entry_sets.get(fkey, ()))


def entries_weight(entries) -> int:
    """The thread-entry weight of a set of entry ids."""
    return sum(
        2 if entry.startswith(_SELF_CONCURRENT) else 1 for entry in entries
    )


def _parameters(func_node: ast.AST) -> Set[str]:
    """The names a function binds as parameters."""
    args = getattr(func_node, "args", None)
    if args is None:
        return set()
    names = [a.arg for a in args.posonlyargs + args.args + args.kwonlyargs]
    names += [a.arg for a in (args.vararg, args.kwarg) if a is not None]
    return set(names)


def _literal_prefix(node: ast.AST) -> Optional[str]:
    """``"_dispatch_" + kind`` / f-string / constant -> literal prefix."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        return _literal_prefix(node.left)
    if isinstance(node, ast.JoinedStr) and node.values:
        head = node.values[0]
        if isinstance(head, ast.Constant) and isinstance(
            head.value, str
        ):
            return head.value
    return None


# blocking-call classification for LWC016 (extends LWC006/013 to
# held-lock context): device readiness waits and upstream HTTP.  The
# port's device waits are ``wait_device_ready`` and ``.synchronize()``
# (``torch.cuda.synchronize``, a CUDA event's or stream's, a pending
# dispatch's); ``getresponse`` is ``http.client``'s blocking read
_BLOCKING_NAMES = {
    "wait_device_ready",
    "block_until_ready",
    "synchronize",
    "getresponse",
}
_HTTP_DOTTED = {
    "http.client.HTTPConnection",
    "http.client.HTTPSConnection",
    "socket.create_connection",
    "requests.get",
    "requests.post",
    "requests.put",
    "requests.delete",
    "requests.request",
    "requests.head",
    "urllib.request.urlopen",
}


def blocking_call(node: ast.AST) -> Optional[str]:
    """Human-readable description if ``node`` is a blocking operation
    LWC016 forbids under a held threading lock; None otherwise."""
    if isinstance(node, ast.Await):
        return "an `await`"
    if not isinstance(node, ast.Call):
        return None
    func = node.func
    if isinstance(func, ast.Name) and func.id in _BLOCKING_NAMES:
        return f"`{func.id}(...)`"
    if isinstance(func, ast.Attribute):
        if func.attr in _BLOCKING_NAMES:
            return f"`.{func.attr}(...)`"
        try:
            dotted = ast.unparse(func)
        except Exception:
            dotted = ""
        for known in _HTTP_DOTTED:
            if dotted == known or dotted.endswith("." + known):
                return f"upstream HTTP call `{dotted}(...)`"
    return None


def _first_blocking(func_node: ast.AST) -> Optional[str]:
    for node in body_nodes(func_node):
        desc = blocking_call(node)
        if desc is not None:
            return desc
    return None


# index cache: the three rules each call project() over the same parsed
# set within one run_lint; build the (call graph + closures) once.
# Keyed by object ids — valid because run_lint holds the modules alive
# across its project-rule loop.
_INDEX_CACHE: Dict[tuple, ProjectIndex] = {}


def project_index(
    modules: Sequence[ParsedModule],
) -> Optional[ProjectIndex]:
    model = load_model(modules)
    if model is None:
        return None
    cache_key = tuple(id(m) for m in modules)
    idx = _INDEX_CACHE.get(cache_key)
    if idx is None:
        idx = ProjectIndex(modules, model)
        _INDEX_CACHE.clear()
        _INDEX_CACHE[cache_key] = idx
    return idx
