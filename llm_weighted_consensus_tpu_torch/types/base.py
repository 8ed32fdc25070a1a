"""Declarative wire-type system with a generic streaming merge algebra.

The reference implements every response type as a serde struct with a hand
written ``push`` merge (reference: src/chat/completions/response.rs:23-302 and
the same pattern at score/multichat level).  The merge rules form a small
algebra:

* strings concatenate,
* numeric totals add,
* optionals are first-write-wins,
* keyed lists (choices by ``index``, tool calls by ``index``) merge per key,
* plain lists extend,
* nested structs recurse.

Instead of hand-writing ~30 ``push`` implementations we declare each struct's
fields once with a merge strategy and derive ``push``/``to_json_obj``/
``from_json_obj`` generically.  ``fold(push, chunks) == unary`` then holds by
construction and is property-tested in tests/test_merge_algebra.py.

This module is pure Python (no IO, no JAX) and is safe to import anywhere —
the analog of the reference's wasm-safe core (src/main.rs:242-243).

The port's copy of ``llm_weighted_consensus_tpu/types/base.py``, the
``HOST_FASTPATH`` splice encoder (``SpliceEncoder``) included.
"""

from __future__ import annotations

import dataclasses
import sys
from decimal import Decimal
from typing import Any, Callable, Optional

from ..utils import jsonutil

MISSING = dataclasses.MISSING


class SchemaError(ValueError):
    """Raised when a JSON payload does not match the declared schema."""

    def __init__(self, path: str, message: str):
        self.path = path
        super().__init__(f"{path}: {message}" if path else message)


# ---------------------------------------------------------------------------
# Field specs
# ---------------------------------------------------------------------------

# Merge strategies (the `push` algebra):
FIRST = "first"      # first-write-wins (Option<T> semantics)
CONCAT = "concat"    # string concatenation
ADD = "add"          # numeric addition (int / Decimal)
EXTEND = "extend"    # list concatenation
KEYED = "keyed"      # list merged per-element by a key field (default "index")
NESTED = "nested"    # recurse into nested Struct.push
KEEP = "keep"        # never overwritten by pushes (id/created/model/object)


def field(
    spec,
    *,
    default=MISSING,
    default_factory=MISSING,
    merge: str = FIRST,
    skip_if_none: bool = True,
    key: str = "index",
    json_name: Optional[str] = None,
    required: bool = False,
):
    """Declare a struct field.

    ``spec`` describes the JSON codec for the value (see the spec mini-language
    below).  ``merge`` picks the push strategy.  ``skip_if_none`` mirrors
    serde's ``skip_serializing_if = "Option::is_none"``.  ``required=True``
    makes the field mandatory on parse even when a Python-side construction
    default exists (serde has no ``#[serde(default)]`` on it).
    """
    metadata = {
        "spec": spec,
        "merge": merge,
        "skip_if_none": skip_if_none,
        "key": key,
        "json_name": json_name,
        "required": required,
    }
    kwargs: dict[str, Any] = {"metadata": metadata}
    if default is not MISSING:
        kwargs["default"] = default
    if default_factory is not MISSING:
        kwargs["default_factory"] = default_factory
    return dataclasses.field(**kwargs)


# --- spec mini-language -----------------------------------------------------
#
# A spec is one of:
#   str / int / bool / float / Decimal  - scalar codecs
#   RAW                                 - passthrough JSON value
#   a Struct subclass                   - nested struct
#   List(spec)                          - homogeneous array
#   Map(spec)                           - string-keyed object (order-preserving)
#   Union(...)                          - untagged union, first parse wins
#   Enum(*values)                       - closed set of strings
#   Const(value)                        - fixed string (unit enum variants like
#                                         "chat.completion.chunk")

RAW = object()


class List:
    def __init__(self, spec):
        self.spec = spec


class Map:
    def __init__(self, spec):
        self.spec = spec


class Union:
    """Untagged union; parse attempts run in declaration order.

    Mirrors serde's ``#[serde(untagged)]``; order matters exactly the way
    variant order matters in the reference enums.
    """

    def __init__(self, *specs):
        self.specs = specs


class Enum:
    def __init__(self, *values: str):
        self.values = values


class Const:
    def __init__(self, value: str):
        self.value = value


class Lazy:
    """Spec resolved on first use — breaks import cycles (e.g. score request's
    ``model`` field referencing identity.ModelBase)."""

    def __init__(self, thunk: Callable):
        self.thunk = thunk
        self._spec = None

    def spec(self):
        if self._spec is None:
            self._spec = self.thunk()
        return self._spec


class TaggedUnion:
    """Internally tagged union (serde ``#[serde(tag = "...")]``).

    ``variants`` maps tag value -> Struct subclass.  The tag is injected /
    stripped during serialization.  Used for the ``Message`` role tree and
    rich content parts.
    """

    def __init__(self, tag: str, variants: dict):
        self.tag = tag
        self.variants = variants


def _decode(spec, obj, path: str):
    if isinstance(spec, Lazy):
        spec = spec.spec()
    if spec is RAW:
        return obj
    if spec is str:
        if not isinstance(obj, str):
            raise SchemaError(path, f"expected string, got {type(obj).__name__}")
        return obj
    if spec is bool:
        if not isinstance(obj, bool):
            raise SchemaError(path, f"expected bool, got {type(obj).__name__}")
        return obj
    if spec is int:
        if isinstance(obj, bool) or not isinstance(obj, int):
            raise SchemaError(path, f"expected integer, got {type(obj).__name__}")
        return obj
    if spec is float:
        if isinstance(obj, bool) or not isinstance(obj, (int, float, Decimal)):
            raise SchemaError(path, f"expected number, got {type(obj).__name__}")
        return float(obj)
    if spec is Decimal:
        if isinstance(obj, bool) or not isinstance(obj, (int, float, Decimal)):
            raise SchemaError(path, f"expected number, got {type(obj).__name__}")
        return obj if isinstance(obj, Decimal) else Decimal(str(obj))
    if isinstance(spec, Const):
        if obj != spec.value:
            raise SchemaError(path, f"expected {spec.value!r}, got {obj!r}")
        return obj
    if isinstance(spec, Enum):
        if obj not in spec.values:
            raise SchemaError(path, f"expected one of {spec.values}, got {obj!r}")
        return obj
    if isinstance(spec, List):
        if not isinstance(obj, list):
            raise SchemaError(path, f"expected array, got {type(obj).__name__}")
        return [_decode(spec.spec, v, f"{path}[{i}]") for i, v in enumerate(obj)]
    if isinstance(spec, Map):
        if not isinstance(obj, dict):
            raise SchemaError(path, f"expected object, got {type(obj).__name__}")
        return {k: _decode(spec.spec, v, f"{path}.{k}") for k, v in obj.items()}
    if isinstance(spec, Union):
        errors = []
        for sub in spec.specs:
            try:
                return _decode(sub, obj, path)
            except SchemaError as e:
                errors.append(str(e))
        raise SchemaError(path, "no union variant matched: " + "; ".join(errors))
    if isinstance(spec, TaggedUnion):
        if not isinstance(obj, dict):
            raise SchemaError(path, f"expected object, got {type(obj).__name__}")
        tag = obj.get(spec.tag)
        cls = spec.variants.get(tag)
        if cls is None:
            raise SchemaError(
                path, f"unknown {spec.tag} {tag!r} (expected one of {list(spec.variants)})"
            )
        rest = {k: v for k, v in obj.items() if k != spec.tag}
        return cls.from_json_obj(rest, path=path)
    if isinstance(spec, type) and issubclass(spec, Struct):
        return spec.from_json_obj(obj, path=path)
    raise TypeError(f"bad field spec {spec!r}")


def _encode(spec, value):
    if isinstance(spec, Lazy):
        spec = spec.spec()
    if value is None:
        return None
    if spec is RAW or spec in (str, bool, int, float, Decimal):
        return value
    if isinstance(spec, (Const, Enum)):
        return value
    if isinstance(spec, List):
        return [_encode(spec.spec, v) for v in value]
    if isinstance(spec, Map):
        return {k: _encode(spec.spec, v) for k, v in value.items()}
    if isinstance(spec, Union):
        # runtime type decides the encoding (first matching variant wins,
        # mirroring serde untagged serialization by variant type)
        for sub in spec.specs:
            if _spec_matches(sub, value):
                return _encode(sub, value)
        return _encode_dynamic(value)
    if isinstance(spec, TaggedUnion):
        for tag, cls in spec.variants.items():
            if type(value) is cls:
                obj = value.to_json_obj()
                return {spec.tag: tag, **obj}
        raise TypeError(f"value {type(value)!r} not a member of tagged union")
    if isinstance(spec, type) and issubclass(spec, Struct):
        return value.to_json_obj()
    raise TypeError(f"bad field spec {spec!r}")


def _spec_matches(spec, value) -> bool:
    """Best-effort runtime check that ``value`` belongs to ``spec``."""
    if isinstance(spec, Lazy):
        spec = spec.spec()
    if spec is RAW:
        return True
    if spec is str:
        return isinstance(value, str)
    if spec is bool:
        return isinstance(value, bool)
    if spec is int:
        return isinstance(value, int) and not isinstance(value, bool)
    if spec in (float, Decimal):
        return isinstance(value, (int, float, Decimal)) and not isinstance(value, bool)
    if isinstance(spec, Const):
        return value == spec.value
    if isinstance(spec, Enum):
        return value in spec.values
    if isinstance(spec, List):
        return isinstance(value, list)
    if isinstance(spec, Map):
        return isinstance(value, dict)
    if isinstance(spec, Union):
        return any(_spec_matches(sub, value) for sub in spec.specs)
    if isinstance(spec, TaggedUnion):
        return any(type(value) is cls for cls in spec.variants.values())
    if isinstance(spec, type) and issubclass(spec, Struct):
        return isinstance(value, spec)
    return False


def _encode_dynamic(value):
    if isinstance(value, Struct):
        return value.to_json_obj()
    if isinstance(value, list):
        return [_encode_dynamic(v) for v in value]
    if isinstance(value, dict):
        return {k: _encode_dynamic(v) for k, v in value.items()}
    return value


# ---------------------------------------------------------------------------
# Struct base
# ---------------------------------------------------------------------------


def _class_plan(cls, attr: str, build):
    """Per-class cache stored on the class itself (``cls.__dict__`` probe,
    NOT getattr: a subclass must not inherit its base's plan), so plans
    are garbage-collected with their class and cost one dict lookup per
    call.  Field specs are frozen at class-definition time (everything
    here re-derives what the hot methods used to pull from
    ``dataclasses.fields`` metadata on every call — mappingproxy lookups
    measured as a top host cost in a profiled scored request; push/clone/
    to_json_obj run per chunk per judge)."""
    plan = cls.__dict__.get(attr)
    if plan is None:
        plan = build(cls)
        setattr(cls, attr, plan)
    return plan


def _build_names(cls):
    return tuple(f.name for f in dataclasses.fields(cls))


def _build_push(cls):
    return tuple(
        (
            f.name,
            f.metadata.get("merge", FIRST),
            f.metadata.get("key", "index"),
        )
        for f in dataclasses.fields(cls)
    )


def _speccless_error(cls, name):
    return TypeError(
        f"{cls.__name__}.{name} was declared without the field() "
        "helper (no codec spec in metadata) — it can be pushed/cloned "
        "but not (de)serialized"
    )


def _build_encode(cls):
    # a spec-less field (declared without the field() helper — push/clone-
    # only state) stays in the plan with a None spec sentinel: encoding is
    # fine while its value is None (nothing to emit), and raises the
    # declaration error only when a real value would need a codec.
    # Raising at plan-build time instead would poison to_json_obj for the
    # WHOLE class the first time any instance serialized, even if the
    # spec-less field was never set.
    return tuple(
        (
            f.name,
            f.metadata.get("json_name") or f.name,
            f.metadata.get("skip_if_none", True),
            f.metadata.get("spec"),
        )
        for f in dataclasses.fields(cls)
    )


def _build_decode(cls):
    # spec-less fields are excluded outright: incoming JSON can't target
    # them (no json name contract), so they simply keep their default
    return tuple(
        (
            f.name,
            f.metadata.get("json_name") or f.name,
            f.metadata["spec"],
            bool(f.metadata.get("required"))
            or (
                f.default is dataclasses.MISSING
                and f.default_factory is dataclasses.MISSING
            ),
        )
        for f in dataclasses.fields(cls)
        if "spec" in f.metadata
    )


class Struct:
    """Base for all wire types; subclasses are auto-dataclassed."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        dataclasses.dataclass(cls)

    # -- serialization ------------------------------------------------------

    def to_json_obj(self) -> dict:
        out: dict[str, Any] = {}
        encode_plan = _class_plan(type(self), "_lwc_encode_plan", _build_encode)
        for attr, name, skip_if_none, spec in encode_plan:
            value = getattr(self, attr)
            if value is None and skip_if_none:
                continue
            if spec is None:
                # spec-less (push/clone-only) field holding a real value:
                # there is no codec to render it with — refuse loudly
                # instead of emitting something json.dumps will mangle
                raise _speccless_error(type(self), attr)
            out[name] = _encode(spec, value)
        return out

    def to_json(self, *, pretty: bool = False) -> str:
        return jsonutil.dumps(self.to_json_obj(), pretty=pretty)

    @classmethod
    def from_json_obj(cls, obj, *, path: str = ""):
        if not isinstance(obj, dict):
            raise SchemaError(path, f"expected object, got {type(obj).__name__}")
        kwargs = {}
        # unknown JSON fields are ignored, matching serde's default behavior
        decode_plan = _class_plan(cls, "_lwc_decode_plan", _build_decode)
        for attr, name, spec, required in decode_plan:
            if name in obj and obj[name] is not None:
                sub_path = f"{path}.{name}" if path else name
                kwargs[attr] = _decode(spec, obj[name], sub_path)
            elif required:
                sub_path = f"{path}.{name}" if path else name
                raise SchemaError(sub_path, "missing required field")
            # else: default applies
        return cls(**kwargs)

    @classmethod
    def from_json(cls, s: str):
        return cls.from_json_obj(jsonutil.loads(s))

    # -- merge algebra ------------------------------------------------------

    def push(self, other) -> None:
        """Merge ``other`` (a later streaming chunk) into ``self`` in place."""
        if type(other) is not type(self):
            raise TypeError(
                f"cannot push {type(other).__name__} into {type(self).__name__}"
            )
        push_plan = _class_plan(type(self), "_lwc_push_plan", _build_push)
        for name, strategy, key in push_plan:
            if strategy == KEEP:
                continue
            mine = getattr(self, name)
            theirs = getattr(other, name)
            if theirs is None:
                continue
            if mine is None:
                setattr(self, name, _clone(theirs))
                continue
            if strategy == FIRST:
                pass  # first write wins
            elif strategy == CONCAT:
                setattr(self, name, mine + theirs)
            elif strategy == ADD:
                setattr(self, name, mine + theirs)
            elif strategy == EXTEND:
                mine.extend(_clone(v) for v in theirs)
            elif strategy == NESTED:
                mine.push(theirs)
            elif strategy == KEYED:
                _push_keyed(mine, theirs, key)
            else:
                raise ValueError(f"unknown merge strategy {strategy!r}")

    def clone(self):
        return _clone(self)


def _push_keyed(mine: list, theirs: list, key: str) -> None:
    # Linear scan matches the reference exactly (choices lists are small);
    # reference: src/chat/completions/response.rs:56-78.
    for other in theirs:
        other_key = getattr(other, key)
        for item in mine:
            if getattr(item, key) == other_key:
                item.push(other)
                break
        else:
            mine.append(_clone(other))


def _clone(value):
    # exact-class checks first: the overwhelmingly common case is a leaf
    # (str/int/Decimal/None), which should fall through with two pointer
    # compares instead of three isinstance() calls (this function is the
    # top host cost of a profiled scored request — per-judge isolation
    # clones run per judge per chunk)
    cls = value.__class__
    if cls is list:
        return [_clone(v) for v in value]
    if cls is dict:
        return {k: _clone(v) for k, v in value.items()}
    if isinstance(value, Struct):
        return cls(
            **{
                name: _clone(getattr(value, name))
                for name in _class_plan(cls, "_lwc_field_names", _build_names)
            }
        )
    # subclasses of the containers (rare; exact classes took the fast path)
    if isinstance(value, list):
        return [_clone(v) for v in value]
    if isinstance(value, dict):
        return {k: _clone(v) for k, v in value.items()}
    return value


class ResponseError(Struct, Exception):
    """Wire-form ``{code, message}`` error (reference src/error.rs:8-13).

    Lives in the type core (rather than errors.py) because response types
    embed it as a field; errors.py re-exports it alongside the rich error
    taxonomy.
    """

    code: int = field(int)
    message: object = field(RAW, default=None, skip_if_none=False)

    def __post_init__(self):
        Exception.__init__(self, self.to_json())


# ---------------------------------------------------------------------------
# Splice serialization (the HOST_FASTPATH fast lane's codec)
# ---------------------------------------------------------------------------
#
# The slow path renders a streamed frame in two walks: ``to_json_obj``
# builds a dict tree, then ``jsonutil.dumps`` walks the tree into a
# string.  The splice plan compiled here precomputes, per struct class,
# a writer closure per field plus the static text around every splice
# point (``,"confidence":`` and the surrounding punctuation), so a frame
# is assembled in ONE walk straight into string segments joined and
# encoded once — and a per-stream ``SpliceEncoder`` additionally caches
# each nested value's rendered text, so a chunk whose choice metadata
# did not change since the previous chunk splices the cached segment
# back in and re-renders only the fields that changed (O(changed bytes),
# not O(frame)).
#
# Byte-identity contract: for every struct the splicer accepts,
# ``SpliceEncoder().encode(s) == jsonutil.dumps(s.to_json_obj())
# .encode("utf-8")``.  Leaves format through jsonutil's own scalar
# tokens, dynamic subtrees (unions, maps, RAW) are rendered by jsonutil
# itself on the encoded subtree, and anything the splicer cannot prove
# identical raises — callers (serve/frames.py) fall back to the slow
# path for that frame, never silently diverge.  Property-tested against
# the slow path in tests/test_torch_host_fastpath.py.
#
# Aliasing contract: cache entries hold the encoded values BY REFERENCE
# (cloning every cached subtree costs more than the splice saves).
# That is safe here because the stream engine never mutates a chunk
# after yielding it — the aggregate is a *clone* of the initial chunk
# and ``push`` clones on insert — and the encoder is per-stream,
# dropped with the stream.  Mutating a struct after encoding it on the
# same encoder voids the byte-identity guarantee.


# Per-stream Decimal token memo, activated for the duration of one
# ``SpliceEncoder.encode`` call (encoding is synchronous and the encoder
# is single-stream by contract, so a module slot is safe on the serving
# event loop).  Streamed frames repeat a handful of Decimal OBJECTS —
# hard ballots share one zero per row, the tally memoizes repeated sums
# and shares — so formatting is keyed by object id; entries pin the
# value (the tuple holds the reference), which makes id reuse for a
# *different* live Decimal impossible.
_dec_memo: "dict | None" = None


def _splice_scalar(
    value,
    node,
    slot,
    out,
    _esc=jsonutil._escape_string,
    _fmt_dec=jsonutil._format_decimal,
    _int_repr=int.__repr__,
    _token=jsonutil.scalar_token,
):
    # exact-class fast paths for the tokens streamed frames are made of
    # (content strings, Decimal weights, integer indexes/timestamps);
    # everything else goes through the writer's scalar dispatch.  Note
    # ``cls is int`` cannot match bool — bool's class is bool, and the
    # dispatch fallback emits true/false for it.
    cls = value.__class__
    if cls is str:
        out.append(_esc(value))
    elif cls is Decimal:
        memo = _dec_memo
        if memo is None:
            out.append(_fmt_dec(value))
        else:
            hit = memo.get(id(value))
            if hit is None:
                memo[id(value)] = hit = (value, _fmt_dec(value))
            out.append(hit[1])
    elif cls is int:
        out.append(_int_repr(value))
    else:
        token = _token(value)
        if token is None:
            raise TypeError(f"cannot splice scalar {type(value).__name__}")
        out.append(token)


_MISS = object()


def _strict_eq(a, b):
    """Token-strict equality for splice-cache hit tests.  Plain ``==``
    is NOT sound here: ``Decimal("1") == Decimal("1.0")`` and
    ``True == 1`` hold while their JSON tokens differ, so a value-equal
    cache hit could replay stale bytes.  This compares the way the bytes
    would compare — identity first (the merge algebra shares objects
    across frames, so the hot path is one ``is``), then per-class rules
    that imply identical tokens.  Unknown classes return False: a
    re-render is always byte-safe, a false hit never is."""
    if a is b:
        return True
    cls = a.__class__
    if cls is not b.__class__:
        return False
    if cls is str or cls is int or cls is bool:
        return a == b
    if cls is Decimal:
        # equal value + equal exponent => same sign/digits => same token
        return a == b and a.as_tuple().exponent == b.as_tuple().exponent
    if cls is float:
        # repr IS the token; catches -0.0 == 0.0 and rejects nan
        return float.__repr__(a) == float.__repr__(b)
    if cls is list or cls is tuple:
        return len(a) == len(b) and all(map(_strict_eq, a, b))
    if cls is dict:
        if len(a) != len(b):
            return False
        for k, va in a.items():
            vb = b.get(k, _MISS)
            if vb is _MISS or not _strict_eq(va, vb):
                return False
        return True
    if isinstance(a, Struct):
        names = cls.__dict__.get("_lwc_field_names")
        if names is None:
            names = _class_plan(cls, "_lwc_field_names", _build_names)
        da, db = a.__dict__, b.__dict__
        for name in names:
            if not _strict_eq(da[name], db[name]):
                return False
        return True
    return False


def _splice_cached_struct(value, node, slot, out):
    """Nested struct behind a whole-value text cache: an unchanged value
    (token-strict compare, see _strict_eq) splices its previous
    rendering back in without re-walking.  A miss renders straight into
    ``out`` — only the cache copy pays a join."""
    if node is None:
        _splice_struct(value, None, out)
        return
    entry = node.get(slot)
    if entry is not None and _strict_eq(entry[0], value):
        out.append(entry[1])
        return
    child = entry[2] if entry is not None else {}
    start = len(out)
    _splice_struct(value, child, out)
    node[slot] = (value, "".join(out[start:]), child)


def _splice_value_writer(spec, merge, keyfield):
    """The writer closure for one field spec: ``write(value, node, slot,
    out)`` appends the value's JSON text segments to ``out``.  ``value``
    is never None — the field loop and the list writer handle null."""
    if isinstance(spec, Lazy):
        # resolved once at plan-build time (first encode of the class;
        # every lazily-referenced class exists by then)
        spec = spec.spec()
    if spec is RAW or isinstance(spec, (Union, TaggedUnion, Map)):

        def write_dynamic(value, node, slot, out, _spec=spec):
            # dynamic subtree: byte-identity by composition — jsonutil
            # renders the encoded subtree exactly as the slow path would
            out.append(jsonutil.dumps(_encode(_spec, value)))

        return write_dynamic
    if isinstance(spec, type) and issubclass(spec, Struct):
        return _splice_cached_struct
    if isinstance(spec, List):
        elem_spec = spec.spec
        if isinstance(elem_spec, Lazy):
            elem_spec = elem_spec.spec()
        if (
            merge == KEYED
            and isinstance(elem_spec, type)
            and issubclass(elem_spec, Struct)
        ):

            def write_keyed(value, node, slot, out, _key=keyfield):
                # per-element caches keyed the way push merges the list:
                # a choice whose fields did not change since the last
                # chunk is one equality compare + one cached segment
                if node is not None:
                    sub = node.get(slot)
                    if sub is None:
                        sub = node[slot] = {}
                else:
                    sub = None
                out.append("[")
                first = True
                for v in value:
                    if first:
                        first = False
                    else:
                        out.append(",")
                    _splice_cached_struct(v, sub, getattr(v, _key), out)
                out.append("]")

            return write_keyed
        elem_write = _splice_value_writer(elem_spec, FIRST, keyfield)
        if elem_write is _splice_scalar:

            def write_scalar_list(
                value,
                node,
                slot,
                out,
                _esc=jsonutil._escape_string,
                _fmt_dec=jsonutil._format_decimal,
                _int_repr=int.__repr__,
            ):
                # scalar elements (a judge's 64-Decimal vote vector is
                # the hot case): tokens into a local list, commas by one
                # C-level join — the generic path pays an append per
                # comma and a dispatch call per element
                if node is not None:
                    entry = node.get(slot)
                    if entry is not None and _strict_eq(entry[0], value):
                        out.append(entry[1])
                        return
                memo = _dec_memo
                parts = []
                ap = parts.append
                for v in value:
                    cls = v.__class__
                    if cls is Decimal:
                        if memo is None:
                            ap(_fmt_dec(v))
                        else:
                            hit = memo.get(id(v))
                            if hit is None:
                                memo[id(v)] = hit = (v, _fmt_dec(v))
                            ap(hit[1])
                    elif cls is str:
                        ap(_esc(v))
                    elif cls is int:
                        ap(_int_repr(v))
                    elif v is None:
                        # _encode maps None elements to None for every
                        # spec, so the slow path emits null here too
                        ap("null")
                    else:
                        sub: list = []
                        _splice_scalar(v, None, None, sub)
                        ap(sub[0])
                rendered = "[" + ",".join(parts) + "]"
                if node is not None:
                    node[slot] = (value, rendered)
                out.append(rendered)

            return write_scalar_list

        def write_list(value, node, slot, out, _elem=elem_write):
            # whole-value text cache, like nested structs: a judge's
            # vote vector rides along unchanged in every frame after its
            # final chunk, and the aggregate shares the list object, so
            # the hit test is usually one `is`
            if node is not None:
                entry = node.get(slot)
                if entry is not None and _strict_eq(entry[0], value):
                    out.append(entry[1])
                    return
            start = len(out)
            out.append("[")
            first = True
            for v in value:
                if first:
                    first = False
                else:
                    out.append(",")
                if v is None:
                    # _encode maps None elements to None for every spec,
                    # so the slow path emits null here too
                    out.append("null")
                else:
                    _elem(v, None, None, out)
            out.append("]")
            if node is not None:
                node[slot] = (value, "".join(out[start:]))

        return write_list
    # scalar specs (str/int/bool/float/Decimal/Enum/Const) format by
    # runtime type, exactly like the writer's scalar dispatch
    return _splice_scalar


_SCALAR_INLINE = """\
{i}cls_v = v.__class__
{i}if cls_v is str:
{i}    append(_esc(v))
{i}elif cls_v is Decimal:
{i}    _memo = _mod._dec_memo
{i}    if _memo is None:
{i}        append(_fmt_dec(v))
{i}    else:
{i}        _hit = _memo.get(id(v))
{i}        if _hit is None:
{i}            _memo[id(v)] = _hit = (v, _fmt_dec(v))
{i}        append(_hit[1])
{i}elif cls_v is int:
{i}    append(_int_repr(v))
{i}else:
{i}    _scalar(v, None, None, out)
"""


def _compile_splice(cls):
    """Compile the byte template for one struct class into a renderer
    function (``exec``-generated, the way dataclasses builds __init__).

    Everything knowable at class-definition time is baked into the
    code: the static text around every splice point (each field key with
    and without its leading comma, fused ``"key":null`` constants),
    first-comma tracking eliminated after the first always-emitted field
    (``skip_if_none=False`` fields are unconditionally present, so every
    later field statically knows a comma is needed), scalar dispatch
    inlined, and per-field writer closures bound as default args (local
    loads, not global lookups).  Only the values move at encode time —
    O(changed fields), with the surrounding bytes precompiled.

    Spec-less fields compile to a raise at the exact point the slow
    path raises."""
    binds = {
        "_esc": jsonutil._escape_string,
        "_fmt_dec": jsonutil._format_decimal,
        "_int_repr": int.__repr__,
        "_scalar": _splice_scalar,
        "_speccless_error": _speccless_error,
        "_mod": sys.modules[__name__],
        "_cls": cls,
        "Decimal": Decimal,
    }
    sig_extra = []
    lines = []
    state = "empty"  # -> "maybe" (runtime flag) -> "nonempty" (static)
    need_flag = False
    for f in dataclasses.fields(cls):
        name = f.metadata.get("json_name") or f.name
        spec = f.metadata.get("spec")
        skip_if_none = f.metadata.get("skip_if_none", True)
        key = jsonutil.scalar_token(name) + ":"
        if spec is None:
            write_kind = "error"
        else:
            writer = _splice_value_writer(
                spec,
                f.metadata.get("merge", FIRST),
                f.metadata.get("key", "index"),
            )
            if writer is _splice_scalar:
                write_kind = "scalar"
            else:
                write_kind = "call"
                binds[f"_w_{f.name}"] = writer
                sig_extra.append(f"_w_{f.name}")

        def write_code(indent):
            if write_kind == "scalar":
                return _SCALAR_INLINE.format(i=indent)
            if write_kind == "call":
                return f"{indent}_w_{f.name}(v, node, {f.name!r}, out)\n"
            return (
                f"{indent}raise _speccless_error(_cls, {f.name!r})\n"
            )

        lines.append(f"    v = values[{f.name!r}]\n")
        if skip_if_none:
            # absent when None: emission is conditional
            lines.append("    if v is not None:\n")
            if state == "empty":
                lines.append("        first = False\n")
                lines.append(f"        append({key!r})\n")
                need_flag = True
                state = "maybe"
            elif state == "maybe":
                lines.append("        if first:\n")
                lines.append("            first = False\n")
                lines.append(f"            append({key!r})\n")
                lines.append("        else:\n")
                lines.append(f"            append({',' + key!r})\n")
            else:
                lines.append(f"        append({',' + key!r})\n")
            lines.append(write_code("        "))
        else:
            # always emitted (null when None): later fields statically
            # know the object is non-empty
            if state == "empty":
                k = key
            elif state == "maybe":
                lines.append("    if first:\n")
                lines.append("        first = False\n")
                lines.append(f"        append({key!r})\n")
                lines.append("    else:\n")
                lines.append(f"        append({',' + key!r})\n")
            else:
                k = "," + key
            if state in ("empty", "nonempty"):
                lines.append("    if v is None:\n")
                lines.append(f"        append({k + 'null'!r})\n")
                lines.append("    else:\n")
                lines.append(f"        append({k!r})\n")
                lines.append(write_code("        "))
            else:
                lines.append("    if v is None:\n")
                lines.append("        append('null')\n")
                lines.append("    else:\n")
                lines.append(write_code("        "))
            state = "nonempty"
    sig = ", ".join(
        ["value", "node", "out"]
        + [f"{n}={n}" for n in binds if n in sig_extra]
        + [f"{n}={n}" for n in binds if n not in sig_extra]
    )
    src = [f"def _render({sig}):\n"]
    src.append("    values = value.__dict__\n")
    src.append("    append = out.append\n")
    if need_flag:
        src.append("    first = True\n")
    src.append("    append('{')\n")
    src.extend(lines)
    src.append("    append('}')\n")
    g = dict(binds)
    g["__builtins__"] = {"id": id, "str": str, "int": int}
    exec("".join(src), g)
    return g["_render"]


def _splice_struct(value, node, out):
    cls = value.__class__
    # __dict__ probe (not getattr): the compiled renderer is stored as a
    # plain function and must never be picked up as a bound method, nor
    # inherited by a subclass whose fields differ
    render = cls.__dict__.get("_lwc_splice_render")
    if render is None:
        render = _class_plan(cls, "_lwc_splice_render", _compile_splice)
    if node is not None and node.get("__cls__") is not cls:
        # a cache slot reused for a different class must never serve
        # stale text
        node.clear()
        node["__cls__"] = cls
    render(value, node, out)


class SpliceEncoder:
    """Per-stream splice serializer over the compiled templates.

    One instance serves one response stream: the cache tree maps nested
    struct fields and KEYED list elements (by their key field, the way
    ``push`` merges them) to their last rendered text, compared by value
    equality and stored by reference (see the aliasing contract above),
    and must not leak across requests."""

    __slots__ = ("_cache", "_decimals")

    def __init__(self):
        self._cache: dict = {}
        # per-stream Decimal token memo (see _dec_memo above): entries
        # pin their value object, so ids stay unambiguous for the
        # encoder's lifetime
        self._decimals: dict = {}

    def encode(self, struct) -> bytes:
        global _dec_memo
        if not isinstance(struct, Struct):
            raise TypeError(f"cannot splice {type(struct).__name__}")
        out: list[str] = []
        _dec_memo = self._decimals
        try:
            _splice_struct(struct, self._cache, out)
        finally:
            _dec_memo = None
        return "".join(out).encode("utf-8")


def fold_chunks(chunks):
    """Fold a chunk stream into the aggregate — ``unary = fold(push, stream)``.

    Mirrors the reference's create_unary loops (src/chat/completions/
    client.rs:170-191, src/score/completions/client.rs:71-91).
    """
    aggregate = None
    for chunk in chunks:
        if aggregate is None:
            aggregate = chunk.clone()
        else:
            aggregate.push(chunk)
    return aggregate
