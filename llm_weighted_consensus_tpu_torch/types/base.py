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

The port's copy of ``llm_weighted_consensus_tpu/types/base.py``, without
its splice encoder (the ``HOST_FASTPATH`` fast lane, not ported).
"""

from __future__ import annotations

import dataclasses
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
