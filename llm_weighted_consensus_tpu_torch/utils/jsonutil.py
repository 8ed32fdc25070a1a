"""Canonical JSON serialization with exact ``Decimal`` support.

The reference crate serializes every wire type with serde_json and hashes the
resulting canonical string to derive content-addressed model identities
(reference: src/score/llm/mod.rs:513-518).  Python's stdlib ``json`` cannot emit
``decimal.Decimal`` values as bare JSON numbers without precision loss, so this
module implements a small, fully deterministic JSON writer:

* declared field order is preserved (dicts keep insertion order),
* ``Decimal`` values are emitted verbatim (``1.0`` stays ``1.0``, not ``1``),
* floats are emitted with ``repr`` (shortest round-trip form),
* no whitespace (serde_json compact form) unless ``pretty=True`` (serde_json
  ``to_string_pretty`` form: 2-space indent), which the ballot serializer needs
  (reference: src/score/completions/client.rs:1580-1603).

The identity scheme built on top of this writer is *structurally* equivalent to
the reference's (same canonicalized fields, same xxh3-128 + base62 pipeline) but
not byte-compatible with rust_decimal/serde formatting; ids are therefore
versioned as this framework's own id space (see identity/__init__.py).
"""

from __future__ import annotations

import json
import math
from decimal import Decimal

_ESCAPE_MAP = {
    "\\": "\\\\",
    '"': '\\"',
    "\b": "\\b",
    "\f": "\\f",
    "\n": "\\n",
    "\r": "\\r",
    "\t": "\\t",
}


def _escape_string_py(s: str) -> str:
    """Reference implementation of the escaping contract (backslash,
    quote, the five short escapes, \\u%04x for other controls, everything
    else verbatim).  Kept as the spec + fallback; the live path below is
    stdlib's C ``encode_basestring``, which implements the same mapping
    (fuzz-pinned byte-identical in tests/test_jsonutil.py) ~7x faster —
    it was the top host hotspot in a profiled scored request (per-judge
    pretty ballot serialization escapes ~1k strings per request)."""
    out = []
    for ch in s:
        esc = _ESCAPE_MAP.get(ch)
        if esc is not None:
            out.append(esc)
        elif ch < "\x20":
            out.append("\\u%04x" % ord(ch))
        else:
            out.append(ch)
    return '"' + "".join(out) + '"'


try:
    from json.encoder import encode_basestring as _escape_string
except ImportError:  # pragma: no cover - stdlib always has it
    _escape_string = _escape_string_py


def _format_decimal(d: Decimal) -> str:
    # Emit the decimal exactly as constructed, in plain (non-scientific)
    # notation, matching rust_decimal's display form.
    if not d.is_finite():
        raise ValueError("cannot serialize non-finite Decimal to JSON")
    return format(d, "f")


def _format_float(f: float) -> str:
    if math.isnan(f) or math.isinf(f):
        raise ValueError("cannot serialize non-finite float to JSON")
    # float.__repr__ is the shortest round-trip form; whole numbers print
    # as `1.0`, matching serde_json's f64 output.  The UNBOUND call
    # matters: float subclasses (np.float64 under numpy>=2 reprs as
    # 'np.float64(1.5)') must format like the stdlib fast path, which
    # also uses float.__repr__ — both paths stay byte-identical.
    return float.__repr__(f)


def scalar_token(obj) -> "str | None":
    """The exact token the compact writer emits for a JSON scalar, or
    ``None`` when ``obj`` is not a scalar (containers, unknown types).

    This is ``_write_scalar``'s dispatch factored out for the splice
    serializer (types/base.py SpliceEncoder): frame assembly from byte
    templates must format every leaf exactly as ``dumps`` would, or the
    fast lane's byte-identity contract breaks.  Order matters — ``bool``
    before ``int`` (bool is an int subclass), ``Decimal`` before the
    numeric tower."""
    if obj is None:
        return "null"
    if obj is True:
        return "true"
    if obj is False:
        return "false"
    if isinstance(obj, str):
        return _escape_string(obj)
    if isinstance(obj, Decimal):
        return _format_decimal(obj)
    if isinstance(obj, int):
        return int.__repr__(obj)
    if isinstance(obj, float):
        return _format_float(obj)
    return None


def dumps(obj, *, pretty: bool = False) -> str:
    """Serialize ``obj`` (dict/list/str/bool/None/int/float/Decimal) to JSON.

    Decimal-free payloads take the C-accelerated stdlib encoder, whose
    compact output is byte-identical to this module's writer (same float
    repr, same string escaping with ensure_ascii=False, same non-finite
    rejection) and ~10x faster on the string/float-heavy serving
    responses (embeddings, SSE frames).  Anything stdlib cannot encode
    (Decimal) falls back to the exact writer below, which emits dict keys
    (str/int/float/bool/None) byte-identically to stdlib's coercion and
    rejects other key types with the same TypeError stdlib raises."""
    if not pretty:
        try:
            # stdlib raises TypeError on any type it doesn't know
            # (Decimal included) — no default hook needed
            return json.dumps(
                obj,
                separators=(",", ":"),
                ensure_ascii=False,
                allow_nan=False,
            )
        except TypeError:
            pass  # Decimal somewhere: exact writer required
        except ValueError as exc:
            # stdlib's ValueError covers two distinct cases: non-finite
            # floats (fall through so the writer raises this module's
            # contract error) and circular references (re-raise — the
            # recursive writer must never be handed a cycle).
            if "circular" in str(exc).lower():
                raise
    out: list[str] = []
    if pretty:
        _write_pretty(obj, out, 0, set())
    else:
        _write_compact(obj, out, set())
    return "".join(out)


class _EmitBuffer:
    """Bounded segment buffer quacking like the writer's ``out`` list.

    ``_write_compact`` only ever calls ``out.append``, so handing it this
    buffer streams the exact compact byte sequence through ``emit`` in
    joined chunks — no full canonical string is ever materialized.  The
    cache fingerprint path (cache/fingerprint.py) feeds chunks straight
    into the incremental request hasher."""

    __slots__ = ("_emit", "_buf", "_size", "_limit")

    def __init__(self, emit, limit: int):
        self._emit = emit
        self._buf: list[str] = []
        self._size = 0
        self._limit = limit

    def append(self, segment: str) -> None:
        self._buf.append(segment)
        self._size += len(segment)
        if self._size >= self._limit:
            self._emit("".join(self._buf))
            self._buf.clear()
            self._size = 0

    def flush(self) -> None:
        if self._buf:
            self._emit("".join(self._buf))
            self._buf.clear()
            self._size = 0


def dump_into(obj, emit, *, chunk_chars: int = 8192) -> None:
    """Stream ``dumps(obj)`` (compact form) through ``emit(str)`` in
    bounded chunks, byte-identical to the full-string writer — same
    recursive walk, same segments, only the join boundaries differ."""
    buf = _EmitBuffer(emit, chunk_chars)
    _write_compact(obj, buf, set())
    buf.flush()


def _write_scalar(obj, out: list[str]) -> bool:
    if obj is None:
        out.append("null")
    elif obj is True:
        out.append("true")
    elif obj is False:
        out.append("false")
    elif isinstance(obj, str):
        out.append(_escape_string(obj))
    elif isinstance(obj, Decimal):
        out.append(_format_decimal(obj))
    elif isinstance(obj, int):
        # UNBOUND repr (same contract as _format_float/_key_str): an int
        # subclass with a custom __str__ must encode like the stdlib fast
        # path, not emit its display text as raw JSON
        out.append(int.__repr__(obj))
    elif isinstance(obj, float):
        out.append(_format_float(obj))
    else:
        return False
    return True


def _key_str(k) -> str:
    """Object key coerced exactly as the stdlib fast path coerces it
    (bool -> "true"/"false", None -> "null", float -> shortest repr), so a
    Decimal elsewhere in the payload can never flip the key encoding.
    Other key types get the same TypeError stdlib raises."""
    if isinstance(k, str):
        return k
    if k is True:
        return "true"
    if k is False:
        return "false"
    if k is None:
        return "null"
    if isinstance(k, float):
        return _format_float(k)
    if isinstance(k, int):
        # UNBOUND repr, same reason as _format_float: int subclasses with
        # a custom __str__/__repr__ must encode like the stdlib fast path
        return int.__repr__(k)
    raise TypeError(
        f"keys must be str, int, float, bool or None, not {type(k).__name__}"
    )


def _enter(obj, seen: set) -> None:
    if id(obj) in seen:
        raise ValueError("Circular reference detected")
    seen.add(id(obj))


def _write_compact(obj, out: list[str], seen: set) -> None:
    if _write_scalar(obj, out):
        return
    if isinstance(obj, dict):
        _enter(obj, seen)
        out.append("{")
        first = True
        for k, v in obj.items():
            if not first:
                out.append(",")
            first = False
            out.append(_escape_string(_key_str(k)))
            out.append(":")
            _write_compact(v, out, seen)
        out.append("}")
        seen.discard(id(obj))
    elif isinstance(obj, (list, tuple)):
        _enter(obj, seen)
        out.append("[")
        first = True
        for v in obj:
            if not first:
                out.append(",")
            first = False
            _write_compact(v, out, seen)
        out.append("]")
        seen.discard(id(obj))
    else:
        raise TypeError(f"cannot serialize {type(obj)!r} to JSON")


def _write_pretty(obj, out: list[str], indent: int, seen: set) -> None:
    if _write_scalar(obj, out):
        return
    pad = "  " * (indent + 1)
    end_pad = "  " * indent
    if isinstance(obj, dict):
        if not obj:
            out.append("{}")
            return
        _enter(obj, seen)
        out.append("{\n")
        first = True
        for k, v in obj.items():
            if not first:
                out.append(",\n")
            first = False
            out.append(pad)
            out.append(_escape_string(_key_str(k)))
            out.append(": ")
            _write_pretty(v, out, indent + 1, seen)
        out.append("\n")
        out.append(end_pad)
        out.append("}")
        seen.discard(id(obj))
    elif isinstance(obj, (list, tuple)):
        if not obj:
            out.append("[]")
            return
        _enter(obj, seen)
        out.append("[\n")
        first = True
        for v in obj:
            if not first:
                out.append(",\n")
            first = False
            out.append(pad)
            _write_pretty(v, out, indent + 1, seen)
        out.append("\n")
        out.append(end_pad)
        out.append("]")
        seen.discard(id(obj))
    else:
        raise TypeError(f"cannot serialize {type(obj)!r} to JSON")


def loads(s: str):
    """Parse JSON preserving exact decimal literals as ``Decimal``."""
    return json.loads(s, parse_float=Decimal)
