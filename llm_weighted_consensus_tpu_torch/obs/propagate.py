"""W3C Trace Context (``traceparent``) inject/extract.

The port's copy of ``llm_weighted_consensus_tpu/obs/propagate.py``.

Format (https://www.w3.org/TR/trace-context/):
``00-{32 hex trace_id}-{16 hex parent_span_id}-{2 hex flags}``; flag
bit 0 is "sampled".  We extract at the gateway door (an external
caller's trace adopts ours as a subtree) and inject on every upstream
judge HTTP call (the attempt span's id becomes the upstream's parent,
so hedged attempts are distinguishable in a cross-service view).
Malformed headers are ignored — tracing must never fail a request.
"""

from __future__ import annotations

from typing import Optional, Tuple

from .span import current_span

TRACEPARENT_HEADER = "traceparent"

_HEX = set("0123456789abcdef")


def format_traceparent(trace_id: str, span_id: str, sampled: bool) -> str:
    return f"00-{trace_id}-{span_id}-{'01' if sampled else '00'}"


def _is_hex(s: str, width: int, allow_zero: bool = False) -> bool:
    if len(s) != width or any(c not in _HEX for c in s):
        return False
    # all-zero trace/span ids are invalid per spec; the version byte 00
    # is the (only) current version and perfectly legal
    return allow_zero or set(s) != {"0"}


def parse_traceparent(
    header: Optional[str],
) -> Optional[Tuple[str, str, bool]]:
    """``(trace_id, parent_span_id, sampled)`` or None when absent or
    malformed (per spec, a bad header is treated as no header)."""
    if not header:
        return None
    parts = header.strip().lower().split("-")
    if len(parts) < 4:
        return None
    version, trace_id, span_id, flags = parts[0], parts[1], parts[2], parts[3]
    if version == "ff" or not _is_hex(version, 2, allow_zero=True):
        return None
    if not _is_hex(trace_id, 32) or not _is_hex(span_id, 16):
        return None
    if len(flags) != 2 or not all(c in _HEX for c in flags):
        return None
    return trace_id, span_id, bool(int(flags, 16) & 0x01)


def inject(headers: dict) -> None:
    """Stamp the ambient span's context onto outgoing request headers;
    no-op when tracing is off."""
    span = current_span()
    if span is None:
        return
    headers[TRACEPARENT_HEADER] = format_traceparent(
        span.trace.trace_id, span.span_id, span.trace.sampled
    )


def extract(headers) -> Optional[Tuple[str, str, bool]]:
    """Parse an incoming request's ``traceparent`` (any mapping with
    ``.get``)."""
    return parse_traceparent(headers.get(TRACEPARENT_HEADER))
