"""Multichat request type (not present in the reference crate).

The reference ships only multichat *response* types and the
``multichat_id``/``multichat_index`` identity machinery (SURVEY §2.10); the
request side is defined here to complete the capability: one request fans
out to every generator slot of a score panel (judges deduplicated by
``multichat_id``; duplicate generators become extra samples, exactly the
slot semantics of model/mod.rs:153-178).
"""

from __future__ import annotations

from typing import Optional

from .base import List, Struct, field
from .chat_request import MESSAGE, SERVICE_TIER, StreamOptions, UsageInclude
from .score_request import MODEL


class ChatCompletionCreateParams(Struct):
    """POST /multichat/completions body: messages + a score panel whose
    judges define the generator slots."""

    messages: list = field(List(MESSAGE))
    model: object = field(MODEL)
    seed: Optional[int] = field(int, default=None)
    service_tier: Optional[str] = field(SERVICE_TIER, default=None)
    stream: Optional[bool] = field(bool, default=None)
    stream_options: Optional[StreamOptions] = field(StreamOptions, default=None)
    usage: Optional[UsageInclude] = field(UsageInclude, default=None)
    # extension (no reference analog): when true and the gateway has an
    # embedder, interleave live ``multichat.consensus`` frames as candidates
    # finish (BASELINE config 5 — streaming incremental consensus)
    consensus: Optional[bool] = field(bool, default=None)
