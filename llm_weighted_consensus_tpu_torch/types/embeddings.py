"""Embedding wire types (OpenAI ``CreateEmbeddingResponse`` shape).

Parity target: reference src/embeddings/response.rs:4-30 — types only in the
reference; this framework implements the request side and a real on-TPU
encoder behind them (models/encoder.py, serve/gateway.py ``/embeddings``).
"""

from __future__ import annotations

from typing import Optional

from .base import Const, List, Struct, Union, field
from .chat_response import Usage


class Embedding(Struct):
    embedding: list = field(List(float))
    index: int = field(int, default=0, skip_if_none=False)
    object: str = field(Const("embedding"), default="embedding")


class CreateEmbeddingResponse(Struct):
    data: list = field(List(Embedding), default_factory=list, skip_if_none=False)
    model: str = field(str, default="", skip_if_none=False)
    object: str = field(Const("list"), default="list")
    usage: Optional[Usage] = field(Usage, default=None)


class CreateEmbeddingParams(Struct):
    """Request side (not present in the reference crate; OpenAI-compatible)."""

    input: object = field(Union(str, List(str)))
    model: str = field(str)
    encoding_format: Optional[str] = field(str, default=None)
    dimensions: Optional[int] = field(int, default=None)
    user: Optional[str] = field(str, default=None)

    def inputs(self) -> list:
        return [self.input] if isinstance(self.input, str) else list(self.input)
