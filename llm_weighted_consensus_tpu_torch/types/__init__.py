"""Pure wire-type core (no IO, no JAX) — the wasm-safe-core analog.

The port's copy of ``llm_weighted_consensus_tpu/types``.

Submodules:

* ``base``               — declarative schema + generic merge (``push``) algebra
* ``chat_request``       — OpenAI/OpenRouter chat request surface
* ``chat_response``      — streaming/unary chat responses, usage, logprobs
* ``score_request``      — score request (messages + model + choices)
* ``score_response``     — score responses (weights/confidences/votes)
* ``multichat_response`` — multi-model fan-out responses
* ``embeddings``         — embedding request/response types
"""

from . import (  # noqa: F401
    base,
    chat_request,
    chat_response,
    embeddings,
    multichat_response,
    score_request,
    score_response,
)
from .base import fold_chunks  # noqa: F401
