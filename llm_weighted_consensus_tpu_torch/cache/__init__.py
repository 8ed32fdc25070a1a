"""Content-addressed consensus cache with single-flight deduplication.

The identity layer already gives every judge-panel configuration a
content-addressed id (identity/model.py); this package extends that to
whole *requests*: a canonical fingerprint over (panel id, canonicalized
messages, candidate choice set, sampling params) keys a two-tier
result store, so two semantically identical score requests pay one judge
fan-out instead of two.  Modules:

* ``fingerprint``  — canonical request keys on ``IncrementalHasher``
  (JSON field order never changes the key);
* ``store``        — in-memory LRU with TTL + byte budget, optional
  append-only JSONL disk tier for warm restarts (``SCORE_CACHE_DIR``);
* ``singleflight`` — concurrent same-fingerprint requests collapse onto
  one in-flight computation (asyncio future per key);
* ``replay``       — record a streamed score response's chunk frames and
  replay them on a hit, so ``stream=true`` clients get byte-identical
  wire behavior on hit and miss.

The port's copy of ``llm_weighted_consensus_tpu/cache/``: the
fingerprints run on the port's own XXH3 (``identity/xxh3.py``) and equal
the reference's hex for hex (tests/test_torch_cache.py).
"""

from .fingerprint import embed_fingerprint, score_fingerprint  # noqa: F401
from .singleflight import SingleFlight  # noqa: F401
from .store import CacheStore, ScoreCache, EmbeddingCache  # noqa: F401
from .replay import record_stream, replay_stream  # noqa: F401

__all__ = [
    "CacheStore",
    "EmbeddingCache",
    "ScoreCache",
    "SingleFlight",
    "embed_fingerprint",
    "record_stream",
    "replay_stream",
    "score_fingerprint",
]
