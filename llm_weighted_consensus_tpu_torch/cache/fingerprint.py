"""Canonical request fingerprints, built on the identity layer's hasher.

A fingerprint is a 22-char base62 id (the same xxh3-128 pipeline as panel
ids, identity/__init__.py) over a canonical byte string, so two requests
that differ only in JSON field order, whitespace, or panel member
declaration order hash identically:

* score requests: ``(context, panel model id, canonicalized messages,
  candidate choice set, sampling params)`` — the model component is the
  panel's content-addressed ``id`` whenever the request carries an inline
  panel (member order and default-value noise already canonicalized by
  ``into_model_validate``), the 22-char id itself for registry
  references;
* embedding rows: ``(model id, truncation window, text)`` — one key per
  row, so the batcher can memoize per row before device dispatch.

Key-space versioning: every fingerprint is prefixed with a ``kind/v1``
tag.  If canonicalization ever changes, bump the tag — a stale disk tier
must miss, never serve a wrong-keyed entry.  The port's copy of
``llm_weighted_consensus_tpu/cache/fingerprint.py``, on the port's XXH3.
"""

from __future__ import annotations

from typing import Optional

from ..identity import IncrementalHasher
from ..utils import jsonutil

SCORE_KEY_VERSION = "score/v1"
EMBED_KEY_VERSION = "embed/v1"

# request fields that must never reach the key: they select the wire
# framing (stream) or the cache policy itself (cache_bypass), not the
# computation
_NON_SEMANTIC_FIELDS = ("stream", "stream_options", "cache_bypass")


def _canonical_model_key(model_param) -> Optional[str]:
    """The content-addressed panel id for any of the four ``model`` request
    forms (clients/score.py fetch_or_validate_score_model), or None when
    the form cannot be resolved without IO surprises (the normal path will
    then raise its usual error — an unfingerprintable request is simply
    uncacheable, never an error here)."""
    from ..identity.model import ModelBase

    if isinstance(model_param, ModelBase):
        try:
            # clone first: callers' params must not observe prepare()'s
            # canonicalization as a side effect of a cache *lookup*
            return model_param.clone().into_model_validate().id
        except Exception:
            return None
    if not isinstance(model_param, str):
        return None
    if len(model_param) == 22:
        return model_param
    slug = model_param.split("/")[-1]
    if len(slug) == 22:
        return slug
    try:
        base = ModelBase.from_json_obj(jsonutil.loads(model_param))
        return base.into_model_validate().id
    except Exception:
        return None


def score_fingerprint(params, ctx: Optional[str] = None) -> Optional[str]:
    """Canonical key for a score request, or None when uncacheable.

    ``ctx`` is the caller's authorization context: results computed under
    one upstream credential are never served to another.
    """
    model_key = _canonical_model_key(params.model)
    if model_key is None:
        return None
    try:
        obj = params.to_json_obj()
    except Exception:
        return None
    for name in _NON_SEMANTIC_FIELDS:
        obj.pop(name, None)
    obj["model"] = model_key
    hasher = IncrementalHasher()
    hasher.write(SCORE_KEY_VERSION)
    hasher.write("\x00")
    hasher.write(ctx or "")
    hasher.write("\x00")
    # the parsed request streams straight into the hasher in bounded
    # chunks — the full canonical string (large message payloads, inline
    # panels) is never materialized; digest bytes are identical to the
    # dumps() form (pinned in tests/test_host_fastpath.py)
    jsonutil.dump_into(obj, hasher.write)
    return hasher.finish_id()


def embed_fingerprint(
    model_id: str, text: str, max_tokens: Optional[int] = None
) -> str:
    """Canonical key for one embedding row.

    The text is hashed byte-exact: tokenizers distinguish codepoint
    sequences that higher-level normalization would conflate, and a false
    hit is strictly worse than a miss.  ``max_tokens`` is part of the key
    because truncation changes the embedding.
    """
    hasher = IncrementalHasher()
    hasher.write(EMBED_KEY_VERSION)
    hasher.write("\x00")
    hasher.write(model_id)
    hasher.write("\x00")
    hasher.write("" if max_tokens is None else str(int(max_tokens)))
    hasher.write("\x00")
    hasher.write(text)
    return hasher.finish_id()
