"""Wire-side record validation: the replay admission guard, cross-replica.

``cache/replay.py::record_stream`` guarantees a replica's OWN cache only
ever holds clean, complete, error-free, non-degraded streams.  A record
arriving over the fleet wire (publish after a granted lease, drain-time
handoff) carries no such guarantee — the sender could be buggy, stale,
or malicious — so the receiving side re-derives it: decode every frame
through the same typed schema the replay path uses and reject anything
``record_stream`` would have refused to cache.  A peer can therefore
never be served a degraded or errored consensus.  The port's copy of
``llm_weighted_consensus_tpu/fleet/wire.py``, on the port's own XXH3-64.
"""

from __future__ import annotations

from typing import List, Optional

from ..cache.replay import chunks_from_record
from ..identity.xxh3 import xxh3_64_hexdigest
from ..utils import jsonutil


def clean_chunk_objs(chunk_objs) -> Optional[List[dict]]:
    """Validate a wire-received chunk record; the (plain-JSON) list on
    success, None on anything record_stream would not have cached."""
    if not isinstance(chunk_objs, list) or not chunk_objs:
        return None
    if not all(isinstance(obj, dict) for obj in chunk_objs):
        return None
    chunks = chunks_from_record(chunk_objs)
    if chunks is None:
        return None
    for chunk in chunks:
        if getattr(chunk, "degraded", None):
            return None
        if any(c.error is not None for c in chunk.choices):
            return None
    return chunk_objs


def record_digest(chunk_objs: List[dict]) -> str:
    """A stable xxh3 fingerprint of a chunk record's canonical JSON —
    what the partition drill compares to assert two replicas converged
    on byte-identical content (and that a replay from the same seed
    reproduced it)."""
    return xxh3_64_hexdigest(jsonutil.dumps(chunk_objs).encode("utf-8"))
