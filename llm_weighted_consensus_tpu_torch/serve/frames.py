"""SSE frame assembly for the streaming routes — the fast lane's door.

The port's copy of ``llm_weighted_consensus_tpu/serve/frames.py``: the
chat routes' stream pump (``serve/chat_routes.py``) encodes every frame
through :class:`FrameEncoder` and never touches ``to_json_obj`` /
``jsonutil.dumps`` itself, so the whole per-chunk byte path is in one
place.

Two lanes, one output:

* slow (default): ``dumps(item.to_json_obj())`` per frame;
* fast (``HOST_FASTPATH``): splice serialization over the byte templates
  compiled next to the codec plans (``types/base.py`` ``SpliceEncoder``)
  — per-stream caches patch only the fields that changed.  Any frame the
  splicer cannot prove byte-identical falls back to the slow lane for
  that frame and counts the fallback (``FrameEncoder.fallbacks``), so
  divergence is impossible and silent degradation is observable.

Byte-identity of the two lanes (and with the reference's splice lane) is
held across seeded chunk orders, degraded frames and per-judge errors in
``tests/test_torch_host_fastpath.py``.
"""

from __future__ import annotations

from ..errors import to_response_error, with_trace_id
from ..types.base import SpliceEncoder
from ..utils import jsonutil

DONE = b"data: [DONE]\n\n"
_PREFIX = b"data: "
_SUFFIX = b"\n\n"


def frame_bytes(obj) -> bytes:
    """One SSE ``data:`` frame around an already-encoded JSON object —
    the slow lane's rendering, shared by both lanes' fallbacks."""
    return _PREFIX + jsonutil.dumps(obj).encode("utf-8") + _SUFFIX


class FrameEncoder:
    """Per-stream encoder of SSE ``data:`` frames.

    One instance serves one response stream — the splice caches key on
    per-stream stable values (response id, choice metadata) and must not
    leak across requests.
    """

    __slots__ = ("_splicer", "fallbacks")

    def __init__(self, fastpath: bool = False):
        self._splicer = SpliceEncoder() if fastpath else None
        # frames the fast lane handed back to the slow lane (0 on the
        # slow lane itself); the pump annotates the trace when > 0
        self.fallbacks = 0

    def encode(self, item) -> bytes:
        """Frame for a response chunk (a Struct)."""
        splicer = self._splicer
        if splicer is not None:
            try:
                return _PREFIX + splicer.encode(item) + _SUFFIX
            except Exception:
                # loud fallback: counted here, annotated by the caller;
                # whatever the splicer choked on, the slow lane below
                # either renders it or raises the slow path's own error
                self.fallbacks += 1
        return frame_bytes(item.to_json_obj())

    def encode_error(self, exc: Exception) -> bytes:
        """Frame for a mid-stream error item (always the slow lane:
        errors are rare and carry the trace id)."""
        return frame_bytes(with_trace_id(to_response_error(exc).to_json_obj()))
