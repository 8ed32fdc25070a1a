"""Ragged segment-id packing for the continuous batcher (pure host side).

The port's own copy of ``llm_weighted_consensus_tpu/serve/packing.py``
(numpy only; the planner, the buckets, the dedup split and the host vote
are the reference's, line for line).

The padded dispatch path pays one encoder ROW per sequence, padded to a
``(R, N, S)`` bucket — under mixed-length traffic most row slots multiply
padding.  The packed layout instead lays many variable-length sequences
end-to-end in each dense row:

* ``ids[B, L]``        — token streams, concatenated per row;
* ``segment_ids[B, L]``— int32 segment slot per token (0 = pad slot;
                         slot j+1 holds the row's j-th sequence);
* ``positions[B, L]``  — within-segment offsets, restarting at 0 per
                         segment (each sequence sees exactly the position
                         embeddings its padded twin would — and a row may
                         exceed the model's position table, because only
                         SEGMENTS are bounded by it);
* ``seg_starts[B, K]`` — row offset of each slot's first token (the
                         segment's [CLS], pooled where the padded path
                         reads ``hidden[:, 0]``).

``models/bert.py::embed_packed`` consumes this layout with the
segment-masked attention kernel (``ops.attention.segment_attention``), so
the packed forward reproduces the per-row forward.  Capacity buckets are
the small fixed set ("packed", B, L, K) with B a power of two (calls are
always exactly full — no pad rows) and L on the coarse ``_L_BUCKETS``
ladder.

Everything here is pure and synchronous (list/ndarray in, ndarray out):
the batcher calls it from its device thread, and the unit tests drive it
directly.
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence

import numpy as np


def plan_rows(
    lengths: Sequence[int], row_tokens: int, max_segments: int
) -> List[List[int]]:
    """First-fit packing: segment lengths -> rows of segment indices.

    Arrival order is preserved within a row (deterministic layout for a
    given input), every segment must satisfy ``0 < length <= row_tokens``
    (callers route oversized sequences to the padded path), and each row
    holds at most ``max_segments`` segments (the K slot dimension).
    First-fit over all open rows: O(n*rows), and within a few percent of
    optimal at serving sizes — the tail waste is bounded by one
    max-length segment per row.
    """
    open_rows: list = []  # [remaining_capacity, seg_count, indices]
    for i, n in enumerate(lengths):
        n = int(n)
        if n <= 0 or n > row_tokens:
            raise ValueError(
                f"segment {i} length {n} outside (0, {row_tokens}]"
            )
        for row in open_rows:
            if row[0] >= n and row[1] < max_segments:
                row[0] -= n
                row[1] += 1
                row[2].append(i)
                break
        else:
            open_rows.append([row_tokens - n, 1, [i]])
    return [row[2] for row in open_rows]


# seq-width buckets for one packed call (the coarse tail of the padded
# path's _SEQ_BUCKETS ladder): a call whose rows all fill below a bucket
# dispatches at that bucket's width instead of the full row_tokens, so a
# sparse dispatch doesn't pay full-width slot waste.  Coarse on purpose —
# each (B, L) pair is a shape the kernels are checked and timed at
_L_BUCKETS = (64, 128, 192, 256, 384, 512, 768, 1024, 1536, 2048)


def seq_bucket_packed(n: int, row_tokens: int) -> int:
    """Packed-call seq width for a max row fill of ``n`` tokens: the
    smallest _L_BUCKETS entry >= n, capped at ``row_tokens``."""
    for size in _L_BUCKETS:
        if size >= n:
            return min(size, row_tokens)
    return min(n, row_tokens)


def rows_bucket(n_rows: int, max_rows: int) -> int:
    """Rows in the NEXT packed device call given ``n_rows`` still to
    dispatch: the largest power of two <= min(n_rows, max_rows).  Calls
    are always exactly full — 20 rows at max_rows=8 dispatch as 8+8+4,
    never as 8+8+8-with-4-pad-rows — so the ("packed", B, L, K)
    shape set stays log-sized AND pad rows never dilute the
    real-token/slot-token efficiency."""
    n = max(1, min(n_rows, max_rows))
    b = 1
    while b * 2 <= n:
        b *= 2
    return b


class PackedCall:
    """One device call's worth of packed arrays plus the segment map."""

    __slots__ = ("ids", "segment_ids", "positions", "seg_starts", "slots",
                 "real_tokens")

    def __init__(self, ids, segment_ids, positions, seg_starts, slots,
                 real_tokens):
        self.ids = ids
        self.segment_ids = segment_ids
        self.positions = positions
        self.seg_starts = seg_starts
        # segment index -> (row, slot) within THIS call
        self.slots = slots
        self.real_tokens = real_tokens

    @property
    def slot_tokens(self) -> int:
        return int(self.ids.size)


def build_calls(
    seg_tokens: Sequence[np.ndarray],
    row_tokens: int,
    max_rows: int,
    max_segments: int,
) -> List[PackedCall]:
    """Plan + materialize: ragged token rows -> a list of PackedCalls.

    Rows are first-fit packed, sorted fullest-first, then chunked into
    exactly-full power-of-two calls (``rows_bucket``); each call's seq
    width is the ``seq_bucket_packed`` bucket of its fullest row.  Both
    choices serve the real-token/slot-token efficiency the /metrics
    ``packing`` section reports: no pad rows ever dispatch, and a call
    of lightly-filled rows (the tail of a burst, a lone small request)
    dispatches at a narrow L instead of the full ``row_tokens``.
    Unused trailing token slots keep segment id 0 — fully masked,
    pooled by nobody.
    """
    lengths = [len(t) for t in seg_tokens]
    rows = plan_rows(lengths, row_tokens, max_segments)
    # fullest-first, so each pow2 chunk groups rows of similar fill and
    # the narrow-L win lands on the sparse tail call
    rows.sort(
        key=lambda seg_list: sum(lengths[si] for si in seg_list),
        reverse=True,
    )
    calls: List[PackedCall] = []
    start = 0
    while start < len(rows):
        b = rows_bucket(len(rows) - start, max_rows)
        chunk = rows[start : start + b]
        start += b
        l_call = seq_bucket_packed(
            max(sum(lengths[si] for si in seg_list) for seg_list in chunk),
            row_tokens,
        )
        ids = np.zeros((b, l_call), np.int32)
        seg = np.zeros((b, l_call), np.int32)
        pos = np.zeros((b, l_call), np.int32)
        starts = np.zeros((b, max_segments), np.int32)
        slots = {}
        real = 0
        for r, seg_list in enumerate(chunk):
            off = 0
            for slot, si in enumerate(seg_list):
                t = np.asarray(seg_tokens[si], np.int32)
                n = len(t)
                ids[r, off : off + n] = t
                seg[r, off : off + n] = slot + 1
                pos[r, off : off + n] = np.arange(n, dtype=np.int32)
                starts[r, slot] = off
                slots[si] = (r, slot)
                off += n
                real += n
        calls.append(PackedCall(ids, seg, pos, starts, slots, real))
    return calls


# -- shared-prefix dedup ------------------------------------------------------

_LAST_WORD = re.compile(r"\s\S*$")


def shared_prefix(texts: Sequence[str], min_chars: int) -> Optional[str]:
    """Longest common prefix of all candidate texts, cut back to the last
    whitespace boundary, or None when shorter than ``min_chars``.

    The whitespace cut keeps the split tokenization-composable: both the
    WordPiece and hash tokenizers segment on whitespace/punctuation first,
    so ``tokens(prefix) + tokens(suffix)`` is ``tokens(full)`` up to the
    per-part special tokens ([CLS]/[SEP]).  The prefix-dedup embedding
    contract (serve/batcher.py::ConsensusBatcher._dispatch_packed) is defined on the parts,
    so an exact token-level split is not required — only a stable one.
    """
    if len(texts) < 2 or min_chars <= 0:
        return None
    p = texts[0]
    for t in texts[1:]:
        while not t.startswith(p):
            p = p[: len(p) - 1]
            if not p:
                return None
    m = _LAST_WORD.search(p)
    if m is not None:
        p = p[: m.start()]
    if len(p) < min_chars:
        return None
    return p


def compose_prefix_suffix(
    prefix_vec: np.ndarray,
    prefix_tokens: int,
    suffix_vec: Optional[np.ndarray],
    suffix_tokens: int,
) -> np.ndarray:
    """The prefix-dedup candidate embedding: token-count-weighted sum of
    the independently pooled, l2-normalized prefix and suffix vectors,
    re-normalized.  This is the DEFINED contract (DESIGN.md "Continuous
    batching"), an approximation of the full-text embedding: a
    bidirectional encoder cannot reuse prefix states exactly, but the
    shared-prefix term is identical across a request's N candidates, so
    the consensus geometry is dominated by the suffix differences —
    which is what the vote measures."""
    if suffix_vec is None:
        return np.asarray(prefix_vec, np.float32)
    v = prefix_tokens * np.asarray(prefix_vec, np.float32) + (
        suffix_tokens * np.asarray(suffix_vec, np.float32)
    )
    return v / max(float(np.linalg.norm(v)), 1e-12)


def consensus_vote_np(vecs: np.ndarray, temperature: float) -> np.ndarray:
    """Host (numpy) twin of ``ops.similarity.dyn_cosine_vote`` for the
    packed consensus path: softmax over mean off-diagonal cosine
    similarity, f32 like the device vote.

    Host-side on purpose: the packed dispatch mixes requests of different
    N in one device call, and a device vote would need a ragged launch per
    request or a second dispatch.  One [segments, H] transfer per packed call plus an
    O(N^2 * H) numpy contraction per request is microseconds at serving
    sizes; parity with the device vote is asserted in tests."""
    v = np.asarray(vecs, np.float32)
    n = v.shape[0]
    nrm = v / np.maximum(
        np.sqrt((v * v).sum(axis=-1, keepdims=True)), 1e-12
    )
    sims = nrm @ nrm.T
    np.fill_diagonal(sims, 0.0)
    mean_sim = sims.sum(axis=-1) / max(n - 1, 1)
    z = mean_sim / np.float32(temperature)
    z = z - z.max()
    e = np.exp(z)
    return (e / e.sum()).astype(np.float32)
