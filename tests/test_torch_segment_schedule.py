"""The segment TMA kernel's tile schedule is exact, on the CPU.

``ops.attention.segment_tile_schedule`` is the plain twin of the test the
kernel's producer warp computes (``csrc/attention_sm90.cu``): per query
block and key tile, compute both products, P V alone on logits that are
all -1e9, or skip.  Here it drives an f32 online softmax that visits only
the scheduled tiles, in the kernel's order, and that emulation is held to
the port's plain ``segment_attention_plain`` and to the reference's
``fused_attention_tiled_seg`` (its Pallas kernel in interpret mode) at
1e-5 in f32 (summation order), on the planner's packed layouts at the
mixed traffic's segment lengths, on hard layouts and on an all-pad row.
A hypothesis property holds the schedule's contract on any layout: no
same-segment key in a skipped or masked tile, and no skipped tile for a
pad row (id <= 0).  The share of the dense tile work the schedule visits
on the packed traffic's calls, at the kernel's tiles and the two others
its design could take, is pinned: it is what chose the tiles.
"""

import functools

import jax.numpy as jnp
import numpy as np

import chip_smoke
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from llm_weighted_consensus_tpu.ops import attention as jax_attention
from llm_weighted_consensus_tpu_torch.ops import attention
from llm_weighted_consensus_tpu_torch.serve import packing

TOL = 1e-5


def _mixed_lengths(rng, n):
    """Segment lengths of the reference's mixed-length traffic
    (``bench_http.py --mixed-lengths``): a shared context of 4-16 words
    (60%), 24-64 (30%) or 96-192 (10%), then 8 words of answer, one
    hash-tokenizer token per word plus [CLS] and [SEP]."""
    out = []
    for _ in range(n):
        kind = rng.random()
        words = (rng.integers(4, 17) if kind < 0.6
                 else rng.integers(24, 65) if kind < 0.9
                 else rng.integers(96, 193))
        out.append(int(words) + 8 + 2)
    return out


def _planner_layouts(seed, row=512, rows=4, segments=64):
    """The segment ids of the packed calls the planner builds for one
    burst of mixed-length requests (each segment capped at the row, as
    the batcher caps it)."""
    rng = np.random.default_rng(seed)
    tokens = [np.ones(min(n, row), np.int32) for n in _mixed_lengths(rng, 40)]
    calls = packing.build_calls(tokens, row, rows, segments)
    return [c.segment_ids for c in calls]


def _hard_layout(b, s):
    """An all-pad row, one-token segments, negative ids (pad slots),
    segments across the 64-row and the 128-key edges (one out of id
    order), 8-token segments end to end, and a random row with pad
    gaps."""
    rng = np.random.default_rng(s)
    seg = np.zeros((b, s), np.int32)
    seg[1, :3] = [1, 2, 3]
    seg[1, 40:44] = -2
    seg[1, 60:70] = 4
    seg[1, 120:140] = 7
    seg[1, s - 3:] = 5
    if b > 2:
        seg[2] = np.arange(s) // 8 + 1
    for r in range(3, b):
        off, slot = 0, 1
        while off < s:
            n = int(rng.integers(1, 40))
            if rng.random() > 0.1:
                seg[r, off: off + n] = slot
                slot += 1
            off += n
    return seg


def emulate(q, k, v, seg, scale, block_q=attention.SEG_BLOCK_Q,
            block_k=attention.SEG_BLOCK_K):
    """The kernel's algorithm in f32: per query block, the key tiles in
    order, each as the schedule says (skipped; logits all -1e9 and P V;
    or the select and both products), an online softmax with a running
    max and sum."""
    b, s, nh, hd = q.shape
    kinds = attention.segment_tile_schedule(seg, block_q, block_k)
    out = torch.empty(b, s, nh, hd)
    masked = torch.tensor(-1e9)
    for r in range(b):
        for qb in range(kinds.shape[1]):
            rows = slice(qb * block_q, min(s, (qb + 1) * block_q))
            sq = seg[r, rows]
            n = sq.shape[0]
            m = torch.full((n, nh), -torch.inf)
            lsum = torch.zeros(n, nh)
            o = torch.zeros(n, nh, hd)
            for kt in range(kinds.shape[2]):
                kind = int(kinds[r, qb, kt])
                if kind == attention.SEG_SKIP:
                    continue
                keys = slice(kt * block_k, min(s, (kt + 1) * block_k))
                sk = seg[r, keys]
                same = (sq[:, None] == sk[None, :]) & (sk[None, :] > 0)
                if kind == attention.SEG_FULL:
                    logits = torch.einsum(
                        "qnd,knd->qkn", q[r, rows], k[r, keys]) * scale
                    x = torch.where(same[:, :, None], logits, masked)
                else:
                    assert not same.any()
                    x = masked.expand(n, sk.shape[0], nh)
                mx = torch.maximum(m, x.amax(dim=1))
                corr = torch.exp(m - mx)
                p = torch.exp(x - mx[:, None, :])
                lsum = lsum * corr + p.sum(dim=1)
                o = o * corr[:, :, None] + torch.einsum(
                    "qkn,knd->qnd", p, v[r, keys])
                m = mx
            out[r, rows] = o / lsum[:, :, None]
    return out


def _check(seg, nh=2, hd=16, seed=0, **blocks):
    b, s = seg.shape
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, s, nh, hd)).astype(np.float32)
               for _ in range(3))
    scale = hd ** -0.5
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    tseg = torch.from_numpy(np.ascontiguousarray(seg, np.int32))
    got = emulate(tq, tk, tv, tseg, scale, **blocks)
    plain = attention.segment_attention_plain(tq, tk, tv, tseg, scale)
    ref = np.asarray(jax_attention.fused_attention_tiled_seg(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tseg),
        scale, heads_per_step=1,
    ))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=TOL)
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL)
    # pad rows are the uniform mean of v
    pads = tseg <= 0
    if pads.any():
        mean_v = tv.mean(dim=1, keepdim=True).expand_as(got)
        np.testing.assert_allclose(got[pads].numpy(), mean_v[pads].numpy(),
                                   atol=TOL)
    return attention.segment_tile_schedule(tseg, **blocks)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_skipping_is_exact_on_the_planners_layouts(seed):
    for seg in _planner_layouts(seed):
        kinds = _check(seg, seed=seed)
        # the planner's rows need fewer than all tiles at 512 tokens
        if seg.shape[1] == 512:
            assert (kinds == attention.SEG_FULL).float().mean() < 0.75


@pytest.mark.parametrize("b,s", [(4, 512), (4, 300), (3, 200)])
def test_skipping_is_exact_on_the_hard_layouts(b, s):
    kinds = _check(_hard_layout(b, s), seed=s)
    # the all-pad row visits every tile, P V only
    assert (kinds[0] == attention.SEG_MASKED).all()


def test_skipping_is_exact_at_small_tiles():
    # many tiles per row at a short s: the schedule's edges everywhere
    for seg in (_hard_layout(4, 96), _planner_layouts(3, row=96)[0]):
        _check(seg, block_q=8, block_k=16)


def test_an_all_pad_call_is_the_mean_of_v():
    kinds = _check(np.zeros((2, 150), np.int32))
    assert (kinds == attention.SEG_MASKED).all()


def test_the_schedule_is_tight_on_the_planners_layouts():
    # segments end to end with increasing ids: a block's ids are a run
    # of consecutive ids, so ranges that overlap share a segment
    for seed in range(4):
        for seg in _planner_layouts(seed):
            tseg = torch.from_numpy(seg)
            kinds = attention.segment_tile_schedule(tseg)
            bq, bk = attention.SEG_BLOCK_Q, attention.SEG_BLOCK_K
            for r, qb, kt in (kinds == attention.SEG_FULL).nonzero().tolist():
                sq = tseg[r, qb * bq:(qb + 1) * bq]
                sk = tseg[r, kt * bk:(kt + 1) * bk]
                assert np.intersect1d(sq[sq > 0], sk[sk > 0]).size


@settings(max_examples=200, deadline=None)
@given(
    rows=st.lists(st.lists(st.integers(-2, 9), min_size=1, max_size=300),
                  min_size=1, max_size=3),
    block_q=st.sampled_from([4, 16, 64]),
    block_k=st.sampled_from([8, 32, 128]),
)
def test_no_same_segment_key_falls_in_a_skipped_or_masked_tile(
    rows, block_q, block_k
):
    # any ids in any order: rows of one call share s, cut to the shortest
    s = min(len(row) for row in rows)
    seg = torch.tensor([row[:s] for row in rows], dtype=torch.int32)
    kinds = attention.segment_tile_schedule(seg, block_q, block_k)
    assert kinds.shape == (len(rows), -(-s // block_q), -(-s // block_k))
    same = (seg[:, :, None] == seg[:, None, :]) & (seg[:, None, :] > 0)
    r, i, j = same.nonzero(as_tuple=True)
    assert (kinds[r, i // block_q, j // block_k] == attention.SEG_FULL).all()
    # a pad row sees every key: none of its tiles is skipped
    r, i = (seg <= 0).nonzero(as_tuple=True)
    assert (kinds[r, i // block_q] != attention.SEG_SKIP).all()


# (query rows, keys) per tile that the kernel's design could take: 128-row
# items as the padded kernel's, one consumer warpgroup's 64 rows (the
# kernel's choice) and 64-key tiles (wgmma n = 64); per layout the share
# of the dense [s, s] area the schedule visits, (full, masked)
TILE_SHARES = {
    "dedup_off": {(128, 128): (0.6319, 0.0892), (64, 128): (0.4896, 0.0637),
                  (64, 64): (0.4007, 0.0676)},
    "dedup_on": {(128, 128): (0.6214, 0.1086), (64, 128): (0.4600, 0.0760),
                 (64, 64): (0.3607, 0.0791)},
    "segment_ids_for": {(128, 128): (0.6250, 0.1289),
                        (64, 128): (0.4824, 0.0850),
                        (64, 64): (0.3926, 0.0889)},
}


@functools.lru_cache(maxsize=1)
def _smoke_layouts():
    """The segment ids of the packed calls ``chip_smoke.py`` serves: its
    mixed traffic through the hash tokenizer and the planner at its
    PACKING settings, with prefix dedup off and on (prefix and suffixes
    as the batcher embeds them), and ``segment_ids_for``'s rows at the
    bucket."""
    from llm_weighted_consensus_tpu_torch.models.tokenizer import (
        HashTokenizer,
    )

    tok = HashTokenizer(30522)
    cfg = chip_smoke.PACKING
    row_tokens = cfg["packing_row_tokens"]

    def calls(texts):
        ids, mask = tok.encode_batch(texts, row_tokens)
        rows = [ids[i, : int(mask[i].sum())] for i in range(len(texts))]
        return packing.build_calls(rows, row_tokens, cfg["packing_max_rows"],
                                   cfg["packing_max_segments"])

    whole, parts = [], []
    bursts, embeds = chip_smoke.mixed_traffic()
    for burst, docs in zip(bursts, embeds):
        whole += [t for req in burst for t in req] + docs
        for req in burst:
            prefix = packing.shared_prefix(req, cfg["prefix_dedup_min_chars"])
            parts += ([prefix] + [t[len(prefix):] for t in req]
                      if prefix else req)
        parts += docs
    return {
        "dedup_off": [c.segment_ids for c in calls(whole)],
        "dedup_on": [c.segment_ids for c in calls(parts)],
        "segment_ids_for": [chip_smoke.segment_ids_for(*chip_smoke.SEG_BUCKET,
                                                       seed)
                            for seed in range(4)],
    }


@pytest.mark.parametrize("layout", sorted(TILE_SHARES))
def test_the_tile_shares_behind_the_tile_choice(layout):
    segs = _smoke_layouts()[layout]
    area = np.array([seg.shape[0] * seg.shape[1] ** 2 for seg in segs],
                    np.float64)
    for (bq, bk), want in TILE_SHARES[layout].items():
        work = np.array([chip_smoke.tile_work(seg, bq, bk) for seg in segs])
        got = (work * area[:, None]).sum(0) / area.sum()
        np.testing.assert_allclose(got, want, atol=1e-4)
    # per 64-row consumer the schedule visits less than at 128-row items
    shares = TILE_SHARES[layout]
    assert sum(shares[(64, 128)]) < sum(shares[(128, 128)])
    assert (attention.SEG_BLOCK_Q, attention.SEG_BLOCK_K) in shares
