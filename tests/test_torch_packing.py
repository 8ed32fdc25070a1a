"""The port's packed (continuous-batching) path against the JAX package's,
on the CPU.

Same inputs in both packages, made from numpy seeds; the same weights
(the reference's ``init_params`` tree or the committed ``bge_micro``
snapshot, carried over by ``convert.from_jax_params``).  The reference
runs ``fused_attention_tiled_seg`` (its Pallas kernel, in interpret mode
on the CPU) through ``attention_impl="fused"``; the port runs the plain
version of its segment-attention kernel.

Tolerances: the planner and the host vote exact; segment attention 1e-5
in f32 and 2e-2 in bf16 (probabilities rounded to bf16 before P·V, as
for the padded kernel); packed embeddings against the reference 1e-5
(f32 summation order), except bge_micro under int4, 2e-4 (an upstream
ulp can flip one int8 activation rounding; ``test_torch_quant_model``);
packed against padded inside the port 1e-6 per segment and a segment
against itself beside other row-mates 1e-7 (masked probabilities are
exactly 0); confidences 1e-5.
"""

import asyncio
import dataclasses
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_weighted_consensus_tpu.models import bert as jax_bert
from llm_weighted_consensus_tpu.models import configs as jax_configs
from llm_weighted_consensus_tpu.models import loading as jax_loading
from llm_weighted_consensus_tpu.models import quant as jax_quant
from llm_weighted_consensus_tpu.models.embedder import TpuEmbedder
from llm_weighted_consensus_tpu.ops import attention as jax_attention
from llm_weighted_consensus_tpu.serve import packing as jax_packing
from llm_weighted_consensus_tpu.serve.batcher import DeviceBatcher
from llm_weighted_consensus_tpu.serve.metrics import Metrics
from llm_weighted_consensus_tpu_torch.models import bert, configs, convert
from llm_weighted_consensus_tpu_torch.models import loading
from llm_weighted_consensus_tpu_torch.models.embedder import TorchEmbedder
from llm_weighted_consensus_tpu_torch.ops import attention
from llm_weighted_consensus_tpu_torch.serve import __main__ as serve_main
from llm_weighted_consensus_tpu_torch.serve import packing
from llm_weighted_consensus_tpu_torch.serve.batcher import ConsensusBatcher
from llm_weighted_consensus_tpu_torch.serve.gateway import Server

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "bge_micro")
EMB_TOL = 1e-5
CONF_TOL = 1e-5
# the reference's test planner settings (tests/test_packing.py)
ROW, ROWS, SEGS = 64, 4, 8
TEXTS = [
    "the quick brown fox",
    "jumps over the lazy dog and keeps going for a while longer",
    "a",
    "weighted consensus serving on tensor processing units",
    "short",
    "another medium length candidate text for packing",
]


def go(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


def _rows(lengths, vocab, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=n).astype(np.int32) for n in lengths]


# -- serve/packing.py: the port's copy against the reference -----------------


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("row,segs", [(64, 8), (512, 64), (40, 3)])
def test_plan_rows_matches_reference(seed, row, segs):
    lengths = np.random.default_rng(seed).integers(1, row + 1, size=37)
    assert packing.plan_rows(lengths, row, segs) == jax_packing.plan_rows(
        lengths, row, segs
    )


def test_plan_rows_refuses_what_the_reference_refuses():
    for bad in ([0], [65], [3, -1]):
        with pytest.raises(ValueError):
            jax_packing.plan_rows(bad, 64, 8)
        with pytest.raises(ValueError):
            packing.plan_rows(bad, 64, 8)


def test_buckets_match_reference():
    assert packing._L_BUCKETS == jax_packing._L_BUCKETS
    for n in range(1, 2100, 7):
        for row in (64, 512, 2048):
            assert packing.seq_bucket_packed(n, row) == (
                jax_packing.seq_bucket_packed(n, row)
            )
    for n in range(0, 40):
        for max_rows in (1, 4, 8, 16):
            assert packing.rows_bucket(n, max_rows) == (
                jax_packing.rows_bucket(n, max_rows)
            )


@pytest.mark.parametrize(
    "lengths,row,rows,segs",
    [
        ([30, 40, 20, 10, 64, 1, 1, 5], 64, 4, 8),
        (list(range(1, 60)), 128, 8, 16),
        ([500, 12, 12, 300, 3, 200, 511, 7, 7, 7], 512, 8, 64),
        ([1] * 70, 64, 2, 8),
    ],
)
def test_build_calls_matches_reference(lengths, row, rows, segs):
    tokens = _rows(lengths, 500, seed=len(lengths))
    got = packing.build_calls(tokens, row, rows, segs)
    want = jax_packing.build_calls(tokens, row, rows, segs)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for name in ("ids", "segment_ids", "positions", "seg_starts"):
            a, b = getattr(g, name), getattr(w, name)
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)
        assert g.slots == w.slots
        assert g.real_tokens == w.real_tokens
        assert g.slot_tokens == w.slot_tokens


@pytest.mark.parametrize(
    "texts,min_chars",
    [
        (["a long shared prefix here: yes", "a long shared prefix here: no"], 8),
        (["abc def", "abc xyz"], 1),
        (["same", "same"], 2),
        (["one"], 1),
        (["no common", "thing at all"], 1),
        (["prefix word and more", "prefix word and less"], 48),
        (["x y z w", "x y z w v", "x y q"], 0),
    ],
)
def test_shared_prefix_matches_reference(texts, min_chars):
    assert packing.shared_prefix(texts, min_chars) == (
        jax_packing.shared_prefix(texts, min_chars)
    )


def test_compose_and_host_vote_match_reference_exactly():
    rng = np.random.default_rng(3)
    for _ in range(5):
        p, sfx = rng.normal(size=(2, 48)).astype(np.float32)
        pt, st = (int(x) for x in rng.integers(1, 40, size=2))
        np.testing.assert_array_equal(
            packing.compose_prefix_suffix(p, pt, sfx, st),
            jax_packing.compose_prefix_suffix(p, pt, sfx, st),
        )
        np.testing.assert_array_equal(
            packing.compose_prefix_suffix(p, pt, None, 0),
            jax_packing.compose_prefix_suffix(p, pt, None, 0),
        )
    for n in (1, 2, 5, 64):
        vecs = rng.normal(size=(n, 32)).astype(np.float32)
        for temperature in (0.05, 0.7):
            got = packing.consensus_vote_np(vecs, temperature)
            np.testing.assert_array_equal(
                got, jax_packing.consensus_vote_np(vecs, temperature)
            )
            assert got.dtype == np.float32


# -- segment attention: the plain version against the Pallas kernel ----------


def _segments(b, s, seed, layout):
    """int32 segment ids [b, s]: random segments, plus the layouts that
    are hard for a tiled kernel."""
    rng = np.random.default_rng(seed)
    seg = np.zeros((b, s), np.int32)
    for r in range(b):
        off, slot = 0, 1
        while off < s:
            n = int(rng.integers(1, 24))
            if rng.random() < 0.15:
                off += n  # a gap of pad slots
                continue
            seg[r, off: off + n] = slot
            off, slot = off + n, slot + 1
        tail = int(rng.integers(0, 5))
        seg[r, s - tail:] = 0  # a pad tail
    if layout == "hard":
        seg[0] = 0  # a row that is all pad
        if b > 1:
            seg[1] = 0
            seg[1, :3] = [1, 2, 3]  # one-token segments
            if s > 70:
                seg[1, 60:70] = 4  # straddles the 64-key tile edge
                seg[1, 66:68] = 5
                seg[1, s - 3:] = 6  # starts past 64
    return seg


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,s,nh,hd,layout",
    [
        (2, 16, 2, 16, "random"),
        (3, 80, 2, 32, "hard"),
        (2, 150, 2, 24, "hard"),
        (4, 64, 4, 64, "hard"),
        (1, 200, 2, 16, "random"),
    ],
)
def test_plain_segment_attention_matches_pallas_kernel(
    dtype, b, s, nh, hd, layout
):
    rng = np.random.default_rng(b * s + hd)
    q, k, v = (rng.normal(size=(b, s, nh, hd)).astype(np.float32)
               for _ in range(3))
    seg = _segments(b, s, seed=s, layout=layout)
    scale = hd ** -0.5
    ref = np.asarray(
        jax_attention.fused_attention_tiled_seg(
            *(jnp.asarray(t, dtype) for t in (q, k, v)),
            jnp.asarray(seg), scale, heads_per_step=1,
        ),
        np.float32,
    )
    tdt = getattr(torch, dtype)
    before = attention.segment_attention.launches
    port = attention.segment_attention(
        *(torch.from_numpy(t).to(tdt) for t in (q, k, v)),
        torch.from_numpy(seg), scale,
    )
    # the CPU runs the plain version: no kernel launch is counted
    assert attention.segment_attention.launches == before
    assert port.dtype == tdt and port.shape == (b, s, nh, hd)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(port.float().numpy(), ref, atol=tol)
    # pad query rows see -1e9 everywhere: the uniform mean of v, finite
    vt = torch.from_numpy(v).to(tdt).float()
    for r in range(b):
        pads = np.flatnonzero(seg[r] == 0)
        if len(pads):
            np.testing.assert_allclose(
                port[r, pads].float().numpy(),
                np.broadcast_to(vt[r].mean(dim=0).numpy(),
                                (len(pads), nh, hd)),
                atol=tol,
            )
    assert torch.isfinite(port.float()).all()


def test_segment_attention_sees_only_its_segment():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 12, 2, 16)).astype(
        np.float32)) for _ in range(3))
    seg = torch.tensor([[1] * 5 + [2] * 4 + [0] * 3], dtype=torch.int32)
    full = attention.segment_attention(q, k, v, seg, 0.25)
    alone = attention.attention_plain(
        q[:, :5], k[:, :5], v[:, :5], torch.zeros(1, 5), 0.25
    )
    np.testing.assert_allclose(full[:, :5].numpy(), alone.numpy(), atol=1e-6)


@pytest.mark.parametrize("change", ["int64", "float", "shape", "qkv_shape"])
def test_segment_attention_rejects_bad_ids(change):
    q = torch.zeros(2, 8, 2, 16)
    seg = torch.ones(2, 8, dtype=torch.int32)
    k = q
    if change == "int64":
        seg = seg.long()
    elif change == "float":
        seg = seg.float()
    elif change == "shape":
        seg = seg[:, :4]
    else:
        k = q[:, :4]
    with pytest.raises((ValueError, TypeError)):
        attention.segment_attention(q, k, q, seg, 0.25)


# -- bert.embed_packed against the reference's --------------------------------


def _packed_inputs(vocab, seed, row=ROW, rows=ROWS, segs=SEGS, longest=None):
    lengths = np.random.default_rng(seed).integers(1, 30, size=11)
    lengths[0] = longest or row  # by default a segment that fills a row
    return packing.build_calls(_rows(lengths, vocab, seed), row, rows, segs)


def _jax_packed(params, cfg, call, pooling):
    return np.asarray(
        jax_bert.embed_packed(
            params, *(jnp.asarray(a) for a in (
                call.ids, call.segment_ids, call.positions, call.seg_starts
            )), cfg, pooling=pooling,
        )
    )


def _port_packed(model, call, pooling):
    with torch.inference_mode():
        return bert.embed_packed(
            model, *(torch.from_numpy(a) for a in (
                call.ids, call.segment_ids, call.positions, call.seg_starts
            )), pooling=pooling,
        ).numpy()


def _quantized(params, mode):
    if mode == "none":
        return params
    if mode.startswith("int4"):
        return jax_quant.quantize_bert_params_int4(params)
    return jax_quant.quantize_bert_params(params)


def _pair(params, jax_cfg, port_cfg, mode):
    """The reference's tree (quantized under ``mode``) in both packages,
    the reference running its Pallas kernels in interpret mode."""
    qparams = _quantized(params, mode)
    model = bert.from_hf_state_dict(
        convert.from_jax_params(
            jax.tree_util.tree_map(np.asarray, qparams), port_cfg
        ),
        port_cfg, device="cpu",
    )
    return qparams, dataclasses.replace(
        jax_cfg, attention_impl="fused", quantize=mode
    ), model


@pytest.fixture(scope="module")
def tiny_params():
    return jax_bert.init_params(jax.random.PRNGKey(0), jax_configs.TEST_TINY)


@pytest.mark.parametrize("mode", ["none", "int8-pallas", "int4-pallas"])
@pytest.mark.parametrize("pooling", ["cls", "mean"])
def test_embed_packed_matches_jax_on_test_tiny(tiny_params, mode, pooling):
    qparams, jcfg, model = _pair(
        tiny_params, jax_configs.TEST_TINY, configs.TEST_TINY, mode
    )
    calls = _packed_inputs(jcfg.vocab_size, seed=len(mode), rows=2)
    assert len(calls) >= 2
    for call in calls:
        want = _jax_packed(qparams, jcfg, call, pooling)
        got = _port_packed(model, call, pooling)
        assert got.shape == want.shape and got.dtype == np.float32
        # every slot, the unused ones too: finite and equal
        np.testing.assert_allclose(got, want, atol=EMB_TOL)


@pytest.mark.parametrize(
    "mode,tol", [("none", EMB_TOL), ("int8-pallas", EMB_TOL),
                 ("int4-pallas", 2e-4)],
)
@pytest.mark.parametrize("pooling", ["cls", "mean"])
def test_embed_packed_matches_jax_on_bge_micro(mode, tol, pooling):
    port_cfg = loading.load_hf_config(os.path.join(FIXTURE, "config.json"))
    jcfg = jax_configs.BertConfig(
        **{f.name: getattr(port_cfg, f.name)
           for f in dataclasses.fields(port_cfg)},
    )
    params = jax_loading.load_params(FIXTURE, jcfg)
    qparams, jcfg, model = _pair(params, jcfg, port_cfg, mode)
    # rows of 160 tokens, past the 128-position table: only segments are
    # bounded by it
    calls = _packed_inputs(
        port_cfg.vocab_size, seed=5, row=160, rows=2, segs=6, longest=120
    )
    assert max(c.ids.shape[1] for c in calls) > port_cfg.max_position_embeddings
    for call in calls:
        np.testing.assert_allclose(
            _port_packed(model, call, pooling),
            _jax_packed(qparams, jcfg, call, pooling), atol=tol,
        )


def test_packed_hidden_states_match_jax(tiny_params):
    _, jcfg, model = _pair(
        tiny_params, jax_configs.TEST_TINY, configs.TEST_TINY, "none"
    )
    call = _packed_inputs(jcfg.vocab_size, seed=9)[0]
    want = np.asarray(
        jax_bert.encode(
            tiny_params, jnp.asarray(call.ids),
            jnp.asarray((call.segment_ids > 0).astype(np.int32)), jcfg,
            segment_ids=jnp.asarray(call.segment_ids),
            positions=jnp.asarray(call.positions),
        )
    )
    with torch.inference_mode():
        got = bert.encode(
            model, torch.from_numpy(call.ids), None,
            segment_ids=torch.from_numpy(call.segment_ids),
            positions=torch.from_numpy(call.positions),
        ).numpy()
    # pad query rows (the uniform mean of v) included
    np.testing.assert_allclose(got, want, atol=EMB_TOL)


# -- packed against padded inside the port ------------------------------------


@pytest.fixture(scope="module")
def port_tiny():
    return TorchEmbedder("test-tiny", max_tokens=32, seed=3, device="cpu")


def _packed_vs_padded(emb, texts, atol, **plan):
    plan = {"row_tokens": ROW, "max_rows": ROWS, "max_segments": SEGS, **plan}
    ref = emb.embed_texts(texts)
    rows = emb.tokenize_ragged(texts)
    calls = packing.build_calls(rows, plan["row_tokens"], plan["max_rows"],
                                plan["max_segments"])
    got = [None] * len(texts)
    for c in calls:
        out = emb.embed_packed(c.ids, c.segment_ids, c.positions, c.seg_starts)
        assert out.shape == (c.ids.shape[0], plan["max_segments"],
                             emb.config.hidden_size)
        assert np.isfinite(out).all()
        for si, (r, slot) in c.slots.items():
            got[si] = out[r, slot]
    np.testing.assert_allclose(np.stack(got), ref, atol=atol)


@pytest.mark.parametrize("pooling", ["cls", "mean"])
@pytest.mark.parametrize("quantize", ["none", "int8", "int4-pallas"])
def test_packed_matches_padded_per_segment(pooling, quantize):
    emb = TorchEmbedder(
        "test-tiny", max_tokens=32, seed=3, device="cpu", pooling=pooling,
        quantize=quantize,
    )
    _packed_vs_padded(emb, TEXTS, atol=1e-6)


def test_packed_matches_padded_with_many_segments_per_row(port_tiny):
    words = "red green blue cyan magenta yellow black white".split()
    rng = np.random.default_rng(4)
    texts = [" ".join(rng.choice(words, size=rng.integers(1, 30)))
             for _ in range(40)]
    _packed_vs_padded(port_tiny, texts, atol=1e-6, row_tokens=128,
                      max_rows=8, max_segments=64)


def test_no_cross_segment_attention(port_tiny):
    """A segment's vector does not move with its row-mates: masked
    probabilities are exactly 0."""
    rows_a = port_tiny.tokenize_ragged(["segment under test"])
    outs = []
    for mates in ([], ["benign neighbor"], ["hostile neighbor 999 zz"],
                  ["x " * 25, "a b c d e f g"]):
        rows = rows_a + port_tiny.tokenize_ragged(mates)
        calls = packing.build_calls(rows, ROW, ROWS, SEGS)
        assert len(calls) == 1
        c = calls[0]
        out = port_tiny.embed_packed(
            c.ids, c.segment_ids, c.positions, c.seg_starts
        )
        r, slot = c.slots[0]
        outs.append(out[r, slot])
    for other in outs[1:]:
        np.testing.assert_allclose(outs[0], other, atol=1e-7)


def test_a_segment_past_the_position_table_is_refused(port_tiny):
    table = configs.TEST_TINY.max_position_embeddings  # 64
    ids = np.ones((1, 96), np.int32)
    seg = np.ones((1, 96), np.int32)
    pos = np.arange(96, dtype=np.int32)[None]
    starts = np.zeros((1, 4), np.int32)
    with pytest.raises(ValueError, match="max_position_embeddings"):
        port_tiny.embed_packed(ids, seg, pos, starts)
    with pytest.raises(ValueError, match="segment of 96 tokens"):
        bert.embed_packed(
            port_tiny.model,
            *(torch.from_numpy(a) for a in (ids, seg, pos, starts)),
        )
    # the same 96-token row holding two segments of 48 fits
    seg[0, 48:] = 2
    pos[0, 48:] -= 48
    starts[0, 1] = 48
    out = port_tiny.embed_packed(ids, seg, pos, starts)
    assert out.shape == (1, 4, 64) and np.isfinite(out).all()
    assert table < 96


def test_cls_pooling_reads_seg_starts_and_unused_slots_stay_finite():
    hidden = torch.arange(2 * 6 * 3, dtype=torch.float32).view(2, 6, 3)
    seg = torch.tensor([[1, 1, 2, 2, 2, 0], [1, 2, 3, 3, 0, 0]],
                       dtype=torch.int32)
    starts = torch.tensor([[0, 2, 0, 0], [0, 1, 2, 0]], dtype=torch.int32)
    cls = bert.pool_segments(hidden, seg, starts, "cls", normalize=False)
    assert torch.equal(cls[0, 1], hidden[0, 2])
    assert torch.equal(cls[1, 2], hidden[1, 2])
    assert torch.equal(cls[0, 3], hidden[0, 0])  # unused slot: offset 0
    mean = bert.pool_segments(hidden, seg, starts, "mean", normalize=False)
    assert torch.allclose(mean[0, 1], hidden[0, 2:5].mean(dim=0))
    assert torch.equal(mean[0, 3], torch.zeros(3))  # unused slot: zero
    want = jax_bert.pool_segments(
        jnp.asarray(hidden.numpy()), jnp.asarray(seg.numpy()),
        jnp.asarray(starts.numpy()), "mean",
    )
    got = bert.pool_segments(hidden, seg, starts, "mean")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


# -- the embedders and the batchers against the reference ---------------------


@pytest.fixture(scope="module")
def embedders(tiny_params):
    """The reference's TpuEmbedder (Pallas kernels in interpret mode) and
    the port's TorchEmbedder on the same test-tiny weights."""
    cfg = dataclasses.replace(jax_configs.TEST_TINY, attention_impl="fused")
    ref = TpuEmbedder("test-tiny", config=cfg, params=tiny_params,
                      max_tokens=32)
    state = convert.from_jax_params(
        jax.tree_util.tree_map(np.asarray, tiny_params), configs.TEST_TINY
    )
    port = TorchEmbedder(
        "test-tiny",
        model=bert.from_hf_state_dict(state, configs.TEST_TINY, device="cpu"),
        max_tokens=32, device="cpu",
    )
    return ref, port


def test_torch_embedder_embed_packed_matches_tpu_embedder(embedders):
    ref, port = embedders
    assert port.supports_packing()
    rows = port.tokenize_ragged(TEXTS + ["x " * 40])
    want_rows = ref.tokenize_ragged(TEXTS + ["x " * 40])
    assert len(rows) == len(want_rows)
    for a, b in zip(rows, want_rows):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    assert len(rows[-1]) == 32  # capped at max_tokens
    for call in packing.build_calls(rows, ROW, ROWS, SEGS):
        args = (call.ids, call.segment_ids, call.positions, call.seg_starts)
        np.testing.assert_allclose(
            port.embed_packed(*args), np.asarray(ref.embed_packed(*args)),
            atol=EMB_TOL,
        )


PREFIX = "a long shared conversation prefix for every candidate "
CONS_A = ["candidate one x", "candidate two y", "candidate three z"]
CONS_B = [f"other {i} {'pad ' * i}" for i in range(5)]
CONS_P = [PREFIX + s for s in ("alpha", "beta", "gamma gamma")]
# no whitespace in the shared prefix: the first candidate IS the prefix,
# so its suffix is empty and its vector is the prefix vector
CONS_E = ["q.r.s.t.u.v.w.x.y.z", "q.r.s.t.u.v.w.x.y.z tail",
          "q.r.s.t.u.v.w.x.y.z more words"]
EMBED = ["alpha beta", "gamma delta epsilon", "z " * 50]


def _port_results(port, **options):
    """The mixed traffic through the port's batcher in one group (every
    request queued before the group's wait ends); -> (results, stats)."""
    with ConsensusBatcher(port, window_ms=300, **options) as batcher:
        futures = [
            batcher.submit_embed(EMBED),
            batcher.submit_consensus(CONS_A, 0.05),
            batcher.submit_consensus(CONS_B, 0.07),
            batcher.submit_consensus(CONS_P, 0.05),
            batcher.submit_consensus(CONS_E, 0.3),
        ]
        results = [f.result(120) for f in futures]
        return results, batcher.stats()


def _packed_options(**over):
    return dict(packing=True, packing_row_tokens=ROW, packing_max_rows=ROWS,
                packing_max_segments=SEGS, prefix_dedup_min_chars=16, **over)


@pytest.mark.parametrize("dedup", [True, False])
def test_packed_batcher_matches_the_reference_batcher(embedders, dedup):
    """Embedding and mixed-N, mixed-temperature consensus requests share
    one packed dispatch in both packages and give the same answers."""
    ref, port = embedders
    results, stats = _port_results(port, **_packed_options(prefix_dedup=dedup))
    batcher = DeviceBatcher(
        ref, Metrics(), window_ms=30.0, **_packed_options(prefix_dedup=dedup)
    )
    assert batcher.packing

    async def run():
        return await asyncio.gather(
            batcher.embed(EMBED),
            batcher.consensus(CONS_A, 0.05),
            batcher.consensus(CONS_B, 0.07),
            batcher.consensus(CONS_P, 0.05),
            batcher.consensus(CONS_E, 0.3),
        )

    want = go(run())
    series = batcher.metrics.snapshot()["series"]
    assert series["device:batch:packed"]["count"] == 1
    (emb, tokens), *cons = results
    np.testing.assert_allclose(emb, np.asarray(want[0][0]), atol=EMB_TOL)
    assert tokens == int(np.sum(want[0][1]))
    for (conf, tok), (w_conf, w_tok) in zip(cons, want[1:]):
        np.testing.assert_allclose(conf, np.asarray(w_conf), atol=CONF_TOL)
        assert tok == int(w_tok)
    assert stats["packing"]["dispatches"] == 1
    assert stats["dispatches"] == {"consensus": 0, "embed": 0}
    assert stats["requests"] == {"consensus": 4, "embed": 1}
    assert stats["largest_group"] == 5
    pk, ref_pk = stats["packing"], batcher.utilization()["packing"]
    for field in ("enabled", "real_tokens", "slot_tokens", "padding_waste",
                  "prefix_dedup_hits", "prefix_dedup_tokens_saved",
                  "fallback_items", "bucket_occupancy"):
        assert pk[field] == ref_pk[field], field
    hits = len(CONS_P) - 1 + len(CONS_E) - 1
    assert pk["prefix_dedup_hits"] == (hits if dedup else 0)
    assert sum(pk["call_shapes"].values()) == sum(
        pk["bucket_occupancy"].values()
    )


def test_packed_dedup_off_gives_the_padded_answers(embedders):
    _, port = embedders
    results, stats = _port_results(port, **_packed_options(prefix_dedup=False))
    (emb, tokens), *cons = results
    np.testing.assert_allclose(emb, port.embed_texts(EMBED), atol=1e-6)
    _, mask = port.tokenize(EMBED)
    assert tokens == int(mask.sum())
    for (conf, tok), texts, temp in zip(
        cons, (CONS_A, CONS_B, CONS_P, CONS_E), (0.05, 0.07, 0.05, 0.3)
    ):
        np.testing.assert_allclose(
            conf, port.consensus_confidence(texts, temperature=temp),
            atol=CONF_TOL,
        )
        assert tok == int(port.tokenize(texts)[1].sum())
    assert stats["packing"]["prefix_dedup_hits"] == 0


def test_packed_dedup_on_is_the_composition_contract(embedders):
    """The prefix embeds once; each candidate is the token-count-weighted
    normalised sum of its prefix and suffix vectors (the padded path's
    embeddings of the parts), voted on the host."""
    _, port = embedders
    results, stats = _port_results(port, **_packed_options())
    saved = 0
    for (conf, tokens), texts, temp in zip(
        results[3:], (CONS_P, CONS_E), (0.05, 0.3)
    ):
        p = packing.shared_prefix(texts, 16)
        assert p is not None
        suffixes = [t[len(p):] for t in texts]
        parts = [p] + [s for s in suffixes if s]
        rows = port.tokenize_ragged(parts, min(ROW, port.max_tokens))
        vecs = port.embed_texts(parts)
        it = iter(range(1, len(parts)))
        cand = []
        for s in suffixes:
            i = next(it) if s else None
            cand.append(packing.compose_prefix_suffix(
                vecs[0], len(rows[0]), None if i is None else vecs[i],
                0 if i is None else len(rows[i]),
            ))
        np.testing.assert_allclose(
            conf, packing.consensus_vote_np(np.stack(cand), temp),
            atol=CONF_TOL,
        )
        assert tokens == sum(len(r) for r in rows)
        saved += (len(texts) - 1) * len(rows[0])
    assert "" in [t[len(packing.shared_prefix(CONS_E, 16)):] for t in CONS_E]
    pk = stats["packing"]
    assert pk["prefix_dedup_hits"] == len(CONS_P) - 1 + len(CONS_E) - 1
    assert pk["prefix_dedup_tokens_saved"] == saved


def test_packed_group_is_capped_by_segments(port_tiny):
    # 2 rows x 4 segments = 8 segments per group: requests of 3 + 3 fit,
    # the third (3 more) waits for the next group
    options = dict(packing=True, packing_row_tokens=64, packing_max_rows=2,
                   packing_max_segments=4)
    with ConsensusBatcher(port_tiny, max_batch=1, window_ms=300,
                          **options) as batcher:
        futures = [batcher.submit_consensus(["a", "b", "c"]) for _ in range(3)]
        for f in futures:
            f.result(120)
        stats = batcher.stats()
    # max_batch does not cap a packed group
    assert stats["packing"]["dispatches"] == 2
    assert stats["largest_group"] == 2


def test_a_long_request_is_capped_per_segment_and_stays_packed(port_tiny):
    # each segment is capped at min(row_tokens, max_tokens) = 16 tokens
    with ConsensusBatcher(port_tiny, window_ms=100, packing=True,
                          packing_row_tokens=16) as batcher:
        conf, tokens = batcher.consensus(["w " * 30, "v " * 30])
        stats = batcher.stats()
    assert stats["packing"]["fallback_items"] == 0
    assert stats["packing"]["call_shapes"] == {"2x16": 1}
    assert len(conf) == 2 and tokens == 32


def test_a_request_that_does_not_fit_takes_the_padded_dispatch(
    port_tiny, monkeypatch
):
    # the cap above makes every real request fit; an empty token row
    # (which no packed row takes) stands in for one that does not
    texts = ["a b", "a c", "d"]
    want = port_tiny.consensus_confidence(texts)
    monkeypatch.setattr(
        port_tiny, "tokenize_ragged",
        lambda texts, cap=None: [np.zeros(0, np.int32) for _ in texts],
    )
    with ConsensusBatcher(port_tiny, window_ms=1, packing=True) as batcher:
        conf, tokens = batcher.consensus(texts)
        stats = batcher.stats()
    assert stats["packing"]["fallback_items"] == 1
    assert stats["packing"]["slot_tokens"] == 0
    np.testing.assert_allclose(conf, want, atol=CONF_TOL)
    assert stats["padded"]["real_tokens"] == tokens == 11


def test_an_empty_embeddings_request_is_answered_as_padded(port_tiny):
    results = []
    for packing in (False, True):
        with ConsensusBatcher(port_tiny, window_ms=300,
                              packing=packing) as batcher:
            # it shares a group with a real request, which still answers
            empty = batcher.submit_embed([])
            full = batcher.submit_embed(["alpha beta"])
            results.append((empty.result(60), full.result(60)))
    (pad_empty, pad_full), (pk_empty, pk_full) = results
    assert pad_empty[0].shape == pk_empty[0].shape == (0, 64)
    assert pad_empty[1] == pk_empty[1] == 0
    np.testing.assert_allclose(pk_full[0], pad_full[0], atol=1e-6)


def test_packing_off_is_the_padded_batcher(port_tiny):
    with ConsensusBatcher(port_tiny, max_batch=8, window_ms=50) as batcher:
        assert not batcher.packing
        futures = [
            batcher.submit_consensus(["a", "b"], 0.05),
            batcher.submit_consensus(["c", "d"], 0.05),
            batcher.submit_consensus(["a", "b", "c"], 0.05),
            batcher.submit_embed(["x", "y", "z"]),
        ]
        out = [f.result(60) for f in futures]
        stats = batcher.stats()
    assert stats["dispatches"] == {"consensus": 2, "embed": 1}
    assert stats["packing"]["dispatches"] == 0
    assert stats["packing"]["slot_tokens"] == 0
    pad = stats["padded"]
    # [CLS] a [SEP] per candidate: 3 tokens, in the s=16 bucket
    assert pad["real_tokens"] == 3 * 4 + 3 * 3 + 3 * 3
    assert pad["slot_tokens"] == 2 * 2 * 16 + 1 * 3 * 16 + 16 * 16
    np.testing.assert_allclose(
        out[2][0], port_tiny.consensus_confidence(["a", "b", "c"]), atol=1e-6
    )


def test_packed_server_answers_over_http(embedders):
    import json
    import urllib.request

    _, port = embedders
    bodies = [{"input": CONS_A}, {"input": CONS_B, "temperature": 0.07},
              {"input": CONS_P}]
    out = [None] * 4
    with Server(port, window_ms=300, **_packed_options()) as srv:

        def call(i, path, body):
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.port}{path}",
                data=json.dumps(body).encode(),
                headers={"content-type": "application/json"},
            )
            with urllib.request.urlopen(req, timeout=60) as resp:
                out[i] = json.loads(resp.read())

        threads = [threading.Thread(target=call, args=(i, "/consensus", b))
                   for i, b in enumerate(bodies)]
        threads.append(threading.Thread(
            target=call, args=(3, "/embeddings",
                               {"model": "test-tiny", "input": EMBED})))
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        stats = srv.batcher.stats()
    assert stats["packing"]["dispatches"] == 1
    for body, got in zip(bodies, out):
        assert len(got["confidence"]) == len(body["input"])
        assert abs(sum(got["confidence"]) - 1) < 1e-5
    np.testing.assert_allclose(
        out[0]["confidence"], port.consensus_confidence(CONS_A), atol=CONF_TOL
    )
    assert len(out[3]["data"]) == len(EMBED)


def test_server_takes_a_burst_of_concurrent_connections(port_tiny):
    """48 clients connecting at once all complete their handshake on the
    first SYN: the listen backlog holds them until the server accepts
    (socketserver's default backlog of 5 drops the rest, and the client
    retries only after 1 s)."""
    import socket

    srv = Server(port_tiny)  # listening, not yet accepting
    try:
        socks = [
            socket.create_connection(("127.0.0.1", srv.port), timeout=5)
            for _ in range(48)
        ]
        for sock in socks:
            sock.close()
    finally:
        srv.close()


def test_main_reads_the_packing_environment():
    assert serve_main.packing_options({}) == {
        "packing": False, "packing_row_tokens": 512, "packing_max_rows": 8,
        "packing_max_segments": 64, "prefix_dedup": True,
        "prefix_dedup_min_chars": 48,
    }
    env = {"PACKING_ENABLED": "1", "PACKING_ROW_TOKENS": "4",
           "PACKING_MAX_ROWS": "0", "PACKING_MAX_SEGMENTS": "-3",
           "PREFIX_DEDUP": "0", "PREFIX_DEDUP_MIN_CHARS": "0"}
    # the reference's clamps
    assert serve_main.packing_options(env) == {
        "packing": True, "packing_row_tokens": 16, "packing_max_rows": 1,
        "packing_max_segments": 1, "prefix_dedup": False,
        "prefix_dedup_min_chars": 1,
    }
    env = {"PACKING_ENABLED": "true", "PACKING_ROW_TOKENS": "64",
           "PACKING_MAX_ROWS": "4", "PACKING_MAX_SEGMENTS": "16",
           "PREFIX_DEDUP": "yes", "PREFIX_DEDUP_MIN_CHARS": "20"}
    opts = serve_main.packing_options(env)
    assert opts == {
        "packing": True, "packing_row_tokens": 64, "packing_max_rows": 4,
        "packing_max_segments": 16, "prefix_dedup": True,
        "prefix_dedup_min_chars": 20,
    }
    # and the server built from them packs
    emb = serve_main.build_embedder(
        {"EMBEDDER_MODEL": "test-tiny", "LWC_ALLOW_RANDOM_PARAMS": "1",
         "EMBEDDER_MAX_TOKENS": "16"}, device="cpu",
    )
    with Server(emb, **opts) as srv:
        assert srv.batcher.packing
        assert srv.batcher.packing_row_tokens == 64
        assert srv.batcher.prefix_dedup_min_chars == 20
