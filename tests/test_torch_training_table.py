"""The port's trained-weight path against the JAX package's.

* ``ops.similarity``: ``training_table_weights_batched``,
  ``training_table_weights`` and ``top_k_similar`` against the reference
  on seeded tables at 1e-6 relative, with padded rows, zero rows, ``k``
  greater than a judge's rows and than the padded row count, and exact
  ties at the k-th place: duplicated rows that straddle it carry
  different scores, and the port picks the reference's rows (the lower
  index first, as ``jax.lax.top_k`` does);
* ``TorchTrainingTableFetcher`` against ``TpuTrainingTableFetcher`` on
  the committed ``tests/fixtures/bge_micro`` snapshot (the JAX parameters
  carried over by ``models.convert``) in f32: the embeddings response and
  every judge's weight within 1e-5 relative (two f32 encoders summing in
  different orders), the judges without a table at their base weight;
  the same fetchers on one shared query vector at 1e-6 relative; through
  the batcher, the same weights as without it;
* ``TrainingTableStore``: a snapshot the JAX store writes loads in the
  port, and the reverse;
* the batcher's ``embed_cache`` path: cached rows skip the dispatch, a
  row a concurrent request is computing is joined, a peer's failed or
  cancelled dispatch makes the row recompute, and the rows equal the
  uncached path's.

The CPU comparisons hold JAX against the port at a relative tolerance,
not byte for byte: a weight's string is ``repr(float(f32))``, and the two
packages' f32 reductions may round one ulp apart.
"""

import asyncio
import dataclasses
import os
import threading
from decimal import Decimal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_weighted_consensus_tpu.identity.model import ModelBase as RefModelBase
from llm_weighted_consensus_tpu.models import configs as jax_configs
from llm_weighted_consensus_tpu.models import loading as jax_loading
from llm_weighted_consensus_tpu.models import tokenizer as jax_tokenizer
from llm_weighted_consensus_tpu.models.embedder import TpuEmbedder
from llm_weighted_consensus_tpu.ops import similarity as ref_sim
from llm_weighted_consensus_tpu.types import score_request as ref_req
from llm_weighted_consensus_tpu.weights import training_table as ref_tt
from llm_weighted_consensus_tpu_torch.identity.model import ModelBase
from llm_weighted_consensus_tpu_torch.models import (
    bert,
    convert,
    loading,
    tokenizer,
)
from llm_weighted_consensus_tpu_torch.models.embedder import TorchEmbedder
from llm_weighted_consensus_tpu_torch.ops import similarity as port_sim
from llm_weighted_consensus_tpu_torch.serve.batcher import DeviceBatcher
from llm_weighted_consensus_tpu_torch.types import score_request as port_req
from llm_weighted_consensus_tpu_torch.weights import training_table as port_tt
from llm_weighted_consensus_tpu_torch.cache import EmbeddingCache

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "bge_micro")
LOOKUP_TOL = 1e-6
MICRO_TOL = 1e-5


def go(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-30)))


# -- the lookup -----------------------------------------------------------------


def seeded_tables(seed, j=5, t=12, d=24, ties=True):
    """Per-judge tables padded to ``t`` rows: judge 1 has 3 rows (fewer
    than k), judge 2 one row, judge 3 a zero row; with ``ties`` judge 0
    and 4 hold duplicated rows (with different scores) at the query's
    nearest places, so equal similarities straddle the k-th place."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=d).astype(np.float32)
    tables = rng.normal(size=(j, t, d)).astype(np.float32)
    mask = np.ones((j, t), np.float32)
    mask[1, 3:] = 0
    mask[2, 1:] = 0
    tables[3, 4] = 0.0
    if ties:
        near = q + 0.3 * rng.normal(size=d).astype(np.float32)
        for judge, rows in ((0, (2, 5, 7, 9)), (4, (0, 1, 2, 3, 4, 10))):
            for r in rows:
                tables[judge, r] = near
    tables[mask == 0] = 0.0
    scores = rng.random((j, t)).astype(np.float32)
    lo = rng.uniform(0.5, 1.5, j).astype(np.float32)
    hi = (lo + rng.uniform(0.5, 4.0, j)).astype(np.float32)
    return tables, mask, scores, q, lo, hi


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 8, 12, 40])
def test_batched_lookup_matches_the_reference(seed, k):
    args = seeded_tables(seed)
    want = np.asarray(ref_sim.training_table_weights_batched(
        *map(jnp.asarray, args), min(k, args[0].shape[1])))
    got = port_sim.training_table_weights_batched(
        *map(torch.from_numpy, args), k).numpy()
    assert got.dtype == np.float32
    assert rel_err(got, want) <= LOOKUP_TOL
    lo, hi = args[4], args[5]
    assert np.all(got >= lo - 1e-6) and np.all(got <= hi + 1e-6)


@pytest.mark.parametrize("k", [2, 3, 4, 5, 6])
def test_ties_at_the_kth_place_pick_the_reference_rows(k):
    """Judge 4's six identical nearest rows carry different scores; at
    each k the port's selection (hence the weight) is the reference's,
    where an arbitrary order among ties would move it by up to the
    spread of those scores."""
    tables, mask, scores, q, lo, hi = seeded_tables(3)
    nq = ref_sim.l2_normalize(jnp.asarray(q))
    sims = jnp.einsum("td,d->t", ref_sim.l2_normalize(jnp.asarray(tables[4])),
                      nq)
    _, want_idx = jax.lax.top_k(sims, k)
    _, got_idx = port_sim._top_k(torch.tensor(np.asarray(sims)), k)
    assert got_idx.tolist() == np.asarray(want_idx).tolist()
    # the tie is real and the scores at its rows differ
    tied = [0, 1, 2, 3, 4, 10]
    assert len({float(s) for s in np.asarray(sims)[tied]}) == 1
    assert len({float(s) for s in scores[4, tied]}) == len(tied)
    want = np.asarray(ref_sim.training_table_weights_batched(
        *map(jnp.asarray, (tables, mask, scores, q, lo, hi)), k))
    got = port_sim.training_table_weights_batched(
        *map(torch.from_numpy, (tables, mask, scores, q, lo, hi)), k).numpy()
    assert rel_err(got, want) <= LOOKUP_TOL
    if k >= len(tied):
        return  # every tied row enters: the order among them cannot matter
    # the same rows in reverse order: another pick among the ties, so
    # another weight (the order among ties decides it)
    rev = [a[:, ::-1].copy() for a in (tables, mask, scores)]
    flipped = port_sim.training_table_weights_batched(
        *map(torch.from_numpy, (rev[0], rev[1], rev[2], q, lo, hi)),
        k).numpy()
    assert flipped[4] != got[4]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("k", [1, 3, 7])
def test_shared_table_lookup_matches_the_reference(seed, k):
    rng = np.random.default_rng(seed)
    t, d, j, b = 9, 16, 4, 3
    table = rng.normal(size=(t, d)).astype(np.float32)
    table[5] = table[2]  # a tie
    scores = rng.random((j, t)).astype(np.float32)
    queries = rng.normal(size=(b, d)).astype(np.float32)
    lo = np.ones(j, np.float32)
    hi = np.full(j, 5.0, np.float32)
    want = np.asarray(ref_sim.training_table_weights(
        *map(jnp.asarray, (table, scores, queries, lo, hi)), k))
    got = port_sim.training_table_weights(
        *map(torch.from_numpy, (table, scores, queries, lo, hi)), k).numpy()
    assert rel_err(got, want) <= LOOKUP_TOL
    want_s, want_i = ref_sim.top_k_similar(jnp.asarray(table),
                                           jnp.asarray(queries), k)
    got_s, got_i = port_sim.top_k_similar(torch.from_numpy(table),
                                          torch.from_numpy(queries), k)
    assert got_i.tolist() == np.asarray(want_i).tolist()
    assert np.abs(got_s.numpy() - np.asarray(want_s)).max() <= 1e-6


def test_zero_rows_normalise_to_zero_not_nan():
    x = torch.zeros(3, 8)
    assert torch.equal(port_sim.l2_normalize(x), x)
    tables = np.zeros((2, 4, 8), np.float32)
    mask = np.ones((2, 4), np.float32)
    out = port_sim.training_table_weights_batched(
        torch.from_numpy(tables), torch.from_numpy(mask),
        torch.full((2, 4), 0.5), torch.ones(8), torch.ones(2),
        torch.full((2,), 3.0), 3)
    assert torch.isfinite(out).all() and torch.allclose(out, torch.full(
        (2,), 2.0))


# -- the fetcher ------------------------------------------------------------------


def micro_embedders():
    """The JAX and the port embedders on bge_micro, in f32."""
    port_cfg = loading.load_hf_config(FIXTURE)
    jax_cfg = jax_configs.BertConfig(
        **{f.name: getattr(port_cfg, f.name)
           for f in dataclasses.fields(port_cfg)})
    params = jax_loading.load_params(FIXTURE, jax_cfg)
    state = convert.from_jax_params(
        jax.tree_util.tree_map(np.asarray, params), port_cfg)
    vocab = loading.find_vocab(FIXTURE)
    ref = TpuEmbedder("bge-micro", params=params, config=jax_cfg,
                      tokenizer=jax_tokenizer.load_tokenizer(vocab),
                      max_tokens=64)
    port = TorchEmbedder(
        "bge-micro", model=bert.from_hf_state_dict(state, port_cfg,
                                                   device="cpu"),
        config=port_cfg, tokenizer=tokenizer.load_tokenizer(vocab),
        max_tokens=64, device="cpu")
    return ref, port


@pytest.fixture(scope="module")
def micro():
    return micro_embedders()


PROMPTS = ["what is the capital of france", "paris is in france",
           "bananas are yellow", "how do rivers form",
           "the capital city of france is paris", "tell me about lyon"]
PROMPT = "which city is the capital of france?"


def panel(n_judges=4, top=3, max_tokens=32):
    return {
        "llms": [{"model": f"judge-{i}", "weight": {
            "type": "training_table", "base_weight": 1 + i % 2,
            "min_weight": 1, "max_weight": 2 + i}}
            for i in range(n_judges)],
        "weight": {"type": "training_table",
                   "embeddings": {"model": "bge-micro",
                                  "max_tokens": max_tokens},
                   "top": top},
    }


def stores(emb_rows, model, seed=0, skip=(3,)):
    """The same tables in a JAX and a port store: each judge (but those
    in ``skip``) gets ``emb_rows`` (its own shuffle and length) with its
    own seeded scores."""
    rng = np.random.default_rng(seed)
    ref_store, port_store = ref_tt.TrainingTableStore(), \
        port_tt.TrainingTableStore()
    for pos, llm in enumerate(model.llms):
        if pos in skip:
            continue
        rows = rng.permutation(len(emb_rows))[:len(emb_rows) - pos]
        e = np.asarray(emb_rows, np.float32)[rows]
        s = rng.random(len(rows)).astype(np.float32)
        ref_store.add_rows(llm.training_table_id, e, s)
        port_store.add_rows(llm.training_table_id, e, s)
    return ref_store, port_store


def both_models(body):
    return (RefModelBase.from_json_obj(body).into_model_validate(),
            ModelBase.from_json_obj(body).into_model_validate())


def both_params(text=PROMPT):
    body = {"messages": [{"role": "user", "content": text}],
            "model": "x" * 22, "choices": ["a", "b"]}
    return (ref_req.ChatCompletionCreateParams.from_json_obj(body),
            port_req.ChatCompletionCreateParams.from_json_obj(body))


@pytest.mark.parametrize("top", [1, 3, 8])
def test_fetcher_on_bge_micro_matches_the_reference(micro, top):
    ref_emb, port_emb = micro
    ref_model, port_model = both_models(panel(top=top))
    table_rows = port_emb.embed_texts(PROMPTS + [PROMPT, PROMPT])
    ref_store, port_store = stores(table_rows, port_model)
    ref_params, port_params = both_params()
    want_w, want_data = go(ref_tt.TpuTrainingTableFetcher(
        ref_emb, ref_store).fetch(None, ref_params, ref_model))
    got_w, got_data = go(port_tt.TorchTrainingTableFetcher(
        port_emb, port_store).fetch(None, port_params, port_model))
    assert all(isinstance(w, Decimal) for w in got_w)
    assert rel_err([float(w) for w in got_w],
                   [float(w) for w in want_w]) <= MICRO_TOL
    # a judge without a table keeps its base weight, exactly
    assert got_w[3] == want_w[3] == port_model.llms[3].base.weight.base_weight
    got_obj = got_data.to_json_obj()
    want_obj = want_data.to_json_obj()
    assert got_obj["embeddings_response"]["usage"] == \
        want_obj["embeddings_response"]["usage"]
    assert rel_err(got_obj["embeddings_response"]["data"][0]["embedding"],
                   want_obj["embeddings_response"]["data"][0]["embedding"]) \
        <= 1e-3 or np.abs(
        np.asarray(got_obj["embeddings_response"]["data"][0]["embedding"])
        - np.asarray(want_obj["embeddings_response"]["data"][0]["embedding"])
    ).max() <= MICRO_TOL


class _FixedEmbedder:
    """An embedder whose every response is one fixed vector: both
    fetchers then see the same query, so only the lookups differ."""

    def __init__(self, emb_types, vector, device=None):
        self.vector = [float(v) for v in vector]
        self.emb_types = emb_types
        self.device = device

    def embeddings_response(self, texts, max_tokens=None):
        return self.emb_types.CreateEmbeddingResponse.from_json_obj({
            "object": "list", "model": "fixed",
            "data": [{"object": "embedding", "index": 0,
                      "embedding": self.vector}],
            "usage": {"prompt_tokens": 9, "completion_tokens": 0,
                      "total_tokens": 9}})


@pytest.mark.parametrize("seed", range(4))
def test_fetcher_lookup_on_one_query_matches_the_reference(seed):
    from llm_weighted_consensus_tpu.types import embeddings as ref_types
    from llm_weighted_consensus_tpu_torch.types import embeddings as port_types

    rng = np.random.default_rng(seed)
    rows = rng.normal(size=(20, 32)).astype(np.float32)
    query = rows[4] + 0.1 * rng.normal(size=32).astype(np.float32)
    ref_model, port_model = both_models(panel(n_judges=6, top=5))
    ref_store, port_store = stores(rows, port_model, seed=seed, skip=(2,))
    ref_params, port_params = both_params()
    want, _ = go(ref_tt.TpuTrainingTableFetcher(
        _FixedEmbedder(ref_types, query), ref_store).fetch(
        None, ref_params, ref_model))
    got, _ = go(port_tt.TorchTrainingTableFetcher(
        _FixedEmbedder(port_types, query, torch.device("cpu")),
        port_store).fetch(None, port_params, port_model))
    assert rel_err([float(w) for w in got], [float(w) for w in want]) \
        <= LOOKUP_TOL
    assert got[2] == want[2]


def test_fetcher_through_the_batcher_equals_the_direct_path(micro):
    _, port_emb = micro
    _, port_model = both_models(panel())
    table_rows = port_emb.embed_texts(PROMPTS)
    _, port_store = stores(table_rows, port_model)
    _, port_params = both_params()
    direct = go(port_tt.TorchTrainingTableFetcher(
        port_emb, port_store).fetch(None, port_params, port_model))
    with DeviceBatcher(port_emb, window_ms=1) as batcher:
        batched = go(port_tt.TorchTrainingTableFetcher(
            port_emb, port_store, batcher=batcher).fetch(
            None, port_params, port_model))
        assert batcher.stats()["dispatches"]["embed"] == 1
    assert batched[0] == direct[0]
    assert batched[1].to_json_obj() == direct[1].to_json_obj()


def test_fetcher_keeps_a_shared_empty_store(micro):
    store = port_tt.TrainingTableStore()
    fetcher = port_tt.TorchTrainingTableFetcher(micro[1], store)
    assert fetcher.store is store


@pytest.mark.parametrize("writer,reader", [
    (ref_tt, port_tt), (port_tt, ref_tt)])
def test_tables_snapshot_loads_across_packages(tmp_path, writer, reader):
    rng = np.random.default_rng(1)
    store = writer.TrainingTableStore()
    store.add_rows("t1", rng.normal(size=(3, 8)), rng.random(3))
    store.add_rows("t1", rng.normal(size=(2, 8)), rng.random(2))
    store.add_rows("t2", rng.normal(size=(1, 8)), rng.random(1))
    store.mark_ingested("c-1")
    path = str(tmp_path / "tables.npz")
    store.save(path)
    loaded = reader.TrainingTableStore.load(path)
    assert len(loaded) == 2 and loaded.is_ingested("c-1")
    for tid in ("t1", "t2"):
        e, s = loaded.get(tid)
        want_e, want_s = store.get(tid)
        assert e.dtype == np.float32 and np.array_equal(e, want_e)
        assert np.array_equal(s, want_s)


# -- the batcher's embed cache ---------------------------------------------------


class _Gate:
    """Wraps an embedder's ``embed_tokens``: holds each call until
    released, and fails the calls listed in ``fail``."""

    def __init__(self, embedder, fail=()):
        self.embedder = embedder
        self.real = embedder.embed_tokens
        self.release = threading.Event()
        self.calls = 0
        self.rows = 0
        self.fail = set(fail)
        embedder.embed_tokens = self

    def __call__(self, ids, mask):
        self.calls += 1
        self.rows += int(mask.any(axis=1).sum())
        call = self.calls
        self.release.wait(10)
        if call in self.fail:
            raise RuntimeError("planted dispatch failure")
        return self.real(ids, mask)

    def restore(self):
        del self.embedder.embed_tokens


TEXTS = ["paris is the capital", "bananas are yellow", "rivers flow",
         "paris is the capital"]


def _cached_batcher(port_emb, ttl=60):
    return DeviceBatcher(port_emb, window_ms=1,
                         embed_cache=EmbeddingCache(ttl, 1 << 20))


def test_embed_cache_hits_skip_the_dispatch_and_equal_the_uncached(micro):
    ref_emb, port_emb = micro
    with DeviceBatcher(port_emb, window_ms=1) as plain:
        want, want_tokens = plain.embed(TEXTS, max_tokens=32)
    with _cached_batcher(port_emb) as batcher:
        first, tokens = batcher.embed(TEXTS, max_tokens=32)
        assert batcher.stats()["dispatches"]["embed"] == 1
        again, tokens2 = batcher.embed(TEXTS[1:3], max_tokens=32)
        assert batcher.stats()["dispatches"]["embed"] == 1  # all hits
        other, _ = batcher.embed(TEXTS[:2], max_tokens=16)  # another window
        assert batcher.stats()["dispatches"]["embed"] == 2
        stats = batcher._embed_cache_stats()
    assert np.array_equal(first, want) and tokens == want_tokens
    assert np.array_equal(again, want[1:3])
    assert tokens2 == sum(int(m.sum()) for m in [port_emb.tokenize(
        [t], 32)[1] for t in TEXTS[1:3]])
    assert other.shape == (2, port_emb.config.hidden_size)
    # the repeated text inside one request joined its own row
    assert stats["inflight_collapses"] == 1
    assert stats["hits"] == 2 and stats["entries"] == 5
    # and the vectors are the reference embedder's, within the f32 bar
    ref_vecs, _ = ref_emb.embed_texts(TEXTS, max_tokens=32), None
    assert np.abs(first - np.asarray(ref_vecs)).max() <= MICRO_TOL


def test_concurrent_identical_rows_join_one_dispatch(micro):
    _, port_emb = micro
    gate = _Gate(port_emb)
    try:
        with _cached_batcher(port_emb) as batcher:
            a = batcher.submit_embed(TEXTS[:2], max_tokens=32)
            b = batcher.submit_embed(TEXTS[:3], max_tokens=32)
            gate.release.set()
            va, _ = a.result(10)
            vb, _ = b.result(10)
            stats = batcher._embed_cache_stats()
            assert gate.rows == 3  # b dispatched only its third row
    finally:
        gate.restore()
    assert stats["inflight_collapses"] == 2
    assert np.array_equal(vb[:2], va)


def test_a_failed_peer_dispatch_makes_the_row_recompute(micro):
    _, port_emb = micro
    gate = _Gate(port_emb, fail={1})
    try:
        with _cached_batcher(port_emb) as batcher:
            leader = batcher.submit_embed(TEXTS[:2], max_tokens=32)
            peer = batcher.submit_embed(TEXTS[:2], max_tokens=32)
            gate.release.set()
            with pytest.raises(RuntimeError, match="planted"):
                leader.result(10)
            vecs, tokens = peer.result(10)
            assert gate.calls == 2  # the peer's retry
            assert batcher._embed_inflight == {}
    finally:
        gate.restore()
    with DeviceBatcher(port_emb, window_ms=1) as plain:
        want, want_tokens = plain.embed(TEXTS[:2], max_tokens=32)
    assert np.array_equal(vecs, want) and tokens == want_tokens


def test_a_cancelled_caller_never_cancels_a_joined_row(micro):
    _, port_emb = micro
    gate = _Gate(port_emb)
    try:
        with _cached_batcher(port_emb) as batcher:
            leader = batcher.submit_embed(TEXTS[:1], max_tokens=32)
            peer = batcher.submit_embed(TEXTS[:1], max_tokens=32)
            assert leader.cancel()
            gate.release.set()
            vecs, _ = peer.result(10)
            assert not peer.cancelled()
    finally:
        gate.restore()
    with DeviceBatcher(port_emb, window_ms=1) as plain:
        want, _ = plain.embed(TEXTS[:1], max_tokens=32)
    assert np.array_equal(vecs, want)


def test_embed_cache_section_of_metrics(micro):
    from llm_weighted_consensus_tpu_torch.serve.metrics import Metrics

    metrics = Metrics()
    with DeviceBatcher(micro[1], metrics, window_ms=1,
                       embed_cache=EmbeddingCache(60, 1 << 20)) as batcher:
        batcher.embed(TEXTS, max_tokens=32)
        section = metrics.snapshot()["embed_cache"]
    assert section["entries"] == 3 and section["inflight_collapses"] == 1
    # the repeated text misses the cache before it joins, as in the
    # reference's batcher
    assert section["misses"] == 4
