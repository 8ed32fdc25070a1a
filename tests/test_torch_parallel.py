"""The port's serving mesh on the CPU against the JAX package's.

``parallel/mesh.py``'s errors, ``parallel/collectives.py``'s sharded vote
and tally, ``parallel/sharding.py``'s rule tables and placement, the
tensor-parallel forward of ``models/bert.py`` (f32, bf16, int8 and int4
at tp 2 and 4, against the reference's ``shard_bert_params`` +
``bert.embed`` under GSPMD), ``shard_embedder_mesh`` / ``shard_embedder``,
``shard_reranker_mesh`` (DeBERTa's layers and head tensor-parallel) and
``rescore_batch`` on a mesh.  JAX runs on the conftest's 8 virtual
CPU devices; the port's meshes are ``[torch.device("cpu")] * k``.  Inputs
come from numpy seeds.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_weighted_consensus_tpu.models import bert as jax_bert
from llm_weighted_consensus_tpu.models import configs as jax_configs
from llm_weighted_consensus_tpu.models import deberta as jax_deberta
from llm_weighted_consensus_tpu.models import loading as jax_loading
from llm_weighted_consensus_tpu.models import quant as jax_quant
from llm_weighted_consensus_tpu.models.embedder import TpuEmbedder
from llm_weighted_consensus_tpu.parallel import batch as jax_batch
from llm_weighted_consensus_tpu.parallel import collectives as jax_coll
from llm_weighted_consensus_tpu.parallel import sharding as jax_sharding
from llm_weighted_consensus_tpu.parallel.mesh import make_mesh as jax_mesh
from llm_weighted_consensus_tpu_torch.models import (
    bert,
    configs,
    convert,
    deberta,
    loading,
    quant,
)
from llm_weighted_consensus_tpu_torch.models.embedder import TorchEmbedder
from llm_weighted_consensus_tpu_torch.parallel import (
    batch,
    collectives,
    sharding,
)
from llm_weighted_consensus_tpu_torch.parallel.mesh import make_mesh

CPU = torch.device("cpu")
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "bge_micro")
VOTE_TOL = 1e-5  # f32 vote and tally: the same sums in another order
F32_TOL = 1e-5  # the f32 forward tolerance of tests/test_torch_bert.py
BF16_TOL = 2e-2  # the bf16 forward tolerance of tests/test_torch_bert.py
INT4_TOL = 2e-4  # bge_micro's int4 tolerance, tests/test_torch_quant_model.py


def cpus(k=8):
    return [CPU] * k


def tokens(b, s, vocab, seed, n_pad=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab, size=(b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    lengths = rng.integers(max(1, s - n_pad), s + 1, size=b)
    lengths[0] = s
    for i, n in enumerate(lengths):
        mask[i, n:] = 0
        ids[i, n:] = 0
    return ids, mask


# -- make_mesh --------------------------------------------------------------------


MESH_CASES = {
    "4x2 over 1": (dict(dp=4, tp=2), 1),
    "1x1x2 over 1": (dict(dp=1, tp=1, sp=2), 1),
    "auto dp, tp past the devices": (dict(dp=None, tp=2), 1),
    "auto dp, sp axis": (dict(dp=None, tp=2, sp=2), 2),
    "tp 0": (dict(dp=1, tp=0), 4),
    "sp 0": (dict(dp=1, tp=1, sp=0), 4),
    "dp 0": (dict(dp=0, tp=1), 4),
    "legacy sp names": (dict(dp=None, tp=4, names=("dp", "sp")), 2),
}


@pytest.mark.parametrize("case", list(MESH_CASES))
def test_make_mesh_refuses_as_the_reference(case):
    kw, n = MESH_CASES[case]
    with pytest.raises(ValueError) as want:
        jax_mesh(devices=jax.devices()[:n], **kw)
    with pytest.raises(ValueError) as got:
        make_mesh(devices=cpus(n), **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw,n", [
    (dict(dp=4, tp=2), 8), (dict(dp=None, tp=2), 8),
    (dict(dp=2, tp=2, sp=2), 8), (dict(dp=1, tp=1, sp=1), 3),
    (dict(dp=None, tp=2, names=("dp", "sp")), 4),
])
def test_make_mesh_shapes_match_the_reference(kw, n):
    ref = jax_mesh(devices=jax.devices()[:n], **kw)
    port = make_mesh(devices=cpus(n), **kw)
    assert dict(port.shape) == dict(ref.shape)
    assert port.axis_names == tuple(ref.axis_names)


def test_make_mesh_takes_no_cpu_fallback():
    """No card here: the default device list raises, nothing falls back
    to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(dp=1)


# -- the sharded vote and tally ------------------------------------------------------


@pytest.mark.parametrize("dp", [2, 4, 8])
@pytest.mark.parametrize("n,n_valid", [(16, None), (13, None), (12, 9)])
def test_sharded_cosine_vote_matches_the_reference(dp, n, n_valid):
    rng = np.random.default_rng(dp * 100 + n)
    emb = rng.normal(size=(n, 32)).astype(np.float32)
    want = np.asarray(jax_coll.sharded_cosine_vote(
        jnp.asarray(emb), jax_mesh(dp=dp, tp=1), 0.07, n_valid=n_valid))
    got = collectives.sharded_cosine_vote(
        torch.from_numpy(emb), make_mesh(dp=dp, devices=cpus()), 0.07,
        n_valid=n_valid).numpy()
    assert got.shape == want.shape == (n_valid or n,)
    np.testing.assert_allclose(got, want, atol=VOTE_TOL)


def test_sharded_cosine_vote_takes_the_dp_shards():
    rng = np.random.default_rng(5)
    emb = torch.from_numpy(rng.normal(size=(12, 16)).astype(np.float32))
    mesh = make_mesh(dp=4, devices=cpus())
    whole = collectives.sharded_cosine_vote(emb, mesh, 0.05, n_valid=10)
    parts = collectives.sharded_cosine_vote(list(emb.chunk(4)), mesh, 0.05,
                                            n_valid=10)
    np.testing.assert_array_equal(whole.numpy(), parts.numpy())


@pytest.mark.parametrize("dp,m", [(2, 24), (4, 13), (8, 24)])
def test_sharded_tally_matches_the_reference(dp, m):
    rng = np.random.default_rng(dp + m)
    v = rng.random((m, 5)).astype(np.float32)
    v /= v.sum(axis=1, keepdims=True)
    w = rng.uniform(0.5, 2.0, m).astype(np.float32)
    want = np.asarray(jax_coll.sharded_tally(
        jnp.asarray(v), jnp.asarray(w), jax_mesh(dp=dp, tp=1)))
    got = collectives.sharded_tally(v, w, make_mesh(dp=dp, devices=cpus()))
    np.testing.assert_allclose(got.numpy(), want, atol=VOTE_TOL)


def test_collectives_record_their_groups():
    parts = [torch.full((2,), float(i)) for i in range(4)]
    with collectives.recording() as notes:
        summed = collectives.psum(parts)
        biggest = collectives.pmax(parts)
        gathered = collectives.all_gather(parts)
        rotated = collectives.ppermute(parts)
        collectives.psum(parts[:1])  # one shard: no group
    assert [n["op"] for n in notes] == ["psum", "pmax", "all_gather",
                                        "ppermute"]
    assert {n["group_size"] for n in notes} == {4}
    assert all(torch.equal(s, torch.full((2,), 6.0)) for s in summed)
    assert all(torch.equal(b, torch.full((2,), 3.0)) for b in biggest)
    assert gathered[0].tolist() == [0, 0, 1, 1, 2, 2, 3, 3]
    assert [r[0].item() for r in rotated] == [3.0, 0.0, 1.0, 2.0]


# -- the rule tables -------------------------------------------------------------------


def _spec(spec):
    return tuple(spec)


@pytest.mark.parametrize("arch", ["bert", "deberta"])
@pytest.mark.parametrize("quantized", [False, True])
def test_rule_tables_equal_the_references(arch, quantized):
    want = jax_sharding.partition_rules_for(arch, quantized=quantized)
    got = sharding.partition_rules_for(arch, quantized=quantized)
    assert [(n, p, _spec(s)) for n, p, s in want] == list(got)


@pytest.mark.parametrize("quantized", [False, True])
def test_spec_templates_equal_the_references(quantized):
    for tp in (True, False):
        want = jax.tree_util.tree_map(
            _spec, jax_sharding.bert_param_specs(tp=tp, quantized=quantized),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        assert sharding.bert_param_specs(tp=tp, quantized=quantized) == want


def _port_tree(arch, quantized):
    if arch == "bert":
        model = bert.init_params(configs.TEST_TINY, device="cpu")
        if quantized:
            quant.quantize_encoder(model, "int8")
        return model
    model = deberta.init_params(configs.DEBERTA_TEST_TINY, device="cpu")
    if quantized:
        quant.quantize_encoder(model, "int8")
    return model


def _jax_tree(arch, quantized):
    if arch == "bert":
        tree = jax_bert.init_params(jax.random.PRNGKey(0),
                                    jax_configs.TEST_TINY)
        return jax_quant.quantize_bert_params(tree) if quantized else tree
    tree = jax_deberta.init_params(jax.random.PRNGKey(0),
                                   jax_configs.DEBERTA_TEST_TINY)
    return jax_quant.quantize_deberta_params(tree) if quantized else tree


@pytest.mark.parametrize("arch", ["bert", "deberta"])
@pytest.mark.parametrize("quantized", [False, True])
def test_every_port_leaf_is_covered_exactly_once(arch, quantized):
    """The port's tensors name the reference's leaves: the match report
    over the port's model is the reference's over its tree, every leaf
    hits one rule, and no rule is dead."""
    rules = sharding.partition_rules_for(arch, quantized=quantized)
    leaves, counts = sharding.match_report(rules, _port_tree(arch, quantized))
    ref_leaves, ref_counts = jax_sharding.match_report(
        jax_sharding.partition_rules_for(arch, quantized=quantized),
        _jax_tree(arch, quantized))
    assert leaves == ref_leaves and counts == ref_counts
    assert all(len(hits) == 1 for hits in leaves.values()), leaves
    assert all(c >= 1 for c in counts.values()), counts


def test_match_partition_rules_raises_on_an_uncovered_leaf():
    rules = (("only_token", r"token_embed", ()),)
    with pytest.raises(ValueError, match="no partition rule"):
        sharding.match_partition_rules(rules, _port_tree("bert", False))


def test_shard_by_rules_splits_the_tp_layout():
    model = _port_tree("bert", False)
    mesh = make_mesh(dp=2, tp=2, devices=cpus(4))
    placed = sharding.shard_by_rules(model, mesh,
                                     sharding.bert_partition_rules())
    layer, full = placed.shard(1, CPU).encoder.layer[0], model.encoder.layer[0]
    h = configs.TEST_TINY.hidden_size
    q = layer.attention.self.query
    assert tuple(q.weight.shape) == (h // 2, h) and q.out_features == h // 2
    torch.testing.assert_close(q.weight, full.attention.self.query.weight[h // 2:])
    out = layer.attention.output.dense
    assert tuple(out.weight.shape) == (h, h // 2)
    torch.testing.assert_close(out.bias, full.attention.output.dense.bias)
    off = sharding.shard_by_rules(model, mesh, sharding.bert_partition_rules(),
                                  tp=False)
    assert off.tp == 1 and off.shard(0, CPU).encoder.layer[0].attention.self \
        .query.weight.shape == full.attention.self.query.weight.shape


def test_tp_refuses_heads_that_do_not_split():
    model = _port_tree("bert", False)  # 4 heads
    with pytest.raises(ValueError, match="num_heads=4 does not divide by tp=8"):
        sharding.shard_bert_params(model, make_mesh(dp=1, tp=8,
                                                    devices=cpus()))


# -- the tensor-parallel forward -------------------------------------------------------


def _jax_pair(jcfg, pcfg, params, mode="none", dtype=None):
    if mode.startswith("int4"):
        params = jax_quant.quantize_bert_params_int4(params)
    elif mode != "none":
        params = jax_quant.quantize_bert_params(params)
    jcfg = dataclasses.replace(jcfg, quantize=mode)
    state = convert.from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                                    pcfg)
    model = bert.from_hf_state_dict(state, pcfg, dtype=dtype, device="cpu")
    return params, jcfg, model


def _jax_tp_embed(params, jcfg, ids, mask, dp, tp):
    mesh = jax_mesh(dp=dp, tp=tp)
    placed = jax_sharding.shard_bert_params(params, mesh, tp=True)
    put = lambda a: jax.device_put(jnp.asarray(a),
                                   jax_sharding.batch_sharding(mesh))
    return np.asarray(jax_bert.embed(placed, put(ids), put(mask), jcfg))


def _port_tp_embed(model, ids, mask, dp, tp):
    placed = sharding.shard_bert_params(
        model, make_mesh(dp=dp, tp=tp, devices=cpus()))
    with torch.inference_mode():
        return bert.embed_mesh(placed, torch.from_numpy(ids),
                               torch.from_numpy(mask)).numpy()


@pytest.mark.parametrize("dp,tp", [(1, 2), (2, 2), (1, 4), (2, 4)])
@pytest.mark.parametrize("mode", ["none", "int8-pallas"])
def test_tp_forward_matches_the_reference_on_test_tiny(dp, tp, mode):
    jcfg = jax_configs.TEST_TINY
    params = jax_bert.init_params(jax.random.PRNGKey(0), jcfg)
    params, jcfg, model = _jax_pair(jcfg, configs.TEST_TINY, params, mode)
    ids, mask = tokens(4, 24, jcfg.vocab_size, seed=dp * tp, n_pad=9)
    want = _jax_tp_embed(params, jcfg, ids, mask, dp, tp)
    got = _port_tp_embed(model, ids, mask, dp, tp)
    np.testing.assert_allclose(got, want, atol=F32_TOL)
    # and the port's one-device forward
    with torch.inference_mode():
        one = bert.embed(model, torch.from_numpy(ids),
                         torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, one, atol=F32_TOL)


def test_tp_forward_int4_at_tp2_matches_the_reference():
    """int4 under tp: each shard repacks its K/tp rows (sharding doc);
    the product is the reference's, whose GSPMD forward gathers the
    packed rows."""
    jcfg = jax_configs.TEST_TINY
    params = jax_bert.init_params(jax.random.PRNGKey(0), jcfg)
    params, jcfg, model = _jax_pair(jcfg, configs.TEST_TINY, params,
                                    "int4-pallas")
    ids, mask = tokens(4, 24, jcfg.vocab_size, seed=11, n_pad=9)
    want = _jax_tp_embed(params, jcfg, ids, mask, 2, 2)
    got = _port_tp_embed(model, ids, mask, 2, 2)
    np.testing.assert_allclose(got, want, atol=F32_TOL)


def test_tp_forward_bf16_matches_the_reference():
    """bf16: the row-split partials reduce in f32 and cast once, as the
    reference's GSPMD dot does; the tolerance is the bf16 forward's."""
    jcfg = jax_configs.TEST_TINY
    params = jax_bert.init_params(jax.random.PRNGKey(0), jcfg)
    _, _, model = _jax_pair(jcfg, configs.TEST_TINY, params,
                            dtype=torch.bfloat16)
    bf16 = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), params)
    ids, mask = tokens(4, 32, jcfg.vocab_size, seed=9, n_pad=10)
    want = _jax_tp_embed(bf16, jcfg, ids, mask, 2, 2)
    got = _port_tp_embed(model, ids, mask, 2, 2)
    assert np.abs(got - want).max() <= BF16_TOL
    cos = (got * want).sum(-1) / (
        np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))
    assert cos.min() >= 0.999, cos


def _micro():
    pcfg = loading.load_hf_config(os.path.join(FIXTURE, "config.json"))
    jcfg = jax_configs.BertConfig(
        **{f.name: getattr(pcfg, f.name) for f in dataclasses.fields(pcfg)})
    return pcfg, jcfg


@pytest.mark.parametrize("mode,tol", [("none", F32_TOL),
                                      ("int8-pallas", F32_TOL),
                                      ("int4-pallas", INT4_TOL)])
def test_tp_forward_matches_the_reference_on_bge_micro(mode, tol):
    pcfg, jcfg = _micro()
    params = jax_loading.load_params(FIXTURE, jcfg)
    params, jcfg, model = _jax_pair(jcfg, pcfg, params, mode)
    ids, mask = tokens(4, 48, pcfg.vocab_size, seed=4, n_pad=30)
    want = _jax_tp_embed(params, jcfg, ids, mask, 2, 2)
    got = _port_tp_embed(model, ids, mask, 2, 2)
    np.testing.assert_allclose(got, want, atol=tol)


def test_tp_forward_packed_matches_one_device():
    model = _port_tree("bert", False)
    rng = np.random.default_rng(3)
    b, l, k = 4, 32, 3
    ids = torch.from_numpy(rng.integers(1, 500, (b, l)).astype(np.int32))
    seg = torch.from_numpy(np.repeat([1, 2, 3, 0], 8)[None].repeat(b, 0)
                           .astype(np.int32))
    pos = torch.from_numpy(np.tile(np.arange(8), 4)[None].repeat(b, 0)
                           .astype(np.int32))
    starts = torch.tensor([[0, 8, 16]] * b, dtype=torch.int32)
    placed = sharding.shard_bert_params(model, make_mesh(dp=2, tp=2,
                                                         devices=cpus(4)))
    with torch.inference_mode():
        one = bert.embed_packed(model, ids, seg, pos, starts)
        got = bert.embed_packed_mesh(placed, ids, seg, pos, starts)
    np.testing.assert_allclose(got.numpy(), one.numpy(), atol=F32_TOL)


def test_a_ring_collective_on_one_device_is_refused():
    model = _port_tree("bert", False)
    ids = torch.ones((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="runs across shards"):
        bert.encode(model, ids, torch.ones_like(ids), attention_impl="ring")


# -- the embedder on a mesh ------------------------------------------------------------


TEXTS = [f"candidate number {i % 3} for the mesh" for i in range(6)]


def _embedders(dp, tp, quantize="none"):
    ref = TpuEmbedder("test-tiny", config=jax_configs.TEST_TINY,
                      max_tokens=32, seed=3,
                      quantize="int8-pallas" if quantize != "none"
                      else "none")
    from llm_weighted_consensus_tpu.parallel.sharding import (
        shard_embedder_mesh as jax_shard,
    )

    jax_shard(ref, jax_mesh(dp=dp, tp=tp))
    tree = jax.tree_util.tree_map(np.asarray, ref.params)
    model = bert.from_hf_state_dict(
        convert.from_jax_params(tree, configs.TEST_TINY), configs.TEST_TINY,
        device="cpu")
    port = TorchEmbedder("test-tiny", model=model, config=configs.TEST_TINY,
                         tokenizer=ref.tokenizer, max_tokens=32,
                         device="cpu")
    sharding.shard_embedder_mesh(port, make_mesh(dp=dp, tp=tp,
                                                 devices=cpus()))
    return ref, port


@pytest.mark.parametrize("dp,tp", [(2, 1), (1, 2), (2, 2), (4, 2)])
def test_shard_embedder_mesh_consensus_matches_the_reference(dp, tp):
    ref, port = _embedders(dp, tp)
    assert port.batch_multiple == dp and port.mesh_shape == (dp, tp)
    assert port.label_suffix == f"@dp{dp}xtp{tp}"
    for texts, temp in ((TEXTS, 0.05), (TEXTS[:5], 0.2)):
        want = np.asarray(ref.consensus_confidence(texts, temperature=temp))
        got = port.consensus_confidence(texts, temperature=temp)
        np.testing.assert_allclose(got, want, atol=VOTE_TOL)
    np.testing.assert_allclose(port.embed_texts(TEXTS[:3]),
                               np.asarray(ref.embed_texts(TEXTS[:3])),
                               atol=F32_TOL)
    ids, mask = ref.tokenize(TEXTS)
    r = 3
    many_ids = np.stack([ids] * r)
    many_mask = np.stack([mask] * r)
    want = np.asarray(ref.consensus_confidence_tokens_many(
        many_ids, many_mask))
    got = port.consensus_confidence_tokens_many(many_ids, many_mask)
    np.testing.assert_allclose(got, want, atol=VOTE_TOL)


def test_shard_embedder_legacy_hooks_match_one_device():
    ref = TorchEmbedder("test-tiny", config=configs.TEST_TINY, max_tokens=32,
                        seed=1, device="cpu")
    emb = TorchEmbedder("test-tiny", config=configs.TEST_TINY, max_tokens=32,
                        seed=1, device="cpu")
    sharding.shard_embedder(emb, make_mesh(dp=4, tp=2, devices=cpus()),
                            tp=True)
    texts = [f"text number {i}" for i in range(7)]
    np.testing.assert_allclose(emb.embed_texts(texts), ref.embed_texts(texts),
                               atol=F32_TOL)
    assert not emb.mesh_mode and not emb.supports_packing()
    assert emb.label_suffix == ""


def test_rescore_batch_on_a_mesh_matches_the_reference():
    rng = np.random.default_rng(4)
    b, m, n = 19, 4, 6  # ragged batch
    v = rng.random((b, m, n)).astype(np.float32)
    v /= v.sum(axis=2, keepdims=True)
    w = rng.uniform(0.5, 2.0, (b, m)).astype(np.float32)
    want_cw, want = jax_batch.rescore_batch(v, w, mesh=jax_mesh(dp=8, tp=1))
    for mesh in (make_mesh(dp=8, devices=cpus()),
                 make_mesh(dp=2, tp=4, devices=cpus(), names=("dp", "sp"))):
        cw, conf = batch.rescore_batch(v, w, mesh=mesh)
        assert conf.shape == (b, n)
        np.testing.assert_allclose(conf, np.asarray(want), atol=1e-6)
        np.testing.assert_allclose(cw, np.asarray(want_cw), atol=1e-5)


# -- the reward model on a mesh ----------------------------------------------------


@pytest.mark.parametrize("dp,tp", [(1, 1), (1, 2), (2, 2), (1, 4)])
@pytest.mark.parametrize("port_mode,jax_mode", [("none", "none"),
                                                ("int8", "int8-pallas")])
def test_shard_reranker_mesh_matches_the_reference(dp, tp, port_mode,
                                                   jax_mode):
    """DeBERTa's params placed by its rule table: the layers and the head
    tensor-parallel (``deberta.reward_mesh``), the batch unsharded."""
    from llm_weighted_consensus_tpu.models.reranker import TpuReranker
    from llm_weighted_consensus_tpu.parallel.sharding import (
        shard_reranker_mesh as jax_shard_rm,
    )
    from llm_weighted_consensus_tpu_torch.models.reranker import (
        TorchReranker,
    )

    jcfg = jax_configs.DEBERTA_TEST_TINY
    params = jax_deberta.init_params(jax.random.PRNGKey(5), jcfg)
    ref = TpuReranker("deberta-test-tiny", params=params, config=jcfg,
                      max_tokens=48, quantize=jax_mode)
    jax_shard_rm(ref, jax_mesh(dp=dp, tp=tp))
    state = convert.from_jax_deberta_params(
        jax.tree_util.tree_map(np.asarray, params), configs.DEBERTA_TEST_TINY)
    port = TorchReranker(
        "deberta-test-tiny",
        model=deberta.from_state(state, configs.DEBERTA_TEST_TINY,
                                 device="cpu"),
        max_tokens=48, device="cpu", quantize=port_mode)
    sharding.shard_reranker_mesh(port, make_mesh(dp=dp, tp=tp,
                                                 devices=cpus()))
    assert port.mesh_model.tp == tp
    texts = ["the answer is four because two plus two",
             "the answer is five", "unrelated text about weather", "four"]
    for kwargs in ({}, {"prompt": "what is 2+2?", "temperature": 0.05}):
        got, tokens = port.rerank_confidence(texts, **kwargs)
        want, want_tokens = ref.rerank_confidence(texts, **kwargs)
        assert tokens == want_tokens
        np.testing.assert_allclose(got, np.asarray(want), atol=VOTE_TOL)
