"""The port's ring attention (``parallel/ring.py``) on the CPU against the
JAX package's ``tests/test_ring.py`` cases: ``ring_attention`` at sp 2
and 4 with padded keys, ``ring_encode`` / ``ring_embed`` against the
reference's ring and against the dense forward, a sequence past the
dense window, dp x sp, roberta positions, the refusals, and the legacy
``MESH_SP`` hook.  The reference rings over the conftest's virtual CPU
devices; the port over ``[torch.device("cpu")] * k``.  f32 throughout:
the online softmax is one softmax in another order of sums.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

from llm_weighted_consensus_tpu.models import bert as jax_bert
from llm_weighted_consensus_tpu.models import configs as jax_configs
from llm_weighted_consensus_tpu.parallel import ring as jax_ring
from llm_weighted_consensus_tpu.parallel.compat import shard_map
from llm_weighted_consensus_tpu_torch.models import bert, configs, convert
from llm_weighted_consensus_tpu_torch.models.embedder import TorchEmbedder
from llm_weighted_consensus_tpu_torch.parallel import ring
from llm_weighted_consensus_tpu_torch.parallel.mesh import make_mesh

CPU = torch.device("cpu")
RING_TOL = 1e-5  # the ring against the reference's ring, f32
DENSE_TOL = 1e-4  # the ring against a dense forward (the reference's bar)


def jax_sp_mesh(sp, dp=1):
    return JaxMesh(np.array(jax.devices()[: dp * sp]).reshape(dp, sp),
                   ("dp", "sp"))


def sp_mesh(sp, dp=1):
    return make_mesh(dp=dp, tp=sp, devices=[CPU] * (dp * sp),
                     names=("dp", "sp"))


def pair(jcfg, seed):
    """The reference's params and the port's model on them."""
    params = jax_bert.init_params(jax.random.PRNGKey(seed), jcfg)
    pcfg = configs.BertConfig(**{
        f.name: getattr(jcfg, f.name)
        for f in dataclasses.fields(configs.BertConfig)})
    model = bert.from_hf_state_dict(
        convert.from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                                pcfg), pcfg, device="cpu")
    return params, model


def ring_cfg(cfg):
    return dataclasses.replace(cfg, attention_impl="ring")


def dense_cfg(cfg):
    return dataclasses.replace(cfg, attention_impl="einsum")


@pytest.mark.parametrize("sp", [2, 4])
def test_ring_attention_matches_the_references(sp):
    rng = np.random.default_rng(0)
    b, s, nh, hd = 2, 32, 4, 8
    q, k, v = (rng.normal(size=(b, s, nh, hd)).astype(np.float32)
               for _ in range(3))
    bias = np.zeros((b, s), np.float32)
    bias[0, 28:] = ring.NEG_INF
    bias[1, 17:] = ring.NEG_INF
    scale = 1.0 / np.sqrt(hd)
    spec = P(None, "sp")
    want = np.asarray(shard_map(
        lambda q, k, v, b: jax_ring.ring_attention(q, k, v, b, scale, "sp"),
        mesh=jax_sp_mesh(sp), in_specs=(spec,) * 4,
        out_specs=P(None, "sp", None, None), check_vma=False,
    )(*(jnp.asarray(a) for a in (q, k, v, bias))))
    cut = lambda a: list(torch.from_numpy(a).chunk(sp, dim=1))
    got = torch.cat(ring.ring_attention(cut(q), cut(k), cut(v), cut(bias),
                                        scale), dim=1).numpy()
    np.testing.assert_allclose(got, want, atol=RING_TOL)
    # and one softmax over the whole row
    logits = np.einsum("bqnd,bknd->bnqk", q, k) * scale + bias[:, None, None]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    dense = np.einsum("bnqk,bknd->bqnd", probs, v)
    np.testing.assert_allclose(got, dense, atol=RING_TOL)


def test_ring_encode_matches_the_reference_and_the_dense_forward():
    cfg = jax_configs.TEST_TINY
    params, model = pair(cfg, 0)
    rng = np.random.default_rng(1)
    b, s = 2, 32
    ids = rng.integers(3, cfg.vocab_size, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[1, 20:] = 0
    want = np.asarray(jax_ring.ring_encode(
        params, jnp.asarray(ids), jnp.asarray(mask), ring_cfg(cfg),
        jax_sp_mesh(8)))
    with torch.inference_mode():
        got = ring.ring_encode(model, torch.from_numpy(ids),
                               torch.from_numpy(mask), sp_mesh(8))[0].numpy()
        dense = bert.encode(model, torch.from_numpy(ids),
                            torch.from_numpy(mask)).numpy()
    real = mask.astype(bool)
    np.testing.assert_allclose(got[real], want[real], atol=RING_TOL)
    np.testing.assert_allclose(got[real], dense[real], atol=DENSE_TOL)


@pytest.mark.parametrize("sp", [2, 4, 8])
def test_ring_embed_matches_the_reference(sp):
    cfg = jax_configs.TEST_TINY
    params, model = pair(cfg, 2)
    rng = np.random.default_rng(3)
    b, s = 4, 64
    ids = rng.integers(3, cfg.vocab_size, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[2, 40:] = 0
    want = np.asarray(jax_ring.ring_embed(
        params, jnp.asarray(ids), jnp.asarray(mask), ring_cfg(cfg),
        jax_sp_mesh(sp)))
    with torch.inference_mode():
        got = ring.ring_embed(model, torch.from_numpy(ids),
                              torch.from_numpy(mask), sp_mesh(sp)).numpy()
        dense = bert.embed(model, torch.from_numpy(ids),
                           torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=RING_TOL)
    np.testing.assert_allclose(got, dense, atol=DENSE_TOL)


def test_ring_long_context_beyond_one_window():
    """A sequence far past TEST_TINY's window: each shard holds s/sp."""
    cfg = jax_configs.BertConfig(
        vocab_size=256, hidden_size=32, num_layers=2, num_heads=2,
        intermediate_size=64, max_position_embeddings=2048)
    params, model = pair(cfg, 4)
    rng = np.random.default_rng(5)
    ids = rng.integers(3, 256, (1, 1024)).astype(np.int32)
    mask = np.ones_like(ids)
    want = np.asarray(jax_ring.ring_embed(
        params, jnp.asarray(ids), jnp.asarray(mask), ring_cfg(cfg),
        jax_sp_mesh(8)))
    with torch.inference_mode():
        got = ring.ring_embed(model, torch.from_numpy(ids),
                              torch.from_numpy(mask), sp_mesh(8)).numpy()
        dense = bert.embed(model, torch.from_numpy(ids),
                           torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=RING_TOL)
    np.testing.assert_allclose(got, dense, atol=DENSE_TOL)


def test_ring_with_dp_and_sp_axes():
    cfg = jax_configs.TEST_TINY
    params, model = pair(cfg, 6)
    rng = np.random.default_rng(7)
    b, s = 4, 16
    ids = rng.integers(3, cfg.vocab_size, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[3, 9:] = 0
    want = np.asarray(jax_bert.encode(params, jnp.asarray(ids),
                                      jnp.asarray(mask), dense_cfg(cfg)))
    with torch.inference_mode():
        hidden = ring.ring_encode(model, torch.from_numpy(ids),
                                  torch.from_numpy(mask), sp_mesh(4, dp=2),
                                  dp_axis="dp")
        emb = ring.ring_embed(model, torch.from_numpy(ids),
                              torch.from_numpy(mask), sp_mesh(4, dp=2),
                              dp_axis="dp").numpy()
    got = torch.cat(hidden).numpy()
    real = mask.astype(bool)
    np.testing.assert_allclose(got[real], want[real], atol=DENSE_TOL)
    np.testing.assert_allclose(emb, np.asarray(jax_bert.embed(
        params, jnp.asarray(ids), jnp.asarray(mask), dense_cfg(cfg))),
        atol=DENSE_TOL)


def test_ring_with_roberta_positions():
    cfg = jax_configs.BertConfig(
        vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
        intermediate_size=64, max_position_embeddings=66, type_vocab_size=1,
        pad_token_id=1, position_style="roberta")
    params, model = pair(cfg, 9)
    rng = np.random.default_rng(10)
    ids = rng.integers(4, 128, (2, 64)).astype(np.int32)
    mask = np.ones_like(ids)
    want = np.asarray(jax_ring.ring_embed(
        params, jnp.asarray(ids), jnp.asarray(mask), ring_cfg(cfg),
        jax_sp_mesh(8)))
    with torch.inference_mode():
        got = ring.ring_embed(model, torch.from_numpy(ids),
                              torch.from_numpy(mask), sp_mesh(8)).numpy()
    np.testing.assert_allclose(got, want, atol=RING_TOL)
    # the usable window counts the position base
    too_long = torch.zeros((1, 72), dtype=torch.int32)
    with pytest.raises(ValueError, match="usable window"):
        ring.ring_encode(model, too_long, torch.ones_like(too_long),
                         sp_mesh(8))


def test_ring_refuses_bad_shapes():
    _, model = pair(jax_configs.TEST_TINY, 0)
    ids = torch.zeros((1, 12), dtype=torch.int32)  # 12 % 8 != 0
    with pytest.raises(ValueError, match="divide"):
        ring.ring_encode(model, ids, torch.ones_like(ids), sp_mesh(8))
    long = torch.zeros((1, 128), dtype=torch.int32)  # past 64 positions
    with pytest.raises(ValueError, match="usable window"):
        ring.ring_encode(model, long, torch.ones_like(long), sp_mesh(8))
    seg = torch.ones((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="packed segment_ids"):
        next(bert.encode_steps(model, seg, None, segment_ids=seg,
                               positions=seg, attention_impl="ring"))


def test_shard_embedder_sp_matches_the_plain_embedder():
    plain = TorchEmbedder("test-tiny", config=configs.TEST_TINY,
                          max_tokens=64, seed=2, device="cpu")
    ringed = TorchEmbedder("test-tiny", config=configs.TEST_TINY,
                           max_tokens=64, seed=2, device="cpu")
    ring.shard_embedder_sp(ringed, sp_mesh(8))
    texts = ["a longer text with many words " * 2, "short",
             "and a third document"]
    np.testing.assert_allclose(ringed.embed_texts(texts),
                               plain.embed_texts(texts), atol=DENSE_TOL)
    assert ringed.sp_mesh is not None and not ringed.supports_packing()
    # dp x sp: the batch pads to the dp multiple; sp=3 caps the window
    dp3 = TorchEmbedder("test-tiny", config=configs.TEST_TINY, max_tokens=64,
                        seed=2, device="cpu")
    ring.shard_embedder_sp(dp3, sp_mesh(2, dp=3), dp_axis="dp")
    assert dp3.batch_multiple == 3
    four = ["one", "two", "three", "four"]
    np.testing.assert_allclose(dp3.embed_texts(four),
                               plain.embed_texts(four), atol=DENSE_TOL)
    sp3 = TorchEmbedder("test-tiny", config=configs.TEST_TINY, max_tokens=64,
                        seed=2, device="cpu")
    ring.shard_embedder_sp(sp3, sp_mesh(3))
    assert sp3.max_tokens == 63
    out = sp3.embed_texts(["word " * 200])
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, atol=1e-5)


def test_build_embedder_mesh_sp_round_trip():
    from llm_weighted_consensus_tpu_torch.serve.__main__ import build_embedder

    env = {"EMBEDDER_MODEL": "test-tiny", "LWC_ALLOW_RANDOM_PARAMS": "1"}
    emb = build_embedder({**env, "EMBEDDER_MAX_TOKENS": "64",
                          "MESH_SP": "4", "MESH_DP": "2"},
                         device="cpu", mesh_devices=[CPU] * 8)
    assert dict(emb.sp_mesh.shape) == {"dp": 2, "sp": 4}
    out = emb.embed_texts(["long context through the ring"])
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, atol=1e-5)
    auto = build_embedder({**env, "MESH_SP": "2"}, device="cpu",
                          mesh_devices=[CPU] * 8)
    assert dict(auto.sp_mesh.shape) == {"dp": 4, "sp": 2}
    assert auto.max_tokens == 64  # the whole table, not 512
    with pytest.raises(ValueError, match="mutually exclusive"):
        build_embedder({**env, "MESH_SP": "4", "MESH_TP": "2"},
                       device="cpu", mesh_devices=[CPU] * 8)
    with pytest.raises(ValueError, match="axes must be >= 1"):
        build_embedder({**env, "MESH_SP": "0"}, device="cpu",
                       mesh_devices=[CPU] * 8)


@pytest.mark.parametrize("dp,sp", [(1, 4), (2, 2)])
def test_mesh_ring_dispatch_matches_the_dense_forward(dp, sp):
    """The first-class mesh's ring dispatch (``MESH_SHAPE=dp x 1 x sp``):
    embed and vote past the dense window against the dense forward of a
    one-device embedder on the whole sequence."""
    from llm_weighted_consensus_tpu_torch.parallel.sharding import (
        shard_embedder_mesh,
    )

    cfg = dataclasses.replace(configs.TEST_TINY, max_position_embeddings=256)
    one = TorchEmbedder("test-tiny", config=cfg, max_tokens=256, seed=5,
                        device="cpu")
    emb = TorchEmbedder("test-tiny", config=cfg, max_tokens=32, seed=5,
                        device="cpu")
    shard_embedder_mesh(emb, make_mesh(dp=dp, tp=1, sp=sp,
                                       devices=[CPU] * (dp * sp)))
    assert emb.ring_available() and emb.ring_max_tokens == 256
    texts = ["word " * 150, "another long text " * 30, "short"]
    ids, mask = emb.tokenize_ring(texts)
    assert ids.shape[1] > emb.max_tokens and ids.shape[1] % sp == 0
    got = emb.embed_tokens_ring(ids, mask)
    want = one.embed_tokens(ids, mask)
    np.testing.assert_allclose(got, want, atol=DENSE_TOL)
    conf = emb.consensus_confidence_tokens_ring(ids, mask, 0.05)
    np.testing.assert_allclose(
        conf, one.consensus_confidence_tokens(ids, mask, 0.05),
        atol=DENSE_TOL)
    assert any(k.startswith(f"mesh({dp},1,{sp},ring")
               for k in emb.graph_stats()["keys"]) is False  # not warmed
    emb.warmup([], ring_buckets=[(3, 200)])
    keys = emb.graph_stats()["keys"]
    assert f"mesh({dp},1,{sp},ring_vote,3,256)" in keys
    assert emb.label_suffix == f"@dp{dp}xtp1xsp{sp}"
