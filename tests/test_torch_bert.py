"""The PyTorch port's BERT encoder against the JAX package's.

Same weights in both: test-tiny params made by the reference's
``init_params`` and carried over by ``convert.from_jax_params``, and the
committed ``tests/fixtures/bge_micro`` HF snapshot loaded by each
package's own loader.  The reference runs with
``attention_impl="fused"`` (its Pallas attention in interpret mode), the
kernel the port's attention replaces.

Tolerances: f32 |diff| <= 1e-5 on embeddings; bf16 |diff| <= 2e-2 and
per-row cosine >= 0.999.
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
from llm_weighted_consensus_tpu.models import loading as jax_loading
from llm_weighted_consensus_tpu_torch.models import bert, configs, convert
from llm_weighted_consensus_tpu_torch.models import loading

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "bge_micro")
F32_TOL = 1e-5


def _tokens(b, s, vocab, seed, n_pad=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab, size=(b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    lengths = rng.integers(max(1, s - n_pad), s + 1, size=b)
    lengths[0] = s
    for i, n in enumerate(lengths):
        mask[i, n:] = 0
        ids[i, n:] = 0
    return ids, mask


@pytest.fixture(scope="module")
def tiny():
    cfg = dataclasses.replace(jax_configs.TEST_TINY, attention_impl="fused")
    params = jax_bert.init_params(jax.random.PRNGKey(0), cfg)
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = bert.from_hf_state_dict(
        convert.from_jax_params(tree, configs.TEST_TINY), configs.TEST_TINY,
        device="cpu",
    )
    return cfg, params, model


def _jax_embed(params, ids, mask, cfg, pooling):
    return np.asarray(
        jax_bert.embed(
            params, jnp.asarray(ids), jnp.asarray(mask), cfg, pooling=pooling
        )
    )


def _port_embed(model, ids, mask, pooling):
    with torch.inference_mode():
        return bert.embed(
            model, torch.from_numpy(ids), torch.from_numpy(mask), pooling
        ).numpy()


@pytest.mark.parametrize("pooling", ["cls", "mean"])
@pytest.mark.parametrize("b,s,n_pad", [(4, 24, 7), (3, 64, 40), (2, 5, 0)])
def test_embed_matches_jax_on_test_tiny(tiny, pooling, b, s, n_pad):
    cfg, params, model = tiny
    ids, mask = _tokens(b, s, cfg.vocab_size, seed=b * s, n_pad=n_pad)
    ref = _jax_embed(params, ids, mask, cfg, pooling)
    port = _port_embed(model, ids, mask, pooling)
    assert port.shape == ref.shape and port.dtype == np.float32
    np.testing.assert_allclose(port, ref, atol=F32_TOL)


def test_hidden_states_match_jax(tiny):
    cfg, params, model = tiny
    ids, mask = _tokens(3, 16, cfg.vocab_size, seed=1, n_pad=6)
    ref = np.asarray(
        jax_bert.encode(params, jnp.asarray(ids), jnp.asarray(mask), cfg)
    )
    with torch.inference_mode():
        port = bert.encode(
            model, torch.from_numpy(ids), torch.from_numpy(mask)
        ).numpy()
    np.testing.assert_allclose(port, ref, atol=F32_TOL)


def test_embed_bf16_matches_jax(tiny):
    cfg, params, _ = tiny
    bf16 = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), params)
    model = bert.from_hf_state_dict(
        convert.from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                                configs.TEST_TINY),
        configs.TEST_TINY,
        dtype=torch.bfloat16,
        device="cpu",
    )
    ids, mask = _tokens(4, 32, cfg.vocab_size, seed=9, n_pad=10)
    ref = _jax_embed(bf16, ids, mask, cfg, "cls")
    port = _port_embed(model, ids, mask, "cls")
    assert np.abs(port - ref).max() <= 2e-2
    cos = (port * ref).sum(-1) / (
        np.linalg.norm(port, axis=-1) * np.linalg.norm(ref, axis=-1)
    )
    assert cos.min() >= 0.999, cos


def _micro_config():
    path = os.path.join(FIXTURE, "config.json")
    port_cfg = loading.load_hf_config(path)
    jax_cfg = jax_configs.BertConfig(
        **{f.name: getattr(port_cfg, f.name)
           for f in dataclasses.fields(port_cfg)},
        attention_impl="fused",
    )
    return port_cfg, jax_cfg


@pytest.mark.parametrize("pooling", ["cls", "mean"])
def test_embed_matches_jax_on_bge_micro(pooling):
    port_cfg, jax_cfg = _micro_config()
    params = jax_loading.load_params(FIXTURE, jax_cfg)
    model = loading.load_params(FIXTURE, port_cfg, device="cpu")
    ids, mask = _tokens(5, 48, port_cfg.vocab_size, seed=4, n_pad=30)
    ref = _jax_embed(params, ids, mask, jax_cfg, pooling)
    port = _port_embed(model, ids, mask, pooling)
    np.testing.assert_allclose(port, ref, atol=F32_TOL)


def test_safetensors_reader_matches_the_safetensors_package():
    from safetensors.numpy import load_file

    ref = load_file(os.path.join(FIXTURE, "model.safetensors"))
    port = loading.read_safetensors(os.path.join(FIXTURE, "model.safetensors"))
    assert set(port) == set(ref)
    for name, arr in ref.items():
        np.testing.assert_array_equal(port[name], arr)


def test_bin_checkpoint_with_bert_prefix_loads(tmp_path):
    state = loading.load_state_dict(os.path.join(FIXTURE, "model.safetensors"))
    torch.save(
        {f"bert.{k}": torch.from_numpy(v) for k, v in state.items()},
        tmp_path / "pytorch_model.bin",
    )
    port_cfg, _ = _micro_config()
    a = loading.load_params(FIXTURE, port_cfg, device="cpu")
    b = loading.load_params(str(tmp_path), port_cfg, device="cpu")
    for (name, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), name


def test_find_vocab_and_missing_weights(tmp_path):
    assert loading.find_vocab(FIXTURE) == os.path.join(FIXTURE, "vocab.txt")
    assert loading.find_vocab(str(tmp_path)) is None
    with pytest.raises(FileNotFoundError):
        loading.load_params(str(tmp_path), configs.TEST_TINY, device="cpu")


def test_init_params_is_seeded():
    a = bert.init_params(configs.TEST_TINY, seed=3, device="cpu")
    b = bert.init_params(configs.TEST_TINY, seed=3, device="cpu")
    c = bert.init_params(configs.TEST_TINY, seed=4, device="cpu")
    pa, pb, pc = (dict(m.named_parameters()) for m in (a, b, c))
    name = "encoder.layer.0.attention.self.query.weight"
    assert torch.equal(pa[name], pb[name])
    assert not torch.equal(pa[name], pc[name])
    assert not any(p.requires_grad for p in a.parameters())


@pytest.mark.parametrize("builder", ["init_params", "from_hf_state_dict",
                                     "load_params"])
def test_param_builders_default_to_the_card(monkeypatch, builder):
    port_cfg, _ = _micro_config()
    build = {
        "init_params": lambda **kw: bert.init_params(port_cfg, **kw),
        "from_hf_state_dict": lambda **kw: bert.from_hf_state_dict(
            loading.load_state_dict(
                os.path.join(FIXTURE, "model.safetensors")
            ),
            port_cfg, **kw,
        ),
        "load_params": lambda **kw: loading.load_params(
            FIXTURE, port_cfg, **kw
        ),
    }[builder]
    # on the CPU only when asked, and then in f32
    model = build(device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    # the default is CUDA: with no card that raises, never a CPU fallback
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        build()


def test_position_table_overflow_raises():
    model = bert.init_params(configs.TEST_TINY, device="cpu")
    s = configs.TEST_TINY.max_position_embeddings + 1
    ids = torch.zeros((1, s), dtype=torch.int32)
    with pytest.raises(ValueError, match="max_position_embeddings"):
        bert.encode(model, ids, torch.ones_like(ids))


def test_roberta_positions_start_past_the_pad_id():
    cfg = dataclasses.replace(
        configs.TEST_TINY, position_style="roberta", pad_token_id=1
    )
    jcfg = dataclasses.replace(
        jax_configs.TEST_TINY, position_style="roberta", pad_token_id=1,
        attention_impl="fused",
    )
    params = jax_bert.init_params(jax.random.PRNGKey(1), jcfg)
    model = bert.from_hf_state_dict(
        convert.from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg),
        cfg,
        device="cpu",
    )
    s = configs.usable_positions(cfg)
    ids, mask = _tokens(2, s, cfg.vocab_size, seed=2)
    np.testing.assert_allclose(
        _port_embed(model, ids, mask, "cls"),
        _jax_embed(params, ids, mask, jcfg, "cls"),
        atol=F32_TOL,
    )
    with pytest.raises(ValueError):
        bert.encode(
            model,
            torch.zeros((1, s + 1), dtype=torch.int32),
            torch.ones((1, s + 1), dtype=torch.int32),
        )


# -- transformers.BertModel ---------------------------------------------------------

HF_TINY = dict(vocab_size=512, hidden_size=64, num_layers=3, num_heads=4,
               intermediate_size=128, max_position_embeddings=64)
HF_TOL = 1e-5


@pytest.fixture(scope="module")
def hf_pair():
    """A random-init ``transformers.BertModel`` (f32, erf GELU, no pooler)
    and the port's encoder on its state dict."""
    transformers = pytest.importorskip("transformers")
    cfg = configs.BertConfig(**HF_TINY)
    hf_config = transformers.BertConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        num_hidden_layers=cfg.num_layers,
        num_attention_heads=cfg.num_heads,
        intermediate_size=cfg.intermediate_size,
        max_position_embeddings=cfg.max_position_embeddings,
        type_vocab_size=cfg.type_vocab_size,
        layer_norm_eps=cfg.layer_norm_eps, hidden_act="gelu",
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
    )
    torch.manual_seed(0)
    hf = transformers.BertModel(hf_config, add_pooling_layer=False).eval()
    state = {k: v.detach().clone() for k, v in hf.state_dict().items()}
    model = bert.from_hf_state_dict(state, cfg, dtype=torch.float32,
                                    device="cpu")
    return cfg, hf, model


@pytest.mark.parametrize("what", ["hidden", "cls", "mean"])
def test_encode_matches_transformers_bert_model(hf_pair, what):
    cfg, hf, model = hf_pair
    ids, mask = _tokens(4, 24, cfg.vocab_size, seed=1, n_pad=15)
    tids = torch.from_numpy(ids).long()
    tmask = torch.from_numpy(mask).long()
    with torch.no_grad():
        ref = hf(input_ids=tids, attention_mask=tmask).last_hidden_state
        if what == "hidden":
            got = bert.encode(model, torch.from_numpy(ids),
                              torch.from_numpy(mask))
            # HF computes values at pad positions too; nothing reads them
            real = torch.from_numpy(mask).bool()
            got, ref = got[real], ref[real]
        else:
            got = bert.embed(model, torch.from_numpy(ids),
                             torch.from_numpy(mask), pooling=what,
                             normalize=True)
            if what == "cls":
                pooled = ref[:, 0]
            else:
                m = tmask.float()[:, :, None]
                pooled = (ref * m).sum(1) / m.sum(1)
            ref = torch.nn.functional.normalize(pooled, p=2, dim=-1)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=HF_TOL,
                               rtol=0)
