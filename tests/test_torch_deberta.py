"""The port's DeBERTa reward model (``models/deberta.py``) against the JAX
package's and against ``transformers.DebertaV2*``, on the CPU.

Weights are random from a seed: the reference's ``init_params`` carried
over by ``convert.from_jax_deberta_params``, or a synthetic HF state dict
loaded by both packages' ``from_hf_weights``.

Tolerances: the relative-index tables are exact.  ``encode``,
``reward`` and ``reward_packed`` agree with the reference within 1e-5 in
f32 (summation order).  In bf16 the reference on the CPU lets XLA keep
f32 between element-wise ops; with that excess precision switched off
(``--xla_allow_excess_precision=false``, a subprocess) it rounds where
the TPU rounds, and the port's rewards agree within 1e-5 and its hidden
states within 2 bf16 ulps of |h| < 8 (0.0625), where summing the three
score tensors in f32 moves rewards by ~3e-2.  In-process (excess
precision on) the bf16 bar is 1e-3 on rewards.  Against transformers,
1e-4.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_weighted_consensus_tpu.models import configs as jax_configs
from llm_weighted_consensus_tpu.models import deberta as jax_deberta
from llm_weighted_consensus_tpu_torch.models import configs, convert, deberta
from llm_weighted_consensus_tpu_torch.models import quant
from llm_weighted_consensus_tpu_torch.serve import packing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_TOL = 1e-5
LOG_KW = dict(position_buckets=8, max_relative_positions=32)
CONFIGS = {
    "clamp": (configs.DEBERTA_TEST_TINY, jax_configs.DEBERTA_TEST_TINY),
    "log": (dataclasses.replace(configs.DEBERTA_TEST_TINY, **LOG_KW),
            dataclasses.replace(jax_configs.DEBERTA_TEST_TINY, **LOG_KW)),
}


def _pair(which, seed=0):
    """(port model, JAX params, port config, JAX config) on the same
    weights."""
    cfg, jcfg = CONFIGS[which]
    params = jax_deberta.init_params(jax.random.PRNGKey(seed), jcfg)
    state = convert.from_jax_deberta_params(
        jax.tree_util.tree_map(np.asarray, params), cfg)
    return deberta.from_state(state, cfg, device="cpu"), params, cfg, jcfg


def _tokens(b, s, vocab, seed, lengths=None):
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, vocab, size=(b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    if lengths is None:
        lengths = rng.integers(1, s + 1, size=b)
        lengths[0] = s
    for i, n in enumerate(lengths):
        mask[i, n:] = 0
        ids[i, n:] = 0
    return ids, mask


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- relative positions --------------------------------------------------------


def test_rel_index_is_the_reference_table_at_deberta_v3_base():
    """The whole [512, 512] log-bucket table of deberta-v3-base, exactly;
    every shorter table is its top-left corner (entry (i, j) depends on
    i - j only)."""
    want = np.asarray(jax_deberta._rel_index(512, jax_configs.DEBERTA_V3_BASE))
    got = deberta.rel_index(512, configs.DEBERTA_V3_BASE).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() < 2 * configs.DEBERTA_V3_BASE.att_span
    for s in (1, 7, 128, 300, 511):
        np.testing.assert_array_equal(
            deberta.rel_index(s, configs.DEBERTA_V3_BASE).numpy(),
            got[:s, :s])


@pytest.mark.parametrize("cfg_kw,seq", [
    ({}, 40),                                                # clamp, span 16
    (LOG_KW, 64),                                            # log buckets
    (dict(position_buckets=0, max_relative_positions=512), 600),
    (dict(position_buckets=4, max_relative_positions=16), 14),
])
def test_rel_index_matches_jax(cfg_kw, seq):
    cfg = dataclasses.replace(configs.DEBERTA_TEST_TINY, **cfg_kw)
    jcfg = dataclasses.replace(jax_configs.DEBERTA_TEST_TINY, **cfg_kw)
    np.testing.assert_array_equal(
        deberta.rel_index(seq, cfg).numpy(),
        np.asarray(jax_deberta._rel_index(seq, jcfg)))


# -- the forward against the reference ----------------------------------------


@pytest.mark.parametrize("which", sorted(CONFIGS))
@pytest.mark.parametrize("b,s", [(3, 24), (2, 64)])
def test_encode_and_reward_match_jax(which, b, s):
    model, params, cfg, jcfg = _pair(which, seed=b * s)
    ids, mask = _tokens(b, s, cfg.vocab_size, seed=s)
    want_h = np.asarray(
        jax_deberta.encode(params, jnp.asarray(ids), jnp.asarray(mask), jcfg))
    want_r = np.asarray(
        jax_deberta.reward(params, jnp.asarray(ids), jnp.asarray(mask), jcfg))
    with torch.inference_mode():
        got_h = deberta.encode(model, _t(ids), _t(mask)).numpy()
        got_r = deberta.reward(model, _t(ids), _t(mask)).numpy()
    valid = mask.astype(bool)
    np.testing.assert_allclose(got_h[valid], want_h[valid], atol=F32_TOL)
    np.testing.assert_allclose(got_r, want_r, atol=F32_TOL)
    conf = deberta.reward_consensus_vote(_t(got_r), 0.7).numpy()
    want_c = np.asarray(jax_deberta.reward_consensus_vote(want_r, 0.7))
    np.testing.assert_allclose(conf, want_c, atol=F32_TOL)


@pytest.mark.parametrize("which", sorted(CONFIGS))
def test_reward_packed_matches_jax_and_per_row_reward(which):
    """The packed layout of ``serve/packing.py``: each segment's reward
    equals its padded row's, and the reference's packed reward."""
    model, params, cfg, jcfg = _pair(which, seed=2)
    rng = np.random.default_rng(2)
    lens = [12, 7, 30, 5, 17, 1]
    rows = [rng.integers(4, cfg.vocab_size, size=n).astype(np.int32)
            for n in lens]
    ids = np.zeros((len(rows), max(lens)), np.int32)
    mask = np.zeros_like(ids)
    for i, r in enumerate(rows):
        ids[i, : len(r)] = r
        mask[i, : len(r)] = 1
    with torch.inference_mode():
        per_row = deberta.reward(model, _t(ids), _t(mask)).numpy()
    got = [None] * len(rows)
    calls = packing.build_calls(rows, 64, 4, 8)
    assert any(c.ids.shape[0] > 1 or len(c.slots) > 1 for c in calls)
    for c in calls:
        with torch.inference_mode():
            out = deberta.reward_packed(
                model, _t(c.ids), _t(c.segment_ids), _t(c.seg_starts)
            ).numpy()
        want = np.asarray(jax_deberta.reward_packed(
            params, jnp.asarray(c.ids), jnp.asarray(c.segment_ids),
            jnp.asarray(c.seg_starts), jcfg))
        assert np.isfinite(out).all()
        for si, (r, slot) in c.slots.items():
            got[si] = out[r, slot]
            np.testing.assert_allclose(out[r, slot], want[r, slot],
                                       atol=F32_TOL)
    np.testing.assert_allclose(np.asarray(got), per_row, atol=F32_TOL)


def test_masked_rows_stay_finite():
    """The mask fill is -1e9, never -inf: a row whose keys are all masked
    (padded: an empty mask; packed: a row past its segments) gives
    finite numbers, where -inf would give NaN."""
    model, _, cfg, _ = _pair("log")
    ids, mask = _tokens(3, 16, cfg.vocab_size, seed=1)
    mask[2] = 0
    seg = np.zeros((2, 16), np.int32)
    seg[0, :9] = 1
    seg[0, 9:13] = 2
    starts = np.array([[0, 9], [0, 0]], np.int32)
    with torch.inference_mode():
        padded = deberta.reward(model, _t(ids), _t(mask))
        packed = deberta.reward_packed(model, _t(ids[:2]), _t(seg), _t(starts))
        hidden = deberta.encode(model, _t(ids[:2]), None, segment_ids=_t(seg))
    assert torch.isfinite(padded).all() and torch.isfinite(packed).all()
    assert torch.isfinite(hidden).all()


def test_padding_does_not_change_a_reward():
    """A row alone and the same row padded inside a longer batch give the
    same reward: padded keys weigh exp(-1e9) = 0."""
    model, _, cfg, _ = _pair("log", seed=5)
    ids, mask = _tokens(4, 48, cfg.vocab_size, seed=6, lengths=[48, 20, 9, 33])
    with torch.inference_mode():
        batch = deberta.reward(model, _t(ids), _t(mask)).numpy()
        alone = [
            deberta.reward(model, _t(ids[i:i + 1, :n]), _t(mask[i:i + 1, :n]))
            .item() for i, n in enumerate([48, 20, 9, 33])
        ]
    np.testing.assert_allclose(batch, alone, atol=1e-6)


def test_bf16_rewards_are_close_to_jax_in_process():
    model, params, cfg, jcfg = _pair("log", seed=3)
    params = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), params)
    model = model.to(torch.bfloat16)
    ids, mask = _tokens(4, 64, cfg.vocab_size, seed=3)
    want = np.asarray(
        jax_deberta.reward(params, jnp.asarray(ids), jnp.asarray(mask), jcfg))
    with torch.inference_mode():
        got = deberta.reward(model, _t(ids), _t(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3)


_JAX_BF16 = r"""
import dataclasses, json, sys
import numpy as np, jax, jax.numpy as jnp
from llm_weighted_consensus_tpu.models import configs, deberta
from llm_weighted_consensus_tpu_torch.models import configs as port_configs
from llm_weighted_consensus_tpu_torch.models import convert
kw = json.loads(sys.argv[2])
cfg = dataclasses.replace(configs.DEBERTA_TEST_TINY, **kw)
d = np.load(sys.argv[1])
params = deberta.init_params(jax.random.PRNGKey(4), cfg)
params = jax.tree_util.tree_map(
    lambda a: (a * 5 if a.ndim >= 2 else a).astype(jnp.bfloat16), params)
ids, mask = jnp.asarray(d["ids"]), jnp.asarray(d["mask"])
state = convert.from_jax_deberta_params(
    jax.tree_util.tree_map(lambda a: np.asarray(a.astype(jnp.float32)), params),
    dataclasses.replace(port_configs.DEBERTA_TEST_TINY, **kw))
np.savez(sys.argv[3], **{"state/" + k: v for k, v in state.items()},
         hidden=np.asarray(deberta.encode(params, ids, mask, cfg)
                           .astype(jnp.float32)),
         reward=np.asarray(deberta.reward(params, ids, mask, cfg)))
"""


def test_bf16_score_storage_matches_jax_rounding_where_the_tpu_rounds(
        tmp_path):
    """The reference in bf16 with XLA's excess precision off rounds each
    score tensor, their sum, the scale and the bias to bf16, as on the
    TPU.  The port rounds in the same places; summing the scores in f32
    would move these rewards by ~3e-2 (weights x5, so the scores are
    large enough for their storage to matter)."""
    cfg, _ = CONFIGS["log"]
    ids, mask = _tokens(4, 64, cfg.vocab_size, seed=9)
    np.savez(tmp_path / "in.npz", ids=ids, mask=mask)
    out = str(tmp_path / "out.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               XLA_FLAGS="--xla_allow_excess_precision=false")
    subprocess.run(
        [sys.executable, "-c", _JAX_BF16, str(tmp_path / "in.npz"),
         json.dumps(LOG_KW), out],
        check=True, env=env, timeout=300, capture_output=True,
    )
    ref = np.load(out)
    state = {k[len("state/"):]: ref[k] for k in ref.files
             if k.startswith("state/")}
    model = deberta.from_state(state, cfg, dtype=torch.bfloat16, device="cpu")
    with torch.inference_mode():
        hidden = deberta.encode(model, _t(ids), _t(mask)).float().numpy()
        rewards = deberta.reward(model, _t(ids), _t(mask)).numpy()
    valid = mask.astype(bool)
    np.testing.assert_allclose(rewards, ref["reward"], atol=1e-5)
    np.testing.assert_allclose(hidden[valid], ref["hidden"][valid],
                               atol=0.0625)


# -- loading -----------------------------------------------------------------


def _hf_state(cfg, seed, head=True, rel_rows=None):
    """A synthetic HF DeBERTa-v2 state dict (torch [out, in] layout)."""
    rng = np.random.default_rng(seed)
    h, i = cfg.hidden_size, cfg.intermediate_size

    def w(*shape):
        return (rng.standard_normal(shape) * 0.05).astype(np.float32)

    state = {
        "embeddings.word_embeddings.weight": w(cfg.vocab_size, h),
        "embeddings.LayerNorm.weight": 1 + w(h),
        "embeddings.LayerNorm.bias": w(h),
        "encoder.rel_embeddings.weight": w(rel_rows or 2 * cfg.att_span, h),
        "encoder.LayerNorm.weight": 1 + w(h),
        "encoder.LayerNorm.bias": w(h),
    }
    for n in range(cfg.num_layers):
        base = f"encoder.layer.{n}"
        for name, (o, k) in {
            "attention.self.query_proj": (h, h),
            "attention.self.key_proj": (h, h),
            "attention.self.value_proj": (h, h),
            "attention.output.dense": (h, h),
            "intermediate.dense": (i, h),
            "output.dense": (h, i),
        }.items():
            state[f"{base}.{name}.weight"] = w(o, k)
            state[f"{base}.{name}.bias"] = w(o)
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            state[f"{base}.{name}.weight"] = 1 + w(h)
            state[f"{base}.{name}.bias"] = w(h)
    if head:
        state["pooler.dense.weight"] = w(h, h)
        state["pooler.dense.bias"] = w(h)
        state["classifier.weight"] = w(1, h)
        state["classifier.bias"] = w(1)
    return state


@pytest.mark.parametrize("which", sorted(CONFIGS))
def test_from_hf_weights_matches_jax(which):
    cfg, jcfg = CONFIGS[which]
    hf = _hf_state(cfg, seed=11)
    tree = jax.tree_util.tree_map(
        np.asarray, jax_deberta.from_hf_weights(hf, jcfg))
    want = convert.from_jax_deberta_params(tree, cfg)
    got = deberta.hf_to_state(hf, cfg)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    model = deberta.from_hf_weights(hf, cfg, device="cpu")
    # share_att_key: the position projections hold the content q/k
    # weights as tensors of their own
    layer = model.layers[0]
    assert torch.equal(layer.pos_q.weight, layer.attn_q.weight)
    assert layer.pos_q.weight.data_ptr() != layer.attn_q.weight.data_ptr()
    ids, mask = _tokens(2, 20, cfg.vocab_size, seed=12)
    with torch.inference_mode():
        got_r = deberta.reward(model, _t(ids), _t(mask)).numpy()
    want_r = np.asarray(jax_deberta.reward(
        jax_deberta.from_hf_weights(hf, jcfg), jnp.asarray(ids),
        jnp.asarray(mask), jcfg))
    np.testing.assert_allclose(got_r, want_r, atol=F32_TOL)


def test_from_hf_weights_encoder_only_and_bad_table():
    cfg, jcfg = CONFIGS["log"]
    hf = _hf_state(cfg, seed=13, head=False)
    model = deberta.from_hf_weights(hf, cfg, device="cpu")
    assert tuple(model.head_dense.weight.shape) == (64, 64)
    assert tuple(model.head_out.weight.shape) == (1, 64)
    assert model.head_dense.weight.abs().sum() > 0
    bad = _hf_state(cfg, seed=13, rel_rows=2 * cfg.att_span + 2)
    with pytest.raises(ValueError, match="position_buckets"):
        deberta.from_hf_weights(bad, cfg, device="cpu")
    with pytest.raises(ValueError, match="position_buckets"):
        jax_deberta.from_hf_weights(bad, jcfg)


def test_quantizing_leaves_the_position_path_and_head_full_precision():
    model, _, _, _ = _pair("log")
    quant.resolve_quantize(model, None, "int8")
    for layer in model.layers:
        for name in quant.DEBERTA_QUANT_DENSE:
            assert isinstance(getattr(layer, name), quant.QuantLinear), name
        assert type(layer.pos_q) is torch.nn.Linear
        assert type(layer.pos_k) is torch.nn.Linear
    assert type(model.head_dense) is torch.nn.Linear
    assert type(model.head_out) is torch.nn.Linear
    assert model.config.quantize == "int8"


# -- transformers ------------------------------------------------------------


def _hf_config(**overrides):
    transformers = pytest.importorskip("transformers")
    base = dict(
        vocab_size=128, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=64, relative_attention=True,
        max_relative_positions=8, position_buckets=-1,
        pos_att_type=["p2c", "c2p"], share_att_key=True,
        norm_rel_ebd="layer_norm", position_biased_input=False,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        layer_norm_eps=1e-7,
    )
    base.update(overrides)
    return transformers, transformers.DebertaV2Config(**base)


def _tiny_port_config(buckets, max_rel):
    return configs.DebertaConfig(
        vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
        intermediate_size=64, max_relative_positions=max_rel,
        position_buckets=buckets, layer_norm_eps=1e-7,
    )


@pytest.mark.parametrize("buckets,max_rel,seq", [(0, 8, 12), (4, 16, 14)])
def test_encode_matches_transformers(buckets, max_rel, seq):
    transformers, hf_cfg = _hf_config(
        position_buckets=buckets or -1, max_relative_positions=max_rel)
    torch.manual_seed(buckets)
    hf = transformers.DebertaV2Model(hf_cfg).eval()
    cfg = _tiny_port_config(buckets, max_rel)
    state = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    model = deberta.from_hf_weights(state, cfg, device="cpu")
    rng = np.random.default_rng(2)
    ids = rng.integers(3, 128, size=(2, seq)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, seq - 4:] = 0
    with torch.no_grad():
        want = hf(input_ids=_t(ids).long(),
                  attention_mask=_t(mask).long()).last_hidden_state.numpy()
        got = deberta.encode(model, _t(ids), _t(mask)).numpy()
    valid = mask.astype(bool)
    np.testing.assert_allclose(got[valid], want[valid], atol=1e-4)


def test_reward_matches_transformers_sequence_classification():
    transformers, hf_cfg = _hf_config(
        num_labels=1, position_buckets=4, max_relative_positions=16)
    torch.manual_seed(1)
    hf = transformers.DebertaV2ForSequenceClassification(hf_cfg).eval()
    from llm_weighted_consensus_tpu_torch.models.loading import (
        _strip_deberta_prefix,
    )

    state = _strip_deberta_prefix(
        {k: v.detach().numpy() for k, v in hf.state_dict().items()})
    model = deberta.from_hf_weights(state, _tiny_port_config(4, 16),
                                    device="cpu")
    torch.testing.assert_close(model.head_dense.weight,
                               hf.pooler.dense.weight, rtol=0, atol=0)
    ids = np.array([[3, 17, 42, 99, 5, 7, 11, 13, 90, 2, 64, 31]], np.int32)
    mask = np.ones_like(ids)
    with torch.no_grad():
        want = hf(input_ids=_t(ids).long(),
                  attention_mask=_t(mask).long()).logits[:, 0].numpy()
        got = deberta.reward(model, _t(ids), _t(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
