"""Quantized serving through the port against the JAX package, on the CPU.

The same quantized weights in both packages: the reference's
``quantize_bert_params`` / ``_int4`` trees, carried over byte for byte by
``convert.from_jax_params``, or full-precision weights quantized by each
package's embedder.  The reference runs its Pallas kernels in interpret
mode (``int8-pallas`` / ``int4-pallas``, with ``attention_impl="fused"``
for ``bert.embed``), the kernels the port's CUDA kernels replace; the
port runs their plain versions.

Tolerances: embeddings 1e-5 absolute (f32 summation order), except
bge_micro under int4, 2e-4: an f32 ulp of difference upstream can flip
one int8 activation rounding, which moves an output by about sx * sw
(observed 5.2e-5).  Confidences 1e-5 absolute.
"""

import dataclasses
import json
import os
import urllib.request

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
from llm_weighted_consensus_tpu_torch.models import bert, configs, convert
from llm_weighted_consensus_tpu_torch.models import loading, quant
from llm_weighted_consensus_tpu_torch.models.embedder import TorchEmbedder
from llm_weighted_consensus_tpu_torch.ops import kernels
from llm_weighted_consensus_tpu_torch.serve import __main__ as serve_main
from llm_weighted_consensus_tpu_torch.serve.gateway import Server

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "bge_micro")
EMB_TOL = 1e-5
CONF_TOL = 1e-5
MODES = {"int8-pallas": "int8", "int4-pallas": "int4-pallas"}
TEXTS = [
    "the answer is 42",
    "the answer is 42!",
    "I believe the answer is forty-two",
    "cabbage soup with 99 onions",
    "42",
]


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


def _quantized(params, mode):
    if mode.startswith("int4"):
        return jax_quant.quantize_bert_params_int4(params)
    return jax_quant.quantize_bert_params(params)


def _pair(params, jax_cfg, port_cfg, mode):
    qparams = _quantized(params, mode)
    state = convert.from_jax_params(
        jax.tree_util.tree_map(np.asarray, qparams), port_cfg
    )
    model = bert.from_hf_state_dict(state, port_cfg, device="cpu")
    return qparams, dataclasses.replace(jax_cfg, quantize=mode), model


def _compare(qparams, jcfg, model, ids, mask, tol):
    want = np.asarray(
        jax_bert.embed(qparams, jnp.asarray(ids), jnp.asarray(mask), jcfg)
    )
    with torch.inference_mode():
        got = bert.embed(
            model, torch.from_numpy(ids), torch.from_numpy(mask)
        ).numpy()
    np.testing.assert_allclose(got, want, atol=tol)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("b,s,n_pad", [(4, 24, 7), (3, 64, 40)])
def test_quantized_embed_matches_jax_on_test_tiny(mode, b, s, n_pad):
    jcfg = dataclasses.replace(jax_configs.TEST_TINY, attention_impl="fused")
    params = jax_bert.init_params(jax.random.PRNGKey(0), jcfg)
    qparams, jcfg, model = _pair(params, jcfg, configs.TEST_TINY, mode)
    # the layer stack holds the reference's bytes, not a re-quantization
    layer0 = model.encoder.layer[0].intermediate.dense
    assert isinstance(layer0, quant.QuantLinear)
    np.testing.assert_array_equal(
        layer0.weight_q.numpy(),
        np.asarray(qparams["layers"]["mlp_in"]["kernel_q"][0]).T,
    )
    assert layer0.scale.dtype == torch.float32
    assert model.config.quantize == ("int4-pallas" if "int4" in mode else "int8")
    ids, mask = _tokens(b, s, jcfg.vocab_size, seed=b * s, n_pad=n_pad)
    _compare(qparams, jcfg, model, ids, mask, EMB_TOL)


@pytest.mark.parametrize("mode,tol", [("int8-pallas", EMB_TOL),
                                      ("int4-pallas", 2e-4)])
def test_quantized_embed_matches_jax_on_bge_micro(mode, tol):
    port_cfg = loading.load_hf_config(os.path.join(FIXTURE, "config.json"))
    jcfg = jax_configs.BertConfig(
        **{f.name: getattr(port_cfg, f.name)
           for f in dataclasses.fields(port_cfg)},
        attention_impl="fused",
    )
    params = jax_loading.load_params(FIXTURE, jcfg)
    qparams, jcfg, model = _pair(params, jcfg, port_cfg, mode)
    ids, mask = _tokens(5, 48, port_cfg.vocab_size, seed=4, n_pad=30)
    _compare(qparams, jcfg, model, ids, mask, tol)


@pytest.fixture(scope="module", params=sorted(MODES))
def embedders(request):
    jax_mode = request.param
    params = jax_bert.init_params(
        jax.random.PRNGKey(0), jax_configs.TEST_TINY
    )
    state = convert.from_jax_params(
        jax.tree_util.tree_map(np.asarray, params), configs.TEST_TINY
    )
    ref = TpuEmbedder(
        "test-tiny", params=params, max_tokens=32, quantize=jax_mode
    )
    port = TorchEmbedder(
        "test-tiny",
        model=bert.from_hf_state_dict(state, configs.TEST_TINY, device="cpu"),
        max_tokens=32,
        device="cpu",
        quantize=MODES[jax_mode],
    )
    return ref, port


def test_embedder_quantizes_after_placing_and_keeps_f32_scales(embedders):
    _, port = embedders
    assert port.config.quantize in MODES.values()
    scales = [
        m.scale for m in port.model.modules()
        if isinstance(m, quant.QuantLinear)
    ]
    assert len(scales) == 6 * configs.TEST_TINY.num_layers
    assert {s.dtype for s in scales} == {torch.float32}


@pytest.mark.parametrize("temperature", [0.05, 0.7])
def test_quantized_consensus_matches_tpu_embedder(embedders, temperature):
    ref, port = embedders
    want = np.asarray(ref.consensus_confidence(TEXTS, temperature=temperature))
    got = port.consensus_confidence(TEXTS, temperature=temperature)
    np.testing.assert_allclose(got, want, atol=CONF_TOL)
    np.testing.assert_allclose(
        port.embed_texts(TEXTS), np.asarray(ref.embed_texts(TEXTS)),
        atol=EMB_TOL,
    )


def test_quantized_consensus_many_matches_tpu_embedder(embedders):
    ref, port = embedders
    rng = np.random.default_rng(5)
    words = "alpha beta gamma delta epsilon zeta eta theta".split()
    reqs = [
        [" ".join(rng.choice(words, size=rng.integers(1, 9))) for _ in range(4)]
        for _ in range(3)
    ]
    ids, mask = port.tokenize([t for r in reqs for t in r])
    ids, mask = ids.reshape(3, 4, -1), mask.reshape(3, 4, -1)
    want = np.asarray(ref.consensus_confidence_tokens_many(ids, mask, 0.05))
    got = port.consensus_confidence_tokens_many(ids, mask, 0.05)
    np.testing.assert_allclose(got, want, atol=CONF_TOL)


def test_quantized_vote_stays_near_full_precision():
    """The reference's own bars for the quantized path
    (``tests/test_quant.py``): top-1 agreement and |conf diff| < 0.1 for
    int8, < 0.15 for int4, against the full-precision embedder."""
    kwargs = dict(max_tokens=32, seed=3, device="cpu")
    texts = [
        "the answer is four",
        "the answer is four",
        "the answer is four!",
        "bananas and poetry 999",
    ]
    full = TorchEmbedder("test-tiny", **kwargs).consensus_confidence(texts)
    for mode, bar in (("int8", 0.1), ("int4-pallas", 0.15)):
        emb = TorchEmbedder("test-tiny", quantize=mode, **kwargs)
        conf = emb.consensus_confidence(texts)
        assert conf.argmax() == full.argmax()
        assert np.abs(conf - full).max() < bar


def test_build_embedder_reads_embedder_quantize():
    env = {"EMBEDDER_MODEL": "test-tiny", "LWC_ALLOW_RANDOM_PARAMS": "1",
           "EMBEDDER_MAX_TOKENS": "16"}
    plain = serve_main.build_embedder(env, device="cpu")
    assert plain.config.quantize == "none"
    assert not quant.is_quantized(plain.model)
    for mode in ("int8", "int8-pallas", "int4-pallas"):
        emb = serve_main.build_embedder(
            dict(env, EMBEDDER_QUANTIZE=mode), device="cpu"
        )
        assert emb.config.quantize == mode
        assert quant.is_int4(emb.model) == mode.startswith("int4")


def test_build_embedder_refuses_unknown_and_xla_modes():
    env = {"EMBEDDER_MODEL": "test-tiny", "LWC_ALLOW_RANDOM_PARAMS": "1"}
    with pytest.raises(ValueError) as err:
        serve_main.build_embedder(dict(env, EMBEDDER_QUANTIZE="int3"),
                                  device="cpu")
    for mode in configs.QUANT_MODES:
        assert mode in str(err.value)
    with pytest.raises(ValueError, match="int8-xla"):
        serve_main.build_embedder(dict(env, EMBEDDER_QUANTIZE="int8-xla"),
                                  device="cpu")


def test_int8_consensus_answers_over_the_port_server():
    params = jax_bert.init_params(jax.random.PRNGKey(0), jax_configs.TEST_TINY)
    state = convert.from_jax_params(
        jax.tree_util.tree_map(np.asarray, params), configs.TEST_TINY
    )
    ref = TpuEmbedder(
        "test-tiny", params=params, max_tokens=32, quantize="int8-pallas"
    )
    port = TorchEmbedder(
        "test-tiny",
        model=bert.from_hf_state_dict(state, configs.TEST_TINY, device="cpu"),
        max_tokens=32, device="cpu", quantize="int8",
    )
    with Server(port) as srv:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/consensus",
            data=json.dumps({"input": TEXTS}).encode(),
            headers={"content-type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert resp.status == 200
            got = json.loads(resp.read())
    np.testing.assert_allclose(
        got["confidence"], np.asarray(ref.consensus_confidence(TEXTS)),
        atol=CONF_TOL,
    )
    # the CPU served the plain versions: no kernel launch was counted
    assert kernels.w8a8_matmul.launches == 0
