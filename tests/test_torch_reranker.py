"""The port's reward-model scorer against the JAX package's, on the CPU.

``TorchReranker`` and the reference's ``TpuReranker`` run on the same
weights (the reference's ``init_params``, carried over by
``convert.from_jax_deberta_params``, or one HF snapshot written here and
read by both packages' ``load_rm_params``) and the same tokenization.
Unquantized, and under ``int8`` / ``int4-pallas`` against the reference's
``int8-pallas`` / ``int4-pallas`` (its Pallas kernels in interpret mode;
the port runs the W8A8 / W4A8 kernels' plain versions).  The port's HTTP
server answers ``/consensus {"scorer": "rm"}`` with the reference
gateway's body.

Tolerances: confidences 1e-5 absolute (f32 summation order), as in
``tests/test_torch_quant_model.py``.
"""

import asyncio
import dataclasses
import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from llm_weighted_consensus_tpu.models import configs as jax_configs
from llm_weighted_consensus_tpu.models import deberta as jax_deberta
from llm_weighted_consensus_tpu.models import reranker as jax_reranker
from llm_weighted_consensus_tpu.models import spm as jax_spm
from llm_weighted_consensus_tpu_torch.models import configs, convert, deberta
from llm_weighted_consensus_tpu_torch.models import loading, quant, spm
from llm_weighted_consensus_tpu_torch.models.reranker import (
    RM_PRESETS,
    TorchReranker,
)
from llm_weighted_consensus_tpu_torch.models.tokenizer import HashTokenizer
from llm_weighted_consensus_tpu_torch.serve import __main__ as serve_main
from llm_weighted_consensus_tpu_torch.serve.gateway import Server
from test_spm import serialize_proto

CONF_TOL = 1e-5
LOG_KW = dict(position_buckets=8, max_relative_positions=32)
TEXTS = [
    "the answer is four because two plus two",
    "the answer is five because arithmetic",
    "completely unrelated text about weather",
    "four",
]
PROMPT = "what is 2+2?"
WORDS = ["the", "answer", "is", "42", "41", "value", "because", "so"]
PIECES = [
    ("[PAD]", 0.0, spm.CONTROL),
    ("[CLS]", 0.0, spm.CONTROL),
    ("[SEP]", 0.0, spm.CONTROL),
    ("[UNK]", 0.0, spm.UNKNOWN),
] + [(spm.SPACE + w, -float(len(w)), spm.NORMAL) for w in WORDS] + [
    (ch, -10.0, spm.NORMAL) for ch in "abcdefghijklmnopqrstuvwxyz0123456789?+"
    + spm.SPACE
]


def _configs(log: bool):
    if log:
        return (dataclasses.replace(configs.DEBERTA_TEST_TINY, **LOG_KW),
                dataclasses.replace(jax_configs.DEBERTA_TEST_TINY, **LOG_KW))
    return configs.DEBERTA_TEST_TINY, jax_configs.DEBERTA_TEST_TINY


def _rerankers(log=False, port_mode="none", jax_mode="none", tokenizers=None,
               seed=5, max_tokens=48):
    cfg, jcfg = _configs(log)
    params = jax_deberta.init_params(jax.random.PRNGKey(seed), jcfg)
    state = convert.from_jax_deberta_params(
        jax.tree_util.tree_map(np.asarray, params), cfg)
    port_tok, jax_tok = tokenizers or (None, None)
    ref = jax_reranker.TpuReranker(
        "deberta-test-tiny", params=params, config=jcfg, tokenizer=jax_tok,
        max_tokens=max_tokens, quantize=jax_mode,
    )
    port = TorchReranker(
        "deberta-test-tiny",
        model=deberta.from_state(state, cfg, device="cpu"),
        tokenizer=port_tok, max_tokens=max_tokens, device="cpu",
        quantize=port_mode,
    )
    return port, ref


def _spm_tokenizers():
    return (spm.UnigramTokenizer(PIECES, scheme="deberta"),
            jax_spm.UnigramTokenizer(PIECES, scheme="deberta"))


def _same_confidence(port, ref, texts, **kwargs):
    got, got_tokens = port.rerank_confidence(texts, **kwargs)
    want, want_tokens = ref.rerank_confidence(texts, **kwargs)
    assert got_tokens == want_tokens
    assert got.shape == (len(texts),) and abs(got.sum() - 1) < 1e-5
    np.testing.assert_allclose(got, np.asarray(want), atol=CONF_TOL)
    return got


@pytest.mark.parametrize("log", [False, True])
@pytest.mark.parametrize("tokenizer", ["hash", "spm"])
def test_rerank_confidence_matches_jax(log, tokenizer):
    tokenizers = _spm_tokenizers() if tokenizer == "spm" else None
    port, ref = _rerankers(log=log, tokenizers=tokenizers)
    if tokenizer == "hash":
        assert isinstance(port.tokenizer, HashTokenizer)
        assert port.tokenizer.vocab_size == port.config.vocab_size
    for kwargs in ({}, {"prompt": PROMPT}, {"prompt": PROMPT,
                                             "temperature": 0.05},
                   {"temperature": 3.0}, {"prompt": ""}):
        _same_confidence(port, ref, TEXTS, **kwargs)
    # long candidates truncate at max_tokens and land in its bucket
    long = [" ".join(["the answer is 42"] * 40)] * 2 + TEXTS[:1]
    _same_confidence(port, ref, long, prompt=PROMPT)
    ids, _ = port.tokenize(long)
    assert ids.shape[1] == 48


@pytest.mark.parametrize("port_mode,jax_mode", [("int8", "int8-pallas"),
                                                ("int4-pallas", "int4-pallas")])
def test_quantized_rerank_matches_jax_pallas_modes(port_mode, jax_mode):
    port, ref = _rerankers(log=True, port_mode=port_mode, jax_mode=jax_mode)
    assert port.config.quantize == port_mode
    n_quant = 0
    for layer in port.model.layers:
        for name in quant.DEBERTA_QUANT_DENSE:
            q = getattr(layer, name)
            assert isinstance(q, quant.QuantLinear)
            assert q.int4 == port_mode.startswith("int4")
            n_quant += 1
        # the position path stays full precision, in the param dtype
        assert type(layer.pos_q) is torch.nn.Linear
        assert layer.pos_q.weight.dtype == torch.float32
    assert n_quant == 6 * port.config.num_layers
    assert type(port.model.head_dense) is torch.nn.Linear
    assert type(port.model.head_out) is torch.nn.Linear
    _same_confidence(port, ref, TEXTS, prompt=PROMPT)


def test_int8_xla_and_unknown_modes_are_refused():
    with pytest.raises(ValueError, match="int8-xla"):
        TorchReranker("deberta-test-tiny", device="cpu", quantize="int8-xla")
    with pytest.raises(ValueError, match="expected one of"):
        TorchReranker("deberta-test-tiny", device="cpu", quantize="int3")


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        TorchReranker("deberta-test-tiny")


# -- loading -----------------------------------------------------------------


def _snapshot(tmp_path, head=True, fmt="safetensors"):
    """An HF DeBERTa-v2 RM snapshot: backbone under ``deberta.``, the head
    unprefixed, and the ``spm.model`` beside it."""
    from safetensors.numpy import save_file
    import transformers

    hf_cfg = transformers.DebertaV2Config(
        vocab_size=512, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=128,
        max_position_embeddings=64, relative_attention=True,
        max_relative_positions=16, position_buckets=-1,
        pos_att_type=["p2c", "c2p"], share_att_key=True,
        norm_rel_ebd="layer_norm", position_biased_input=False,
        layer_norm_eps=1e-7, num_labels=1,
    )
    torch.manual_seed(3)
    model = (transformers.DebertaV2ForSequenceClassification(hf_cfg) if head
             else transformers.DebertaV2Model(hf_cfg))
    state = {k: v.detach().contiguous() for k, v in model.state_dict().items()}
    if not head:
        state = {f"deberta.{k}": v for k, v in state.items()}
    if fmt == "safetensors":
        save_file({k: v.numpy() for k, v in state.items()},
                  str(tmp_path / "model.safetensors"))
    else:
        torch.save(state, tmp_path / "pytorch_model.bin")
    (tmp_path / "spm.model").write_bytes(serialize_proto(PIECES))
    return tmp_path


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_load_rm_params_matches_jax(tmp_path, fmt):
    path = str(_snapshot(tmp_path, fmt=fmt))
    cfg = configs.DEBERTA_TEST_TINY
    model, head_loaded = loading.load_rm_params(path, cfg, device="cpu")
    params, jax_head = jax_reranker.load_rm_params(
        path, jax_configs.DEBERTA_TEST_TINY)
    assert head_loaded is True and jax_head is True
    vocab = loading.find_vocab(path)
    assert vocab.endswith("spm.model")
    port = TorchReranker(
        "deberta-test-tiny", model=model, device="cpu",
        tokenizer=spm.UnigramTokenizer.from_model_file(vocab, "deberta"))
    ref = jax_reranker.TpuReranker(
        "deberta-test-tiny", params=params,
        tokenizer=jax_spm.UnigramTokenizer.from_model_file(vocab, "deberta"))
    _same_confidence(port, ref, TEXTS, prompt=PROMPT)


def test_load_rm_params_encoder_only_and_orbax(tmp_path):
    path = str(_snapshot(tmp_path, head=False))
    model, head_loaded = loading.load_rm_params(
        path, configs.DEBERTA_TEST_TINY, device="cpu")
    assert head_loaded is False
    assert jax_reranker.load_rm_params(
        path, jax_configs.DEBERTA_TEST_TINY)[1] is False
    orbax = tmp_path / "ckpt"
    orbax.mkdir()
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(NotImplementedError, match="Orbax checkpoint"):
        loading.load_rm_params(str(orbax), configs.DEBERTA_TEST_TINY,
                               device="cpu")
    with pytest.raises(FileNotFoundError):
        loading.load_rm_params(str(tmp_path / "missing"),
                               configs.DEBERTA_TEST_TINY, device="cpu")


# -- build_reranker ------------------------------------------------------------


def test_build_reranker_gate_and_presets(monkeypatch):
    monkeypatch.delenv("LWC_ALLOW_RANDOM_PARAMS", raising=False)
    env = {"RM_MODEL": "deberta-test-tiny", "RM_MAX_TOKENS": "40"}
    with pytest.raises(ValueError, match="RM_WEIGHTS"):
        serve_main.build_reranker(env, device="cpu")
    rr = serve_main.build_reranker(dict(env, LWC_ALLOW_RANDOM_PARAMS="1"),
                                   device="cpu")
    assert rr.model_name == "deberta-test-tiny" and rr.max_tokens == 40
    assert rr.config == RM_PRESETS["deberta-test-tiny"]
    assert isinstance(rr.tokenizer, HashTokenizer)
    with pytest.raises(ValueError, match="RM_MODEL"):
        serve_main.build_reranker({"RM_MODEL": "deberta-enormous"},
                                  device="cpu")
    assert serve_main.build_reranker({}, device="cpu") is None
    for mode, match in (("int3", "RM_QUANTIZE"), ("int8-xla", "int8-xla")):
        with pytest.raises(ValueError, match=match):
            serve_main.build_reranker(
                dict(env, LWC_ALLOW_RANDOM_PARAMS="1", RM_QUANTIZE=mode),
                device="cpu")
    q = serve_main.build_reranker(
        dict(env, LWC_ALLOW_RANDOM_PARAMS="1", RM_QUANTIZE="int4-pallas"),
        device="cpu")
    assert q.config.quantize == "int4-pallas"
    assert set(RM_PRESETS) == set(jax_reranker.RM_PRESETS)


def test_build_reranker_reads_a_snapshot_and_its_spm(tmp_path, monkeypatch):
    monkeypatch.delenv("LWC_ALLOW_RANDOM_PARAMS", raising=False)
    path = str(_snapshot(tmp_path))
    rr = serve_main.build_reranker(
        {"RM_MODEL": "deberta-test-tiny", "RM_WEIGHTS": path}, device="cpu")
    assert isinstance(rr.tokenizer, spm.UnigramTokenizer)
    assert rr.tokenizer.scheme == "deberta"
    conf, tokens = rr.rerank_confidence(TEXTS, prompt=PROMPT)
    assert conf.shape == (4,) and tokens > 0
    encoder_only = tmp_path / "enc"
    encoder_only.mkdir()
    _snapshot(encoder_only, head=False)
    with pytest.raises(ValueError, match="reward head"):
        serve_main.build_reranker(
            {"RM_MODEL": "deberta-test-tiny",
             "RM_WEIGHTS": str(encoder_only)}, device="cpu")


# -- the server ----------------------------------------------------------------


def _post(port, path, body):
    data = json.dumps(body).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data,
        headers={"content-type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def _jax_consensus(body, embedder=None, reranker=None):
    """POST ``body`` to the reference's /consensus handler."""
    from aiohttp import web
    from aiohttp.test_utils import TestClient, TestServer

    from llm_weighted_consensus_tpu.serve import gateway

    app = web.Application()
    app.router.add_post(
        "/consensus", gateway._consensus_handler(embedder, reranker=reranker)
    )

    async def run():
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            resp = await client.post("/consensus", json=body)
            return resp.status, await resp.json()
        finally:
            await client.close()

    return asyncio.new_event_loop().run_until_complete(run())


@pytest.fixture(scope="module")
def rerankers():
    return _rerankers(log=True, tokenizers=_spm_tokenizers())


@pytest.mark.parametrize("body", [
    {"input": TEXTS, "scorer": "rm"},
    {"input": TEXTS, "scorer": "rm", "prompt": PROMPT},
    {"input": TEXTS[:2], "scorer": "rm", "prompt": PROMPT,
     "temperature": 0.25},
])
def test_rm_round_trip_matches_the_jax_gateway(rerankers, body):
    port, ref = rerankers
    with Server(reranker=port) as srv:
        status, got = _post(srv.port, "/consensus", body)
    assert status == 200
    r_status, want = _jax_consensus(body, reranker=ref)
    assert r_status == 200
    assert set(got) == set(want) == {"model", "scorer", "confidence", "usage"}
    assert got["model"] == want["model"] == "deberta-test-tiny"
    assert got["scorer"] == want["scorer"] == "rm"
    assert got["usage"] == want["usage"]
    np.testing.assert_allclose(got["confidence"], want["confidence"],
                               atol=CONF_TOL)


@pytest.mark.parametrize("body", [
    {"input": ["a", "b"]},
    {"input": ["a", "b"], "scorer": "cosine"},
    {"input": ["a", "b"], "scorer": "rm", "prompt": 7},
    {"input": ["a", "b"], "scorer": "rm", "temperature": 0},
    {"input": ["a", "b"], "scorer": "magic"},
    {"input": ["a"], "scorer": "rm"},
])
def test_reranker_only_server_gives_the_reference_400s(rerankers, body):
    port, ref = rerankers
    with Server(reranker=port) as srv:
        status, got = _post(srv.port, "/consensus", body)
        e_status, _ = _post(srv.port, "/embeddings",
                            {"model": "x", "input": "a"})
    r_status, want = _jax_consensus(body, reranker=ref)
    assert status == r_status == 400
    assert got == {"code": 400, "message": want["message"]}
    assert e_status == 404


def test_concurrent_rm_requests_each_get_their_own_answer(rerankers):
    """Handler threads share the reranker (its launch lock, the model's
    relative-index cache): 16 concurrent requests with a short switch
    interval each get the answer they get alone."""
    import sys

    port, _ = rerankers
    rng = np.random.default_rng(1)
    bodies = [
        {"input": [" ".join(rng.choice(WORDS, size=int(rng.integers(2, 30))))
                   for _ in range(n)],
         "scorer": "rm", "prompt": PROMPT}
        for n in (2, 3, 4, 5, 6, 7, 8, 3, 2, 5, 9, 4, 6, 3, 7, 2)
    ]
    results = [None] * len(bodies)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with Server(reranker=port) as srv:

            def call(i):
                results[i] = _post(srv.port, "/consensus", bodies[i])

            threads = [threading.Thread(target=call, args=(i,))
                       for i in range(len(bodies))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(120)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    for body, (status, got) in zip(bodies, results):
        assert status == 200
        alone, _ = port.rerank_confidence(body["input"], prompt=PROMPT)
        np.testing.assert_allclose(got["confidence"], alone, atol=1e-6)


def test_server_needs_a_model_and_main_says_which(monkeypatch):
    """A ``Server`` with nothing to serve is refused, naming what it
    takes.  ``main`` with neither ``EMBEDDER_MODEL`` nor ``RM_MODEL``
    serves the chat routes only, as the reference's server does, says so,
    and drains clean on SIGTERM."""
    import os
    import signal
    import subprocess
    import sys

    with pytest.raises(ValueError,
                       match="embedder, a reranker or a chat client"):
        Server()
    env = {k: v for k, v in os.environ.items()
           if k not in ("EMBEDDER_MODEL", "RM_MODEL")}
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "llm_weighted_consensus_tpu_torch.serve",
         "--device", "cpu", "--port", "0"],
        env=env, stderr=subprocess.PIPE, text=True,
    )
    try:
        lines = []
        for line in proc.stderr:
            lines.append(line)
            if line.rstrip().endswith("ready"):
                break
        said = "".join(lines)
        assert "no EMBEDDER_MODEL or RM_MODEL: the chat routes only" in said
        proc.send_signal(signal.SIGTERM)
        rest = proc.stderr.read()
        assert proc.wait(timeout=60) == 0
        assert "drained clean" in rest
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
