"""The port's HTTP server on the CPU against the JAX package's gateway.

The port's ``Server`` (stdlib threading HTTP server + micro-batcher) runs
test-tiny on ``device="cpu"`` on an ephemeral port; the reference's
``/consensus`` and ``/embeddings`` handlers run on the same weights in an
aiohttp test server.  Confidences agree within 1e-6, embeddings within
1e-5.
"""

import asyncio
import json
import os
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from llm_weighted_consensus_tpu.models import bert as jax_bert
from llm_weighted_consensus_tpu.models import configs as jax_configs
from llm_weighted_consensus_tpu.models.embedder import TpuEmbedder
from llm_weighted_consensus_tpu_torch.models import bert, configs, convert
from llm_weighted_consensus_tpu_torch.models.embedder import TorchEmbedder
from llm_weighted_consensus_tpu_torch.serve import __main__ as serve_main
from llm_weighted_consensus_tpu_torch.serve.gateway import Server

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "bge_micro")
TEXTS = ["the answer is 42", "the answer is 42!", "cabbage", "forty two"]


@pytest.fixture(scope="module")
def embedders():
    params = jax_bert.init_params(jax.random.PRNGKey(0), jax_configs.TEST_TINY)
    state = convert.from_jax_params(
        jax.tree_util.tree_map(np.asarray, params), configs.TEST_TINY
    )
    ref = TpuEmbedder("test-tiny", params=params, max_tokens=32)
    port = TorchEmbedder(
        "test-tiny",
        model=bert.from_hf_state_dict(state, configs.TEST_TINY, device="cpu"),
        max_tokens=32,
        device="cpu",
    )
    return ref, port


@pytest.fixture
def server(embedders):
    with Server(embedders[1]) as srv:
        yield srv


def _post(port, path, body):
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data,
        headers={"content-type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def _jax_gateway(embedder, path, body):
    """POST ``body`` to the reference's handler for ``path``."""
    from aiohttp import web
    from aiohttp.test_utils import TestClient, TestServer

    from llm_weighted_consensus_tpu.serve import gateway

    app = web.Application()
    app.router.add_post(
        "/consensus", gateway._consensus_handler(embedder)
    )
    app.router.add_post(
        "/embeddings", gateway._embeddings_handler(embedder)
    )

    async def run():
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            resp = await client.post(path, json=body)
            return resp.status, await resp.json()
        finally:
            await client.close()

    return asyncio.new_event_loop().run_until_complete(run())


@pytest.mark.parametrize("temperature", [None, 0.3])
def test_consensus_matches_the_jax_gateway(embedders, server, temperature):
    body = {"input": TEXTS}
    if temperature is not None:
        body["temperature"] = temperature
    status, got = _post(server.port, "/consensus", body)
    assert status == 200
    r_status, want = _jax_gateway(embedders[0], "/consensus", body)
    assert r_status == 200
    assert set(got) == set(want) == {"model", "scorer", "confidence", "usage"}
    assert got["model"] == want["model"] and got["scorer"] == "cosine"
    assert got["usage"] == want["usage"]
    np.testing.assert_allclose(got["confidence"], want["confidence"], atol=1e-6)
    direct = embedders[0].consensus_confidence(
        TEXTS, temperature=temperature or 0.05
    )
    np.testing.assert_allclose(got["confidence"], np.asarray(direct), atol=1e-6)


@pytest.mark.parametrize("inputs", [["hello", "world", "a b c"], "one text"])
def test_embeddings_match_the_jax_gateway(embedders, server, inputs):
    body = {"model": "test-tiny", "input": inputs}
    status, got = _post(server.port, "/embeddings", body)
    assert status == 200
    r_status, want = _jax_gateway(embedders[0], "/embeddings", body)
    assert r_status == 200
    assert set(got) == set(want)
    assert got["object"] == want["object"] == "list"
    assert got["usage"] == want["usage"]
    assert len(got["data"]) == len(want["data"])
    for g, w in zip(got["data"], want["data"]):
        assert set(g) == set(w) and g["index"] == w["index"]
        assert len(g["embedding"]) == configs.TEST_TINY.hidden_size
        np.testing.assert_allclose(g["embedding"], w["embedding"], atol=1e-5)


def test_concurrent_equal_n_requests_coalesce(embedders):
    _, port = embedders
    n_req = 6
    rng = np.random.default_rng(0)
    words = "red green blue cyan magenta yellow black white".split()
    bodies = [
        {"input": [" ".join(rng.choice(words, size=4)) for _ in range(3)]}
        for _ in range(n_req)
    ]
    results = [None] * n_req
    # a group leaves when full: all six wait for each other
    with Server(port, max_batch=n_req, window_ms=30000) as srv:

        def call(i):
            results[i] = _post(srv.port, "/consensus", bodies[i])

        threads = [threading.Thread(target=call, args=(i,)) for i in range(n_req)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        stats = srv.batcher.stats()
    assert stats["dispatches"]["consensus"] == 1
    assert stats["requests"]["consensus"] == n_req
    assert stats["largest_group"] == n_req
    for body, (status, got) in zip(bodies, results):
        assert status == 200
        alone = port.consensus_confidence(body["input"])
        np.testing.assert_allclose(got["confidence"], alone, atol=1e-6)


def test_batcher_groups_by_n_and_temperature(embedders):
    from llm_weighted_consensus_tpu_torch.serve.batcher import ConsensusBatcher

    _, port = embedders
    with ConsensusBatcher(port, max_batch=8, window_ms=50) as batcher:
        futures = [
            batcher.submit_consensus(["a", "b"], 0.05),
            batcher.submit_consensus(["c", "d"], 0.05),
            batcher.submit_consensus(["a", "b", "c"], 0.05),
            batcher.submit_consensus(["a", "b"], 0.5),
            batcher.submit_embed(["x", "y", "z"]),
        ]
        out = [f.result(60) for f in futures]
        stats = batcher.stats()
    assert stats["dispatches"] == {"consensus": 3, "embed": 1}
    assert [len(o[0]) for o in out] == [2, 2, 3, 2, 3]


BAD_CONSENSUS = [
    {"input": ["only one"]},
    {"input": "not a list"},
    {"input": ["a", 7]},
    [1, 2],
    {"input": ["a"] * 257},
    {"input": ["a", "b"], "temperature": 0},
    {"input": ["a", "b"], "temperature": -1.5},
    {"input": ["a", "b"], "temperature": "hot"},
    {"input": ["a", "b"], "temperature": True},
    {"input": ["a", "b"], "scorer": "bogus"},
    {"input": ["a", "b"], "prompt": 5},
]


@pytest.mark.parametrize("body", BAD_CONSENSUS)
def test_bad_consensus_input_gets_a_400_envelope(server, body):
    status, got = _post(server.port, "/consensus", body)
    assert status == 400
    assert got["code"] == 400 and isinstance(got["message"], str)


def test_rm_scorer_without_rm_model_is_400(server):
    status, got = _post(
        server.port, "/consensus", {"input": ["a", "b"], "scorer": "rm"}
    )
    assert status == 400 and "RM_MODEL" in got["message"]


def test_non_finite_temperature_is_refused(server):
    status, got = _post(
        server.port, "/consensus",
        b'{"input": ["a", "b"], "temperature": NaN}',
    )
    assert status == 400 and got["code"] == 400


@pytest.mark.parametrize(
    "body",
    [
        {"model": "bge-large-en", "input": ["x"]},
        {"input": ["x"]},
        {"model": "test-tiny", "input": [1, 2]},
    ],
)
def test_bad_embeddings_input_gets_a_400_envelope(server, body):
    status, got = _post(server.port, "/embeddings", body)
    assert status == 400 and got["code"] == 400


def test_malformed_json_unknown_route_and_healthz(server):
    status, got = _post(server.port, "/consensus", b"{not json")
    assert status == 400 and got["code"] == 400
    status, got = _post(server.port, "/nope", {})
    assert status == 404 and got["code"] == 404
    url = f"http://127.0.0.1:{server.port}/healthz"
    with urllib.request.urlopen(url, timeout=10) as resp:
        assert resp.status == 200 and json.loads(resp.read()) == {"ok": True}


def test_oversized_and_malformed_length_bodies(server):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=30)
    conn.putrequest("POST", "/consensus")
    conn.putheader("content-length", str(64 * 1024 * 1024))
    conn.endheaders()
    resp = conn.getresponse()
    assert resp.status == 413 and json.loads(resp.read())["code"] == 413
    conn.close()
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=30)
    conn.putrequest("POST", "/consensus")
    conn.putheader("content-length", "twelve")
    conn.endheaders()
    resp = conn.getresponse()
    assert resp.status == 400 and json.loads(resp.read())["code"] == 400
    conn.close()
    status, got = _post(server.port, "/consensus", b"\xff\xfe{}")
    assert status == 400 and got["code"] == 400


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        TorchEmbedder("test-tiny", device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        # the default device is CUDA, never a silent CPU fallback
        TorchEmbedder("test-tiny")


def test_build_embedder_from_env():
    env = {"EMBEDDER_MODEL": "test-tiny", "EMBEDDER_MAX_TOKENS": "16"}
    with pytest.raises(ValueError, match="LWC_ALLOW_RANDOM_PARAMS"):
        serve_main.build_embedder(env, device="cpu")
    emb = serve_main.build_embedder(
        dict(env, LWC_ALLOW_RANDOM_PARAMS="1"), device="cpu"
    )
    assert emb.model_name == "test-tiny" and emb.max_tokens == 16
    with pytest.raises(ValueError, match="preset"):
        serve_main.build_embedder({"EMBEDDER_MODEL": "nope"}, device="cpu")


def test_server_serves_the_bge_micro_snapshot():
    # bge_micro's shape is no preset, so it is built from its own
    # config.json rather than through build_embedder
    from llm_weighted_consensus_tpu_torch.models import loading, tokenizer

    cfg = loading.load_hf_config(FIXTURE)
    model = loading.load_params(FIXTURE, cfg, device="cpu")
    port = TorchEmbedder(
        "bge-micro", model=model, config=cfg,
        tokenizer=tokenizer.load_tokenizer(loading.find_vocab(FIXTURE)),
        max_tokens=64, device="cpu",
    )
    with Server(port) as srv:
        status, got = _post(srv.port, "/consensus", {"input": TEXTS})
    assert status == 200
    assert len(got["confidence"]) == len(TEXTS)
    assert abs(sum(got["confidence"]) - 1.0) < 1e-5
