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


@pytest.mark.parametrize("rows,model", [
    (0, "test-tiny"), (1, "test-tiny"), (16, "test-tiny"),
    (3, 'odd "data": [] name'),
])
def test_embeddings_body_is_the_json_of_the_response(embedders, rows, model):
    """The gateway encodes an embeddings answer row by row; its bytes are
    one ``json.dumps`` of the whole response's."""
    from llm_weighted_consensus_tpu_torch.serve.gateway import embeddings_body

    emb = np.random.default_rng(rows).standard_normal((rows, 64))
    response = embedders[1].wire_response(emb.astype(np.float32), 11)
    response.model = model
    obj = response.to_json_obj()
    assert embeddings_body(obj) == json.dumps(obj).encode()


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


# -- the archive's routes against the JAX gateway --------------------------------
#
# ``POST /archive/rescore`` and ``POST /weights/learn`` on the port's server
# (``build_server``) and on the reference's handlers over the same archive
# snapshot: the same statuses and bodies (a rescore's ``results`` within
# 1e-6: the f32 tally sums in another order on each side), the 400s byte
# for byte.  Then the archiving wrapper (``ARCHIVE_STREAMING``), the
# request-body cap's 413, and the knobs of both against the reference's
# ``Config.from_env``.

import http.client  # noqa: E402
import shutil  # noqa: E402
from decimal import Decimal  # noqa: E402

from llm_weighted_consensus_tpu import archive as ref_archive  # noqa: E402
from llm_weighted_consensus_tpu.serve.config import Config  # noqa: E402
from llm_weighted_consensus_tpu_torch.serve.config import (  # noqa: E402
    ServeConfig,
)

ARCHIVE_TOL = 1e-6
UPSTREAM = {"OPENAI_API_BASE": "https://up.example", "OPENAI_API_KEY": "k"}


def _ref_posts(app, requests):
    """[(status, body bytes)] of ``requests`` [(path, raw)] posted in turn
    to the reference's aiohttp ``app``."""
    from aiohttp.test_utils import TestClient, TestServer

    async def run():
        client = TestClient(TestServer(app))
        await client.start_server()
        out = []
        try:
            for path, raw in requests:
                resp = await client.post(
                    path, data=raw,
                    headers={"content-type": "application/json"})
                out.append((resp.status, await resp.read()))
        finally:
            await client.close()
        return out

    return asyncio.new_event_loop().run_until_complete(run())


def _port_posts(server, requests):
    out = []
    for path, raw in requests:
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=120)
        try:
            conn.request("POST", path, body=raw,
                         headers={"content-type": "application/json"})
            resp = conn.getresponse()
            out.append((resp.status, resp.read()))
        finally:
            conn.close()
    return out


def _ref_archive_app(store, embedder=None, tables=None):
    """The reference's two archive handlers on one lock, as its
    ``build_service`` registers them."""
    from aiohttp import web

    from llm_weighted_consensus_tpu.serve.__main__ import (
        _learn_handler,
        _rescore_handler,
    )

    app = web.Application()
    lock = asyncio.Lock()
    app.router.add_post("/archive/rescore", _rescore_handler(store, lock))
    if tables is not None:
        app.router.add_post("/weights/learn",
                            _learn_handler(store, embedder, tables, lock))
    return app


def _same_answer(got, want):
    """The port's (status, body) against the reference's: equal bytes,
    but for a rescore's ``results``, held at 1e-6."""
    assert got[0] == want[0]
    if got[1] == want[1]:
        return
    g, w = json.loads(got[1]), json.loads(want[1])
    assert "results" in w and g.keys() == w.keys()
    assert {k: v for k, v in g.items() if k != "results"} == \
        {k: v for k, v in w.items() if k != "results"}
    assert g["results"].keys() == w["results"].keys()
    for cid, scores in w["results"].items():
        for field in ("weight", "confidence"):
            np.testing.assert_allclose(g["results"][cid][field],
                                       scores[field], atol=ARCHIVE_TOL)


@pytest.fixture(scope="module")
def archive_snapshot(tmp_path_factory):
    """A JAX archive of real score completions (soft votes, a failed
    judge, many judges) saved as a snapshot."""
    from test_torch_archive import build_archive

    path = str(tmp_path_factory.mktemp("routes") / "archive.json")
    build_archive("ref").save(path)
    return path


def _port_archive_server(snapshot, tmp_path, embedder=None, **env):
    path = str(tmp_path / "port_archive.json")
    shutil.copy(snapshot, path)
    config = ServeConfig.from_env({**UPSTREAM, "ARCHIVE_PATH": path, **env})
    return serve_main.build_server(embedder, None, config, device="cpu")


def _judge_ids(store):
    return sorted({c.model for cid in store.score_ids()
                   for c in store.score_completion(cid).choices
                   if c.model_index is not None})


RESCORE_BODIES = {
    "empty_body": lambda s: b"",
    "empty_object": lambda s: b"{}",
    "results": lambda s: b'{"include_results": true}',
    "revote": lambda s: b'{"revote": true, "include_results": true}',
    "overrides": lambda s: json.dumps({
        "weight_overrides": {_judge_ids(s)[0]: 3, _judge_ids(s)[-1]: 0.5},
        "include_results": True}).encode(),
    "ids": lambda s: json.dumps({"ids": s.score_ids()[2:5],
                                 "include_results": True}).encode(),
    "unknown_ids": lambda s: b'{"ids": ["nope", "nada"]}',
    "ids_not_a_list": lambda s: b'{"ids": "abc"}',
    "not_an_object": lambda s: b"[]",
    "overrides_not_a_map": lambda s: b'{"weight_overrides": [1]}',
    "override_not_a_number": lambda s: b'{"weight_overrides": {"a": "x"}}',
    "override_a_bool": lambda s: b'{"weight_overrides": {"a": true}}',
    "malformed_json": lambda s: b"{not json",
    "bad_utf8": lambda s: b"\xff\xfe{}",
}


@pytest.mark.parametrize("case", sorted(RESCORE_BODIES))
def test_archive_rescore_route_answers_as_the_jax_gateway(
        archive_snapshot, tmp_path, case):
    ref = ref_archive.InMemoryArchive.load(archive_snapshot)
    raw = RESCORE_BODIES[case](ref)
    [want] = _ref_posts(_ref_archive_app(ref), [("/archive/rescore", raw)])
    with _port_archive_server(archive_snapshot, tmp_path) as server:
        [got] = _port_posts(server, [("/archive/rescore", raw)])
    _same_answer(got, want)
    if case == "empty_object":
        assert json.loads(got[1]) == {"rescored": len(ref.score_ids()),
                                      "applied": 0}
    if case.startswith("unknown") or case.endswith("list"):
        assert got[0] == 400


def test_archive_rescore_apply_writes_back_as_the_jax_gateway(
        archive_snapshot, tmp_path):
    ref = ref_archive.InMemoryArchive.load(archive_snapshot)
    raw = json.dumps({"weight_overrides": {_judge_ids(ref)[0]: 4},
                      "revote": True, "apply": True}).encode()
    [want] = _ref_posts(_ref_archive_app(ref), [("/archive/rescore", raw)])
    with _port_archive_server(archive_snapshot, tmp_path) as server:
        [got] = _port_posts(server, [("/archive/rescore", raw)])
        store = server.archive
        # the next fetch through the archive seam sees the new values
        fetched = {
            cid: asyncio.new_event_loop().run_until_complete(
                store.fetch_score_completion(None, cid))
            for cid in store.score_ids()}
    assert got == want == (200, b'{"rescored":8,"applied":8}')
    for cid in ref.score_ids():
        for a, b in zip(fetched[cid].choices,
                        ref.score_completion(cid).choices):
            if a.model_index is None:
                assert isinstance(a.confidence, Decimal)
                assert abs(float(a.weight) - float(b.weight)) <= ARCHIVE_TOL
                assert abs(float(a.confidence)
                           - float(b.confidence)) <= ARCHIVE_TOL


@pytest.fixture(scope="module")
def learn_setup(tmp_path_factory):
    """(JAX archive snapshot of training-table completions, the JAX and
    the port bge_micro embedders)."""
    from test_torch_learning import build_archive
    from test_torch_training_table import micro_embedders

    path = str(tmp_path_factory.mktemp("learn") / "archive.json")
    build_archive("ref").save(path)
    return path, micro_embedders()


def _learn_panel(**kw):
    from test_torch_learning import tt_panel

    return tt_panel(**kw)


LEARN_BODIES = {
    "panel": lambda: json.dumps({"model": _learn_panel()}).encode(),
    "labels": lambda: json.dumps({"model": _learn_panel(base_weight=2),
                                  "labels": {"x": 1}}).encode(),
    "empty_body": lambda: b"",
    "not_an_object": lambda: b"[]",
    "no_model": lambda: b"{}",
    "bad_model": lambda: b'{"model": {"llms": []}}',
    "labels_not_a_map": lambda: json.dumps(
        {"model": _learn_panel(), "labels": [1]}).encode(),
    "label_a_bool": lambda: json.dumps(
        {"model": _learn_panel(), "labels": {"c": True}}).encode(),
    "label_a_float": lambda: json.dumps(
        {"model": _learn_panel(), "labels": {"c": 1.5}}).encode(),
    "malformed_json": lambda: b'{"model": ',
}


@pytest.mark.parametrize("case", sorted(LEARN_BODIES))
def test_weights_learn_route_answers_as_the_jax_gateway(
        learn_setup, tmp_path, case):
    from llm_weighted_consensus_tpu.weights.training_table import (
        TrainingTableStore as RefTables,
    )

    snapshot, (ref_emb, port_emb) = learn_setup
    ref = ref_archive.InMemoryArchive.load(snapshot)
    raw = LEARN_BODIES[case]()
    requests = [("/weights/learn", raw)] * 2
    want = _ref_posts(_ref_archive_app(ref, ref_emb, RefTables()), requests)
    tables_path = str(tmp_path / "tables.npz")
    with _port_archive_server(snapshot, tmp_path, port_emb,
                              TABLES_PATH=tables_path) as server:
        got = _port_posts(server, requests)
    assert got == want
    if case in ("panel", "labels"):
        assert [json.loads(b) for _, b in got] == [{"rows_added": 12},
                                                   {"rows_added": 0}]
        assert len(server.tables) == 2
    else:
        assert got[0][0] == 400


def test_weights_learn_needs_an_embedder(archive_snapshot, tmp_path):
    with _port_archive_server(archive_snapshot, tmp_path) as server:
        [got] = _port_posts(server, [("/weights/learn", b"{}")])
    assert got[0] == 404


def _archiving_pair(case, fold):
    """The same score case through the reference's ``_ArchivingClient``
    and the port's ``ArchivingClient``: {pkg: (client, store)}."""
    from llm_weighted_consensus_tpu.serve.__main__ import _ArchivingClient
    from llm_weighted_consensus_tpu_torch.serve.archive_routes import (
        ArchivingClient,
    )
    from test_torch_score import CASES, PKGS, make_client

    _, scripts = CASES[case]
    out = {}
    for pkg, wrapper in (("ref", _ArchivingClient),
                         ("port", ArchivingClient)):
        store = PKGS[pkg].archive.InMemoryArchive()
        client, _ = make_client(pkg, scripts, ballot_sink=store.put_ballot)

        def put_score(result, params, store=store):
            store.put_score(result)
            store.put_score_request(result.id, params)

        unary = PKGS[pkg].resp.ChatCompletion.from_streaming
        out[pkg] = (wrapper(client, put_score,
                            stream_fold=unary if fold else None), store)
    return out


def _archived(store, pkg):
    from test_torch_score import PKGS

    out = []
    for cid in store.score_ids():
        obj = store.score_completion(cid).to_json_obj()
        obj["id"], obj["created"] = "scrcpl", 0
        out.append((PKGS[pkg].json.dumps(obj),
                    PKGS[pkg].json.dumps(store.score_request(cid)
                                         .to_json_obj()),
                    {j: [list(p) for p in b]
                     for j, b in store.score_ballots(cid).items()}))
    return out


@pytest.mark.parametrize("abandon", [False, True])
@pytest.mark.parametrize("case", ["soft_vote_wide", "judge_failure",
                                  "all_failed_5xx"])
def test_archive_streaming_wrapper_archives_as_the_jax_wrapper(case,
                                                               abandon):
    """``ARCHIVE_STREAMING``: a completed stream archives its fold (with
    its request and ballots) as the reference's wrapper does; a stream
    abandoned after its first chunk, or one that ends in an error item,
    archives nothing; the client sees every chunk either way."""
    from test_torch_score import CASES, PKGS

    pairs = _archiving_pair(case, fold=True)
    seen = {}
    for pkg, (client, store) in pairs.items():
        params = PKGS[pkg].req.ChatCompletionCreateParams.from_json_obj(
            CASES[case][0])

        async def run(client=client, params=params):
            stream = await client.create_streaming(None, params)
            n = 0
            async for _ in stream:
                n += 1
                if abandon:
                    break
            await stream.aclose()
            return n

        seen[pkg] = asyncio.new_event_loop().run_until_complete(run())
    assert seen["port"] == seen["ref"] > 0
    ref_store, port_store = pairs["ref"][1], pairs["port"][1]
    assert _archived(port_store, "port") == _archived(ref_store, "ref")
    archived = len(port_store.score_ids())
    assert archived == (0 if abandon or case == "all_failed_5xx" else 1)


@pytest.mark.parametrize("fold", [False, True])
def test_unary_is_archived_and_streams_only_under_the_fold(fold):
    from test_torch_score import CASES, PKGS

    for stream in (False, True):
        pairs = _archiving_pair("disagreement", fold)
        for pkg, (client, store) in pairs.items():
            params = PKGS[pkg].req.ChatCompletionCreateParams.from_json_obj(
                CASES["disagreement"][0])

            async def run(client=client, params=params):
                if not stream:
                    return await client.create_unary(None, params)
                s = await client.create_streaming(None, params)
                async for _ in s:
                    pass

            asyncio.new_event_loop().run_until_complete(run())
        got = _archived(pairs["port"][1], "port")
        assert got == _archived(pairs["ref"][1], "ref")
        assert len(got) == (1 if fold or not stream else 0)


def test_served_completions_are_archived_referenced_and_saved(tmp_path):
    """``build_server`` with ``ARCHIVE_PATH`` (so ``ARCHIVE_WRITE``) and
    ``ARCHIVE_STREAMING`` over the fake upstream: a streamed and a unary
    score completion are archived with their requests and ballots, a
    later request takes an archived choice as a candidate by id, and the
    snapshot saved at close loads in the JAX package with the same ids."""
    from llm_weighted_consensus_tpu_torch.serve.fake_upstream import (
        FakeUpstream,
    )
    from test_torch_score import _wire_masked

    path = str(tmp_path / "archive.json")
    fake = FakeUpstream()
    body = {"messages": [{"role": "user", "content": "q"}],
            "model": {"llms": [{"model": "a"}, {"model": "b"}]},
            "choices": ["x", "y", "z"]}
    try:
        config = ServeConfig.from_env({
            "OPENAI_API_BASE": fake.url, "OPENAI_API_KEY": "k",
            "ARCHIVE_PATH": path, "ARCHIVE_STREAMING": "1"})
        assert config.archive_write and os.path.exists(path) is False
        server = serve_main.build_server(None, None, config, device="cpu")
        assert os.path.exists(path)  # written at once: the path is writable
        with server:
            streamed, unary = _port_posts(server, [
                ("/score/completions",
                 json.dumps({**body, "stream": True}).encode()),
                ("/score/completions", json.dumps(body).encode())])
            ids = server.archive.score_ids()
            ref_body = {**body, "choices": [
                {"type": "score_completion", "id": ids[1],
                 "choice_index": 2}, "w"]}
            [again] = _port_posts(server, [
                ("/score/completions", json.dumps(ref_body).encode())])
            for cid in ids:
                assert server.archive.score_request(cid) is not None
                assert len(server.archive.score_ballots(cid)) == 2
    finally:
        fake.close()
    assert streamed[0] == unary[0] == again[0] == 200
    assert _wire_masked(streamed[1])[-1] == "[DONE]"
    assert ids[1] == json.loads(unary[1])["id"]
    assert len(ids) == 2
    saved = ref_archive.InMemoryArchive.load(path)
    assert saved.score_ids() == ids + [json.loads(again[1])["id"]]


# -- the request-body cap ----------------------------------------------------------


def _ref_capped_app(embedder, max_body_bytes):
    """The reference's gateway with its body cap: ``build_app`` with the
    test-tiny embedder, plus its archive route."""
    from llm_weighted_consensus_tpu.clients.multichat import MultichatClient
    from llm_weighted_consensus_tpu.serve import build_app
    from llm_weighted_consensus_tpu.serve.__main__ import _rescore_handler
    from test_torch_score import make_client

    client, _ = make_client("ref", [])
    app = build_app(client.chat_client, client,
                    MultichatClient(client.chat_client,
                                    client.model_fetcher),
                    embedder, max_body_bytes=max_body_bytes)
    app.router.add_post("/archive/rescore", _rescore_handler(
        ref_archive.InMemoryArchive(), asyncio.Lock()))
    return app


def _port_length_only(server, path, length: int):
    """POST headers announcing ``length`` body bytes, and no body: the
    port decides on the announced length and never reads the body."""
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=30)
    try:
        conn.putrequest("POST", path)
        conn.putheader("content-type", "application/json")
        conn.putheader("content-length", str(length))
        conn.endheaders()
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


CAP_ROUTES = ["/consensus", "/embeddings", "/score/completions",
              "/chat/completions", "/multichat/completions",
              "/archive/rescore"]


@pytest.mark.parametrize("knob", [None, "2048"])
def test_body_cap_answers_the_reference_413(embedders, knob):
    env = dict(UPSTREAM)
    if knob is not None:
        env["MAX_BODY_BYTES"] = knob
    config = ServeConfig.from_env(env)
    ref_config = Config.from_env(env)
    cap = config.max_body_bytes
    assert cap == ref_config.max_body_bytes == int(knob or 1024 * 1024)
    app = _ref_capped_app(embedders[0], ref_config.max_body_bytes)
    want = _ref_posts(app, [(path, b" " * n) for path in CAP_ROUTES
                            for n in (cap, cap + 1)])
    server = serve_main.build_server(embedders[1], None, config)
    with server:
        server.lifecycle.mark_ready()
        got = [_port_length_only(server, path, n) for path in CAP_ROUTES
               for n in (cap, cap + 1)]
    assert got == want
    assert set(got) == {(413, b'{"code":413,"message":'
                         b'{"kind":"payload_too_large"}}')}


def test_a_body_under_the_cap_is_served_alike(embedders):
    """One byte under the cap the body is read: an empty archive's
    rescore of a padded body answers alike."""
    env = {**UPSTREAM, "MAX_BODY_BYTES": "4096"}
    raw = b'{"pad": "' + b"x" * (4096 - 1 - 11) + b'"}'
    assert len(raw) == 4095
    want = _ref_posts(_ref_capped_app(embedders[0], 4096),
                      [("/archive/rescore", raw)])
    server = serve_main.build_server(None, None, ServeConfig.from_env(env),
                                     device="cpu")
    with server:
        got = _port_posts(server, [("/archive/rescore", raw)])
    assert got == want == [(200, b'{"rescored":0,"applied":0}')]


# -- the knobs -------------------------------------------------------------------

KNOBS = ("max_body_bytes", "admission_max_inflight",
         "admission_max_queue_depth", "admission_adaptive",
         "admission_min_limit", "admission_latency_factor",
         "admission_retry_after_millis", "device_watchdog_millis",
         "device_watchdog_interval_millis", "address", "port",
         "archive_path", "archive_write", "archive_streaming",
         "archive_max_completions", "trace_sample_rate", "trace_enabled",
         "trace_ring", "trace_dir", "quality_window",
         "quality_drift_threshold", "ledger_ring", "ledger_dir",
         "ledger_rotate_bytes", "resilience_breaker_threshold",
         "resilience_breaker_window", "resilience_breaker_min_samples",
         "resilience_breaker_cooldown_millis", "resilience_retry_budget",
         "resilience_hedge_millis", "resilience_hedge_quantile",
         "resilience_deadline_millis", "resilience_quorum", "fault_plan",
         "judge_bias_plan", "memguard_enabled", "mem_soft_bytes",
         "mem_hard_bytes", "memguard_interval_millis", "weights_enabled",
         "weights_path", "offline_enabled", "offline_inflight")

KNOB_ENVS = [
    {},
    {"MAX_BODY_BYTES": "0", "ADDRESS": "127.0.0.1", "PORT": "5301"},
    {"ADMISSION_MAX_INFLIGHT": "64", "ADMISSION_ADAPTIVE": "1",
     "ADMISSION_MIN_LIMIT": "0", "ADMISSION_LATENCY_FACTOR": "3.5",
     "ADMISSION_RETRY_AFTER_MILLIS": "250"},
    {"DEVICE_WATCHDOG_MILLIS": "500",
     "DEVICE_WATCHDOG_INTERVAL_MILLIS": "20"},
    {"ARCHIVE_PATH": "/tmp/a.json"},
    {"ARCHIVE_PATH": "/tmp/a.json", "ARCHIVE_WRITE": "0",
     "ARCHIVE_STREAMING": "1", "ARCHIVE_MAX_COMPLETIONS": "0"},
    {"ARCHIVE_WRITE": "1", "ARCHIVE_MAX_COMPLETIONS": "10"},
    {"TRACE_SAMPLE_RATE": "0.25", "TRACE_RING": "0", "TRACE_DIR": "/tmp/t"},
    {"TRACE_ENABLED": "1", "TRACE_RING": "16"},
    {"QUALITY_WINDOW": "8", "QUALITY_DRIFT_THRESHOLD": "1"},
    {"LEDGER_RING": "32", "LEDGER_DIR": "/tmp/l",
     "LEDGER_ROTATE_BYTES": "4096"},
    {"LEDGER_DIR": "/tmp/l"},
    {"RESILIENCE_BREAKER_THRESHOLD": "0.5", "RESILIENCE_BREAKER_WINDOW": "0",
     "RESILIENCE_BREAKER_MIN_SAMPLES": "3",
     "RESILIENCE_BREAKER_COOLDOWN_MILLIS": "250"},
    {"RESILIENCE_RETRY_BUDGET": "8", "RESILIENCE_HEDGE_MILLIS": "150",
     "RESILIENCE_DEADLINE_MILLIS": "5000", "RESILIENCE_QUORUM": "0.5"},
    {"RESILIENCE_HEDGE_QUANTILE": "0.95"},
    {"RESILIENCE_QUORUM": "1", "RESILIENCE_BREAKER_MIN_SAMPLES": "-4"},
    {"FAULT_PLAN": "seed=7,stall_first=0.35,stall_ms=20000",
     "JUDGE_BIAS_PLAN": "judge=2,after=16,flip=1.0,seed=7"},
    {"MEMGUARD": "0"},
    {"MEM_SOFT_BYTES": "1000", "MEM_HARD_BYTES": "2000",
     "MEMGUARD_INTERVAL_MILLIS": "250"},
    {"MEM_SOFT_BYTES": "4096"},
    {"WEIGHTS_ENABLED": "1", "OFFLINE_ENABLED": "1"},
    {"WEIGHTS_PATH": "/nonexistent/lwc-weights.json",
     "OFFLINE_INFLIGHT": "9"},
    {"WEIGHTS_ENABLED": "0", "OFFLINE_ENABLED": "0", "OFFLINE_INFLIGHT": "0"},
]

BAD_KNOB_ENVS = [
    {"ADMISSION_ADAPTIVE": "1"},
    {"ADMISSION_LATENCY_FACTOR": "1"},
    {"ADMISSION_MIN_LIMIT": "two"},
    {"ARCHIVE_MAX_COMPLETIONS": "-1"},
    {"MAX_BODY_BYTES": "-5"},
    {"PORT": "http"},
    {"ADMISSION_RETRY_AFTER_MILLIS": "soon"},
    {"DEVICE_WATCHDOG_INTERVAL_MILLIS": "x"},
    {"TRACE_SAMPLE_RATE": "1.5"},
    {"TRACE_SAMPLE_RATE": "-0.1"},
    {"TRACE_SAMPLE_RATE": "often"},
    {"TRACE_RING": "many"},
    {"QUALITY_WINDOW": "0"},
    {"QUALITY_DRIFT_THRESHOLD": "0"},
    {"QUALITY_DRIFT_THRESHOLD": "1.5"},
    {"LEDGER_RING": "-1"},
    {"LEDGER_ROTATE_BYTES": "-4096"},
    {"RESILIENCE_QUORUM": "1.5"},
    {"RESILIENCE_QUORUM": "-0.5"},
    {"RESILIENCE_QUORUM": "half"},
    {"RESILIENCE_HEDGE_QUANTILE": "1"},
    {"RESILIENCE_HEDGE_QUANTILE": "-0.1"},
    {"RESILIENCE_RETRY_BUDGET": "-1"},
    {"RESILIENCE_BREAKER_WINDOW": "wide"},
    {"RESILIENCE_BREAKER_THRESHOLD": "x"},
    {"RESILIENCE_BREAKER_COOLDOWN_MILLIS": "later"},
    {"RESILIENCE_HEDGE_MILLIS": "soon"},
    {"RESILIENCE_DEADLINE_MILLIS": "never"},
    {"RESILIENCE_BREAKER_MIN_SAMPLES": "few"},
    {"MEM_SOFT_BYTES": "2000", "MEM_HARD_BYTES": "1000"},
    {"MEM_SOFT_BYTES": "-1"},
    {"MEM_HARD_BYTES": "lots"},
    {"MEMGUARD_INTERVAL_MILLIS": "0"},
    {"MEMGUARD_INTERVAL_MILLIS": "-5"},
    {"OFFLINE_ENABLED": "1", "OFFLINE_INFLIGHT": "0"},
    {"OFFLINE_INFLIGHT": "-1"},
    {"OFFLINE_INFLIGHT": "many"},
]


@pytest.mark.parametrize("env", KNOB_ENVS)
def test_knobs_read_as_the_reference_reads_them(env):
    ref, port = Config.from_env(env), ServeConfig.from_env(env)
    assert {n: getattr(port, n) for n in KNOBS} == \
        {n: getattr(ref, n) for n in KNOBS}
    assert vars(port.admission_config()) == vars(ref.admission_config())
    # the factories the knobs feed: None exactly where the reference's is
    for name in ("resilience_policy", "fault_injection_plan",
                 "judge_bias_injection_plan", "memguard", "live_weights"):
        got, want = getattr(port, name)(), getattr(ref, name)()
        assert (got is None) == (want is None), name
        if got is not None:
            assert got.snapshot() == want.snapshot(), name


@pytest.mark.parametrize("env", BAD_KNOB_ENVS)
def test_bad_knobs_are_refused_as_the_reference_refuses_them(env):
    with pytest.raises(ValueError) as want:
        Config.from_env(env)
    with pytest.raises(ValueError) as got:
        ServeConfig.from_env(env)
    assert str(got.value) == str(want.value)


def test_the_server_takes_the_knobs(tmp_path):
    env = {**UPSTREAM, "ADMISSION_MAX_INFLIGHT": "8",
           "ADMISSION_ADAPTIVE": "1", "ADMISSION_RETRY_AFTER_MILLIS": "250",
           "DEVICE_WATCHDOG_MILLIS": "400",
           "DEVICE_WATCHDOG_INTERVAL_MILLIS": "25", "MAX_BODY_BYTES": "100"}
    config = ServeConfig.from_env(env)
    server = serve_main.build_server(None, None, config, device="cpu")
    try:
        assert vars(server.admission.config) == vars(config.admission_config())
        assert server.admission.config.adaptive is True
        assert server.watchdog.interval_ms == 25.0
        assert server.watchdog.timeout_ms == 400.0
    finally:
        server.close()


@pytest.mark.parametrize("extra", [
    {},
    {"TRACE_ENABLED": "1", "LEDGER_RING": "4"},
    {"TRACE_SAMPLE_RATE": "0.5", "TRACE_RING": "7", "QUALITY_WINDOW": "9",
     "QUALITY_DRIFT_THRESHOLD": "0.5", "LEDGER_ROTATE_BYTES": "512"},
])
def test_the_server_takes_the_trace_quality_and_ledger_knobs(tmp_path,
                                                             extra):
    from llm_weighted_consensus_tpu import obs as ref_obs
    from llm_weighted_consensus_tpu.serve.config import Config
    from llm_weighted_consensus_tpu_torch import obs as port_obs

    env = {**UPSTREAM, **extra}
    if "LEDGER_ROTATE_BYTES" in extra:
        env["LEDGER_DIR"] = str(tmp_path / "ledger")
        env["TRACE_DIR"] = str(tmp_path / "traces")
    ref, config = Config.from_env(env), ServeConfig.from_env(env)
    for name in ("trace_sink", "outcome_ledger"):
        got, want = getattr(config, name)(), getattr(ref, name)()
        assert (got is None) == (want is None)
        if got is not None:
            assert got.snapshot() == want.snapshot()
    server = serve_main.build_server(None, None, config, device="cpu")
    try:
        sink, ledger = server.trace_sink, server.ledger
        assert (sink is None) == (config.trace_sink() is None)
        assert (ledger is None) == (config.outcome_ledger() is None)
        assert server.score_client.ledger is ledger
        agg = port_obs.quality_aggregator()
        assert (agg.window, agg.drift_threshold) == (
            config.quality_window, config.quality_drift_threshold)
        snap = server.metrics.snapshot()
        assert "quality" in snap
        assert ("traces" in snap) == (sink is not None)
        assert ("ledger" in snap) == (ledger is not None)
    finally:
        server.close()
        for obs in (port_obs, ref_obs):
            obs.configure_quality(window=64, drift_threshold=0.25)


@pytest.mark.parametrize("extra", [
    {},
    {"RESILIENCE_QUORUM": "0.5", "RESILIENCE_BREAKER_THRESHOLD": "0.5",
     "RESILIENCE_RETRY_BUDGET": "8", "RESILIENCE_HEDGE_MILLIS": "150",
     "RESILIENCE_DEADLINE_MILLIS": "5000", "HOST_FASTPATH": "1",
     "FAULT_PLAN": "seed=7,stall_first=0.35,stall_ms=20000",
     "JUDGE_BIAS_PLAN": "judge=1,flip=1.0", "MEMGUARD": "0"},
])
def test_the_server_takes_the_resilience_and_memguard_knobs(extra):
    from llm_weighted_consensus_tpu_torch.resilience import (
        FaultInjectionTransport,
    )

    config = ServeConfig.from_env({**UPSTREAM, **extra})
    server = serve_main.build_server(None, None, config, device="cpu")
    try:
        chat, score = server.chat_routes.routes["/chat/completions"], \
            server.score_client
        policy = server.resilience
        assert (policy is None) == (not extra)
        assert score.resilience is policy
        assert chat[1].__self__.resilience is policy
        transport = chat[1].__self__.transport
        assert isinstance(transport, FaultInjectionTransport) == bool(extra)
        assert (score.bias_plan is None) == (not extra)
        assert server.chat_routes.host_fastpath == bool(extra)
        snap = server.metrics.snapshot()
        assert ("resilience" in snap) == bool(extra)
        # MEMGUARD is on by default: its thread runs until close
        assert (server.memguard is None) == bool(extra)
        assert ("memguard" in snap) == (not extra)
        if server.memguard is not None:
            assert server.memguard._thread.is_alive()
            assert server.admission.mem_gate == server.memguard.gate
        if policy is not None:
            assert snap["resilience"]["fault_plan"] == {
                "requests": 0, "injected": {}}
            assert policy.deadline_ms == 5000.0
    finally:
        server.close()
    if server.memguard is not None:
        assert server.memguard._thread is None


def test_dotenv_is_loaded_and_set_variables_win(tmp_path, monkeypatch):
    from llm_weighted_consensus_tpu.serve.config import (
        load_dotenv as ref_load_dotenv,
    )
    from llm_weighted_consensus_tpu_torch.serve.config import load_dotenv

    text = ("# comment\nexport A_LWC_X=1\nA_LWC_Y='two words'\n"
            "A_LWC_Z=3 # trailing\nA_LWC_SET=file\nnot a pair\n")
    (tmp_path / ".env").write_text(text)
    got = {}
    for loader in (ref_load_dotenv, load_dotenv):
        for name in ("A_LWC_X", "A_LWC_Y", "A_LWC_Z"):
            monkeypatch.delenv(name, raising=False)
        monkeypatch.setenv("A_LWC_SET", "env")
        loader(str(tmp_path / ".env"))
        got[loader] = {n: os.environ.get(n) for n in (
            "A_LWC_X", "A_LWC_Y", "A_LWC_Z", "A_LWC_SET")}
    assert got[load_dotenv] == got[ref_load_dotenv] == {
        "A_LWC_X": "1", "A_LWC_Y": "two words", "A_LWC_Z": "3",
        "A_LWC_SET": "env"}


def test_known_prom_families_hold_the_exposition_both_ways():
    """``serve/metrics.py`` declares every family the exposition emits
    (``KNOWN_PROM_FAMILIES``, the reference's registry with the port's
    own families): LWC012 holds the declaration against every
    ``prom_family`` call both ways, a live server's exposition names only
    declared families, and the reference's families keep their names (the
    fleet's wait for the fleet tier)."""
    from llm_weighted_consensus_tpu.serve.metrics import (
        KNOWN_PROM_FAMILIES as REF_FAMILIES,
    )
    from llm_weighted_consensus_tpu_torch.analysis import run_lint
    from llm_weighted_consensus_tpu_torch.analysis.rules import RULES_BY_NAME
    from llm_weighted_consensus_tpu_torch.serve import metrics as port_metrics

    families = port_metrics.KNOWN_PROM_FAMILIES
    assert len(set(families)) == len(families)
    assert run_lint(rules=[RULES_BY_NAME["LWC012"]]) == []
    config = ServeConfig.from_env({
        **UPSTREAM, "MEMGUARD": "1", "WEIGHTS_ENABLED": "1",
        "ADMISSION_MAX_INFLIGHT": "4", "DEVICE_WATCHDOG_MILLIS": "5000",
        "LEDGER_RING": "8"})
    with serve_main.build_server(None, None, config, device="cpu") as server:
        text = port_metrics.render_prometheus(server.metrics)
    exposed = {line.split()[2] for line in text.splitlines()
               if line.startswith("# TYPE ")}
    assert "lwc_uptime_seconds" in exposed
    assert exposed <= set(families), exposed - set(families)
    assert set(REF_FAMILIES) - set(families) == {
        "lwc_fleet_peer_fetches", "lwc_fleet_leases", "lwc_fleet_disruptions"}
