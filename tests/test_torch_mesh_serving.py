"""The port's mesh serving path under its ``DeviceBatcher`` on the CPU:
the counterpart of ``tests/test_mesh_serving.py``.

Both packages serve the committed ``tests/fixtures/bge_micro`` snapshot
in f32: the reference through its batcher on a ``shard_embedder_mesh``
embedder over the conftest's virtual CPU devices, the port through its
own on ``[torch.device("cpu")] * 8``.  Answers agree within 1e-5 on the
padded, packed and int8 paths, and with the port's one-device answers;
the graph keys are namespaced per mesh shape; the per-item contracts
(deadline 504, the watchdog, the drain) hold on a mesh; the knobs are off
by default; ``build_embedder`` builds the mesh from ``MESH_*``; the
server's ``/metrics`` counts the mesh; over-length requests on an sp mesh
ride the ring; and a dispatch span carries its ``mesh_epoch``.
"""

import asyncio
import dataclasses
import json
import os
import urllib.request

import jax
import numpy as np
import pytest
import torch

from llm_weighted_consensus_tpu.models import configs as jax_configs
from llm_weighted_consensus_tpu.models import loading as jax_loading
from llm_weighted_consensus_tpu.models import tokenizer as jax_tokenizer
from llm_weighted_consensus_tpu.models.embedder import TpuEmbedder
from llm_weighted_consensus_tpu.parallel.mesh import make_mesh as jax_mesh
from llm_weighted_consensus_tpu.parallel.sharding import (
    shard_embedder_mesh as jax_shard,
)
from llm_weighted_consensus_tpu.serve.batcher import (
    DeviceBatcher as RefBatcher,
)
from llm_weighted_consensus_tpu.serve.config import Config as RefConfig
from llm_weighted_consensus_tpu.serve.metrics import Metrics as RefMetrics
from llm_weighted_consensus_tpu_torch.errors import DeadlineExceededError
from llm_weighted_consensus_tpu_torch.models import (
    bert,
    configs,
    convert,
    loading,
    tokenizer,
)
from llm_weighted_consensus_tpu_torch.models.embedder import TorchEmbedder
from llm_weighted_consensus_tpu_torch.parallel.mesh import make_mesh
from llm_weighted_consensus_tpu_torch.parallel.sharding import (
    shard_embedder_mesh,
)
from llm_weighted_consensus_tpu_torch.resilience.deadline import Deadline
from llm_weighted_consensus_tpu_torch.resilience.watchdog import (
    DeviceWatchdog,
)
from llm_weighted_consensus_tpu_torch.serve.batcher import DeviceBatcher
from llm_weighted_consensus_tpu_torch.serve.config import ServeConfig
from llm_weighted_consensus_tpu_torch.serve.metrics import Metrics

CPU = torch.device("cpu")
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "bge_micro")
TOL = 1e-5
DP, TP = 4, 2
CONS = [
    ["paris is the capital of france", "the capital of france is paris",
     "paris, france's capital city", "bananas are curved and yellow",
     "the capital city of france is paris, on the seine"],
    ["paris", "lyon is a city", "marseille on the sea", "paris again",
     "nice"],
    ["one answer", "another answer here", "a third one", "four", "five"],
]
ODD = ["a short one", "a much longer candidate answer about rivers", "b"]
EMBEDS = [["alpha beta gamma", "delta"], ["epsilon zeta eta theta iota"]]
PACKED = dict(packing=True, packing_row_tokens=64, packing_max_rows=4,
              packing_max_segments=8)


@pytest.fixture(scope="module")
def micro():
    port_cfg = loading.load_hf_config(FIXTURE)
    jax_cfg = jax_configs.BertConfig(
        **{f.name: getattr(port_cfg, f.name)
           for f in dataclasses.fields(port_cfg)})
    params = jax_loading.load_params(FIXTURE, jax_cfg)
    vocab = loading.find_vocab(FIXTURE)
    return port_cfg, jax_cfg, params, vocab


def ref_embedder(micro, dp=DP, tp=TP, quantize="none"):
    _, jax_cfg, params, vocab = micro
    ref = TpuEmbedder("bge-micro", params=params, config=jax_cfg,
                      tokenizer=jax_tokenizer.load_tokenizer(vocab),
                      max_tokens=64, quantize=quantize)
    jax_shard(ref, jax_mesh(dp=dp, tp=tp))
    return ref


def port_embedder(micro, dp=DP, tp=TP, quantize="none"):
    port_cfg, _, params, vocab = micro
    state = convert.from_jax_params(
        jax.tree_util.tree_map(np.asarray, params), port_cfg)
    emb = TorchEmbedder(
        "bge-micro", model=bert.from_hf_state_dict(state, port_cfg,
                                                   device="cpu"),
        config=port_cfg, tokenizer=tokenizer.load_tokenizer(vocab),
        max_tokens=64, device="cpu", quantize=quantize)
    if dp or tp:
        shard_embedder_mesh(emb, make_mesh(dp=dp, tp=tp, devices=[CPU] * 8))
    return emb


def ref_run(ref, **options):
    batcher = RefBatcher(ref, RefMetrics(), window_ms=200.0, **options)

    async def run():
        return await asyncio.gather(
            *(batcher.consensus(texts, 0.05) for texts in CONS),
            batcher.consensus(ODD, 0.3),
            *(batcher.embed(texts) for texts in EMBEDS),
        )

    return asyncio.run(run())


def port_run(port, metrics=None, **options):
    with DeviceBatcher(port, metrics or Metrics(), window_ms=200.0,
                       **options) as b:
        futures = [b.submit_consensus(texts, 0.05) for texts in CONS]
        futures.append(b.submit_consensus(ODD, 0.3))
        futures += [b.submit_embed(texts) for texts in EMBEDS]
        return [f.result(120) for f in futures]


def same(got, want):
    for (a, tok_a), (b, tok_b) in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=TOL)
        assert np.sum(tok_a) == np.sum(tok_b)


@pytest.mark.parametrize("options", [{}, PACKED], ids=["padded", "packed"])
def test_mesh_batcher_matches_the_reference_and_one_device(micro, options):
    port = port_embedder(micro)
    assert port.supports_packing()
    metrics = Metrics()
    got = port_run(port, metrics, **options)
    same(got, ref_run(ref_embedder(micro), **options))
    same(got, port_run(port_embedder(micro, dp=0, tp=0), **options))
    series = metrics.snapshot()["series"]
    if not options:
        # same-shape consensus requests still coalesce into one dispatch
        assert series["device:batch:consensus"]["count"] == 2


def test_mesh_batcher_int8_matches_the_reference(micro):
    port = port_embedder(micro, dp=2, tp=2, quantize="int8-pallas")
    got = port_run(port)
    same(got, ref_run(ref_embedder(micro, dp=2, tp=2,
                                   quantize="int8-pallas")))
    same(got, port_run(port_embedder(micro, dp=0, tp=0,
                                     quantize="int8-pallas")))


def test_mesh_warmup_keys_per_mesh_shape(micro):
    port = port_embedder(micro, dp=4, tp=2)
    s = port.tokenize(CONS[0])[0].shape[1]
    port.warmup([(5, s)], r_buckets=[2], packed_buckets=[(3, 64, 8)])
    keys = port.graph_stats()["keys"]
    assert keys == sorted([
        f"mesh(4,2,vote1,5,{s})", f"mesh(4,2,embed,16,{s})",
        f"mesh(4,2,many,2,5,{s})", "mesh(4,2,packed,4,64,8)",
    ])
    before = port.graph_stats()
    port.consensus_confidence(CONS[0])
    after = port.graph_stats()
    # a warmed bucket (on the CPU: a recorded key) is no eager dispatch
    assert after["eager_dispatches"] == before["eager_dispatches"]
    assert port.mesh_stats()["aot_buckets"] == 4
    one = port_embedder(micro, dp=0, tp=0)
    one.warmup([(5, s)])
    assert f"vote1(5,{s})" in one.graph_stats()["keys"]
    assert port.label_suffix == "@dp4xtp2" and one.label_suffix == ""


def test_legacy_hooks_warm_by_dispatch_and_do_not_pack(micro):
    from llm_weighted_consensus_tpu_torch.parallel.sharding import (
        shard_embedder,
    )

    emb = port_embedder(micro, dp=0, tp=0)
    shard_embedder(emb, make_mesh(dp=2, tp=2, devices=[CPU] * 4), tp=True)
    timings = emb.warmup([(3, 16)])
    assert [label for label, _ in timings] == ["dispatch vote1(3,16)"]
    assert emb.graph_stats()["graphs"] == 0 and not emb.supports_packing()


def test_mesh_deadline_shed_before_dispatch_is_504(micro):
    metrics = Metrics()
    with DeviceBatcher(port_embedder(micro), metrics,
                       window_ms=20.0) as batcher:
        token = Deadline(0.0005).activate()
        try:
            with pytest.raises(DeadlineExceededError) as ei:
                batcher.embed(["too late"])
            assert ei.value.status() == 504
        finally:
            Deadline.deactivate(token)
        emb, tokens = batcher.embed(["in time"])
        assert emb.shape[0] == 1 and tokens > 0
        assert batcher.shed_deadline == 1
    assert metrics.snapshot()["series"]["device:shed:deadline"]["errors"] == 1


def test_mesh_watchdog_brackets_dispatches(micro):
    wd = DeviceWatchdog(60_000.0)  # generous: must never trip here
    with DeviceBatcher(port_embedder(micro), window_ms=5.0,
                       watchdog=wd) as batcher:
        batcher.embed(["one"])
        batcher.consensus(CONS[0])
    snap = wd.snapshot()
    assert snap["dispatches"] == 2 and snap["healthy"]
    assert snap["active_dispatches"] == 0


def test_mesh_drain_waits_for_queued_work(micro):
    with DeviceBatcher(port_embedder(micro), window_ms=10.0) as batcher:
        assert batcher.idle()
        future = batcher.submit_embed(["queued"])
        assert not batcher.idle()
        assert batcher.drain(5.0) is True
        assert batcher.idle()
        assert future.result(1)[0].shape[0] == 1


def test_mesh_config_off_by_default(micro):
    for config in (ServeConfig.from_env({}), RefConfig.from_env({})):
        assert config.mesh_enabled is False and config.mesh_shape is None
    emb = port_embedder(micro, dp=0, tp=0)
    assert emb.mesh_mode is False and emb.mesh is None
    assert emb._key(("vote1", 5, 32)) == ("vote1", 5, 32)
    assert emb.batch_multiple == 1 and not emb.ring_available()


def test_mesh_config_parses_and_validates():
    config = ServeConfig.from_env({"MESH_ENABLED": "1", "MESH_SHAPE": "4x2"})
    assert config.mesh_enabled and config.mesh_shape == (4, 2)
    with pytest.raises(ValueError, match="MESH_ENABLED is not"):
        ServeConfig.from_env({"MESH_SHAPE": "4x2"})
    with pytest.raises(ValueError, match="mutually exclusive"):
        ServeConfig.from_env({"MESH_ENABLED": "1", "MESH_DP": "2"})
    with pytest.raises(ValueError, match="DPxTP"):
        ServeConfig.from_env({"MESH_ENABLED": "1", "MESH_SHAPE": "4x0"})


ENV = {"EMBEDDER_MODEL": "test-tiny", "EMBEDDER_MAX_TOKENS": "64",
       "LWC_ALLOW_RANDOM_PARAMS": "1"}


@pytest.mark.parametrize("shape,legacy", [
    ("4x2", {}), ("2x1x2", {}), (None, {}),
    (None, {"MESH_DP": "2", "MESH_TP": "2"}),
])
def test_build_embedder_round_trips(shape, legacy):
    from llm_weighted_consensus_tpu_torch.serve.__main__ import build_embedder

    env = dict(ENV, **legacy)
    if not legacy:
        env["MESH_ENABLED"] = "1"
    if shape:
        env["MESH_SHAPE"] = shape
    ServeConfig.from_env(env)
    emb = build_embedder(env, device="cpu", mesh_devices=[CPU] * 8)
    want = {"4x2": (4, 2), "2x1x2": (2, 1), None: (8, 1)}[shape]
    if legacy:
        want = (2, 2)
    assert emb.mesh_shape == want and emb.mesh_mode is not bool(legacy)
    assert emb.ring_available() is (shape == "2x1x2")
    out = emb.embed_texts(["mesh round trip"])
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, atol=1e-5)
    # the server never builds a list that repeats a device: on the CPU
    # the mesh is one device
    if shape == "4x2":
        with pytest.raises(ValueError, match="mesh 4x2 needs 8 devices"):
            build_embedder(env, device="cpu")


def test_the_server_reports_and_serves_its_mesh(micro):
    from llm_weighted_consensus_tpu_torch.serve.__main__ import (
        build_embedder,
        build_server,
    )

    env = dict(ENV, MESH_ENABLED="1", MESH_SHAPE="2x2")
    config = ServeConfig.from_env(env)
    emb = build_embedder(env, device="cpu", mesh_devices=[CPU] * 4)
    server = build_server(emb, None, config, port=0, device="cpu")
    with server:
        server.warmup([(3, 16)])
        body = json.dumps({"input": ["a", "b", "c"]}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/consensus", body,
            {"content-type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            conf = json.loads(resp.read())["confidence"]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{server.port}/metrics", timeout=60) as r:
            mesh = json.loads(r.read())["mesh"]
    assert len(conf) == 3 and abs(sum(conf) - 1.0) < 1e-5
    assert mesh["dp"] == 2 and mesh["tp"] == 2 and mesh["devices"] == 4
    assert mesh["aot_buckets"] == 2 and emb.label_suffix == "@dp2xtp2"


def test_over_length_requests_ride_the_ring():
    """On an sp mesh the batcher routes a text past the dense window to
    the ring dispatch (full length) and keeps short ones dense."""
    cfg = dataclasses.replace(configs.TEST_TINY, max_position_embeddings=256)
    emb = TorchEmbedder("test-tiny", config=cfg, max_tokens=32, seed=5,
                        device="cpu")
    shard_embedder_mesh(emb, make_mesh(dp=2, tp=1, sp=2, devices=[CPU] * 4))
    one = TorchEmbedder("test-tiny", config=cfg, max_tokens=256, seed=5,
                        device="cpu")
    long = ["word " * 100, "another long answer " * 20]
    with DeviceBatcher(emb, window_ms=5.0) as batcher:
        vecs, tokens = batcher.embed(long)
        conf, _ = batcher.consensus(long + ["short"])
        short, _ = batcher.consensus(["a", "b"])
        stats = batcher.stats()
    ids, mask = emb.tokenize_ring(long)
    assert np.sum(tokens) == mask.sum() > 2 * emb.max_tokens
    np.testing.assert_allclose(vecs, one.embed_tokens(ids, mask),
                               atol=1e-4)
    ids, mask = emb.tokenize_ring(long + ["short"])
    np.testing.assert_allclose(
        conf, one.consensus_confidence_tokens(ids, mask, 0.05), atol=1e-4)
    assert stats["dispatches"]["ring_embed"] == 1
    assert stats["dispatches"]["ring_vote"] == 1
    assert stats["dispatches"]["consensus"] == 1 and len(short) == 2


def test_the_dispatch_span_carries_the_mesh_epoch(micro):
    from llm_weighted_consensus_tpu_torch.obs.span import Span, start_trace
    from llm_weighted_consensus_tpu_torch.resilience import MeshFaultManager

    emb = port_embedder(micro, dp=1, tp=1)
    mgr = MeshFaultManager(emb)
    root = start_trace("mesh-epoch", sampled=True)
    with DeviceBatcher(emb, window_ms=5.0, meshfault=mgr) as batcher:
        token = root.activate()
        try:
            batcher.consensus(CONS[0])
        finally:
            Span.deactivate(token)
    spans = [s for s in root.trace.spans if s.name == "device:dispatch"]
    assert spans and spans[0].attributes["mesh_epoch"] == mgr.epoch == 0
