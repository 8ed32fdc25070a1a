"""The port's full ``DeviceBatcher`` on the CPU against the JAX package's.

Both batchers serve the committed ``tests/fixtures/bge_micro`` snapshot
(the JAX package's loader, carried to the port by
``convert.from_jax_params``) in f32; the reference runs under
``asyncio.run``, with its Pallas vote in interpret mode.  Confidences
and embeddings agree within 1e-5, token counts and the grouping
counters exactly, and ``utilization()`` has the reference's keys.  The
overload paths (the queue bound's 503, the deadline shed's 504, a
cancelled caller's item dropped before dispatch, the drain) behave as
``tests/test_batcher.py`` pins them for the reference.
"""

import asyncio
import dataclasses
import json
import os
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from llm_weighted_consensus_tpu.models import configs as jax_configs
from llm_weighted_consensus_tpu.models import loading as jax_loading
from llm_weighted_consensus_tpu.models import tokenizer as jax_tokenizer
from llm_weighted_consensus_tpu.models.embedder import TpuEmbedder
from llm_weighted_consensus_tpu.serve.batcher import (
    DeviceBatcher as RefBatcher,
)
from llm_weighted_consensus_tpu.serve.metrics import Metrics as RefMetrics
from llm_weighted_consensus_tpu_torch.errors import (
    DeadlineExceededError,
    OverloadedError,
)
from llm_weighted_consensus_tpu_torch.models import (
    bert,
    convert,
    loading,
    tokenizer,
)
from llm_weighted_consensus_tpu_torch.models.embedder import TorchEmbedder
from llm_weighted_consensus_tpu_torch.resilience.deadline import Deadline
from llm_weighted_consensus_tpu_torch.resilience.watchdog import (
    DeviceWatchdog,
)
from llm_weighted_consensus_tpu_torch.serve.batcher import DeviceBatcher
from llm_weighted_consensus_tpu_torch.serve.gateway import Server
from llm_weighted_consensus_tpu_torch.serve.metrics import Metrics

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "bge_micro")
TOL = 1e-5
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


@pytest.fixture(scope="module")
def micro():
    port_cfg = loading.load_hf_config(FIXTURE)
    jax_cfg = jax_configs.BertConfig(
        **{f.name: getattr(port_cfg, f.name)
           for f in dataclasses.fields(port_cfg)}
    )
    params = jax_loading.load_params(FIXTURE, jax_cfg)
    state = convert.from_jax_params(
        jax.tree_util.tree_map(np.asarray, params), port_cfg
    )
    vocab = loading.find_vocab(FIXTURE)
    ref = TpuEmbedder("bge-micro", params=params, config=jax_cfg,
                      tokenizer=jax_tokenizer.load_tokenizer(vocab),
                      max_tokens=64)
    port = TorchEmbedder(
        "bge-micro", model=bert.from_hf_state_dict(state, port_cfg,
                                                   device="cpu"),
        config=port_cfg, tokenizer=tokenizer.load_tokenizer(vocab),
        max_tokens=64, device="cpu",
    )
    return ref, port


def _ref_run(ref, **options):
    batcher = RefBatcher(ref, RefMetrics(), window_ms=200.0, **options)

    async def run():
        return await asyncio.gather(
            *(batcher.consensus(texts, 0.05) for texts in CONS),
            batcher.consensus(ODD, 0.3),
            *(batcher.embed(texts) for texts in EMBEDS),
        )

    return asyncio.run(run()), batcher.utilization()


def _port_run(port, **options):
    with DeviceBatcher(port, Metrics(), window_ms=200.0, **options) as b:
        futures = [b.submit_consensus(texts, 0.05) for texts in CONS]
        futures.append(b.submit_consensus(ODD, 0.3))
        futures += [b.submit_embed(texts) for texts in EMBEDS]
        results = [f.result(120) for f in futures]
        return results, b.utilization()


def _keys(d, prefix=""):
    """Every key path of a nested dict (not into the staging pool's
    stats, whose port version adds ``pinned``)."""
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict) and k != "staging":
            out |= _keys(v, prefix + k + ".")
    return out


@pytest.mark.parametrize("packing", [False, True])
def test_batcher_matches_the_reference_on_bge_micro(micro, packing):
    ref, port = micro
    options = dict(packing=packing, packing_row_tokens=64,
                   packing_max_rows=4, packing_max_segments=8)
    want, ref_util = _ref_run(ref, **options)
    got, util = _port_run(port, **options)
    n_cons = len(CONS) + 1
    for (conf, tok), (w_conf, w_tok) in zip(got[:n_cons], want[:n_cons]):
        assert conf.shape == np.asarray(w_conf).shape
        np.testing.assert_allclose(conf, np.asarray(w_conf), atol=TOL)
        assert tok == int(w_tok)
    for (emb, tok), (w_emb, w_tok) in zip(got[n_cons:], want[n_cons:]):
        np.testing.assert_allclose(emb, np.asarray(w_emb), atol=TOL)
        assert tok == int(w_tok)
    assert _keys(util) == _keys(ref_util)
    for key in ("dispatches", "items", "items_per_dispatch", "padded",
                "packing", "max_batch", "window_ms", "queue_depth"):
        assert util[key] == ref_util[key], key
    assert util["lanes"]["latency"]["items"] == len(got)
    # one grouped consensus dispatch (R=3), one single, one embed group
    assert util["dispatches"] == (1 if packing else 3)


def test_queue_bound_fails_fast_with_overloaded(micro):
    _, port = micro
    metrics = Metrics()
    with DeviceBatcher(port, metrics, window_ms=300.0,
                       max_queue_depth=2) as batcher:
        t1, t2 = batcher.submit_embed(["a"]), batcher.submit_embed(["b"])
        with pytest.raises(OverloadedError) as ei:
            batcher.embed(["c"])
        assert ei.value.shed_reason == "batcher_queue_full"
        assert ei.value.status() == 503
        # queued work is unaffected by the shed
        assert t1.result(60)[0].shape[0] == 1
        assert t2.result(60)[0].shape[0] == 1
        util = batcher.utilization()
    assert util["shed_queue_full"] == 1 and util["max_queue_depth"] == 2
    assert metrics.snapshot()["series"]["device:shed:queue_full"]["errors"] == 1


def test_deadline_shed_before_dispatch_is_504(micro):
    _, port = micro
    metrics = Metrics()
    with DeviceBatcher(port, metrics, window_ms=20.0) as batcher:
        token = Deadline(0.0005).activate()  # dead long before the window
        try:
            with pytest.raises(DeadlineExceededError) as ei:
                batcher.embed(["too late"])
            assert ei.value.status() == 504
        finally:
            Deadline.deactivate(token)
        # no deadline active: the same batcher keeps serving
        emb, tokens = batcher.embed(["in time"])
        assert emb.shape[0] == 1 and tokens > 0
        assert batcher.shed_deadline == 1
    assert metrics.snapshot()["series"]["device:shed:deadline"]["errors"] == 1


def test_cancelled_caller_drops_item_before_dispatch(micro):
    _, port = micro
    metrics = Metrics()
    with DeviceBatcher(port, metrics, window_ms=300.0) as batcher:
        future = batcher.submit_embed(["abandoned"])
        time.sleep(0.005)  # submitted, still inside the window
        assert future.cancel()
        assert batcher.drain(5.0)
        assert batcher.cancelled_items == 1
        # the whole group was a cancelled caller: nothing reached the device
        assert batcher.utilization()["dispatches"] == 0
    assert "device:batch:embed" not in metrics.snapshot()["series"]


def test_drain_waits_for_queued_and_inflight_work(micro):
    _, port = micro
    with DeviceBatcher(port, window_ms=10.0) as batcher:
        assert batcher.idle()
        future = batcher.submit_embed(["queued"])
        assert not batcher.idle()
        assert batcher.drain(5.0) is True
        assert batcher.idle()
        assert future.result(1)[0].shape[0] == 1


def test_watchdog_brackets_batcher_dispatches(micro):
    _, port = micro
    wd = DeviceWatchdog(60_000.0)  # generous: must never trip here
    with DeviceBatcher(port, window_ms=5.0, watchdog=wd) as batcher:
        batcher.embed(["one"])
        batcher.consensus(CONS[0])
    snap = wd.snapshot()
    assert snap["dispatches"] == 2 and snap["healthy"]
    assert snap["active_dispatches"] == 0


def test_offline_lane_waits_for_the_latency_lane(micro):
    _, port = micro
    with DeviceBatcher(port, window_ms=200.0, pipeline_depth=1) as batcher:
        t0 = time.perf_counter()
        offline = batcher.submit_embed(["background"], priority="offline")
        latency = batcher.submit_embed(["foreground"])
        done = {}
        for name, fut in (("offline", offline), ("latency", latency)):
            fut.add_done_callback(
                lambda f, name=name: done.setdefault(name, time.perf_counter())
            )
        offline.result(60)
        latency.result(60)
        util = batcher.utilization()
        occupancy = batcher.lane_occupancy("latency", t0)
    assert done["latency"] <= done["offline"]
    assert util["lanes"]["offline"]["items"] == 1
    assert util["lanes"]["latency"]["items"] == 1
    assert 0.0 < occupancy <= 1.0


def test_a_fault_in_the_counting_still_answers_and_frees_the_slot(micro):
    _, port = micro

    class FaultyMetrics(Metrics):
        def observe(self, name, *args, **kwargs):
            if name.startswith("device:batch:"):
                raise RuntimeError("metrics fault")
            return super().observe(name, *args, **kwargs)

    with DeviceBatcher(port, FaultyMetrics(), window_ms=0.0,
                       pipeline_depth=1) as batcher:
        first = batcher.submit_embed(["one"]).result(30)
        # one pipeline slot: a slot left held would stall this dispatch
        second = batcher.submit_embed(["two"]).result(30)
        util = batcher.utilization()
    assert first[0].shape[0] == second[0].shape[0] == 1
    assert util["dispatches"] == 2


def test_pipelined_groups_resolve_in_their_own_futures(micro):
    _, port = micro
    want = [port.consensus_confidence(t) for t in CONS]
    with DeviceBatcher(port, window_ms=0.0, max_batch=1,
                       pipeline_depth=2) as batcher:
        results = [None] * 9

        def call(i):
            results[i] = batcher.consensus(CONS[i % 3])

        threads = [threading.Thread(target=call, args=(i,)) for i in range(9)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        util = batcher.utilization()
    assert util["dispatches"] == 9
    for i, (conf, _) in enumerate(results):
        np.testing.assert_allclose(conf, want[i % 3], atol=1e-6)


def _post(port, path, body, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"content-type": "application/json", **(headers or {})},
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, dict(resp.headers), json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, dict(err.headers), json.loads(err.read())


def test_overload_and_deadline_over_http(micro):
    from llm_weighted_consensus_tpu_torch.resilience.admission import (
        AdmissionConfig,
    )

    _, port = micro
    with Server(port, window_ms=1000.0,
                admission=AdmissionConfig(max_queue_depth=1)) as srv:
        first = {}
        t = threading.Thread(target=lambda: first.setdefault(
            "out", _post(srv.port, "/consensus", {"input": CONS[0]})))
        t.start()
        for _ in range(200):  # wait until it is queued
            if srv.batcher.utilization()["queue_depth"]:
                break
            time.sleep(0.005)
        status, headers, body = _post(srv.port, "/consensus",
                                      {"input": CONS[1]})
        assert status == 503 and headers["Retry-After"] == "1"
        assert body == {"code": 503, "message": {
            "kind": "overloaded", "shed_reason": "batcher_queue_full"}}
        t.join(60)
        assert first["out"][0] == 200
        status, _, body = _post(srv.port, "/consensus", {"input": CONS[2]},
                                {"x-deadline-ms": "0.001"})
        assert status == 504
        assert body["error"]["kind"] == "deadline_exceeded"
        series = srv.metrics.snapshot()["series"]
    assert series["http:/consensus"]["count"] == 3
    assert series["http:/consensus"]["errors"] == 2
