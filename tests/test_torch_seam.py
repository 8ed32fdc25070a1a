"""The port's dispatch seam, graph table bookkeeping and replay-aware
launch counters on the CPU, against the JAX package's seam.

``drain_sink`` runs on fake ``wait`` callables and a scripted clock in
both packages: the same device times, intervals and buffer releases, in
the same order.  On the CPU no CUDA graph is captured: warmup records
the reference's AOT keys, and the counters are held.  Exact equality
throughout (bookkeeping); the embedder's deferred results equal its
direct ones exactly (the same forward on the same inputs).
"""

import numpy as np
import pytest
import torch

from llm_weighted_consensus_tpu.models import dispatch_seam as ref_seam
from llm_weighted_consensus_tpu.obs import phases as ref_phases
from llm_weighted_consensus_tpu_torch.models import bert, configs
from llm_weighted_consensus_tpu_torch.models import dispatch_seam as seam
from llm_weighted_consensus_tpu_torch.models.embedder import TorchEmbedder
from llm_weighted_consensus_tpu_torch.models.graphs import Dispatch, GraphTable
from llm_weighted_consensus_tpu_torch.obs import phases
from llm_weighted_consensus_tpu_torch.ops import launches


def _drain(mod, waits, clock_values, raise_at=None):
    """Run ``mod.drain_sink`` over records with fake waits; -> what it
    observed, released and waited on."""
    clock = iter(clock_values).__next__
    log = {"device": [], "interval": [], "released": [], "waited": []}

    def wait_for(i):
        def wait(out):
            log["waited"].append(out)
            if i == raise_at:
                raise RuntimeError("device fault")
        return wait

    sink = mod.DispatchSink()
    for i, (label, t0, timed) in enumerate(waits):
        sink.add(mod.PendingDispatch(label, t0, f"out{i}", wait_for(i),
                                     timed=timed))
    sink.staged.extend(["buf0", "buf1"])
    try:
        mod.drain_sink(
            sink,
            observe_device=lambda label, ms: log["device"].append((label, ms)),
            observe_interval=lambda a, b: log["interval"].append((a, b)),
            release=log["released"].append,
            clock=clock,
        )
    except RuntimeError:
        log["raised"] = True
    log["left"] = list(sink.staged)
    return log


@pytest.mark.parametrize("raise_at", [None, 1])
def test_drain_sink_matches_the_reference(raise_at):
    waits = [("vote1(n=8,s=16)", 1.0, True), ("embed(b=16,s=16)", 1.5, False),
             ("many(r=4,n=8,s=16)", 2.0, True)]
    clock = [2.25, 3.0, 4.125]
    got = _drain(seam, waits, clock, raise_at)
    want = _drain(ref_seam, waits, clock, raise_at)
    assert got == want
    if raise_at is None:
        assert got["device"] == [("vote1(n=8,s=16)", 1250.0),
                                 ("many(r=4,n=8,s=16)", 2125.0)]
        assert got["released"] == ["buf0", "buf1"] and got["left"] == []
    else:
        assert got["released"] == [] and got["left"] == ["buf0", "buf1"]


def test_the_overlap_gauge_matches_the_reference():
    intervals = [(0.0, 1.0), (0.5, 1.5), (3.0, 4.0)]
    device = [("a", 2.0), ("b", 5.0), ("a", 3.0)]
    out = []
    for mod in (phases, ref_phases):
        agg = mod.PhaseAggregator()
        for start, end in intervals:
            agg.observe_device_interval(start, end)
        for bucket, ms in device:
            agg.observe_device(bucket, ms)
        agg.observe_phase("batcher_queue", 7.0)
        out.append((agg.snapshot(), agg.device_snapshot()))
    assert out[0] == out[1]
    assert out[0][0]["overlap"] == 0.625


def test_deferred_readiness_scopes_a_sink_to_its_thread():
    assert seam.active_sink() is None
    outer, inner = seam.DispatchSink(), seam.DispatchSink()
    with seam.deferred_readiness(outer):
        assert seam.active_sink() is outer
        with seam.deferred_readiness(None):
            assert seam.active_sink() is None
        with seam.deferred_readiness(inner):
            assert seam.active_sink() is inner
        assert seam.active_sink() is outer
    assert seam.active_sink() is None


def test_staging_pool_recycles_per_bucket_like_the_reference():
    port, ref = seam.StagingPool(per_bucket=1), ref_seam.StagingPool(1)
    a = port.acquire((4, 16), torch.int32)
    ra = ref.acquire((4, 16), np.int32)
    assert a.shape == (4, 16) and a.dtype == torch.int32 and not a.is_pinned()
    b = port.acquire((4, 16), torch.int32)
    rb = ref.acquire((4, 16), np.int32)
    port.release(a)
    port.release(b)  # past per_bucket: dropped
    ref.release(ra)
    ref.release(rb)
    assert port.acquire((4, 16), torch.int32) is a
    ref.acquire((4, 16), np.int32)
    assert port.acquire((2, 16), torch.int32) is not a
    ref.acquire((2, 16), np.int32)
    got, want = port.stats(), ref.stats()
    assert got.pop("pinned") is False
    assert got == want == {"per_bucket": 1, "hits": 1, "misses": 3,
                           "buckets": 1}
    off = seam.StagingPool(per_bucket=0)
    buf = off.acquire((2,), torch.float32)
    off.release(buf)
    assert not off.enabled and off.acquire((2,), torch.float32) is not buf


def test_launch_counters_note_captures_and_add_replays():
    def wrapper():
        pass

    wrapper.launches = 0
    wrapper.routes = {"tma": 0, "mma": 0}
    launches.count(wrapper, "tma")
    with launches.recording() as noted:
        launches.count(wrapper, "tma")
        launches.count(wrapper, "tma")
        launches.count(wrapper, "mma")
    # noted at capture, nothing counted
    assert wrapper.launches == 1 and wrapper.routes == {"tma": 1, "mma": 0}
    for _ in range(3):
        launches.replayed(noted)
    assert wrapper.launches == 1 + 3 * 3
    assert wrapper.routes == {"tma": 1 + 3 * 2, "mma": 3}


@pytest.fixture(scope="module")
def tiny():
    return TorchEmbedder(
        "test-tiny",
        model=bert.init_params(configs.TEST_TINY, seed=2, device="cpu"),
        max_tokens=32, device="cpu",
    )


def _fresh(emb):
    return TorchEmbedder("test-tiny", model=emb.model, max_tokens=32,
                         device="cpu")


def test_warmup_records_the_reference_keys_and_captures_nothing(tiny):
    emb = _fresh(tiny)
    timings = emb.warmup([(3, 20), (5, 16)], [1, 2, 4],
                         [(1, 64, 8), (2, 64, 8)])
    keys = [label for label, _ in timings]
    # S snaps to the seq bucket; R=1 is the single-request forward; the
    # embed forward pads to 16 rows; per spec vote1, embed, then many
    assert keys == [
        "vote1(3,32)", "embed(16,32)", "many(2,3,32)", "many(4,3,32)",
        "vote1(5,16)", "embed(16,16)", "many(2,5,16)", "many(4,5,16)",
        "packed(1,64,8)", "packed(2,64,8)",
    ]
    stats = emb.graph_stats()
    assert stats["graphs"] == len(keys) and stats["captures"] == 0
    assert stats["pool_bytes"] == 0 and sorted(keys) == stats["keys"]
    # warming again adds nothing
    assert emb.warmup([(3, 20)], [2]) == []


def test_dispatches_count_eager_only_at_buckets_not_warmed(tiny):
    emb = _fresh(tiny)
    ids, mask = emb.tokenize(["a b c", "a b d", "e f"])
    emb.warmup([(3, ids.shape[1])])
    emb.consensus_confidence_tokens(ids, mask)
    emb.embed_tokens(ids, mask)
    assert emb.graph_stats()["eager_dispatches"] == 0
    emb.consensus_confidence_tokens_many(ids[None], mask[None])  # R=1 many
    emb.embed_tokens(ids[:2, :8], mask[:2, :8])
    stats = emb.graph_stats()
    assert stats["eager_dispatches"] == 2
    assert stats["replays"] == stats["captures"] == 0


def test_a_deferred_dispatch_equals_the_direct_one(tiny):
    emb = _fresh(tiny)
    ids, mask = emb.tokenize(["alpha beta", "beta gamma", "delta"])
    direct = emb.consensus_confidence_tokens(ids, mask, 0.3)
    sink = seam.DispatchSink()
    with seam.deferred_readiness(sink):
        handle = emb.consensus_confidence_tokens(ids, mask, 0.3)
    assert isinstance(handle, Dispatch) and len(sink.pending) == 1
    assert sink.pending[0].label == f"vote1(n=3,s={ids.shape[1]})"
    assert len(sink.staged) == 2  # ids and mask, back to the pool later
    seam.drain_sink(sink, release=emb.staging_pool.release)
    np.testing.assert_array_equal(handle.result(), direct)
    assert emb.staging_pool.stats()["hits"] >= 0


def test_a_direct_dispatch_records_its_device_time(tiny):
    emb = _fresh(tiny)
    ids, mask = emb.tokenize(["one two", "three"])
    phases.reset_phases()
    emb.embed_tokens(ids, mask)
    emb.device_timing = False
    emb.embed_tokens(ids, mask)
    snap = phases.aggregator().device_snapshot()
    assert list(snap) == [f"embed(b=16,s={ids.shape[1]})"]
    assert snap[f"embed(b=16,s={ids.shape[1]})"]["count"] == 1


def test_graph_table_on_the_cpu_keeps_keys_only():
    table = GraphTable("cpu")
    calls = []

    def forward(ids):
        calls.append(ids.clone())
        return ids.float() * 2

    assert table.warm(("embed", 2, 4), {"ids": np.zeros((2, 4), np.int32)},
                      forward)
    assert not table.warm(("embed", 2, 4), {}, forward)
    assert calls == []  # nothing runs, nothing is captured on the CPU
    pool = seam.StagingPool()
    arr = np.arange(8, dtype=np.int32).reshape(2, 4)
    out = table.dispatch(("embed", 2, 4), "embed", {"ids": arr}, forward,
                         lambda t: t + 1, pool)
    np.testing.assert_array_equal(out, arr * 2 + 1)
    table.dispatch(("embed", 1, 4), "embed", {"ids": arr[:1]}, forward,
                   lambda t: t, pool)
    stats = table.stats()
    assert (stats["eager_dispatches"], stats["replays"], stats["graphs"]) == (
        1, 0, 1)


def test_reranker_warmup_keys_its_serving_buckets():
    from llm_weighted_consensus_tpu_torch.models import deberta
    from llm_weighted_consensus_tpu_torch.models.reranker import TorchReranker

    cfg = configs.DEBERTA_TEST_TINY
    rr = TorchReranker("deberta-test-tiny", device="cpu", max_tokens=64,
                       model=deberta.init_params(cfg, seed=1, device="cpu"))
    texts = ["one two three", "four five", "six"]
    ids, mask = rr.tokenize(texts)
    timings = rr.warmup([(3, 10), (2, 100)])
    assert [label for label, _ in timings] == [
        f"rm(3,{ids.shape[1]})", "rm(2,64)"]  # S capped at max_tokens
    conf = rr.confidence_tokens(ids, mask, 0.5)
    assert conf.shape == (3,) and abs(conf.sum() - 1) < 1e-6
    stats = rr.graph_stats()
    assert stats["eager_dispatches"] == 0 and stats["captures"] == 0
    rr.confidence_tokens(ids[:2], mask[:2])
    assert rr.graph_stats()["eager_dispatches"] == 1
