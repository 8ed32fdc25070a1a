"""The host's phases of a ``/consensus`` request (``obs/phases.py``):

* a tiny-bert server's ``stats()["phases"]`` rises by one count per
  request in each phase, the host pool's tokenization and the inline one;
* ``held_idle`` on scripted dispatch intervals: a lone request, two
  requests over one idle gap (each counts it), a dispatch launched and
  not yet ready (busy), a failed one forgotten;
* with no profiler running, the path enters no ``record_function``; with
  one running on another thread (``profile_all_threads``), the server's
  threads leave ``lwc.*`` ranges in its trace;
* the breakdown of a traced request carves the scopes' spans out of the
  phases they run inside;
* the benchmark's four readers of these phases on synthetic readings.
"""

import http.client
import json
import threading
import time

import pytest
import torch

from llm_weighted_consensus_tpu_torch import obs
from llm_weighted_consensus_tpu_torch.models import bert, configs
from llm_weighted_consensus_tpu_torch.models.embedder import TorchEmbedder
from llm_weighted_consensus_tpu_torch.obs import phases
from llm_weighted_consensus_tpu_torch.serve.gateway import Server

from test_torch_obs import build_trace

# each observed once per /consensus request
PER_REQUEST = ("admission_wait", "gateway_read", "tokenize", "batch_window",
               "batcher_queue", "prepare_wait", "launch", "device_dispatch",
               "finalize", "gateway_write", "held_idle")


@pytest.fixture(scope="module")
def tiny():
    return TorchEmbedder(
        "test-tiny",
        model=bert.init_params(configs.TEST_TINY, seed=1, device="cpu"),
        max_tokens=32, device="cpu",
    )


@pytest.fixture(autouse=True)
def _fresh_phases():
    phases.reset_phases()
    yield
    phases.reset_phases()


def consensus(port: int, texts) -> dict:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", "/consensus", body=json.dumps({"input": texts}),
                     headers={"content-type": "application/json"})
        resp = conn.getresponse()
        body = resp.read()
    finally:
        conn.close()
    assert resp.status == 200, body
    return json.loads(body)


def settled_counts(batcher, want: int, names) -> dict:
    """The phases' counts once ``want`` requests are all observed: the
    last byte reaches the client before its handler observes
    ``gateway_write`` and ``held_idle``."""
    end = time.monotonic() + 10
    while True:
        got = batcher.stats()["phases"]
        if all(got[p]["count"] >= want for p in names) or \
                time.monotonic() > end:
            return got
        time.sleep(0.01)


# -- the counters, through the server -----------------------------------------


@pytest.mark.parametrize("pool", [2, 0], ids=["host_pool", "inline"])
def test_each_phase_counts_once_per_consensus_request(tiny, pool):
    names = PER_REQUEST if pool else tuple(
        p for p in PER_REQUEST if p != "prepare_wait")
    with Server(tiny, window_ms=3.0, host_tokenizer_workers=pool) as srv:
        before = srv.batcher.stats()["phases"]
        assert set(before) == set(phases.PHASES)
        for k in range(3):
            consensus(srv.port, [f"a b {k}", "b c", "c d e"])
        after = settled_counts(srv.batcher, 3, names)
    for p in names:
        assert after[p]["count"] - before[p]["count"] == 3, p
        assert after[p]["sum_ms"] > before[p]["sum_ms"], p
    if not pool:
        assert after["prepare_wait"]["count"] == 0
    # the window a lone request sat in is at most the configured one
    assert after["batch_window"]["sum_ms"] / 3 <= 3.0 + 5.0
    # the device's idle time while held is part of the time held
    held = srv.metrics.snapshot()["series"]["http:/consensus"]
    assert after["held_idle"]["sum_ms"] / 3 < 2 * held["p99_ms"]


def test_a_grouped_dispatch_counts_each_item(tiny):
    """Work done once for a group (the launch, the finalize) is observed
    once for each of its items."""
    with Server(tiny, window_ms=200.0) as srv:
        threads = [threading.Thread(target=consensus,
                                    args=(srv.port, [f"x {k}", "y", "z"]))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        after = settled_counts(srv.batcher, 4, PER_REQUEST)
        stats = srv.batcher.stats()
    assert stats["requests"]["consensus"] == 4
    assert stats["dispatches"]["consensus"] < 4
    for p in ("launch", "finalize", "batcher_queue"):
        assert after[p]["count"] == 4, p


# -- held_idle on scripted intervals ------------------------------------------


def test_held_idle_of_a_lone_request():
    agg = phases.PhaseAggregator()
    agg.observe_device_interval(12.0, 17.0)
    assert agg.observe_held_idle(10.0, 20.0) == pytest.approx(5000.0)
    # an interval outside the request's hold is no busy time of it
    agg.observe_device_interval(20.5, 21.0)
    assert agg.observe_held_idle(10.0, 20.0) == pytest.approx(5000.0)
    assert agg.sums()["held_idle"] == {"sum_ms": pytest.approx(10000.0),
                                       "count": 2}


def test_two_requests_over_one_idle_gap_each_count_it():
    agg = phases.PhaseAggregator()
    agg.observe_device_interval(0.0, 4.0)
    agg.observe_device_interval(6.0, 10.0)
    a = agg.observe_held_idle(3.0, 8.0)  # busy 3-4 and 6-8
    b = agg.observe_held_idle(5.0, 7.0)  # busy 6-7
    assert (a, b) == (pytest.approx(2000.0), pytest.approx(1000.0))
    assert agg.sums()["held_idle"]["sum_ms"] == pytest.approx(3000.0)


def test_a_dispatch_in_flight_counts_as_busy():
    agg = phases.PhaseAggregator()
    agg.note_device_launch(2.0)
    assert agg.observe_held_idle(1.0, 5.0) == pytest.approx(1000.0)
    # launched after the request's end: none of its busy time
    agg.note_device_launch(6.0)
    assert agg.observe_held_idle(1.0, 5.0) == pytest.approx(1000.0)
    # ready now: its interval stands for it, and it is no longer in flight
    agg.observe_device_interval(2.0, 3.0)
    agg.observe_device_interval(6.0, 7.0)
    assert agg.observe_held_idle(1.0, 5.0) == pytest.approx(3000.0)
    # a failed dispatch is forgotten, not left busy for ever
    agg.note_device_launch(8.0)
    agg.forget_device_launch(8.0)
    assert agg.observe_held_idle(8.0, 9.0) == pytest.approx(1000.0)


def test_two_dispatches_launched_at_once_land_one_by_one():
    agg = phases.PhaseAggregator()
    agg.note_device_launch(1.0)
    agg.note_device_launch(1.0)
    agg.observe_device_interval(1.0, 2.0)
    # the other one is still in flight over the whole hold
    assert agg.observe_held_idle(1.0, 4.0) == pytest.approx(0.0)
    agg.observe_device_interval(1.0, 3.0)
    assert agg.observe_held_idle(1.0, 4.0) == pytest.approx(1000.0)


def test_launches_and_landings_from_many_threads_balance():
    """Dispatch threads note launches and waiter threads land them while
    handler threads read ``held_idle``: nothing is left in flight and no
    observation is lost."""
    import sys

    agg = phases.PhaseAggregator()
    errors = []

    def dispatcher(k):
        try:
            for i in range(300):
                t0 = k * 1000.0 + i
                agg.note_device_launch(t0)
                agg.observe_held_idle(t0 - 0.5, t0 + 0.5)
                if i % 7:
                    agg.observe_device_interval(t0, t0 + 0.25)
                else:
                    agg.forget_device_launch(t0)
        except Exception as exc:  # surfaced below
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=dispatcher, args=(k,))
                   for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(t.is_alive() for t in threads)
    with agg._lock:
        assert agg._launched == {}
    assert agg.sums()["held_idle"]["count"] == 16 * 300


def test_held_idle_ms_unions_overlapping_dispatches():
    got = phases.held_idle_ms(0.0, 10.0, [(1.0, 4.0), (3.0, 5.0), (9.0, 12.0)],
                              [8.5])
    assert got == pytest.approx((10.0 - 4.0 - 1.5) * 1e3)


def test_the_seam_lands_what_it_launched(tiny):
    """Each dispatch the seam notes at its launch lands when the waiter
    sees it ready: nothing stays in flight after a served request."""
    with Server(tiny, window_ms=1.0) as srv:
        consensus(srv.port, ["a", "b", "c"])
        assert srv.batcher.drain(10)
    agg = phases.aggregator()
    assert agg.device_intervals()
    with agg._lock:
        assert agg._launched == {}


# -- the profiler ranges ------------------------------------------------------


class CountingRange(torch.autograd.profiler.record_function):
    made = []

    def __init__(self, name, args=None):
        CountingRange.made.append((name, threading.current_thread().name))
        super().__init__(name, args)


def test_no_profiler_means_no_record_function(tiny, monkeypatch):
    CountingRange.made = []
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        CountingRange)
    monkeypatch.setattr(torch.profiler, "record_function", CountingRange)
    with Server(tiny, window_ms=1.0) as srv:
        consensus(srv.port, ["a b", "b c"])
        settled_counts(srv.batcher, 1, PER_REQUEST)
        assert CountingRange.made == []
        # the control: the same path under the process-wide flag enters
        # one range per phase scope
        monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled",
                            True)
        consensus(srv.port, ["a b", "b c"])
        settled_counts(srv.batcher, 2, PER_REQUEST)
    names = {name for name, _ in CountingRange.made}
    assert {"lwc.gateway_read", "lwc.tokenize", "lwc.batch_window",
            "lwc.prepare_wait", "lwc.launch", "lwc.finalize",
            "lwc.gateway_write"} <= names


def test_a_profiler_of_all_threads_holds_the_servers_ranges(tiny):
    from llm_weighted_consensus_tpu_torch.serve.profiling import _all_threads

    config = _all_threads()
    if config is None:
        pytest.skip("this torch has no profile_all_threads")
    from torch.profiler import ProfilerActivity, profile

    with Server(tiny, window_ms=1.0) as srv:
        consensus(srv.port, ["warm", "up"])
        prof = profile(activities=[ProfilerActivity.CPU],
                       experimental_config=config)
        prof.start()
        try:
            for k in range(2):
                consensus(srv.port, [f"a {k}", "b", "c"])
            settled_counts(srv.batcher, 3, PER_REQUEST)
        finally:
            prof.stop()
    ranges = [e for e in prof.events() if e.name.startswith("lwc.")]
    names = {e.name for e in ranges}
    assert {"lwc.gateway_read", "lwc.tokenize", "lwc.launch",
            "lwc.finalize"} <= names
    # from the handler, the tokenizer pool, the dispatch and the waiter:
    # not the profiler's own thread
    threads = {e.thread for e in ranges}
    assert len(threads) >= 3
    # the scopes' ranges carry the aten ops they ran, on their threads
    assert all(e.cpu_time_total >= 0 for e in ranges)


# -- the breakdown of one traced request --------------------------------------


def test_the_breakdown_carves_the_scopes_out_of_their_phases():
    spec = [
        ("gateway:POST /consensus", None, 0.0, 0.100,
         {"admission_wait_ms": 0.01}),
        ("phase:gateway_read", 0, 0.000, 0.004, {}),
        ("batcher:consensus", 0, 0.003, 0.095, {}),
        ("phase:tokenize", 1, 0.003, 0.009, {}),
        ("phase:batch_window", 1, 0.003, 0.006, {}),
        ("device:dispatch", 1, 0.010, 0.094, {}),
        ("phase:prepare_wait", 4, 0.010, 0.011, {}),
        ("phase:launch", 4, 0.011, 0.013, {}),
        ("phase:finalize", 4, 0.092, 0.094, {}),
    ]
    got = phases.phase_breakdown(build_trace(obs, spec))
    assert got["gateway_read"] == pytest.approx(3.0)  # until the submit
    assert got["batch_window"] == pytest.approx(3.0)
    assert got["tokenize"] == pytest.approx(3.0)  # 6-9 ms, past the window
    assert got["batcher_queue"] == pytest.approx(92 - 84 - 3 - 3)
    assert got["prepare_wait"] == pytest.approx(1.0)
    assert got["launch"] == pytest.approx(2.0)
    assert got["finalize"] == pytest.approx(2.0)
    assert got["device_dispatch"] == pytest.approx(84 - 5)
    named = sum(v for k, v in got.items() if k not in ("e2e_ms", "other_ms"))
    assert named <= got["e2e_ms"]
    assert got["other_ms"] == pytest.approx(100 - named, abs=1e-3)


def test_a_traced_request_has_each_phase_as_a_child_span(tiny):
    sink = obs.TraceSink(sample_rate=1.0)
    with Server(tiny, window_ms=1.0, trace_sink=sink) as srv:
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)
        conn.request("POST", "/consensus",
                     body=json.dumps({"input": ["a", "b", "c"]}),
                     headers={"content-type": "application/json"})
        resp = conn.getresponse()
        resp.read()
        conn.close()
        record = sink.get(resp.getheader("x-trace-id"))
    spans = {s["name"]: s for s in record["spans"]}
    by_id = {s["span_id"]: s["name"] for s in record["spans"]}
    assert by_id[spans["phase:gateway_read"]["parent_id"]] == \
        "gateway:POST /consensus"
    for name in ("tokenize", "batch_window", "prepare_wait", "launch",
                 "finalize"):
        assert by_id[spans[f"phase:{name}"]["parent_id"]] == \
            "batcher:consensus", name
    breakdown = record["spans"][0]["attributes"]["phase_breakdown"]
    assert breakdown["launch"] > 0 and breakdown["gateway_read"] > 0
    named = sum(v for k, v in breakdown.items()
                if k not in ("e2e_ms", "other_ms"))
    assert named <= breakdown["e2e_ms"] + 1e-3


# -- the benchmark's readers ----------------------------------------------------


def _readings(before: dict, after: dict):
    from benchmark.readings import Readings

    return Readings(cfg={}, mix={}, window_s=20.0, completed=[],
                    latencies_ms=[], lengths=[], before=before, after=after,
                    trace={"device": [], "kernels": [], "busy_s": 0.0,
                           "window_s": 20.0})


def _counters(requests: int, **sums) -> dict:
    return {"batcher": {
        "requests": {"consensus": requests, "embed": 0},
        "phases": {p: {"sum_ms": s, "count": c} for p, (s, c) in sums.items()},
    }}


READERS = {
    "tokenize_ms.rest": ("tokenize", 2.0),
    "queue_ms.rest": ("batcher_queue", 2.0),
    "held_idle_ms.rest": ("held_idle", 2.0),
}


@pytest.mark.parametrize("metric", sorted(READERS))
def test_a_phase_reader_divides_the_windows_sum_by_its_count(metric):
    from benchmark import spec

    phase, want = READERS[metric]
    read = spec.reader(metric).read
    before = _counters(10, **{phase: (5.0, 10)})
    after = _counters(30, **{phase: (45.0, 30)})
    assert read(_readings(before, after)) == pytest.approx(want)
    # no rise of the count: nothing to read
    assert read(_readings(after, after)) is None
    # the parent's counters, without the phases: nothing, no error
    bare = {"batcher": {"requests": {"consensus": 30}}}
    assert read(_readings(bare, bare)) is None


def test_the_gateway_reader_divides_both_ends_by_the_requests():
    from benchmark import spec

    read = spec.reader("gateway_ms.rest").read
    before = _counters(10, gateway_read=(1.0, 10), gateway_write=(2.0, 10))
    after = _counters(30, gateway_read=(21.0, 30), gateway_write=(12.0, 30))
    assert read(_readings(before, after)) == pytest.approx((20 + 10) / 20)
    assert read(_readings(after, after)) is None
    bare = {"batcher": {"requests": {"consensus": 30}}}
    assert read(_readings(bare, _counters(40))) is None
