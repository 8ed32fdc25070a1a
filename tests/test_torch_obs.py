"""The port's request tracing (``obs/span.py``, ``obs/sink.py``,
``obs/propagate.py``, ``obs/phases.phase_breakdown``) against the JAX
package's, on the same inputs.

* span trees, the ``span`` scope's exception rule and the no-op helpers
  (the cases of ``tests/test_obs.py``): the same names, parent structure,
  statuses and attributes, ids normalised to their order;
* the sink: ring bound and newest-first index, head sampling from a
  seeded ``rng`` (the same coin sequence), forced retention, the JSONL
  disk tier;
* ``traceparent`` parse and format on a table of valid and invalid
  headers: the same tuples, the same bytes;
* ``phase_breakdown`` on the same built traces with fixed times: equal;
* concurrency across threads: traced requests on their own threads, the
  port's batcher under many traced callers, and a coroutine submitted to
  a loop thread, each see only their own trace;
* every span name the port starts is in ``KNOWN_SPANS``, and every name
  listed there is started somewhere.
"""

import ast
import asyncio
import json
import random
import re
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from llm_weighted_consensus_tpu import obs as ref_obs
from llm_weighted_consensus_tpu_torch import obs as port_obs
from llm_weighted_consensus_tpu.obs.span import KNOWN_SPANS as REF_SPANS
from llm_weighted_consensus_tpu_torch.obs.span import KNOWN_SPANS
from llm_weighted_consensus_tpu_torch.serve.batcher import DeviceBatcher

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "llm_weighted_consensus_tpu_torch"
PKGS = {"ref": ref_obs, "port": port_obs}


def shape(record: dict) -> list:
    """A trace record without ids and times: (name, parent position,
    status, finished, attributes) per span."""
    pos = {s["span_id"]: i for i, s in enumerate(record["spans"])}
    return [
        (s["name"], pos.get(s["parent_id"], s["parent_id"]), s["status"],
         s["duration_ms"] is not None, s["attributes"])
        for s in record["spans"]
    ]


def summary(record: dict) -> dict:
    return {k: record[k] for k in ("name", "status", "sampled", "forced",
                                   "force_reason")}


# -- span tree, scope and no-op --------------------------------------------------


def _tree(obs):
    root = obs.start_trace("gateway:POST /x", sampled=True, route="/x")
    a = root.child("cache:lookup")
    b = a.child("singleflight:wait", leader_abandoned=True)
    a.annotate(outcome="leader")
    a.finish()
    b.finish("error")
    root.finish()
    return root


def test_span_tree_parent_ids_and_render_match_the_reference():
    got = {name: _tree(obs) for name, obs in PKGS.items()}
    records = {name: root.trace.to_json_obj() for name, root in got.items()}
    assert shape(records["port"]) == shape(records["ref"])
    assert summary(records["port"]) == summary(records["ref"])
    assert records["port"].keys() == records["ref"].keys()
    root = got["port"]
    trace = root.trace
    assert root.parent_id is None
    assert len({s.span_id for s in trace.spans}) == 3
    # W3C-shaped ids: 32-hex trace, 16-hex spans, never all-zero
    assert re.fullmatch(r"[0-9a-f]{32}", trace.trace_id)
    assert trace.trace_id != "0" * 32
    assert all(re.fullmatch(r"[0-9a-f]{16}", s.span_id)
               for s in trace.spans)


def test_tracing_off_is_a_noop_in_both():
    for obs in PKGS.values():
        assert obs.current_span() is None
        assert obs.current_trace_id() is None
        assert obs.child_span("anything") is None
        obs.annotate(ignored=True)
        obs.force_keep("ignored")
        with obs.span("scope") as s:
            assert s is None
        headers = {}
        obs.inject(headers)
        assert headers == {}
    # the port's executor-hop helper is the function itself
    fn = lambda: 1  # noqa: E731
    assert port_obs.carry(fn) is fn


def _scopes(obs):
    out = []
    root = obs.start_trace("r", sampled=False)
    token = root.activate()
    with pytest.raises(ValueError):
        with obs.span("boom", step=1):
            raise ValueError("kaput")
    with obs.span("fine") as s:
        s.annotate(k="v")
        obs.annotate(inner=True)
    obs.Span.deactivate(token)
    root.finish()
    out.append(root.trace.to_json_obj())
    root2 = obs.start_trace("r2", sampled=False)
    token2 = root2.activate()
    with pytest.raises(asyncio.CancelledError):
        with obs.span("gone"):
            raise asyncio.CancelledError()
    obs.force_keep("all_failed")
    obs.force_keep("second reason never wins")
    obs.Span.deactivate(token2)
    root2.finish()
    out.append(root2.trace.to_json_obj())
    root3 = obs.start_trace("r3", sampled=False)
    token3 = root3.activate()
    with pytest.raises(asyncio.CancelledError):
        with obs.span("gone"):
            raise asyncio.CancelledError()
    obs.Span.deactivate(token3)
    root3.finish()
    out.append(root3.trace.to_json_obj())
    return out


def test_span_scope_exception_rule_matches_the_reference():
    ref, port = _scopes(ref_obs), _scopes(port_obs)
    for want, got in zip(ref, port):
        assert shape(got) == shape(want)
        assert summary(got) == summary(want)
    errored, forced, cancelled = port
    assert errored["forced"] and errored["force_reason"] == "error:boom"
    assert errored["spans"][1]["attributes"]["error"] == "kaput"
    assert forced["force_reason"] == "all_failed"
    # a cancellation marks its span, never the whole trace
    assert not cancelled["forced"]
    assert cancelled["spans"][1]["attributes"] == {"cancelled": True}


# -- the sink ----------------------------------------------------------------------


def _done(obs, sampled=False, forced_reason=None, trace_id=None):
    root = obs.start_trace("t", sampled=sampled, trace_id=trace_id)
    if forced_reason is not None:
        root.trace.force(forced_reason)
    root.finish()
    return root.trace


def _index(sink):
    return [{k: v for k, v in e.items()
             if k not in ("started_epoch", "duration_ms")}
            for e in sink.index()]


def test_sink_ring_bound_and_recent_first_match_the_reference():
    out = {}
    for name, obs in PKGS.items():
        sink = obs.TraceSink(capacity=3, sample_rate=1.0)
        for i in range(5):
            sink.offer(_done(obs, sampled=True, trace_id=f"{i:032x}"))
        snap = sink.snapshot()
        assert sink.get(f"{0:032x}") is None  # evicted oldest-first
        assert sink.get(f"{4:032x}")["trace_id"] == f"{4:032x}"
        assert sink.index(limit=1) == sink.index()[:1]
        assert len(sink.index(limit=0)) == 1
        out[name] = (_index(sink), snap)
    assert out["port"] == out["ref"]
    assert [e["trace_id"] for e in out["port"][0]] == [
        f"{i:032x}" for i in (4, 3, 2)]


def test_sink_sampling_from_a_seeded_rng_and_forced_keep():
    out = {}
    for name, obs in PKGS.items():
        sink = obs.TraceSink(capacity=8, sample_rate=0.3,
                             rng=random.Random(7))
        coins = [sink.sample() for _ in range(64)]
        zero = obs.TraceSink(capacity=8, sample_rate=0.0)
        zero.offer(_done(obs))
        forced = _done(obs, forced_reason="http_503", trace_id="f" * 32)
        zero.offer(forced)
        out[name] = (coins, zero.snapshot(), _index(zero),
                     obs.TraceSink(sample_rate=1.0).sample(), zero.sample())
    assert out["port"] == out["ref"]
    coins, snap, index, one, none = out["port"]
    assert 0 < sum(coins) < 64 and one is True and none is False
    assert snap["dropped"] == 1 and snap["kept"] == 1 and snap["forced"] == 1
    assert index[0]["force_reason"] == "http_503"


def test_sink_disk_jsonl_matches_the_reference(tmp_path):
    lines = {}
    for name, obs in PKGS.items():
        sink = obs.TraceSink(capacity=2, sample_rate=1.0,
                             disk_dir=str(tmp_path / name))
        for i in range(3):
            sink.offer(_done(obs, sampled=True, trace_id=f"{i + 1:032x}"))
        sink.offer(_done(obs, sampled=False))  # dropped: never on disk
        files = list((tmp_path / name).glob("traces-*.jsonl"))
        assert len(files) == 1
        assert sink.snapshot()["disk_path"] == str(files[0])
        lines[name] = [json.loads(ln)
                       for ln in files[0].read_text().splitlines()]
    for got, want in zip(lines["port"], lines["ref"]):
        assert shape(got) == shape(want) and summary(got) == summary(want)
    # disk keeps everything kept, past the ring's eviction
    assert [r["trace_id"] for r in lines["port"]] == [
        f"{i:032x}" for i in (1, 2, 3)]


def test_sink_disk_error_is_counted_never_raised(tmp_path):
    sink = port_obs.TraceSink(sample_rate=1.0, disk_dir=str(tmp_path))
    sink._disk_path = str(tmp_path)  # a directory: every append fails
    sink.offer(_done(port_obs, sampled=True))
    assert sink.snapshot()["disk_errors"] == 1
    assert sink.snapshot()["size"] == 1


def _hammer(fn, workers=16):
    """``fn(k)`` on ``workers`` threads at once with a shortened switch
    interval, so a lost update under a missing lock would show."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=fn, args=(k,))
                   for k in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)


def test_sink_takes_offers_from_many_threads(tmp_path):
    sink = port_obs.TraceSink(capacity=64, sample_rate=0.5,
                              rng=random.Random(3),
                              disk_dir=str(tmp_path))

    def offer_many(k):
        for i in range(50):
            sink.offer(_done(port_obs, sampled=sink.sample(),
                             forced_reason="x" if i % 10 == 0 else None))

    _hammer(offer_many)
    snap = sink.snapshot()
    assert snap["kept"] + snap["dropped"] == 800
    assert snap["forced"] == 80 and snap["size"] == 64
    assert len(sink.index(limit=64)) == 64
    with open(snap["disk_path"], encoding="utf-8") as f:
        assert len([json.loads(ln) for ln in f]) == snap["kept"]


def test_ledger_takes_offers_from_many_threads(tmp_path):
    ledger = port_obs.OutcomeLedger(capacity=32, disk_dir=str(tmp_path),
                                    rotate_bytes=4096)

    def offer_many(k):
        for i in range(40):
            ledger.offer({"id": f"t{k}-{i}", "confidence": [0.5, 0.5]})

    _hammer(offer_many)
    snap = ledger.snapshot()
    assert snap["kept"] == 640 and snap["size"] == 32
    assert snap["rotations"] > 0 and snap["disk_errors"] == 0
    records, torn = port_obs.load_ledger_records(str(tmp_path))
    assert torn == 0
    assert sorted(r["id"] for r in records) == sorted(
        f"t{k}-{i}" for k in range(16) for i in range(40))


# -- traceparent ---------------------------------------------------------------------

TID, SID = "a" * 32, "b" * 16
HEADERS = [
    f"00-{TID}-{SID}-01",
    f"00-{TID}-{SID}-00",
    f"00-{TID}-{SID}-03",
    f"00-{TID}-{SID}-02",
    f"00-{TID.upper()}-{SID}-01-extra",
    f"  00-{TID}-{SID}-01  ",
    f"01-{TID}-{SID}-01",
    f"fe-{TID}-{SID}-ff",
    None,
    "",
    "garbage",
    f"ff-{TID}-{SID}-01",
    f"00-{'0' * 32}-{SID}-01",
    f"00-{TID}-{'0' * 16}-01",
    f"00-{TID[:-1]}-{SID}-01",
    f"00-{TID}-{SID[:-1]}-01",
    f"00-{TID}-{SID}-zz",
    f"00-{TID}-{SID}-1",
    f"0-{TID}-{SID}-01",
    f"00-{TID}-{SID}",
    f"00-{'g' * 32}-{SID}-01",
    f"00_{TID}_{SID}_01",
]


@pytest.mark.parametrize("header", HEADERS)
def test_traceparent_parse_matches_the_reference(header):
    got = port_obs.parse_traceparent(header)
    assert got == ref_obs.parse_traceparent(header)
    assert port_obs.extract({"traceparent": header}) == got


@pytest.mark.parametrize("sampled", [True, False])
def test_traceparent_format_and_inject_are_byte_equal(sampled):
    tid, sid = "0123456789abcdef" * 2, "fedcba9876543210"
    text = port_obs.format_traceparent(tid, sid, sampled)
    assert text == ref_obs.format_traceparent(tid, sid, sampled)
    assert port_obs.parse_traceparent(text) == (tid, sid, sampled)
    headers = {}
    for obs in PKGS.values():
        root = obs.start_trace("r", sampled=sampled, trace_id=tid)
        root.span_id = sid
        token = root.activate()
        try:
            out = {}
            obs.inject(out)
        finally:
            obs.Span.deactivate(token)
        headers[obs.__name__] = out
    assert list(headers.values())[0] == list(headers.values())[1] == {
        port_obs.TRACEPARENT_HEADER: text}


# -- phase_breakdown ----------------------------------------------------------------

# (name, parent position, start s, end s or None, attributes); the root
# is span 0 with the trace's t0 at 0
BUILT_TRACES = {
    "padded_consensus": [
        ("gateway:POST /consensus", None, 0.0, 0.6731,
         {"admission_wait_ms": 0.012, "admission_inflight": 8}),
        ("batcher:consensus", 0, 0.0021, 0.6712, {"queue_depth": 3}),
        ("device:dispatch", 1, 0.0250, 0.6705,
         {"kind": "consensus", "batch_size": 8}),
    ],
    "packed_burst": [
        ("gateway:POST /consensus", None, 0.0, 0.1712,
         {"admission_wait_ms": 0.02}),
        ("batcher:consensus", 0, 0.0011, 0.1690,
         {"queue_depth": 0, "pack_plan_ms": 1.25, "host_tally_ms": 0.375}),
        ("device:dispatch", 1, 0.0503, 0.1688,
         {"kind": "consensus", "batch_size": 33}),
    ],
    "score_trained": [
        ("gateway:POST /score/completions", None, 0.0, 1.5,
         {"admission_wait_ms": 0.004}),
        ("cache:lookup", 0, 0.001, 0.0012, {"outcome": "bypass"}),
        ("batcher:embed", 0, 0.002, 0.030, {"queue_depth": 1}),
        ("device:dispatch", 2, 0.005, 0.029,
         {"kind": "embed", "batch_size": 3}),
        ("judge:stream", 0, 0.060, 0.90, {"model": "a"}),
        ("judge:attempt", 4, 0.061, 0.20, {}),
        ("judge:stream", 0, 0.061, 1.20, {"model": "b"}),
        ("judge:stream", 0, 1.30, 1.35, {"model": "c"}),
        ("consensus:tally", 0, 1.40, 1.41, {"n_judges": 3}),
    ],
    "unfinished_and_pipelined": [
        ("gateway:POST /embeddings", None, 0.0, 0.2, {}),
        ("batcher:embed", 0, 0.01, 0.19, {}),
        ("device:dispatch", 1, 0.02, 0.12, {}),
        ("device:dispatch", 1, 0.10, 0.18, {}),
        ("batcher:embed", 0, 0.05, None, {}),
        ("judge:stream", 0, 0.03, None, {}),
    ],
    "shed": [
        ("gateway:POST /consensus", None, 0.0, 0.0004,
         {"shed_reason": "inflight_limit", "http_status": 503}),
    ],
    "root_open": [
        ("gateway:GET /x", None, 0.0, None, {}),
        ("batcher:embed", 0, 0.01, 0.02, {}),
    ],
    "no_spans": [],
}


def build_trace(obs, spec):
    trace = obs.Trace("1" * 32, True)
    trace.t0 = 0.0
    spans = []
    for name, parent, start, end, attrs in spec:
        parent_id = spans[parent].span_id if parent is not None else None
        s = obs.Span(trace, name, parent_id, **attrs)
        s._start, s._end = start, end
        spans.append(s)
    return trace


# the phases only the port's scopes time (``obs/phases.py``)
PORT_PHASES = ("gateway_read", "tokenize", "batch_window", "prepare_wait",
               "launch", "finalize", "gateway_write")


@pytest.mark.parametrize("case", sorted(BUILT_TRACES))
def test_phase_breakdown_matches_the_reference(case):
    spec = BUILT_TRACES[case]
    got = port_obs.phase_breakdown(build_trace(port_obs, spec))
    want = ref_obs.phase_breakdown(build_trace(ref_obs, spec))
    assert {k: got[k] for k in want} == want
    # a trace without the port's phase spans reads 0 in each of them
    assert {k: v for k, v in got.items() if k not in want} == {
        p: 0.0 for p in PORT_PHASES}
    if spec and spec[0][3] is not None:
        named = sum(v for k, v in got.items()
                    if k not in ("e2e_ms", "other_ms"))
        assert abs(named + got["other_ms"] - got["e2e_ms"]) < 1e-2 or \
            named > got["e2e_ms"]


def test_phase_breakdown_splits_a_padded_dispatch():
    got = port_obs.phase_breakdown(
        build_trace(port_obs, BUILT_TRACES["padded_consensus"]))
    assert got["device_dispatch"] == 645.5
    assert got["batcher_queue"] == 23.6
    assert got["admission_wait"] == 0.012
    assert got["e2e_ms"] == 673.1


def test_union_attributes_concurrent_work_once():
    from llm_weighted_consensus_tpu.obs.phases import _union_ms as ref_union
    from llm_weighted_consensus_tpu_torch.obs.phases import _union_ms

    rng = random.Random(5)
    for _ in range(20):
        iv = []
        for _ in range(rng.randint(0, 12)):
            a = rng.uniform(0, 100)
            iv.append((a, a + rng.uniform(0, 30)))
        assert _union_ms(list(iv)) == ref_union(list(iv))


# -- concurrency -----------------------------------------------------------------------


def test_concurrent_traces_on_threads_do_not_cross_contaminate():
    """The reference's test on one loop, here across handler-like
    threads: each thread's contextvar holds only its own root."""
    traces = [None] * 8
    errors = []
    barrier = threading.Barrier(8)

    def one_request(n):
        try:
            root = port_obs.start_trace(f"req-{n}", sampled=True)
            token = root.activate()
            barrier.wait()
            try:
                for hop in range(5):
                    time.sleep(random.Random(n * 31 + hop).random() / 200)
                    assert port_obs.current_trace_id() == root.trace.trace_id
                    port_obs.child_span(f"hop-{hop}").finish()
                with port_obs.span("scope"):
                    assert port_obs.current_span().name == "scope"
            finally:
                port_obs.Span.deactivate(token)
                root.finish()
            assert port_obs.current_span() is None
            traces[n] = root.trace
        except Exception as exc:  # surfaced below
            errors.append(exc)

    threads = [threading.Thread(target=one_request, args=(n,))
               for n in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert len({t.trace_id for t in traces}) == 8
    for t in traces:
        assert len(t.spans) == 7  # root + 5 hops + scope
        assert all(s.trace is t for s in t.spans)
        ids = {s.span_id for s in t.spans}
        assert all(s.parent_id in ids for s in t.spans[1:])


class NullEmbedder:
    """A stand-in with the ``embed`` kind's surface, as the reference's
    ``tests/test_obs.py`` uses."""

    model_name = "null"
    MAX_DEVICE_BATCH = 64

    def tokenize(self, texts, max_tokens=None):
        n = len(texts)
        return (np.zeros((n, 4), dtype=np.int32),
                np.ones((n, 4), dtype=np.int32))

    def embed_tokens(self, ids, mask):
        time.sleep(0.002)
        return np.zeros((ids.shape[0], 8), dtype=np.float32)


def test_batcher_items_carry_their_own_request_across_threads():
    """16 traced callers on their own threads share dispatches; each
    caller's batcher span and device children hang under its own root,
    every span finished before the caller holds its answer."""
    batcher = DeviceBatcher(NullEmbedder(), window_ms=20.0,
                            host_tokenizer_workers=0)
    roots = [None] * 16
    errors = []

    def caller(n):
        try:
            root = port_obs.start_trace(f"req-{n}", sampled=True)
            token = root.activate()
            try:
                emb, tokens = batcher.embed([f"text {n}"] * (1 + n % 3))
            finally:
                port_obs.Span.deactivate(token)
            queued = [s for s in root.trace.spans
                      if s.name == "batcher:embed"]
            device = [s for s in root.trace.spans
                      if s.name == "device:dispatch"]
            assert len(queued) == 1 and len(device) == 1
            assert queued[0].duration_ms() is not None
            assert device[0].duration_ms() is not None
            assert device[0].parent_id == queued[0].span_id
            assert queued[0].parent_id == root.span_id
            root.finish()
            roots[n] = root
        except Exception as exc:
            errors.append(exc)

    threads = [threading.Thread(target=caller, args=(n,)) for n in range(16)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        batcher.close()
    assert not errors
    for root in roots:
        assert all(s.trace is root.trace for s in root.trace.spans)
    # the items rode shared dispatches
    assert max(s.attributes["batch_size"] for r in roots
               for s in r.trace.spans if s.name == "device:dispatch") > 1


def test_the_batcher_span_ends_when_its_caller_resumes():
    """As the reference's ``_submit``: the device span closes before the
    future resolves, the batcher span when the caller reads the result,
    so the caller's wake-up is queue time."""
    batcher = DeviceBatcher(NullEmbedder(), window_ms=1.0,
                            host_tokenizer_workers=0)
    try:
        root = port_obs.start_trace("r", sampled=True)
        token = root.activate()
        try:
            futures = [batcher.submit_embed(["a"]), batcher.submit_embed(["b"])]
        finally:
            port_obs.Span.deactivate(token)
        for fut in futures:
            fut.result(30)
        queued = [s for s in root.trace.spans if s.name == "batcher:embed"]
        device = [s for s in root.trace.spans if s.name == "device:dispatch"]
        assert all(d.duration_ms() is not None for d in device)
        assert all(q.duration_ms() is None for q in queued)
        time.sleep(0.02)
        asyncio.new_event_loop().run_until_complete(
            batcher.wait_async(futures[0]))
        batcher.wait(futures[1])
    finally:
        batcher.close()
    for q, d in zip(queued, device):
        assert d.parent_id == q.span_id and q.status == "ok"
        assert q._end - d._end >= 0.02


def test_run_coroutine_threadsafe_carries_the_callers_span():
    """The chat routes submit each request's coroutine from its handler
    thread: the task runs in a copy of that thread's context."""
    loop = asyncio.new_event_loop()
    t = threading.Thread(target=loop.run_forever, daemon=True)
    t.start()
    try:
        async def probe():
            seen = port_obs.current_span()

            async def sub():
                await asyncio.sleep(0)
                return port_obs.current_span()

            inner = await asyncio.create_task(sub())
            with port_obs.span("judge:stream") as s:
                child = s
            return seen, inner, child

        out = {}

        def handler(n):
            root = port_obs.start_trace(f"req-{n}", sampled=True)
            token = root.activate()
            try:
                out[n] = (root, asyncio.run_coroutine_threadsafe(
                    probe(), loop).result(10))
            finally:
                port_obs.Span.deactivate(token)

        threads = [threading.Thread(target=handler, args=(n,))
                   for n in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        for root, (seen, inner, child) in out.values():
            assert seen is root and inner is root
            assert child.parent_id == root.span_id
        # untraced: the coroutine sees no span
        assert asyncio.run_coroutine_threadsafe(
            probe(), loop).result(10)[0] is None
    finally:
        loop.call_soon_threadsafe(loop.stop)
        t.join(5)
        loop.close()


def test_carry_takes_the_span_through_an_executor_hop():
    import concurrent.futures

    pool = concurrent.futures.ThreadPoolExecutor(1)
    try:
        root = port_obs.start_trace("r", sampled=True)
        token = root.activate()
        try:
            bare = pool.submit(port_obs.current_span).result()
            carried = pool.submit(port_obs.carry(port_obs.current_span))
            carried = carried.result()
        finally:
            port_obs.Span.deactivate(token)
        # the worker's own context is untouched afterwards
        after = pool.submit(port_obs.current_span).result()
    finally:
        pool.shutdown()
    assert bare is None and carried is root and after is None


# -- the span-name registry ---------------------------------------------------------

SPAN_CALLS = ("child_span", "span", "start_trace", "child")


def _span_names(path: Path):
    """(name, line) of every span a port file starts: the first
    argument of ``child_span``/``span``/``start_trace``/``.child``; an
    f-string yields its literal prefix and ``*``; a ``phase`` scope
    yields ``phase:`` and its name."""
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        fn = node.func
        name = (fn.attr if isinstance(fn, ast.Attribute)
                else fn.id if isinstance(fn, ast.Name) else None)
        arg = node.args[0]
        if name == "phase" and isinstance(arg, ast.Constant):
            # a phase scope's span (obs/phases.py)
            yield f"phase:{arg.value}", node.lineno
        if name not in SPAN_CALLS:
            continue
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            yield arg.value, node.lineno
        elif isinstance(arg, ast.JoinedStr):
            head = arg.values[0]
            prefix = (head.value if isinstance(head, ast.Constant) else "")
            yield prefix + "*", node.lineno


def _known(name: str) -> str:
    for pattern in KNOWN_SPANS:
        if pattern.endswith("*"):
            if name.startswith(pattern[:-1]):
                return pattern
        elif name == pattern:
            return pattern
    return ""


def test_every_span_name_is_known_and_every_known_name_is_used():
    assert KNOWN_SPANS == REF_SPANS + ("phase:*",)
    used = set()
    unknown = []
    for path in sorted(PORT.rglob("*.py")):
        if path.parts[-2] == "obs":
            continue  # the span machinery itself
        for name, line in _span_names(path):
            pattern = _known(name)
            if pattern:
                used.add(pattern)
            else:
                unknown.append(f"{path.relative_to(REPO)}:{line} {name!r}")
    assert unknown == []
    assert used == set(KNOWN_SPANS)
