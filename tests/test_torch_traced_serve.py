"""The port's traced server against the JAX gateway (the cases of
``tests/test_obs.py`` and ``tests/test_quality.py`` over HTTP, not the
hedge and bias drills).

Both gateways serve the same scripted judges (``tests/fakes.py``) with a
trace sink; span ids, times and the per-request timings are normalised,
and the span trees (names, parents, statuses, attributes), the statuses
and the bodies are compared:

* ``/v1/traces`` index and get, 404 on an unknown id;
* ``x-trace-id`` on every traced response, a caller's ``traceparent``
  adopted and injected upstream with the attempt span as parent;
* forced retention of a 5xx and of an all-failed panel at rate 0;
* ``trace_id`` on the SSE final frame, on error envelopes and on the 413;
* ``/v1/judges`` and ``/v1/judges/{id}``, the ``quality``, ``ledger`` and
  ``traces`` sections of ``/metrics`` and the series' exemplars;
* the ``batcher:consensus`` -> ``device:dispatch`` tree of ``/consensus``
  through the port's ``DeviceBatcher`` (test-tiny on the CPU);
* ``admission_wait`` observed once per admitted request, and a shed's
  ``shed_reason`` on its kept trace;
* with tracing off, no ``x-trace-id``, no ``trace_id`` and no
  ``/v1/traces``.
"""

import asyncio
import http.client
import json

import jax
import numpy as np
import pytest

from llm_weighted_consensus_tpu import obs as ref_obs
from llm_weighted_consensus_tpu.models import bert as jax_bert
from llm_weighted_consensus_tpu.models import configs as jax_configs
from llm_weighted_consensus_tpu.models.embedder import TpuEmbedder
from llm_weighted_consensus_tpu_torch import obs as port_obs
from llm_weighted_consensus_tpu_torch.models import bert, configs, convert
from llm_weighted_consensus_tpu_torch.models.embedder import TorchEmbedder
from llm_weighted_consensus_tpu_torch.resilience.admission import (
    AdmissionConfig,
)
from llm_weighted_consensus_tpu_torch.serve.gateway import Server
from llm_weighted_consensus_tpu_torch.utils import jsonutil as port_json

from test_torch_score import CASES, KEYS3, TWO, body, judge_script
from test_torch_score import make_client

TIMED = ("phase_breakdown", "admission_wait_ms", "first_chunk_ms",
         "pack_plan_ms", "host_tally_ms", "admission_inflight")
# the port's own phases (``obs/phases.py``): their ``phase:*`` spans and
# breakdown keys have no counterpart in the reference, and are left out
# of the comparison (``tests/test_torch_phase_scope.py`` holds them)
PORT_PHASES = ("gateway_read", "tokenize", "batch_window", "prepare_wait",
               "launch", "finalize", "gateway_write")
CALLER_TID, CALLER_SID = "c" * 32, "d" * 16


@pytest.fixture(autouse=True)
def _fresh_aggregates():
    # the quality and phase aggregates are process-global in both
    # packages; a traced request leaves a margin exemplar behind
    for obs in (ref_obs, port_obs):
        obs.reset_quality()
        obs.reset_phases()
    yield
    for obs in (ref_obs, port_obs):
        obs.reset_quality()
        obs.reset_phases()


# -- the two gateways -------------------------------------------------------------


def ref_app(scripts, sink=None, ledger=None, embedder=None):
    from llm_weighted_consensus_tpu.clients.multichat import MultichatClient
    from llm_weighted_consensus_tpu.resilience.admission import (
        AdmissionConfig as RefAdmissionConfig,
        AdmissionController,
    )
    from llm_weighted_consensus_tpu.serve import build_app

    client, transport = make_client("ref", scripts, ledger=ledger)
    multichat = MultichatClient(client.chat_client, client.model_fetcher)
    app = build_app(
        client.chat_client, client, multichat, embedder=embedder,
        trace_sink=sink, ledger=ledger,
        admission=AdmissionController(RefAdmissionConfig()),
        batch_window_ms=1.0,
    )
    return app, transport


def port_server(scripts, sink=None, ledger=None, embedder=None, **kw):
    client, transport = make_client("port", scripts, ledger=ledger)
    return Server(embedder, chat_client=client.chat_client,
                  score_client=client, trace_sink=sink, ledger=ledger,
                  window_ms=1.0, **kw), transport


def ref_calls(app, calls):
    """[(status, headers, body bytes)] of ``calls`` [(method, path,
    body bytes or None, headers)] made in turn to the reference's app;
    a ``{tid}`` in a path is the previous answer's ``x-trace-id``."""
    from aiohttp.test_utils import TestClient, TestServer

    async def run():
        client = TestClient(TestServer(app))
        await client.start_server()
        out = []
        try:
            for method, path, raw, headers in calls:
                path = _fill(path, out)
                resp = await client.request(
                    method, path, data=raw,
                    headers={"content-type": "application/json",
                             **(headers or {})})
                out.append((resp.status, dict(resp.headers),
                            await resp.read()))
        finally:
            await client.close()
        return out

    return asyncio.new_event_loop().run_until_complete(run())


def port_calls(server, calls):
    out = []
    for method, path, raw, headers in calls:
        path = _fill(path, out)
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=60)
        try:
            conn.request(method, path, body=raw,
                         headers={"content-type": "application/json",
                                  **(headers or {})})
            resp = conn.getresponse()
            out.append((resp.status, dict(resp.headers), resp.read()))
        finally:
            conn.close()
    return out


def _fill(path, out):
    """``{tid}``: the trace id of the last answer that names one (its
    ``x-trace-id``, or, for the reference's streams, which are prepared
    before the header could be set, its frames' ``trace_id``)."""
    if "{tid}" not in path:
        return path
    for _, headers, raw in reversed(out):
        tid = headers.get("x-trace-id") or _body_tid(raw)
        if tid:
            return path.replace("{tid}", tid)
    raise AssertionError("no traced answer before " + path)


def both(scripts, calls, sink_rate=1.0, ledger=False, **kw):
    """(ref answers, port answers, ref sink, port sink, ref transport,
    port transport)."""
    ref_sink = ref_obs.TraceSink(sample_rate=sink_rate)
    port_sink = port_obs.TraceSink(sample_rate=sink_rate)
    ref_ledger = ref_obs.OutcomeLedger(8) if ledger else None
    port_ledger = port_obs.OutcomeLedger(8) if ledger else None
    app, ref_transport = ref_app(scripts, ref_sink, ref_ledger, **kw)
    want = ref_calls(app, calls)
    server, port_transport = port_server(scripts, port_sink, port_ledger,
                                         **kw)
    with server:
        got = port_calls(server, calls)
    return want, got, ref_sink, port_sink, ref_transport, port_transport


# -- normalisation ------------------------------------------------------------------


def norm_attrs(attrs: dict) -> dict:
    out = {}
    for k, v in attrs.items():
        if k == "phase_breakdown":
            out[k] = sorted(p for p in v if p not in PORT_PHASES)
        elif k in TIMED:
            out[k] = type(v).__name__
        elif k == "error":
            out[k] = "error"
        else:
            out[k] = v
    return out


def tree(record: dict) -> list:
    """A trace record's spans as sorted (name, parent name, status,
    attributes) rows: no ids, no times."""
    by_id = {s["span_id"]: s for s in record["spans"]}
    rows = []
    for s in record["spans"]:
        if s["name"].startswith("phase:"):
            continue
        parent = by_id.get(s["parent_id"])
        rows.append(json.dumps([
            s["name"], parent["name"] if parent else s["parent_id"],
            s["status"], s["duration_ms"] is not None,
            norm_attrs(s["attributes"])], sort_keys=True))
    return sorted(rows)


def summary(record: dict) -> dict:
    return {k: record[k] for k in ("name", "status", "sampled", "forced",
                                   "force_reason")}


def wire(raw: bytes, trace_id=None) -> list:
    """A body as its SSE events (or its one JSON object), response ids,
    timestamps and the given trace id masked."""
    text = raw.decode()
    if trace_id:
        text = text.replace(trace_id, "TRACE")
    events = [b[len("data: "):] for b in text.split("\n\n")
              if b.startswith("data: ")] or [text]
    out = []
    for ev in events:
        if ev == "[DONE]":
            out.append(ev)
            continue
        obj = json.loads(ev)
        if str(obj.get("id", "")).startswith("scrcpl-"):
            obj["id"], obj["created"] = "scrcpl", 0
        out.append(obj)
    return out


def _body_tid(raw: bytes):
    try:
        objs = wire(raw)
    except ValueError:
        return None
    for obj in objs:
        if isinstance(obj, dict) and obj.get("trace_id"):
            return obj["trace_id"]
    return None


def post(path, obj, headers=None):
    raw = obj if isinstance(obj, bytes) else port_json.dumps(obj).encode()
    return ("POST", path, raw, headers)


def get(path):
    return ("GET", path, None, None)


def index_rows(raw: bytes) -> list:
    return [{k: v for k, v in e.items()
             if k not in ("trace_id", "started_epoch", "duration_ms")}
            for e in json.loads(raw)["traces"]]


# -- /v1/traces ----------------------------------------------------------------------


@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("case", ["agreement", "judge_failure",
                                  "soft_vote"])
def test_traces_index_and_get_answer_as_the_reference(case, stream):
    b, scripts = CASES[case]
    calls = [post("/score/completions", {**b, "stream": stream}),
             get("/v1/traces"), get("/v1/traces/{tid}"),
             get("/v1/traces/" + "e" * 32), get("/v1/traces?limit=zz")]
    want, got, *_ = both(scripts, calls)
    (rs, rh, rb), (ps, ph, pb) = want[0], got[0]
    assert ps == rs == 200
    tid = ph["x-trace-id"]
    assert len(tid) == 32 and tid != rh.get("x-trace-id")
    # the final frame (the unary fold) names the trace
    assert wire(pb)[-2 if stream else -1]["trace_id"] == tid
    assert wire(pb, tid) == wire(rb, wire(rb)[-2 if stream else -1][
        "trace_id"])
    # the index and the record
    assert index_rows(got[1][2]) == index_rows(want[1][2])
    assert json.loads(got[1][2])["traces"][0]["trace_id"] == tid
    g, w = json.loads(got[2][2]), json.loads(want[2][2])
    assert got[2][0] == want[2][0] == 200
    assert g["trace_id"] == tid
    assert summary(g) == summary(w)
    assert tree(g) == tree(w)
    names = [s["name"] for s in g["spans"]]
    assert names[0] == "gateway:POST /score/completions"
    assert g["spans"][0]["parent_id"] is None
    assert {"cache:lookup", "judge:stream", "judge:attempt",
            "consensus:tally"} <= set(names)
    # an unknown id: the reference's 404 body, byte for byte
    assert got[3][0] == want[3][0] == 404
    assert got[3][2] == want[3][2]
    assert got[4][0] == 200 and index_rows(got[4][2]) == index_rows(
        want[4][2])
    # the trace reads are never traced themselves
    assert "x-trace-id" not in got[1][1] and "x-trace-id" not in got[2][1]


def test_a_callers_traceparent_is_adopted_and_injected_upstream():
    scripts = [judge_script(KEYS3[1])]
    judges = [{"model": "judge-a", "weight": {"type": "static", "weight": 1}}]
    header = {"traceparent": f"00-{CALLER_TID}-{CALLER_SID}-01"}
    calls = [post("/score/completions", body(judges), header),
             get(f"/v1/traces/{CALLER_TID}")]
    # the sink's rate is 0: the caller's sampled flag wins anyway
    want, got, _, _, ref_t, port_t = both(scripts, calls, sink_rate=0.0)
    assert got[0][1]["x-trace-id"] == CALLER_TID
    g, w = json.loads(got[1][2]), json.loads(want[1][2])
    assert g["trace_id"] == CALLER_TID and g["sampled"] is True
    assert g["spans"][0]["parent_id"] == CALLER_SID
    assert tree(g) == tree(w) and summary(g) == summary(w)
    # the upstream judge call carries the caller's trace, with the
    # attempt span as its parent
    attempts = {s["span_id"] for s in g["spans"]
                if s["name"] == "judge:attempt"}
    [(_, headers, _)] = port_t.requests
    tid, parent, sampled = port_obs.parse_traceparent(headers["traceparent"])
    assert tid == CALLER_TID and sampled and parent in attempts
    ref_tp = ref_obs.parse_traceparent(ref_t.requests[0][1]["traceparent"])
    assert ref_tp[0] == CALLER_TID


def test_a_malformed_traceparent_starts_a_new_trace():
    scripts = [judge_script(KEYS3[1])]
    judges = [{"model": "judge-a"}]
    calls = [post("/score/completions", body(judges),
                  {"traceparent": "00-zz-bad-01"}),
             get("/v1/traces/{tid}")]
    _, got, *_ = both(scripts, calls)
    tid = got[0][1]["x-trace-id"]
    assert tid != "zz" and json.loads(got[1][2])["spans"][0][
        "parent_id"] is None


# -- forced retention -----------------------------------------------------------------


class Exploding:
    """A chat, score and multichat client whose every call raises."""

    async def create_unary(self, ctx, params):
        raise RuntimeError("boom")

    async def create_streaming(self, ctx, params):
        raise RuntimeError("boom")


def test_a_5xx_is_kept_at_rate_zero_with_its_trace_id_in_the_envelope():
    from llm_weighted_consensus_tpu.serve import build_app

    stub = Exploding()
    chat = {"model": "m", "messages": [{"role": "user", "content": "q"}]}
    calls = [post("/chat/completions", chat), get("/v1/traces/{tid}"),
             get("/v1/traces")]
    ref_sink = ref_obs.TraceSink(sample_rate=0.0)
    want = ref_calls(build_app(stub, stub, stub, trace_sink=ref_sink), calls)
    port_sink = port_obs.TraceSink(sample_rate=0.0)
    with Server(None, chat_client=stub, trace_sink=port_sink) as server:
        got = port_calls(server, calls)
    for (status, headers, raw), sink in ((got[0], port_sink),
                                         (want[0], ref_sink)):
        assert status == 500
        assert json.loads(raw)["trace_id"] == headers["x-trace-id"]
        assert sink.forced == 1
    assert wire(got[0][2], got[0][1]["x-trace-id"]) == \
        wire(want[0][2], want[0][1]["x-trace-id"])
    g, w = json.loads(got[1][2]), json.loads(want[1][2])
    assert summary(g) == summary(w) == {
        "name": "gateway:POST /chat/completions", "status": "error",
        "sampled": False, "forced": True, "force_reason": "http_500"}
    assert g["spans"][0]["attributes"]["http_status"] == 500


@pytest.mark.parametrize("stream", [False, True])
def test_an_all_failed_panel_is_kept_at_rate_zero(stream):
    b, scripts = CASES["all_failed_4xx"]
    calls = [post("/score/completions", {**b, "stream": stream}),
             get("/v1/traces/{tid}")]
    want, got, ref_sink, port_sink, *_ = both(scripts, calls, sink_rate=0.0)
    tid = got[0][1]["x-trace-id"]
    assert got[0][0] == want[0][0]
    assert wire(got[0][2], tid) == wire(
        want[0][2], want[0][1].get("x-trace-id") or _body_tid(want[0][2]))
    g, w = json.loads(got[1][2]), json.loads(want[1][2])
    assert g["force_reason"] == "all_failed" and summary(g) == summary(w)
    assert tree(g) == tree(w)
    assert port_sink.snapshot()["forced"] == 1




def test_sse_error_frames_carry_the_trace_id_and_force_the_trace():
    b, scripts = CASES["all_failed_5xx"]
    calls = [post("/score/completions", {**b, "stream": True}),
             get("/v1/traces/{tid}")]
    want, got, *_ = both(scripts, calls, sink_rate=0.0)
    tid = got[0][1]["x-trace-id"]
    frames = wire(got[0][2])
    # the final frame, then the AllVotesFailed envelope, then [DONE]
    assert frames[-1] == "[DONE]"
    assert frames[-2]["trace_id"] == tid and frames[-2]["code"] >= 400
    assert frames[-3]["trace_id"] == tid
    ref_tid = _body_tid(want[0][2])
    assert wire(got[0][2], tid) == wire(want[0][2], ref_tid)
    g = json.loads(got[1][2])
    assert g["forced"] is True


def test_parse_errors_and_the_413_carry_the_trace_id(tmp_path):
    calls = [post("/score/completions", b"{not json"),
             post("/score/completions", b'{"model": "m"}')]
    want, got, *_ = both([], calls)
    for (ps, ph, pb), (rs, rh, rb) in zip(got, want):
        assert ps == rs == 400
        assert json.loads(pb)["trace_id"] == ph["x-trace-id"]
        assert wire(pb, ph["x-trace-id"]) == wire(rb, rh["x-trace-id"])
    # the body cap: the reference's envelope with the trace id
    client, _ = make_client("port", [])
    sink = port_obs.TraceSink(sample_rate=1.0)
    with Server(None, chat_client=client.chat_client, score_client=client,
                trace_sink=sink, max_body_bytes=64) as server:
        (status, headers, raw), = port_calls(
            server, [post("/score/completions", b"x" * 64)])
    assert status == 413
    assert raw.decode() == (
        '{"code":413,"message":{"kind":"payload_too_large"},'
        f'"trace_id":"{headers["x-trace-id"]}"}}')
    record = sink.get(headers["x-trace-id"])
    assert record["spans"][0]["attributes"]["payload_too_large"] is True


# -- /v1/judges and /metrics -----------------------------------------------------------


def test_judges_routes_and_quality_sections_answer_as_the_reference():
    b, scripts = CASES["disagreement"]
    judge_ids = _judge_ids(TWO)
    calls = ([post("/score/completions", b)] * 3 + [
        get("/v1/judges"), get(f"/v1/judges/{judge_ids[0]}"),
        get("/v1/judges/nope"), get("/metrics")])
    want, got, *_ = both(scripts * 3, calls, ledger=True)
    for i in (3, 4, 5):
        assert got[i][0] == want[i][0]
        assert got[i][2] == want[i][2], i
    judges = json.loads(got[3][2])
    assert judges["window"] == 64 and len(judges["judges"]) == 2
    assert all(c["ballots"] == 3 for c in judges["judges"])
    assert got[5][0] == 404
    g, w = json.loads(got[6][2]), json.loads(want[6][2])
    assert g["quality"] == w["quality"]
    assert g["quality"]["requests"] == 3
    for section in (g["ledger"], w["ledger"]):
        section.pop("disk_path")
    assert g["ledger"] == w["ledger"] and g["ledger"]["kept"] == 3
    gt, wt = dict(g["traces"]), dict(w["traces"])
    assert gt == wt and gt["kept"] == 3
    # the route's series names its newest traced request
    assert len(g["series"]["http:/score/completions"]["trace_id"]) == 32


def _judge_ids(judges):
    from llm_weighted_consensus_tpu_torch.identity.model import ModelBase

    model = ModelBase.from_json_obj({"llms": judges}).into_model_validate()
    return [llm.id for llm in model.llms]


def test_judges_are_served_without_a_sink_and_tracing_off_changes_nothing():
    b, scripts = CASES["agreement"]
    calls = [post("/score/completions", b),
             post("/score/completions", {**b, "stream": True}),
             post("/score/completions", b"{not json"),
             get("/v1/traces"), get("/v1/judges")]
    want = ref_calls(ref_app(scripts * 2)[0], calls)
    server, _ = port_server(scripts * 2)
    with server:
        got = port_calls(server, calls)
    for (ps, ph, pb), (rs, _, rb) in zip(got[:3], want[:3]):
        assert ps == rs and "x-trace-id" not in ph
        assert "trace_id" not in pb.decode()
        assert wire(pb) == wire(rb)
    assert got[3][0] == 404
    assert got[4][0] == want[4][0] == 200 and got[4][2] == want[4][2]


# -- the device path -----------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_embedders():
    params = jax_bert.init_params(jax.random.PRNGKey(0), jax_configs.TEST_TINY)
    state = convert.from_jax_params(
        jax.tree_util.tree_map(np.asarray, params), configs.TEST_TINY)
    ref = TpuEmbedder("test-tiny", params=params, max_tokens=32)
    port = TorchEmbedder(
        "test-tiny",
        model=bert.from_hf_state_dict(state, configs.TEST_TINY, device="cpu"),
        max_tokens=32, device="cpu")
    return ref, port


def test_consensus_tree_through_the_batcher_matches_the_reference(
        tiny_embedders):
    texts = ["the answer is 42", "the answer is 42!", "cabbage"]
    calls = [post("/consensus", {"input": texts}), get("/v1/traces/{tid}"),
             post("/embeddings", {"model": "test-tiny", "input": texts}),
             get("/v1/traces/{tid}")]
    ref_sink = ref_obs.TraceSink(sample_rate=1.0)
    app, _ = ref_app([], ref_sink, embedder=tiny_embedders[0])
    want = ref_calls(app, calls)
    port_sink = port_obs.TraceSink(sample_rate=1.0)
    server, _ = port_server([], port_sink, embedder=tiny_embedders[1])
    with server:
        got = port_calls(server, calls)
    for i in (1, 3):
        g, w = json.loads(got[i][2]), json.loads(want[i][2])
        assert tree(g) == tree(w) and summary(g) == summary(w)
    g = json.loads(got[1][2])
    by_name = {s["name"]: s for s in g["spans"]}
    root = by_name["gateway:POST /consensus"]
    queued = by_name["batcher:consensus"]
    device = by_name["device:dispatch"]
    assert queued["parent_id"] == root["span_id"]
    assert device["parent_id"] == queued["span_id"]
    assert device["attributes"] == {"kind": "consensus", "batch_size": 1}
    # every named phase is accounted for, the phases within e2e
    breakdown = root["attributes"]["phase_breakdown"]
    assert breakdown["device_dispatch"] > 0
    assert breakdown["e2e_ms"] == root["duration_ms"]
    named = sum(v for k, v in breakdown.items()
                if k not in ("e2e_ms", "other_ms"))
    assert named <= breakdown["e2e_ms"] + 1e-3
    # the answers are the untraced server's
    with Server(tiny_embedders[1], window_ms=1.0) as untraced:
        plain = port_calls(untraced, calls[:1])
    assert json.loads(plain[0][2]) == json.loads(got[0][2])
    assert json.loads(got[0][2])["confidence"] == pytest.approx(
        json.loads(want[0][2])["confidence"], abs=1e-6)


def test_admission_wait_is_observed_once_per_admitted_request(
        tiny_embedders):
    texts = ["a b", "b c", "c d"]
    calls = [post("/consensus", {"input": texts})] * 5 + [get("/metrics")]
    app, _ = ref_app([], None, embedder=tiny_embedders[0])
    want = ref_calls(app, calls)
    ref_count = json.loads(want[-1][2])["phases"]["admission_wait"]["count"]
    port_obs.reset_phases()
    server, _ = port_server([], None, embedder=tiny_embedders[1])
    with server:
        got = port_calls(server, calls)
    phases = json.loads(got[-1][2])["phases"]
    assert phases["admission_wait"]["count"] == ref_count == 5
    assert phases["batcher_queue"]["count"] == 5


def test_a_shed_request_keeps_its_trace_with_the_shed_reason(tiny_embedders):
    sink = port_obs.TraceSink(sample_rate=0.0)
    server, _ = port_server([], sink, embedder=tiny_embedders[1],
                            ready=False)
    with server:
        (status, headers, raw), = port_calls(
            server, [post("/consensus", {"input": ["a", "b"]})])
        port_obs.reset_phases()
        server.lifecycle.mark_ready()
        port_calls(server, [post("/consensus", {"input": ["a", "b"]})])
        phases = port_obs.phases_snapshot()
    assert status == 503 and headers["Retry-After"] == "1"
    body = json.loads(raw)
    assert body["message"]["shed_reason"] == "warming"
    assert body["trace_id"] == headers["x-trace-id"]
    record = sink.get(headers["x-trace-id"])
    assert record["forced"] and record["force_reason"] == "http_503"
    attrs = record["spans"][0]["attributes"]
    assert attrs["shed_reason"] == "warming" and attrs["http_status"] == 503
    assert "admission_wait_ms" not in attrs
    # the admitted request is observed, the shed one is not
    assert phases["admission_wait"]["count"] == 1
    assert sink.snapshot()["dropped"] == 1


def test_a_full_queue_sheds_with_a_batcher_span(tiny_embedders):
    """An item the batcher's queue bound refuses: its span is finished
    errored with ``shed="queue_full"``, and the 503 keeps the trace."""
    sink = port_obs.TraceSink(sample_rate=1.0)
    server, _ = port_server(
        [], sink, embedder=tiny_embedders[1],
        admission=AdmissionConfig(max_queue_depth=1))
    with server:
        batcher = server.batcher
        with batcher._cond:
            batcher._pending.append(object())  # the queue is full
        try:
            (status, headers, _), = port_calls(
                server, [post("/consensus", {"input": ["a", "b"]})])
        finally:
            with batcher._cond:
                batcher._pending.clear()
    assert status == 503
    record = sink.get(headers["x-trace-id"])
    spans = {s["name"]: s for s in record["spans"]}
    assert spans["batcher:consensus"]["attributes"]["shed"] == "queue_full"
    assert spans["batcher:consensus"]["status"] == "error"
    assert "device:dispatch" not in spans


class SlowSink(port_obs.TraceSink):
    """A sink whose ``offer`` takes 200 ms: a trace offered after the
    answer's last bytes would still be missing when the client, holding
    its answer, reads ``/v1/traces``."""

    def offer(self, trace) -> None:
        import time

        time.sleep(0.2)
        super().offer(trace)


@pytest.mark.parametrize("stream", [False, True])
def test_the_trace_is_offered_before_the_answer_is_written(stream):
    b, scripts = CASES["agreement"]
    calls = [post("/score/completions", {**b, "stream": stream}),
             get("/v1/traces"), get("/v1/traces/{tid}")]
    server, _ = port_server(scripts, SlowSink(sample_rate=1.0))
    with server:
        got = port_calls(server, calls)
    assert got[0][0] == 200
    tid = got[0][1]["x-trace-id"]
    assert [e["trace_id"] for e in json.loads(got[1][2])["traces"]] == [tid]
    assert got[2][0] == 200
    record = json.loads(got[2][2])
    assert record["trace_id"] == tid
    root = record["spans"][0]
    assert root["attributes"]["http_status"] == 200
    breakdown = root["attributes"]["phase_breakdown"]
    assert breakdown["e2e_ms"] <= record["duration_ms"] + 1e-6
