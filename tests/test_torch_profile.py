"""The port's profiler routes against the JAX gateway's.

``POST /v1/profile``, ``/profile/start`` and ``/profile/stop``
(``serve/profiling.py``): without ``PROFILE_DIR`` the reference's 403
body byte for byte and 404 for ``/profile/*``; with it the reference's
200 and 400 bodies (``no active trace``, ``trace already active``), a
one-shot capture on the CPU that writes a Chrome trace which parses, the
duration clamped to [10, 10000] ms, and ``/v1/profile`` answering under a
saturated admission gate (the reference's exemption) while
``/consensus`` sheds.
"""

import asyncio
import http.client
import json
import os
import threading
import time

import pytest

from llm_weighted_consensus_tpu_torch.models.embedder import TorchEmbedder
from llm_weighted_consensus_tpu_torch.resilience.admission import (
    AdmissionConfig,
)
from llm_weighted_consensus_tpu_torch.serve import profiling
from llm_weighted_consensus_tpu_torch.serve.gateway import Server


class Stub:
    """A chat, score and multichat client for the reference's app."""

    async def create_unary(self, ctx, params):
        raise RuntimeError("boom")

    async def create_streaming(self, ctx, params):
        raise RuntimeError("boom")


def ref_calls(calls, **app_kw):
    from aiohttp.test_utils import TestClient, TestServer

    from llm_weighted_consensus_tpu.serve import build_app

    stub = Stub()
    app = build_app(stub, stub, stub, **app_kw)

    async def run():
        client = TestClient(TestServer(app))
        await client.start_server()
        out = []
        try:
            for path, body in calls:
                resp = await client.post(path, data=body)
                out.append((resp.status, await resp.read()))
        finally:
            await client.close()
        return out

    return asyncio.new_event_loop().run_until_complete(run())


def port_calls(server, calls):
    out = []
    for path, body in calls:
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=60)
        try:
            conn.request("POST", path, body=body,
                         headers={"content-type": "application/json"})
            resp = conn.getresponse()
            out.append((resp.status, resp.read()))
        finally:
            conn.close()
    return out


@pytest.fixture(scope="module")
def tiny():
    return TorchEmbedder("test-tiny", max_tokens=32, device="cpu")


def test_without_profile_dir_the_codes_and_bodies_are_the_references(tiny):
    calls = [("/v1/profile", b"{}"), ("/v1/profile", b""),
             ("/profile/start", b""), ("/profile/stop", b"")]
    want = ref_calls(calls)
    with Server(tiny) as srv:
        got = port_calls(srv, calls)
    assert [s for s, _ in got] == [s for s, _ in want] == [403, 403, 404,
                                                           404]
    assert got[0][1] == want[0][1] == (
        b'{"code": 403, "message": "profiling disabled: set PROFILE_DIR"}')
    assert got[1][1] == want[1][1]


def test_with_profile_dir_the_codes_and_bodies_are_the_references(
        tiny, tmp_path):
    profile_dir = str(tmp_path)
    calls = [("/profile/stop", b""), ("/profile/start", b""),
             ("/profile/start", b""), ("/v1/profile", b'{"duration_ms": 5}'),
             ("/profile/stop", b""), ("/profile/stop", b"")]
    want = ref_calls(calls, profile_dir=profile_dir)
    with Server(tiny, profile_dir=profile_dir) as srv:
        got = port_calls(srv, calls)
        traces = list(srv.profiler.traces)
    assert got == want
    assert [s for s, _ in got] == [400, 200, 400, 400, 200, 400]
    assert json.loads(got[0][1]) == {"code": 400,
                                     "message": "no active trace"}
    assert json.loads(got[2][1]) == {"code": 400,
                                     "message": "trace already active"}
    assert len(traces) == 1 and os.path.dirname(traces[0]) == profile_dir


def test_a_one_shot_capture_writes_a_trace_that_parses(tiny, tmp_path):
    with Server(tiny, profile_dir=str(tmp_path), window_ms=1.0) as srv:
        box = {}

        def capture():
            box["out"] = port_calls(srv, [("/v1/profile",
                                           b'{"duration_ms": 400}')])[0]

        thread = threading.Thread(target=capture)
        thread.start()
        while srv.profiler._prof is None and thread.is_alive():
            time.sleep(0.005)
        srv.batcher.consensus(["one two", "three four", "five"])
        # a second trace meanwhile: the profiler is process-global
        busy = port_calls(srv, [("/profile/start", b"")])[0]
        thread.join(60)
        assert not thread.is_alive()
        short = port_calls(srv, [("/v1/profile", b'{"duration_ms": 1}')])[0]
        path = srv.profiler.traces[0]
    assert busy == (400, b'{"code": 400, "message": "trace already active"}')
    status, body = box["out"]
    assert status == 200 and json.loads(body) == {
        "ok": True, "dir": str(tmp_path), "duration_ms": 400.0}
    assert short[0] == 200 and json.loads(short[1])["duration_ms"] == 10.0
    with open(path) as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("aten::" in n for n in names), sorted(names)[:20]


def test_the_duration_is_clamped_above(tmp_path, monkeypatch):
    slept = []
    monkeypatch.setattr(profiling.time, "sleep", slept.append)
    routes = profiling.ProfileRoutes(str(tmp_path))
    try:
        status, body = routes.capture(b'{"duration_ms": 99999}')
        assert (status, body["duration_ms"], slept) == (200, 10000.0, [10.0])
        status, body = routes.capture(b"not json")
        assert body["duration_ms"] == 500.0 and slept[-1] == 0.5
    finally:
        routes.close()


def test_close_stops_a_running_trace(tiny, tmp_path):
    srv = Server(tiny, profile_dir=str(tmp_path)).start()
    try:
        assert port_calls(srv, [("/profile/start", b"")])[0][0] == 200
    finally:
        srv.close()
    (path,) = srv.profiler.traces
    with open(path) as f:
        assert "traceEvents" in json.load(f)


@pytest.mark.parametrize("with_dir", [False, True])
def test_v1_profile_answers_under_a_saturated_gate(tiny, tmp_path, with_dir):
    from llm_weighted_consensus_tpu.resilience.admission import (
        AdmissionConfig as RefAdmissionConfig,
        AdmissionController as RefAdmission,
    )

    profile_dir = str(tmp_path) if with_dir else None
    calls = [("/v1/profile", b'{"duration_ms": 10}')]
    ref_gate = RefAdmission(RefAdmissionConfig(max_inflight=1))
    assert ref_gate.try_acquire() is None
    want = ref_calls(calls, admission=ref_gate, profile_dir=profile_dir)
    with Server(tiny, admission=AdmissionConfig(max_inflight=1),
                profile_dir=profile_dir) as srv:
        assert srv.admission.try_acquire() is None  # the one slot, held
        got = port_calls(srv, calls + [("/consensus",
                                        b'{"input": ["a", "b"]}')])
    assert got[0][0] == want[0][0] == (200 if with_dir else 403)
    if not with_dir:
        assert got[0][1] == want[0][1]
    assert got[1][0] == 503 and json.loads(got[1][1])["message"][
        "shed_reason"] == "inflight_limit"
