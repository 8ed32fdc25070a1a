"""Overload, lifecycle, configuration and metrics of the port's server on
the CPU, against the JAX package's.

* ``AdmissionController`` and ``DeviceWatchdog`` make the reference's
  decisions on scripted clocks (the scripts of
  ``tests/test_lifecycle.py``), run op by op on both;
* ``_parse_warmup`` / ``_parse_warmup_r`` accept and reject the same
  specs, with the same values and messages, and the knobs read the
  reference's defaults;
* ``render_prometheus`` is text-identical to the reference's on the
  shared families (series, phases, device buckets, lanes) given the
  same observations;
* ``/livez``, ``/readyz`` and ``/metrics`` over the stdlib server: 503
  until warmup has finished, a scrape that parses, and a drain that
  lets in-flight requests finish while new ones shed.
Exact equality throughout.
"""

import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from llm_weighted_consensus_tpu.obs import phases as ref_phases
from llm_weighted_consensus_tpu.resilience import admission as ref_admission
from llm_weighted_consensus_tpu.resilience import watchdog as ref_watchdog
from llm_weighted_consensus_tpu.serve import config as ref_config
from llm_weighted_consensus_tpu.serve import metrics as ref_metrics
from llm_weighted_consensus_tpu_torch.models import bert, configs
from llm_weighted_consensus_tpu_torch.models.embedder import TorchEmbedder
from llm_weighted_consensus_tpu_torch.obs import phases
from llm_weighted_consensus_tpu_torch.resilience import admission, watchdog
from llm_weighted_consensus_tpu_torch.serve import config, metrics
from llm_weighted_consensus_tpu_torch.serve.gateway import Server
from llm_weighted_consensus_tpu_torch.serve.lifecycle import (
    DRAINING,
    READY,
    STARTING,
    STOPPED,
    Lifecycle,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- admission and the watchdog, op by op against the reference ----------------


def _admission_script(mod, now):
    """The reference tests' admission scripts as one op list; -> every
    decision, every limit and the snapshots."""
    out = []
    ctrl = mod.AdmissionController(mod.AdmissionConfig())
    out.append([ctrl.try_acquire() for _ in range(5)])
    for _ in range(5):
        ctrl.release(5.0)
    out.append(ctrl.snapshot())
    ctrl = mod.AdmissionController(mod.AdmissionConfig(max_inflight=2))
    out.append([ctrl.try_acquire() for _ in range(3)])
    ctrl.release(5.0)
    out.append([ctrl.try_acquire(), ctrl.snapshot()])
    ctrl.draining = True
    out.append([ctrl.try_acquire(), ctrl.try_acquire(device_work=True)])
    ctrl = mod.AdmissionController(
        mod.AdmissionConfig(max_inflight=10),
        device_gate=lambda: "device_unhealthy",
    )
    out.append([ctrl.try_acquire(), ctrl.try_acquire(device_work=True),
                ctrl.shed])
    ctrl = mod.AdmissionController(
        mod.AdmissionConfig(max_inflight=10, adaptive=True, min_limit=2,
                            latency_factor=2.0),
        clock=lambda: now[0],
    )
    for ms, step in ((10.0, 0), (100.0, 0), (100.0, 0), (100.0, 1.0),
                     (12.0, 0), (300.0, 0.01), (300.0, 1.0)):
        now[0] += step
        ctrl.try_acquire()
        ctrl.release(ms)
        out.append(round(ctrl.limit, 9))
    while ctrl.try_acquire() is None:
        pass
    out.append(ctrl.inflight)
    ctrl.release(12.0)
    out.append([round(ctrl.limit, 9), ctrl.snapshot()])
    return out


def test_admission_decides_as_the_reference():
    assert _admission_script(admission, [0.0]) == _admission_script(
        ref_admission, [0.0]
    )


def test_shed_response_is_the_reference_envelope():
    status, headers, body = admission.shed_response("inflight_limit", 1500.0)
    ref = ref_admission.shed_response("inflight_limit", 1500.0)
    assert status == ref.status == 503
    assert headers["Retry-After"] == ref.headers["Retry-After"] == "2"
    assert json.loads(body) == json.loads(ref.text)


def _watchdog_script(mod):
    now, events = [0.0], []
    wd = mod.DeviceWatchdog(
        100.0, clock=lambda: now[0],
        on_trip=lambda label, ms: events.append(("trip", label, ms)),
        on_recover=lambda: events.append(("recover",)),
    )
    out = []
    t1 = wd.begin("embed")
    now[0] = 0.05
    out.append(wd.check())
    t2 = wd.begin("consensus")
    now[0] = 0.2
    out += [wd.check(), wd.check(), wd.trips, wd.snapshot()]
    wd.end(t1)
    out += [wd.healthy(), wd.snapshot()]
    now[0] = 0.4
    out.append(wd.check())
    wd.end(t2)
    out += [wd.healthy(), wd.recoveries, wd.snapshot(), events]
    return out


def test_watchdog_decides_as_the_reference():
    assert _watchdog_script(watchdog) == _watchdog_script(ref_watchdog)


# -- the lifecycle --------------------------------------------------------------


class _FakeBatcher:
    def __init__(self, clean=True):
        self.clean = clean
        self.drains = 0

    def drain(self, timeout_sec):
        self.drains += 1
        return self.clean


def test_lifecycle_is_not_ready_until_warmup_and_drains_once():
    ctrl = admission.AdmissionController(admission.AdmissionConfig())
    batcher = _FakeBatcher()
    lc = Lifecycle(admission=ctrl, batcher=batcher, state=STARTING)
    assert lc.ready() == (False, STARTING)
    lc.mark_ready()
    assert lc.ready() == (True, None)
    first, second = lc.begin_drain(), lc.begin_drain()
    assert first is second  # idempotent: every SIGTERM joins one drain
    assert first.result(5) is True
    assert lc.state == STOPPED and ctrl.draining and batcher.drains == 1
    assert lc.ready() == (False, STOPPED)
    lc.mark_ready()  # no way back
    assert lc.snapshot()["state"] == STOPPED
    assert lc.snapshot()["drained_clean"] is True
    assert (READY, DRAINING) == ("ready", "draining")


def test_lifecycle_drain_timeout_is_unclean():
    ctrl = admission.AdmissionController(admission.AdmissionConfig())
    ctrl.inflight = 1  # a request that never finishes
    lc = Lifecycle(admission=ctrl, drain_timeout_ms=30.0)
    assert lc.drain() is False
    assert lc.drained_clean is False and lc.drain_elapsed_ms >= 30.0


def test_ready_reflects_watchdog_health():
    now = [0.0]
    wd = watchdog.DeviceWatchdog(100.0, clock=lambda: now[0])
    lc = Lifecycle(watchdog=wd)
    assert lc.ready() == (True, None)
    wd.begin("embed")
    now[0] = 1.0
    wd.check()
    assert lc.ready() == (False, "device_unhealthy")


# -- the knobs -------------------------------------------------------------------

WARMUP_SPECS = [None, "", "64x112,64x128", " 8x16 , ", "2x1", "256x512",
                "1x16", "257x16", "8x0", "8", "8x16x2", "axb", "8x16,,4x32"]
WARMUP_R_SPECS = [None, "", "2,4", "3", "1,2,3,4,5", "0", "-1", "x", "2,,8"]


def _outcome(fn, raw):
    try:
        return ("ok", fn(raw))
    except ValueError as exc:
        return ("error", str(exc))


@pytest.mark.parametrize("raw", WARMUP_SPECS)
def test_parse_warmup_matches_the_reference(raw):
    assert _outcome(config._parse_warmup, raw) == _outcome(
        ref_config._parse_warmup, raw
    )


@pytest.mark.parametrize("raw", WARMUP_R_SPECS)
def test_parse_warmup_r_matches_the_reference(raw):
    assert _outcome(config._parse_warmup_r, raw) == _outcome(
        ref_config._parse_warmup_r, raw
    )


def test_knobs_read_the_reference_defaults_and_clamps():
    env = {"BATCH_PIPELINE": "0", "BATCH_MAX_ROWS": "-4",
           "STAGING_BUFFERS": "3", "WARMUP": "64x100", "WARMUP_R": "3",
           "METRICS_DEVICE_TIMING": "0", "PACKING_ENABLED": "1",
           "PACKING_MAX_ROWS": "4"}
    for e in ({}, env):
        got = config.ServeConfig.from_env(e)
        want = ref_config.Config.from_env(e)
        for name in ("batch_window_ms", "batch_max", "batch_pipeline",
                     "batch_max_rows", "host_tokenizer_workers",
                     "warmup", "warmup_r",
                     "admission_max_inflight", "admission_max_queue_depth",
                     "drain_timeout_millis", "device_watchdog_millis",
                     "metrics_device_timing"):
            assert getattr(got, name) == getattr(want, name), name
        assert config.staging_buffers(e) == want.staging_buffers
    got = config.ServeConfig.from_env(env)
    assert got.packed_buckets() == [(1, 512, 64), (2, 512, 64),
                                    (4, 512, 64), (1, 64, 64), (1, 128, 64),
                                    (1, 192, 64), (1, 256, 64), (1, 384, 64)]
    assert config.ServeConfig.from_env({"RM_WARMUP": "16x128"}).rm_warmup == [
        (16, 128)]
    for bad, match in (({"WARMUP_R": "2"}, "WARMUP is empty"),
                       ({"DRAIN_TIMEOUT_MILLIS": "-1"}, "DRAIN_TIMEOUT"),
                       ({"DEVICE_WATCHDOG_MILLIS": "-5"}, "WATCHDOG"),
                       ({"RM_WARMUP": "1x4"}, "RM_WARMUP spec")):
        with pytest.raises(ValueError, match=match):
            config.ServeConfig.from_env(bad)
    with pytest.raises(ValueError, match="STAGING_BUFFERS"):
        config.staging_buffers({"STAGING_BUFFERS": "-1"})


def test_staging_buffers_size_both_models_pools():
    from llm_weighted_consensus_tpu_torch.serve.__main__ import (
        build_embedder,
        build_reranker,
    )

    env = {"EMBEDDER_MODEL": "test-tiny", "RM_MODEL": "deberta-test-tiny",
           "LWC_ALLOW_RANDOM_PARAMS": "1", "STAGING_BUFFERS": "5"}
    for model in (build_embedder(env, device="cpu"),
                  build_reranker(env, device="cpu")):
        assert model.staging_pool.stats()["per_bucket"] == 5
    with pytest.raises(ValueError, match="STAGING_BUFFERS"):
        build_embedder(dict(env, STAGING_BUFFERS="-1"), device="cpu")


# -- the Prometheus exposition against the reference's ----------------------------

SHARED = ("lwc_series_requests", "lwc_series_errors", "lwc_series_latency_ms",
          "lwc_phase_latency_ms", "lwc_device_latency_ms", "lwc_lane_")
LANES = {"lanes": {
    "latency": {"queue_depth": 0, "dispatches": 7, "items": 19,
                "busy_fraction": 0.4321},
    "offline": {"queue_depth": 2, "dispatches": 1, "items": 3,
                "busy_fraction": 0.05},
}}


def _families(text: str) -> list:
    keep, lines = False, []
    for line in text.splitlines():
        if line.startswith("# HELP ") or line == "# EOF":
            keep = line.startswith("# HELP ") and line.split()[2].startswith(
                SHARED)
        if keep:
            lines.append(line)
    return lines


def test_render_prometheus_matches_the_reference_on_shared_families():
    rendered = []
    for mods in ((metrics, phases), (ref_metrics, ref_phases)):
        mod, ph = mods
        ph.reset_phases()
        m = mod.Metrics()
        for series, ms, err in (("http:/consensus", 12.5, False),
                                ("http:/consensus", 800.0, True),
                                ("device:batch:consensus", 3.25, False),
                                ("device:shed:queue_full", 0.0, True)):
            m.observe(series, ms, error=err)
        for phase, ms in (("batcher_queue", 1.5), ("device_dispatch", 40.0),
                          ("pack_plan", 0.25)):
            ph.observe_phase(phase, ms)
        ph.observe_device("many(r=8,n=64,s=128)", 645.8)
        ph.observe_device("vote1(n=16,s=512)", 90.0)
        m.register_provider("device_batcher", lambda: LANES)
        rendered.append(mod.render_prometheus(m))
    phases.reset_phases()
    ref_phases.reset_phases()
    port, ref = (_families(text) for text in rendered)
    # the port words two families' help its own way: its phases run to
    # held_idle, and its device histograms are CUDA-event time
    for family in ("lwc_phase_latency_ms", "lwc_device_latency_ms"):
        help_line = f"# HELP {family} "
        mine = next(line for line in port if line.startswith(help_line))
        ref = [mine if line.startswith(help_line) else line for line in ref]
    assert port == ref and len(port) > 40
    assert rendered[0].endswith("# EOF\n")


# -- the probes over the stdlib server -----------------------------------------


@pytest.fixture(scope="module")
def tiny():
    return TorchEmbedder(
        "test-tiny",
        model=bert.init_params(configs.TEST_TINY, seed=1, device="cpu"),
        max_tokens=32, device="cpu",
    )


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as resp:
            return resp.status, dict(resp.headers), resp.read().decode()
    except urllib.error.HTTPError as err:
        return err.code, dict(err.headers), err.read().decode()


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/consensus", data=json.dumps(body).encode(),
        headers={"content-type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, dict(resp.headers), json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, dict(err.headers), json.loads(err.read())


PROM_LINE = re.compile(r'^[a-z_]+(\{[^{}]*\})? -?[0-9.e+-]+(inf)?$')


def test_probes_and_metrics_over_http(tiny):
    with Server(tiny, ready=False, window_ms=1.0) as srv:
        assert _get(srv.port, "/livez")[0] == 200
        status, _, body = _get(srv.port, "/readyz")
        assert status == 503
        assert json.loads(body) == {"ready": False, "reason": "starting"}
        # device routes shed while the graphs are being captured
        status, headers, body = _post(srv.port, {"input": ["a", "b"]})
        assert status == 503 and headers["Retry-After"] == "1"
        assert body["message"]["shed_reason"] == "warming"
        timings = srv.warmup([(2, 16)], [2])
        assert [label for label, _ in timings] == [
            "vote1(2,16)", "embed(16,16)", "many(2,2,16)"]
        status, _, body = _get(srv.port, "/readyz")
        assert status == 200 and json.loads(body) == {"ready": True}
        assert _post(srv.port, {"input": ["a", "b"]})[0] == 200
        status, _, body = _get(srv.port, "/metrics")
        snap = json.loads(body)
        assert status == 200
        assert snap["graphs"]["embedder"]["graphs"] == 3
        assert snap["graphs"]["embedder"]["eager_dispatches"] == 0
        assert snap["device_batcher"]["dispatches"] == 1
        assert snap["admission"]["shed"] == {"warming": 1}
        assert snap["lifecycle"]["state"] == READY
        assert snap["series"]["http:/consensus"] == {
            "count": 2, "errors": 1, "p50_ms": snap["series"][
                "http:/consensus"]["p50_ms"],
            "p99_ms": snap["series"]["http:/consensus"]["p99_ms"]}
        assert set(snap["kernels"]) == {
            "cosine_vote", "attention", "segment_attention", "quantize_rows",
            "w8a8_matmul", "w4a8_matmul", "add_layer_norm", "gelu"}
        assert "device_dispatch" in snap["phases"]
        status, headers, text = _get(srv.port, "/metrics?format=prometheus")
        assert status == 200
        assert headers["content-type"].startswith(
            "application/openmetrics-text")
        lines = text.splitlines()
        assert lines[-1] == "# EOF"
        for line in lines[:-1]:
            assert line.startswith("# ") or PROM_LINE.match(line), line
        assert 'lwc_graphs{model="embedder"} 3' in lines
        assert ('lwc_graph_events_total{model="embedder",event="replays"} 0'
                in lines)


def test_drain_finishes_in_flight_requests_and_sheds_new_ones(tiny):
    with Server(tiny, window_ms=300.0) as srv:
        out = {}
        t = threading.Thread(target=lambda: out.setdefault(
            "first", _post(srv.port, {"input": ["x y", "y z", "z"]})))
        t.start()
        for _ in range(200):  # admitted and queued in the batcher
            if srv.admission.inflight:
                break
            time.sleep(0.005)
        drained = srv.lifecycle.begin_drain()
        for _ in range(200):
            if srv.lifecycle.state != READY:
                break
            time.sleep(0.005)
        status, _, body = _post(srv.port, {"input": ["a", "b"]})
        assert status == 503
        assert body["message"]["shed_reason"] == "draining"
        assert json.loads(_get(srv.port, "/readyz")[2])["ready"] is False
        assert drained.result(10) is True
        t.join(10)
    assert out["first"][0] == 200 and len(out["first"][2]["confidence"]) == 3
    assert srv.lifecycle.drained_clean is True


def test_sigterm_drains_the_server_process():
    env = dict(os.environ, EMBEDDER_MODEL="test-tiny", EMBEDDER_MAX_TOKENS="16",
               LWC_ALLOW_RANDOM_PARAMS="1", WARMUP="2x16", PYTHONPATH=REPO,
               LWC_NATIVE="0")
    with subprocess.Popen(
        [sys.executable, "-m", "llm_weighted_consensus_tpu_torch.serve",
         "--port", "0", "--address", "127.0.0.1", "--device", "cpu"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    ) as proc:
        port = None
        lines = []
        for line in proc.stderr:
            lines.append(line)
            found = re.search(r"on 127\.0\.0\.1:(\d+)", line)
            port = port or (found and int(found.group(1)))
            if line.rstrip().endswith("ready"):
                break
        assert port, lines
        assert _get(port, "/readyz")[0] == 200
        assert _post(port, {"input": ["p q", "q r"]})[0] == 200
        proc.send_signal(signal.SIGTERM)
        rest = proc.stderr.read()
        assert proc.wait(30) == 0
    assert "drained clean" in rest


def test_histogram_matches_the_reference():
    import random

    from llm_weighted_consensus_tpu.obs import histogram as ref_histogram
    from llm_weighted_consensus_tpu_torch.obs import histogram

    rng = random.Random(5)
    values = [0.0, 1e-3, 1e-4, 2.0 ** 30] + [
        10 ** rng.uniform(-4, 7) for _ in range(500)]
    port, ref = histogram.Histogram(), ref_histogram.Histogram()
    for v in values:
        port.observe(v)
        ref.observe(v)
    assert port.counts == ref.counts and port.sum == ref.sum
    assert list(port.cumulative()) == list(ref.cumulative())
    assert port.to_json_obj() == ref.to_json_obj()
    for q in (0.0, 0.25, 0.5, 0.9, 0.99, 1.0):
        assert port.quantile(q) == ref.quantile(q)
    for v in values[:50]:
        assert histogram.le_for(v) == ref_histogram.le_for(v)
    merged = histogram.Histogram().merge(port).merge(port)
    assert merged.count == 2 * port.count
