"""``bench http`` on the CPU at test-tiny: the port's server started in
process through ``build_server`` / ``warm_up``, driven by the stdlib
client, one record per scenario with the reference's keys (less the
written renames of ``tests/test_torch_bench.py``), and the open-loop
pacer holding its schedule against a slow server.  ``--fleet`` and
``--fleet-partition`` run three host-only replicas and meet the
reference's acceptance (``bench_http.py``'s notes): warm
``upstream_calls`` 0 and hot ``upstream_calls`` 1; under the partition
every answer is 200 and clean, at most one fan-out per component."""

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from llm_weighted_consensus_tpu_torch.bench import http as port_http
from test_torch_bench import expected, ref_http_keys


def _run(argv, capsys) -> list:
    args = port_http.parse(["--device", "cpu", "--quick", "--concurrency",
                            "4", *argv])
    port_http.run_http(args, "cpu")
    return [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()]


def test_the_trio_gives_one_record_each(capsys):
    records = _run(["--requests", "8"], capsys)
    assert [r["endpoint"] for r in records] == [
        "/consensus", "/score/completions", "/multichat/completions"]
    funcs = ("bench_consensus_endpoint", "bench_score_endpoint",
             "bench_multichat_endpoint")
    for record, func in zip(records, funcs):
        assert set(record) == expected(ref_http_keys(func),
                                       record["endpoint"])
        assert record["value"] > 0 and record["p50_ms"] > 0
    consensus = records[0]
    assert consensus["requests"] == 8 and consensus["n_candidates"] == 8
    # every bucket the burst formed was warmed (on the CPU the warmed keys
    # are recorded and nothing is captured)
    assert consensus["graphs"]["eager_dispatches"] == 0
    assert consensus["served_vs_direct"] > 0


def test_cache_warm_hits_with_one_upstream_call(capsys):
    (record,) = _run(["--cache", "warm", "--requests", "8"], capsys)
    assert record["endpoint"] == "/score/completions?cache=warm"
    assert set(record) == expected(ref_http_keys("bench_score_cache"),
                                   "cache")
    assert record["score_cache"]["hits"] > 0
    # the repeated body: its priming request, then hits only
    assert record["hit_body_upstream_calls"] == 1


def test_faults_degrade_a_share_of_the_answers(capsys):
    (record,) = _run(["--faults", "--requests", "12"], capsys)
    assert record["endpoint"] == "/score/completions?faults"
    assert set(record) == expected(ref_http_keys("bench_score_faults"),
                                   "faults")
    assert record["degraded_rate"] > 0
    assert record["error_rate"] == 0
    assert record["resilience"]["fault_plan"]["injected"]


class _Slow(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *args):
        pass

    def do_POST(self):
        self.rfile.read(int(self.headers.get("content-length") or 0))
        time.sleep(0.4)
        self.send_response(200)
        self.send_header("content-length", "2")
        self.end_headers()
        self.wfile.write(b"{}")


def test_the_open_loop_pacer_keeps_its_schedule_against_a_slow_server():
    server = ThreadingHTTPServer(("127.0.0.1", 0), _Slow)
    server.daemon_threads = True
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]
    try:
        def fire(body):
            t0 = time.perf_counter()
            status, _ = port_http.post(port, "/slow", body)
            return status, time.perf_counter() - t0

        interval, n = 0.05, 12
        outs, offsets, total = port_http.open_loop(
            fire, ["{}"] * n, interval)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(5)
    assert not thread.is_alive()
    assert [status for status, _ in outs] == [200] * n
    assert all(seconds >= 0.4 for _, seconds in outs)
    # arrival i leaves at i x interval whatever the server does: a
    # closed loop would need n x 0.4 s
    for i, offset in enumerate(offsets):
        assert offset == pytest.approx(i * interval, abs=0.04)
    assert total < n * interval + 0.4 + 1.0 < n * 0.4


def test_fleet_meets_the_references_acceptance(capsys):
    (record,) = _run(["--fleet", "--requests", "12"], capsys)
    assert record["endpoint"] == "/score/completions?fleet"
    assert set(record) == expected(ref_http_keys("bench_fleet"), "fleet")
    assert record["cold"]["upstream_calls"] == 12
    assert record["warm"]["upstream_calls"] == 0
    assert record["hot_stampede"]["upstream_calls"] == 1
    assert record["replicas"] == 3 and record["peer_fetch_hits"] > 0
    for phase in ("cold", "warm", "hot_stampede"):
        assert set(record[phase]) == {"rps", "p50_ms", "p99_ms",
                                      "upstream_calls"}


def test_fleet_partition_answers_clean_under_the_cut(capsys):
    (record,) = _run(["--fleet-partition", "--requests", "12"], capsys)
    assert record["endpoint"] == "/score/completions?fleet-partition"
    assert set(record) == expected(ref_http_keys("bench_fleet_partition"),
                                   "fleet_partition")
    healthy, cut = record["healthy_warm"], record["partitioned_warm"]
    assert healthy["upstream_calls"] == 0 and healthy["dirty_frames"] == 0
    assert cut["dirty_frames"] == 0
    # each fingerprint fans out at most once per component
    assert cut["cold_upstream_calls"] == 12
    assert cut["cold_upstream_calls"] + cut["upstream_calls"] <= 24
    assert record["quarantines"] > 0 and record["peer_errors"] > 0
