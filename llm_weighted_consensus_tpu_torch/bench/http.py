"""Gateway-level bench: answers/s and p50 through the port's HTTP server
(the counterpart of the reference's ``bench_http.py``).

The server is the port's own, started in this process the way ``python
-m llm_weighted_consensus_tpu_torch.serve --fake-upstream`` starts it:
``build_embedder``, ``build_server`` and ``warm_up`` from a
``ServeConfig`` of the serving environment, on an ephemeral port, with
``serve/fake_upstream.py``'s loopback provider as the upstream and the
bench WordPiece vocabulary.  ``WARMUP`` / ``WARMUP_R`` are set to the
buckets the scenario's traffic forms, so its dispatches replay CUDA
graphs, and every record carries the graph counters' rise (``graphs``).
The client is the standard library's: ``http.client`` on a thread pool,
SSE read line by line.  Every record embeds the timed window's phase
breakdown and quality summary, as the reference's do.

Scenarios (the reference's flags): the endpoint trio (``/consensus`` with
its served/direct ratio, streamed ``/score/completions``, unary
``/multichat/completions`` with the consensus overlay); ``--cache
off|cold|warm``; ``--faults [SPEC]``; ``--overload`` (open loop, arrivals
paced by a scheduler thread, not by responses); ``--trace-overhead``;
``--mixed-lengths``; ``--overlap``; ``--offline``; ``--fleet`` and
``--fleet-partition``.  ``--trace-overhead`` and ``--offline`` run their
settings in alternating rounds on servers warmed once (the tracing
servers share one embedder) and report every round's delta, the median
and the spread.  ``--fleet`` and ``--fleet-partition`` start three
host-only replicas of the port's server on loopback (``FLEET_SELF`` /
``FLEET_PEERS``, ``SCORE_CACHE_TTL=600``) over one counting fake
upstream (``FAKE_UPSTREAM_DELAY_MS`` 25 unless set): cold, warm and
hot-stampede rounds, and, for the partition, a second trio under
``FLEET_FAULT_PLAN`` specs carving ``{a} | {b, c}``.  Between rounds
they wait for the owners' publish counters to account for the cold
round (the reference sleeps 0.3 s).  ``--mesh-faults`` serves
``/consensus`` from a 4x2 mesh with the fault ladder (``MESH_FAULT_*``)
in three closed-loop phases: healthy, then with ``DEVICE_FAULT_PLAN``
``script=persistent`` armed (one downsize, the in-flight groups
re-dispatched on the warmed 2x2 rung), then after the recovery probe.
Its mesh lies on the local cards where there are eight, else on the
first card repeated (an explicit device list, as ``chip_smoke.py`` phase
20 builds it; the server's ``MESH_SHAPE`` never repeats a card), and the
record says which (``cards``).

Run: ``python -m llm_weighted_consensus_tpu_torch.bench http [--quick]
[--model M] [--n 64] [--requests 100] [--concurrency 16]``.
"""

from __future__ import annotations

import argparse
import gc
import http.client
import json
import os
import statistics
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from . import common
from .headline import build

NAME = "http"
# alternating rounds of --trace-overhead and --offline (the reference's)
ROUNDS = 5
DEFAULT_FAULTS = "seed=42,stall_first=0.2,stall_mid=0.1,stall_ms=400"


# -- the stdlib client ---------------------------------------------------------------


def post(port: int, path: str, body, method: str = "POST",
         timeout: float = 300.0) -> tuple:
    """(status, body bytes) of one request on a fresh connection; an SSE
    body is read line by line to its end."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        raw = body.encode() if isinstance(body, str) else body
        conn.request(method, path, body=raw,
                     headers={"content-type": "application/json"})
        resp = conn.getresponse()
        if resp.getheader("content-type", "").startswith(
                "text/event-stream"):
            lines = []
            while True:
                line = resp.readline()
                if not line:
                    break
                lines.append(line)
            return resp.status, b"".join(lines)
        return resp.status, resp.read()
    finally:
        conn.close()


def get_json(port: int, path: str) -> dict:
    status, raw = post(port, path, None, method="GET")
    if status != 200:
        raise RuntimeError(f"GET {path}: {status} {raw[:200]!r}")
    return json.loads(raw)


def sse_objs(text: str) -> list:
    """Every ``data:`` frame of an SSE body (``[DONE]`` skipped)."""
    objs = []
    for line in text.splitlines():
        if not line.startswith("data: "):
            continue
        payload = line[len("data: "):]
        if payload.strip() == "[DONE]":
            continue
        try:
            objs.append(json.loads(payload))
        except ValueError:
            pass
    return objs


def drive(port: int, path: str, bodies: list, concurrency: int,
          warmup_bursts: int = 2) -> tuple:
    """Closed loop: ``bodies`` with ``concurrency`` in flight ->
    (seconds, latencies ms).  ``warmup_bursts`` untimed bursts of
    ``concurrency`` requests first; the phase and quality aggregators are
    reset at the start of the timed window."""
    from ..obs import reset_phases, reset_quality

    def one(body, record=True):
        t0 = time.perf_counter()
        status, raw = post(port, path, body)
        if status != 200:
            raise RuntimeError(f"POST {path}: {status} {raw[:300]!r}")
        return (time.perf_counter() - t0) * 1e3 if record else None

    with ThreadPoolExecutor(concurrency) as pool:
        for _ in range(warmup_bursts):
            burst = (bodies * (concurrency // len(bodies) + 1))[:concurrency]
            list(pool.map(lambda b: one(b, False), burst))
        reset_phases()
        reset_quality()
        t0 = time.perf_counter()
        lat = list(pool.map(one, bodies))
        total = time.perf_counter() - t0
    return total, lat


def open_loop(fire, items: list, interval: float) -> tuple:
    """Open loop: item i is handed to ``fire`` at ``i * interval`` s after
    the start, on its own thread, whether or not earlier ones answered
    (this thread is the scheduler) -> (results, offsets s, seconds)."""
    pool = ThreadPoolExecutor(max(1, len(items)))
    futures, offsets = [], []
    try:
        t_start = time.perf_counter()
        for i, item in enumerate(items):
            delay = t_start + i * interval - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            offsets.append(time.perf_counter() - t_start)
            futures.append(pool.submit(fire, item))
        results = [f.result() for f in futures]
        total = time.perf_counter() - t_start
    finally:
        pool.shutdown()
    return results, offsets, total


# -- the service ---------------------------------------------------------------------


class Service:
    """The port's server on an ephemeral port with its fake upstream."""

    def __init__(self, server, fake, embedder, config) -> None:
        self.server = server
        self.fake = fake
        self.embedder = embedder
        self.config = config

    @property
    def port(self) -> int:
        return self.server.port

    def graphs(self) -> dict:
        return self.embedder.graph_stats() if self.embedder else {}

    def close(self) -> None:
        self.server.close()
        self.fake.close()


def r_buckets(concurrency: int, n: int, max_rows: int = 512) -> str:
    """The coalesced R buckets a burst of ``concurrency`` requests of N
    candidates can form under the batcher's row cap."""
    out, r = [], 2
    while r <= min(concurrency, max_rows // max(1, n)):
        out.append(str(r))
        r *= 2
    return ",".join(out)


def start_service(model: str, device: str, window_ms: float,
                  quantize: str = "none", cache_ttl_sec: float = 0.0,
                  extra_env: dict = None, warmup: str = "",
                  warmup_r: str = "", embedder=None) -> Service:
    """The server ``python -m ...serve --fake-upstream`` would start, with
    the bench vocabulary; ``embedder`` shares a warmed model."""
    from ..serve.__main__ import build_server, warm_up
    from ..serve.config import ServeConfig
    from ..serve.fake_upstream import FakeUpstream
    from .headline import build

    env = {"EMBEDDER_MODEL": model, "BATCH_WINDOW_MS": str(window_ms),
           "EMBEDDER_QUANTIZE": quantize, "LWC_ALLOW_RANDOM_PARAMS": "1",
           "MEMGUARD": "0"}
    if warmup:
        env["WARMUP"] = warmup
    if warmup_r:
        env["WARMUP_R"] = warmup_r
    if cache_ttl_sec > 0:
        env["SCORE_CACHE_TTL"] = str(cache_ttl_sec)
    env.update(extra_env or {})
    fake = FakeUpstream()
    config = ServeConfig.from_env(env)
    config.upstream["api_bases"] = [{"api_base": fake.url,
                                     "api_key": "fake-key"}]
    if embedder is None:
        embedder = build(model, quantize, device)
    server = build_server(embedder, None, config, "127.0.0.1", 0,
                          device=device)
    server.start()
    warm_up(server, config)
    return Service(server, fake, embedder, config)


def phase_summary() -> dict:
    from ..obs import phases_snapshot

    snap = phases_snapshot()
    return {
        "phases": {phase: {"p50_ms": row["p50_ms"], "p99_ms": row["p99_ms"]}
                   for phase, row in snap.items()
                   if isinstance(row, dict) and row.get("count")},
        "device_time_share": snap.get("device_time_share"),
    }


def emit(endpoint: str, value: float, unit: str, **extra) -> None:
    from ..obs import quality_summary

    extra.setdefault("phase_breakdown", phase_summary())
    extra.setdefault("quality_summary", quality_summary())
    common.emit({"endpoint": endpoint, "value": round(value, 3),
                 "unit": unit, "baseline_basis": common.BASELINE_BASIS,
                 **extra, **common.envelope(0)})


def graph_delta(before: dict, after: dict) -> dict:
    if not before:
        return {}
    return {"replays": after["replays"] - before["replays"],
            "eager_dispatches": (after["eager_dispatches"]
                                 - before["eager_dispatches"]),
            "captures": after["captures"] - before["captures"]}


def consensus_bodies(requests: int, n: int) -> list:
    return [json.dumps({"input": texts, "temperature": 0.05})
            for texts in common.make_requests(requests, n)]


def score_body(content: str, judges: int = 1, i=None) -> str:
    llms = ([{"model": "fake-judge"}] if judges == 1 else
            [{"model": f"fake-judge-{g}"} for g in range(judges)])
    choices = (["candidate a", "candidate b"] if i is None else
               [f"candidate a {i}", f"candidate b {i}"])
    return json.dumps({"stream": True,
                       "messages": [{"role": "user", "content": content}],
                       "model": {"llms": llms}, "choices": choices})


def score_bodies(requests: int, seed: int = 3) -> list:
    rng = np.random.default_rng(seed)
    return [score_body(" ".join(rng.choice(common.BENCH_WORDS,
                                           size=24).tolist()), i=i)
            for i in range(requests)]


def consensus_warmup(embedder, n: int, concurrency: int,
                     extra: tuple = ()) -> tuple:
    """(WARMUP, WARMUP_R) covering the bench corpus at N candidates (its
    sequence bucket) and the R buckets ``concurrency`` can form."""
    s = int(embedder.tokenize(common.make_requests(1, n)[0])[0].shape[1])
    specs = [f"{n}x{s}", *extra]
    return ",".join(specs), r_buckets(concurrency, n)


# -- the endpoint trio ---------------------------------------------------------------


def bench_consensus_endpoint(svc: Service, n: int, requests: int,
                             concurrency: int, quantize: str) -> float:
    """Served ``/consensus`` against the direct-call twin on the same
    texts."""
    from .headline import Seam, pipelined_rate

    reqs = common.make_requests(requests, n)
    bodies = [json.dumps({"input": t, "temperature": 0.05}) for t in reqs]
    graphs = svc.graphs()
    before = common.launch_counts()
    total, lat = drive(svc.port, "/consensus", bodies, concurrency)
    served = len(bodies) / total
    launches = common.launch_delta(before, common.launch_counts())
    graphs = graph_delta(graphs, svc.graphs())
    embedder = svc.embedder
    seam = Seam(embedder)

    def direct(texts):
        return embedder.consensus_confidence(texts, temperature=0.05)

    seam.finish(seam.launch(direct, reqs[0]))
    direct_rate, _ = pipelined_rate(seam, direct, reqs)
    emit("/consensus", served, "answers/sec", **common.percentiles(lat),
         n_candidates=n, requests=len(bodies), concurrency=concurrency,
         quantize=quantize,
         direct_call_answers_per_sec=round(direct_rate, 3),
         served_vs_direct=round(served / direct_rate, 3),
         graphs=graphs, launches=launches,
         note=("served = stdlib HTTP + JSON + micro-batcher + device; "
               "direct = the same texts through "
               "embedder.consensus_confidence on the dispatch seam"))
    return served


def bench_score_endpoint(svc: Service, requests: int,
                         concurrency: int) -> None:
    bodies = score_bodies(requests)
    status, _ = post(svc.port, "/score/completions", bodies[0])
    if status != 200:
        raise RuntimeError(f"/score/completions answered {status}")
    total, lat = drive(svc.port, "/score/completions", bodies, concurrency)
    emit("/score/completions", len(bodies) / total, "requests/sec",
         **common.percentiles(lat), requests=len(bodies),
         concurrency=concurrency,
         note=("streaming SSE incl. [DONE]; 1 judge via the loopback fake "
               "upstream (ballot round trip, vote extraction, tally)"))


def bench_multichat_endpoint(svc: Service, requests: int, concurrency: int,
                             generators: int = 4) -> None:
    bodies = [json.dumps({
        "consensus": True,
        "messages": [{"role": "user", "content": f"question {i}"}],
        "model": {"llms": [{"model": f"fake-gen-{g}"}
                           for g in range(generators)]},
    }) for i in range(requests)]
    status, raw = post(svc.port, "/multichat/completions", bodies[0])
    if status != 200 or "consensus" not in json.loads(raw):
        raise RuntimeError(f"/multichat/completions: {status} {raw[:200]!r}")
    graphs = svc.graphs()
    total, lat = drive(svc.port, "/multichat/completions", bodies,
                       concurrency, warmup_bursts=3)
    emit("/multichat/completions", len(bodies) / total, "requests/sec",
         **common.percentiles(lat), requests=len(bodies),
         concurrency=concurrency, generators=generators,
         graphs=graph_delta(graphs, svc.graphs()),
         note=("unary multichat: N-generator fan-out via the fake "
               "upstream + the device consensus overlay, batched across "
               "concurrent requests"))


# -- --cache, --faults, --overload ---------------------------------------------------


def bench_score_cache(svc: Service, requests: int, concurrency: int,
                      mode: str) -> None:
    """Hit against miss economics of the consensus result cache."""
    rng = np.random.default_rng(17)

    def words():
        return " ".join(rng.choice(common.BENCH_WORDS, size=24).tolist())

    miss_bodies = [score_body(f"miss {i}: {words()}") for i in range(requests)]
    hit_body = score_body(f"hit: {words()}")
    post(svc.port, "/score/completions", score_body("warmup"))
    _, miss_lat = drive(svc.port, "/score/completions", miss_bodies,
                        concurrency, warmup_bursts=0)
    upstream_before = svc.fake.requests
    if mode == "warm":
        post(svc.port, "/score/completions", hit_body)
    total, hit_lat = drive(svc.port, "/score/completions",
                           [hit_body] * requests, concurrency,
                           warmup_bursts=0)
    cache_stats = get_json(svc.port, "/metrics").get("score_cache")
    emit(f"/score/completions?cache={mode}", len(hit_lat) / total,
         "requests/sec", cache=mode, requests=requests,
         concurrency=concurrency,
         miss_p50_ms=common.quantile(miss_lat, 0.50),
         miss_p95_ms=common.quantile(miss_lat, 0.95),
         hit_p50_ms=common.quantile(hit_lat, 0.50),
         hit_p95_ms=common.quantile(hit_lat, 0.95),
         score_cache=cache_stats,
         hit_body_upstream_calls=svc.fake.requests - upstream_before,
         note=("miss sample = K distinct score bodies (full judge round "
               "trip); hit sample = one body x K (replayed from the "
               "consensus cache when enabled)"))


def bench_score_faults(svc: Service, requests: int, concurrency: int,
                       spec: str) -> None:
    body = score_body("pick the best", judges=3)

    def one(_):
        t0 = time.perf_counter()
        status, raw = post(svc.port, "/score/completions", body)
        ms = (time.perf_counter() - t0) * 1e3
        degraded = status == 200 and any(
            o.get("degraded") for o in sse_objs(raw.decode()))
        return status, ms, degraded

    one(None)
    with ThreadPoolExecutor(concurrency) as pool:
        t0 = time.perf_counter()
        outs = list(pool.map(one, range(requests)))
        total = time.perf_counter() - t0
    lat = [ms for status, ms, _ in outs if status == 200]
    errors = sum(status != 200 for status, _, _ in outs)
    degraded = sum(d for _, _, d in outs)
    resilience = get_json(svc.port, "/metrics").get("resilience")
    emit("/score/completions?faults", len(lat) / total if total else 0.0,
         "requests/sec", **common.percentiles(lat or [0.0]),
         requests=requests, concurrency=concurrency, fault_plan=spec,
         degraded_rate=round(degraded / max(1, requests), 3),
         error_rate=round(errors / max(1, requests), 3),
         resilience=resilience,
         note=("3-judge streaming score under FAULT_PLAN stalls; "
               "RESILIENCE_QUORUM=0.6 cancels unflippable stragglers"))


def bench_score_overload(svc: Service, requests: int, concurrency: int,
                         factor: float) -> None:
    rng = np.random.default_rng(7)

    def body(tag):
        return score_body(f"{tag}: " + " ".join(
            rng.choice(common.BENCH_WORDS, size=24).tolist()))

    path = "/score/completions"
    _, idle_lat = drive(svc.port, path,
                        [body(f"idle {i}") for i in range(requests)], 2,
                        warmup_bursts=1)
    cap_total, unloaded_lat = drive(
        svc.port, path, [body(f"cap {i}") for i in range(requests)],
        concurrency, warmup_bursts=0)
    capacity = len(unloaded_lat) / cap_total
    offered = capacity * factor

    def fire(b):
        t0 = time.perf_counter()
        status, _ = post(svc.port, path, b)
        return status, (time.perf_counter() - t0) * 1e3

    arrivals = [body(f"overload {i}") for i in range(2 * requests)]
    outs, _, total = open_loop(fire, arrivals, 1.0 / offered)
    admitted = [ms for status, ms in outs if status == 200]
    shed_503 = sum(status == 503 for status, _ in outs)
    shed_504 = sum(status == 504 for status, _ in outs)
    errors = len(outs) - len(admitted) - shed_503 - shed_504
    admission = get_json(svc.port, "/metrics").get("admission")
    unloaded_p99 = common.quantile(unloaded_lat, 0.99)
    admitted_p99 = common.quantile(admitted, 0.99) if admitted else None
    emit("/score/completions?overload", len(admitted) / total,
         "goodput requests/sec", requests=len(arrivals),
         concurrency=concurrency, overload_factor=factor,
         capacity_rps=round(capacity, 3), offered_rps=round(offered, 3),
         idle_p50_ms=common.quantile(idle_lat, 0.50),
         idle_p99_ms=common.quantile(idle_lat, 0.99),
         unloaded_p50_ms=common.quantile(unloaded_lat, 0.50),
         unloaded_p99_ms=unloaded_p99,
         admitted_p50_ms=(common.quantile(admitted, 0.50) if admitted
                          else None),
         admitted_p99_ms=admitted_p99,
         p99_inflation=(round(admitted_p99 / unloaded_p99, 3)
                        if admitted_p99 and unloaded_p99 else None),
         shed_rate=round((shed_503 + shed_504) / max(1, len(arrivals)), 3),
         shed_503=shed_503, shed_504=shed_504, errors=errors,
         admission=admission,
         note=("open-loop arrivals (a scheduler thread) at "
               "overload_factor x measured capacity against "
               "ADMISSION_MAX_INFLIGHT=concurrency"))


# -- --trace-overhead ------------------------------------------------------------------


def spread(deltas: list) -> dict:
    return {"rounds_pct": deltas,
            "median_pct": round(statistics.median(deltas), 3),
            "min_pct": min(deltas), "max_pct": max(deltas)}


def bench_trace_overhead(args, device: str) -> None:
    """The streaming score scenario and the ``/consensus`` burst against
    three servers on one warmed embedder (tracing off, rate 0.01, rate
    1.0), in alternating rounds; per round each traced setting's p50
    delta over off."""
    os.environ.setdefault("FAKE_UPSTREAM_DELAY_MS", "25")
    concurrency = min(args.concurrency, 4)
    settings = [("off", None), ("sampled_1pct", "0.01"), ("full", "1.0")]
    rounds = ROUNDS
    services = []
    try:
        embedder = build(args.model, args.quantize, device)
        warmup, warmup_r = consensus_warmup(embedder, args.n, concurrency)
        for label, rate in settings:
            services.append((label, rate, start_service(
                args.model, device, args.window_ms, args.quantize,
                extra_env=({"TRACE_SAMPLE_RATE": rate} if rate else None),
                warmup=warmup, warmup_r=warmup_r, embedder=embedder)))
        graphs = services[0][2].graphs()
        bodies = score_bodies(args.requests)
        cbodies = consensus_bodies(max(4, args.requests // 4), args.n)
        results = {}
        pooled = {label: [] for label, _ in settings}
        p50s = {label: [] for label, _ in settings}
        cp50s = {label: [] for label, _ in settings}
        totals = {label: 0.0 for label, _ in settings}
        for rnd in range(rounds):
            for label, _, svc in services:
                total, lat = drive(svc.port, "/score/completions", bodies,
                                   concurrency,
                                   warmup_bursts=2 if rnd == 0 else 0)
                pooled[label].extend(lat)
                p50s[label].append(common.quantile(lat, 0.50))
                totals[label] += total
                _, clat = drive(svc.port, "/consensus", cbodies,
                                concurrency,
                                warmup_bursts=1 if rnd == 0 else 0)
                cp50s[label].append(common.quantile(clat, 0.50))
        for label, rate, svc in services:
            lat = pooled[label]
            entry = {
                "p50_ms": round(statistics.median(p50s[label]), 3),
                "round_p50s_ms": p50s[label],
                "p95_ms": common.quantile(lat, 0.95),
                "p99_ms": common.quantile(lat, 0.99),
                "requests_per_sec": round(len(lat) / totals[label], 3),
                "consensus_round_p50s_ms": cp50s[label],
            }
            if rate is not None:
                entry["traces"] = get_json(svc.port, "/metrics").get(
                    "traces")
            results[label] = entry
        graphs = graph_delta(graphs, services[0][2].graphs())
    finally:
        for _, _, svc in services:
            svc.close()

    def deltas(series, label):
        return [round((t / o - 1.0) * 100.0, 3)
                for t, o in zip(series[label], series["off"])]

    off_p50 = results["off"]["p50_ms"]

    def inflation(label):
        return (round((results[label]["p50_ms"] / off_p50 - 1.0) * 100.0, 3)
                if off_p50 else None)

    emit("/score/completions?trace-overhead",
         inflation("sampled_1pct") or 0.0, "p50_inflation_pct",
         requests=args.requests, concurrency=concurrency, rounds=rounds,
         p50_inflation_pct_full=inflation("full"),
         round_deltas={label: spread(deltas(p50s, label))
                       for label in ("sampled_1pct", "full")},
         consensus_round_deltas={label: spread(deltas(cp50s, label))
                                 for label in ("sampled_1pct", "full")},
         graphs=graphs,
         **results,
         note=("streaming score scenario and a /consensus burst per "
               "round, one server per setting on one warmed embedder, "
               "rounds alternating off / 1% / full; p50 = median of the "
               "per-round p50s; round_deltas = each round's p50 over the "
               "same round's off"))


# -- --mixed-lengths, --overlap --------------------------------------------------------


def mixed_texts(requests: int, seed: int = 11) -> list:
    """The reference's mixed-length workload: short-head/long-tail lengths
    (60% chat-short, 30% paragraph, 10% document), mixed candidate
    counts, a shared conversation prefix per request."""
    rng = np.random.default_rng(seed)

    def text(words: int, tag: str) -> str:
        return f"{tag} " + " ".join(
            rng.choice(common.BENCH_WORDS, size=max(1, words)).tolist())

    def request_texts(i: int) -> list:
        n = int(rng.choice([3, 4, 6, 8], p=[0.3, 0.3, 0.25, 0.15]))
        kind = rng.random()
        if kind < 0.6:
            words = int(rng.integers(4, 17))
        elif kind < 0.9:
            words = int(rng.integers(24, 65))
        else:
            words = int(rng.integers(96, 193))
        prefix = text(words, f"ctx {i}")
        return [f"{prefix} answer {j} {text(6, 'a')}" for j in range(n)]

    return [request_texts(i) for i in range(requests)]


def bench_mixed_lengths(args, device: str) -> None:
    bodies = [json.dumps({"input": t, "temperature": 0.05})
              for t in mixed_texts(args.requests)]
    settings = [("padded", {"PACKING_ENABLED": "0"}),
                ("packed", {"PACKING_ENABLED": "1"})]
    results = {}
    padded_capacity = None
    embedder = None
    for label, env in settings:
        svc = start_service(args.model, device, args.window_ms,
                            args.quantize, extra_env=env, embedder=embedder,
                            warmup=f"8x{min(128, args.max_tokens)}")
        embedder = svc.embedder
        try:
            graphs = svc.graphs()
            total, _ = drive(svc.port, "/consensus", bodies,
                             args.concurrency)
            capacity = len(bodies) / total
            if padded_capacity is None:
                padded_capacity = capacity
            offered = padded_capacity * 1.5

            def fire(b, port=svc.port):
                t0 = time.perf_counter()
                try:
                    status, _ = post(port, "/consensus", b)
                except OSError:
                    return None
                return (time.perf_counter() - t0) * 1e3 if status == 200 \
                    else None

            outs, _, open_total = open_loop(fire, bodies, 1.0 / offered)
            ok_lat = [ms for ms in outs if ms is not None]
            before = get_json(svc.port, "/metrics").get("device_batcher", {})
            drive(svc.port, "/consensus", bodies, len(bodies),
                  warmup_bursts=0)
            after = get_json(svc.port, "/metrics").get("device_batcher", {})
            key = "packing" if env["PACKING_ENABLED"] == "1" else "padded"
            d_real = (after[key]["real_tokens"]
                      - before[key]["real_tokens"])
            d_slot = (after[key]["slot_tokens"]
                      - before[key]["slot_tokens"])
            results[label] = {
                "goodput_rps": round(len(ok_lat) / open_total, 3),
                "closed_loop_rps": round(capacity, 3),
                "offered_rps": round(offered, 3),
                "failures": len(outs) - len(ok_lat),
                **common.percentiles(ok_lat or [0.0]),
                "saturated_efficiency": (round(d_real / d_slot, 4)
                                         if d_slot else None),
                "saturated_real_tokens": d_real,
                "saturated_slot_tokens": d_slot,
                "packing": after.get("packing"),
                "padded": after.get("padded"),
                "graphs": graph_delta(graphs, svc.graphs()),
            }
        finally:
            svc.close()
    padded_good = results["padded"]["goodput_rps"]
    packed_good = results["packed"]["goodput_rps"]
    emit("/consensus?mixed-lengths", packed_good, "goodput requests/sec",
         requests=args.requests, concurrency=args.concurrency,
         goodput_ratio=(round(packed_good / padded_good, 3)
                        if padded_good else None),
         closed_loop_ratio=(round(results["packed"]["closed_loop_rps"]
                                  / results["padded"]["closed_loop_rps"], 3)
                            if results["padded"]["closed_loop_rps"]
                            else None),
         **results,
         note=("open-loop mixed-length /consensus arrivals at 1.5x the "
               "padded server's closed-loop capacity, padded against "
               "packed (PACKING_ENABLED=1) on one embedder; "
               "saturated_efficiency = real tokens / dispatched slots "
               "over an all-in-flight burst"))


def bench_overlap(args, device: str) -> None:
    """Closed-loop ``/consensus`` with per-bucket device timing on and
    off (``METRICS_DEVICE_TIMING``), ``BATCH_PIPELINE=2``, alternating
    rounds on one server (the flag is the embedder's ``device_timing``,
    set before each round), and the overlap gauge over a saturated
    burst."""
    settings = [("timing_off", False), ("timing_on", True)]
    bodies = consensus_bodies(args.requests, args.n)
    svc = None
    try:
        embedder = build(args.model, args.quantize, device)
        # the saturated burst forms groups of every request at once
        warmup, warmup_r = consensus_warmup(
            embedder, args.n, max(args.concurrency, len(bodies)))
        svc = start_service(args.model, device, args.window_ms,
                            args.quantize, warmup=warmup, warmup_r=warmup_r,
                            extra_env={"BATCH_PIPELINE": "2"},
                            embedder=embedder)
        graphs = svc.graphs()
        round_rps = {label: [] for label, _ in settings}
        pooled = {label: [] for label, _ in settings}
        for rnd in range(3):
            for label, timing in settings:
                embedder.device_timing = timing
                total, lat = drive(svc.port, "/consensus", bodies,
                                   args.concurrency,
                                   warmup_bursts=2 if rnd == 0 else 0)
                round_rps[label].append(round(len(lat) / total, 3))
                pooled[label].extend(lat)
        results = {label: {"goodput_rps": round(statistics.median(
            round_rps[label]), 3), "round_rps": round_rps[label],
            **common.percentiles(pooled[label])} for label, _ in settings}
        embedder.device_timing = True
        drive(svc.port, "/consensus", bodies, len(bodies), warmup_bursts=0)
        served = get_json(svc.port, "/metrics")
        graphs = graph_delta(graphs, svc.graphs())
    finally:
        if svc is not None:
            svc.close()
    phases = served.get("phases", {})
    batcher_stats = served.get("device_batcher", {})
    on_good = results["timing_on"]["goodput_rps"]
    off_good = results["timing_off"]["goodput_rps"]
    emit("/consensus?overlap", on_good, "goodput requests/sec",
         requests=len(bodies), concurrency=args.concurrency,
         n_candidates=args.n, rounds=3,
         goodput_ratio_on_vs_off=(round(on_good / off_good, 3)
                                  if off_good else None),
         overlap=phases.get("overlap"),
         device_time_share=phases.get("device_time_share"),
         host_tokenizer_workers=batcher_stats.get("host_tokenizer_workers"),
         staging=batcher_stats.get("staging"),
         graphs=graphs,
         **results,
         note=("closed-loop /consensus, device timing on against off in "
               "alternating rounds on one server; overlap = device-busy "
               "union / wall over an all-in-flight burst"))


# -- --offline ------------------------------------------------------------------------


def bench_offline(args, device: str) -> None:
    """One ``OFFLINE_ENABLED=1`` server: the idle lane's occupancy, then
    ``/consensus`` alone against ``/consensus`` beside a saturating
    ``POST /v1/train/rescore``, in alternating rounds (round 0 a
    discarded warm-up); per round the contended p50/p99 delta over the
    same round's baseline."""
    n_latency = max(2, min(args.n, 8))
    concurrency = min(args.concurrency, 8)
    offline_n = 4
    rounds = ROUNDS
    svc = None
    try:
        embedder = build(args.model, args.quantize, device)
        warmup, warmup_r = consensus_warmup(embedder, n_latency, concurrency)
        svc = start_service(
            args.model, device, args.window_ms, args.quantize,
            extra_env={"OFFLINE_ENABLED": "1", "OFFLINE_INFLIGHT": "4",
                       "BATCH_PIPELINE": "1"},
            warmup=warmup, warmup_r=warmup_r, embedder=embedder)
        bodies = consensus_bodies(args.requests, n_latency)
        graphs = svc.graphs()

        def rescore(groups, seed, inflight=4):
            status, raw = post(svc.port, "/v1/train/rescore", json.dumps({
                "groups": groups, "n": offline_n, "inflight": inflight,
                "seed": seed}))
            if status != 200:
                raise RuntimeError(f"/v1/train/rescore: {status} {raw!r}")
            return json.loads(raw)

        def lanes():
            return get_json(svc.port, "/metrics")["device_batcher"]["lanes"]

        rescore(max(16, args.requests // 2), seed=1)
        idle = rescore(max(48, args.requests), seed=2, inflight=8)
        base_p50s, base_p99s, base_lat, base_rps = [], [], [], []
        cont_p50s, cont_p99s, cont_lat, cont_rps = [], [], [], []
        offline_during = 0
        contended = None
        lanes_after = None
        with ThreadPoolExecutor(1) as side:
            for rnd in range(rounds + 1):
                record = rnd > 0
                total, lat = drive(svc.port, "/consensus", bodies,
                                   concurrency,
                                   warmup_bursts=2 if rnd == 0 else 0)
                if record:
                    base_p50s.append(common.quantile(lat, 0.50))
                    base_p99s.append(common.quantile(lat, 0.99))
                    base_rps.append(len(lat) / total)
                    base_lat.extend(lat)
                lanes_before = lanes()
                task = side.submit(rescore, max(64, 4 * args.requests),
                                   3 + rnd, 2)
                time.sleep(0.05)  # the drive is in flight
                total, lat = drive(svc.port, "/consensus", bodies,
                                   concurrency, warmup_bursts=0)
                contended = task.result()
                lanes_after = lanes()
                if record:
                    cont_p50s.append(common.quantile(lat, 0.50))
                    cont_p99s.append(common.quantile(lat, 0.99))
                    cont_rps.append(len(lat) / total)
                    cont_lat.extend(lat)
                    offline_during += (lanes_after["offline"]["dispatches"]
                                       - lanes_before["offline"]["dispatches"])
        graphs = graph_delta(graphs, svc.graphs())
    finally:
        if svc is not None:
            svc.close()
    base_p = {"p50_ms": statistics.median(base_p50s),
              "p99_ms": common.quantile(base_lat, 0.99),
              "round_p99s_ms": base_p99s}
    cont_p = {"p50_ms": statistics.median(cont_p50s),
              "p99_ms": common.quantile(cont_lat, 0.99),
              "round_p99s_ms": cont_p99s}
    p50_deltas = [round((c / b - 1.0) * 100.0, 3)
                  for c, b in zip(cont_p50s, base_p50s)]
    p99_deltas = [round((c / b - 1.0) * 100.0, 3)
                  for c, b in zip(cont_p99s, base_p99s)]
    emit("/consensus?offline",
         (round(cont_p["p99_ms"] / base_p["p99_ms"], 3)
          if base_p["p99_ms"] else 0.0),
         "contended/baseline p99 ratio",
         requests=len(bodies), concurrency=concurrency,
         n_candidates=n_latency, offline_n=offline_n, rounds=rounds,
         offline_occupancy_idle=idle["offline_occupancy"],
         idle_rescore=idle,
         baseline={"rps": round(statistics.median(base_rps), 3), **base_p,
                   "round_p50s_ms": base_p50s},
         contended={"rps": round(statistics.median(cont_rps), 3), **cont_p,
                    "round_p50s_ms": cont_p50s},
         p99_inflation_pct=(round((cont_p["p99_ms"] / base_p["p99_ms"]
                                   - 1.0) * 100.0, 3)
                            if base_p["p99_ms"] else None),
         p50_inflation_pct=(round((cont_p["p50_ms"] / base_p["p50_ms"]
                                   - 1.0) * 100.0, 3)
                            if base_p["p50_ms"] else None),
         round_p50_deltas=spread(p50_deltas),
         round_p99_deltas=spread(p99_deltas),
         offline_dispatches_during_contention=offline_during,
         contended_rescore={k: contended[k] for k in (
             "groups", "items", "errors", "offline_occupancy")},
         lanes=lanes_after, graphs=graphs,
         note=("one OFFLINE_ENABLED=1 server; idle = POST "
               "/v1/train/rescore alone; contended = the same closed-loop "
               "/consensus drive beside a saturating rescore; rounds "
               "alternate baseline / contended"))


# -- the fleet tier ---------------------------------------------------------------


def start_fleet(upstream_url: str, extra_env=None) -> list:
    """Three host-only replicas of the port's server on loopback ports
    with one roster; ``extra_env(i, urls)`` adds a replica's own knobs.
    Returns their servers, started and ready."""
    import socket

    from ..serve.__main__ import build_server, warm_up
    from ..serve.config import ServeConfig

    ports = []
    for _ in range(3):
        sock = socket.socket()
        sock.bind(("127.0.0.1", 0))
        ports.append(sock.getsockname()[1])
        sock.close()
    urls = [f"http://127.0.0.1:{p}" for p in ports]
    servers = []
    try:
        for i, port in enumerate(ports):
            env = {"SCORE_CACHE_TTL": "600", "FLEET_SELF": urls[i],
                   "FLEET_PEERS": ",".join(urls), "MEMGUARD": "0"}
            env.update(extra_env(i, urls) if extra_env else {})
            config = ServeConfig.from_env(env)
            config.upstream["api_bases"] = [{"api_base": upstream_url,
                                             "api_key": "bench-key"}]
            server = build_server(None, None, config, "127.0.0.1", port,
                                  device="cpu")
            servers.append(server)
            server.start()
            warm_up(server, config)
    except BaseException:
        for server in servers:
            server.close()
        raise
    # the three replicas share this interpreter: a full collection over
    # their start-up heap (~0.1 s) would stall every peer leg at once
    # and time out the 150 ms ones of --fleet-partition, stranding their
    # leases until TTL.  The caller unfreezes (gc.unfreeze) when done.
    gc.freeze()
    return servers


def fleet_counters(servers) -> list:
    return [get_json(s.port, "/metrics").get("fleet", {}) for s in servers]


def await_publishes(servers, want: int, timeout_s: float = 5.0) -> None:
    """Wait until the owners' lease tables account for ``want``
    fan-outs (published, late or refused), or ``timeout_s`` (a cut
    replica's publishes never land)."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        landed = sum(c.get("leases", {}).get("published", 0)
                     + c.get("leases", {}).get("late_publishes", 0)
                     + c.get("rejected_publishes", 0)
                     for c in fleet_counters(servers))
        if landed >= want:
            return
        time.sleep(0.02)


def fleet_round(targets_and_bodies: list, concurrency: int,
                bad: dict = None) -> tuple:
    """Closed loop over (port, body) pairs -> (seconds, latencies ms);
    with ``bad``, count answers carrying a degraded or corrupt frame."""

    def one(item):
        port, body = item
        t0 = time.perf_counter()
        status, raw = post(port, "/score/completions", body)
        if status != 200:
            raise RuntimeError(f"fleet round: {status} {raw[:200]!r}")
        if bad is not None and (b'"degraded":true' in raw
                                or b"corrupt" in raw):
            bad["n"] += 1
        return (time.perf_counter() - t0) * 1e3

    with ThreadPoolExecutor(concurrency) as pool:
        t0 = time.perf_counter()
        lat = list(pool.map(one, targets_and_bodies))
        total = time.perf_counter() - t0
    return total, lat


def bench_fleet(args) -> None:
    """Fleet-tier goodput: three replicas on loopback sockets, one
    counting fake upstream — cold / warm (every hit crosses the peer
    wire) / hot-key stampede (one upstream fan-out fleet-wide)."""
    from ..serve.fake_upstream import FakeUpstream

    # judge-latency floor, as the reference's: with a 0 ms upstream every
    # request is host CPU and goodput reads thread contention, not the
    # peer protocol's cost
    os.environ.setdefault("FAKE_UPSTREAM_DELAY_MS", "25")
    concurrency = min(args.concurrency, 8)
    fake = FakeUpstream()
    servers = []
    try:
        servers = start_fleet(fake.url)
        ports = [s.port for s in servers]
        bodies = score_bodies(args.requests, seed=3)

        def phase(total, lat, upstream):
            return {"rps": round(len(lat) / total, 2),
                    **common.percentiles(lat), "upstream_calls": upstream}

        # cold: every fingerprint new, round-robin across replicas
        c0 = fake.requests
        cold = phase(*fleet_round(
            [(ports[i % 3], b) for i, b in enumerate(bodies)], concurrency),
            fake.requests - c0)
        await_publishes(servers, cold["upstream_calls"])
        # warm: the same fingerprints on a DIFFERENT replica than the one
        # that computed them — every hit crosses the peer-fetch wire
        c0 = fake.requests
        warm = phase(*fleet_round(
            [(ports[(i + 1) % 3], b) for i, b in enumerate(bodies)],
            concurrency), fake.requests - c0)
        # hot-key stampede: ONE new fingerprint, open fan-in
        hot_body = score_body("the hot question")
        c0 = fake.requests
        hot = phase(*fleet_round(
            [(ports[i % 3], hot_body) for i in range(len(bodies))],
            concurrency), fake.requests - c0)
        counters = fleet_counters(servers)
    finally:
        for server in servers:
            server.close()
        fake.close()
        gc.unfreeze()
    emit("/score/completions?fleet", warm["rps"],
         "requests/sec warm goodput",
         requests=len(bodies), concurrency=concurrency, replicas=3,
         cold=cold, warm=warm, hot_stampede=hot,
         peer_fetch_hits=sum(c.get("peer_fetch", {}).get("hits", 0)
                             for c in counters),
         lease_waits=sum(c.get("leases", {}).get("waits", 0)
                         for c in counters),
         note=("3 replicas, one counting fake upstream; acceptance = "
               "warm upstream_calls == 0 (peer fetch serves fleet-wide) "
               "and hot_stampede upstream_calls == 1 (cross-replica "
               "single-flight)"))


def bench_fleet_partition(args) -> None:
    """Degraded goodput under a network partition: the ``--fleet`` trio,
    then a second trio whose ``FLEET_FAULT_PLAN`` specs carve ``{a} |
    {b, c}`` out of configuration alone (``blackhole=1.0,to=...``).
    Cold populates, warm rotates every fingerprint onto another replica;
    under the cut, cross-partition legs blackhole, breakers open,
    quarantine re-homes the severed keys, and every request still
    answers 200 with clean frames from local compute."""
    from ..serve.fake_upstream import FakeUpstream

    os.environ.setdefault("FAKE_UPSTREAM_DELAY_MS", "25")
    concurrency = min(args.concurrency, 8)
    requests = min(args.requests, 60)
    bodies = score_bodies(requests, seed=17)
    fake = FakeUpstream()

    def fetch_timeout(i, urls):
        # bound the blackhole burn so degraded goodput reads the
        # breaker/quarantine recovery, not a 2 s default timeout
        return {"FLEET_FETCH_TIMEOUT_MILLIS": "150"}

    def partition(i, urls):
        env = fetch_timeout(i, urls)
        env["FLEET_FAULT_PLAN"] = (
            f"blackhole=1.0,to={urls[1]}|{urls[2]}" if i == 0
            else f"blackhole=1.0,to={urls[0]}")
        return env

    def drive_trio(servers) -> dict:
        """cold (populate) then warm (rotated) rounds: the warm round's
        figures, its upstream calls and its dirty answers."""
        ports = [s.port for s in servers]
        c0 = fake.requests
        fleet_round([(ports[i % 3], b) for i, b in enumerate(bodies)],
                    concurrency)
        cold_upstream = fake.requests - c0
        await_publishes(servers, cold_upstream, timeout_s=2.0)
        bad = {"n": 0}
        c0 = fake.requests
        total, lat = fleet_round(
            [(ports[(i + 1) % 3], b) for i, b in enumerate(bodies)],
            concurrency, bad)
        return {"rps": round(len(lat) / total, 2),
                **common.percentiles(lat),
                "upstream_calls": fake.requests - c0,
                "cold_upstream_calls": cold_upstream,
                "dirty_frames": bad["n"]}

    trios = []
    try:
        trios.append(start_fleet(fake.url, fetch_timeout))
        healthy = drive_trio(trios[-1])
        trios.append(start_fleet(fake.url, partition))
        partitioned = drive_trio(trios[-1])
        counters = fleet_counters(trios[-1])
    finally:
        for trio in trios:
            for server in trio:
                server.close()
        fake.close()
        gc.unfreeze()
    emit("/score/completions?fleet-partition", partitioned["rps"],
         "requests/sec degraded goodput (warm round under partition)",
         requests=len(bodies), concurrency=concurrency, replicas=3,
         healthy_warm=healthy, partitioned_warm=partitioned,
         local_fallbacks=sum(c.get("local_fallbacks", 0) for c in counters),
         peer_errors=sum(c.get("peer_fetch", {}).get("errors", 0)
                         for c in counters),
         quarantines=sum(c.get("health", {}).get("quarantines", 0)
                         for c in counters),
         note=("3 replicas; partition carved via FLEET_FAULT_PLAN "
               "blackhole=1.0,to=... env specs ({a} | {b,c}); acceptance "
               "= healthy warm upstream_calls == 0, partitioned warm "
               "all-200 with dirty_frames == 0 (severed replicas "
               "recompute locally, clean)"))


# -- main -----------------------------------------------------------------------------


def bench_mesh_faults(args, device: str) -> None:
    """Goodput through a device fault (``resilience/meshfault.py``): the
    reference's three phases (module doc).  Phase A is the healthy
    baseline; before phase B the manager's ``DEVICE_FAULT_PLAN`` seam is
    armed with ``script=persistent``, so the burst's first dispatch dies
    as a lost card's would and the batcher downsizes one rung (dp halves,
    tp kept) and re-dispatches on the rung's warmed graphs; phase C runs
    after the recovery probe restored the full shape."""
    from ..parallel.mesh import make_mesh
    from ..parallel.sharding import shard_embedder_mesh
    from ..resilience.meshfault import DeviceFaultPlan
    from .scaling import mesh_devices

    dp, tp = 4, 2
    n = max(2, min(args.n, 8))
    concurrency = min(args.concurrency, 8)
    # EMBEDDER_MAX_TOKENS=32 and 96-word texts: every request tokenizes
    # to the cap, so the traffic hits exactly the (n, 32) bucket WARMUP
    # names and warm_ladder warms on every rung
    extra_env = {
        "MESH_ENABLED": "1", "MESH_SHAPE": f"{dp}x{tp}",
        "MESH_FAULT_ENABLED": "1", "MESH_FAULT_TRANSIENT_RETRIES": "2",
        "EMBEDDER_MAX_TOKENS": "32",
    }
    embedder = build(args.model, args.quantize, device, seq=32)
    mesh = make_mesh(dp=dp, tp=tp, devices=mesh_devices(dp * tp, device))
    shard_embedder_mesh(embedder, mesh)
    svc = start_service(args.model, device, args.window_ms, args.quantize,
                        extra_env=extra_env, warmup=f"{n}x32",
                        warmup_r="2,4,8", embedder=embedder)
    meshfault = svc.server.meshfault
    bodies = consensus_bodies(args.requests, n)

    def drive_counting(warmup_bursts: int = 0) -> dict:
        from ..obs import reset_phases, reset_quality

        def one(body):
            t0 = time.perf_counter()
            status, _ = post(svc.port, "/consensus", body)
            return status, (time.perf_counter() - t0) * 1e3

        with ThreadPoolExecutor(concurrency) as pool:
            for _ in range(warmup_bursts):
                burst = (bodies * (concurrency // len(bodies) + 1))[
                    :concurrency]
                list(pool.map(one, burst))
            reset_phases()
            reset_quality()
            t0 = time.perf_counter()
            results = list(pool.map(one, bodies))
            total = time.perf_counter() - t0
        lat = [ms for status, ms in results if status == 200]
        return {
            "goodput_rps": round(len(lat) / total, 3),
            **common.percentiles(lat or [0.0]),
            "shed_504": sum(1 for status, _ in results if status == 504),
            "errors": sum(1 for status, _ in results
                          if status not in (200, 504)),
        }

    def readyz() -> tuple:
        status, raw = post(svc.port, "/readyz", None, method="GET")
        return status, json.loads(raw)

    graphs = svc.graphs()
    try:
        healthy = drive_counting(warmup_bursts=2)
        # arm the seam: the next device dispatch dies persistently,
        # mid-burst, with the rest of the phase in flight behind it
        meshfault.fault_plan = DeviceFaultPlan.parse("script=persistent")
        degraded = drive_counting()
        ready_status, ready_body = readyz()
        # the recovery probe waits out the dispatches in flight (the
        # shape gate's exclusive side), as a downsize does
        recovered_ok = meshfault.try_recover()
        recovered = drive_counting()
        ready_after_status, ready_after = readyz()
        counters = get_json(svc.port, "/metrics").get("meshfault")
        graphs = graph_delta(graphs, svc.graphs())
        pools = {f"{d}x{t}": b
                 for (d, t), b in sorted(meshfault.rung_pool_bytes.items(),
                                         reverse=True)}
    finally:
        svc.close()
    emit(
        "/consensus?mesh-faults", degraded["goodput_rps"],
        "goodput answers/sec",
        requests=len(bodies), concurrency=concurrency, n_candidates=n,
        mesh_shape=f"{dp}x{tp}", cards=len(mesh.distinct_devices()),
        fault_plan="script=persistent",
        healthy=healthy, degraded=degraded, recovered=recovered,
        degraded_vs_healthy=(
            round(degraded["goodput_rps"] / healthy["goodput_rps"], 3)
            if healthy["goodput_rps"] else None),
        recovered_vs_healthy=(
            round(recovered["goodput_rps"] / healthy["goodput_rps"], 3)
            if healthy["goodput_rps"] else None),
        readyz_during=(ready_status, ready_body),
        readyz_after=(ready_after_status, ready_after),
        recovery_probe_ok=bool(recovered_ok),
        meshfault=counters, graphs=graphs, rung_pool_bytes=pools,
        note=("closed-loop /consensus on a dp x tp mesh through a scripted "
              "persistent device fault: value = degraded-phase goodput "
              "(one downsize rung, in-flight groups re-dispatched on "
              "warmed graphs); acceptance = zero 'errors' in every "
              "phase, readyz_during 200 with degraded_mesh, recovered "
              "goodput back near healthy"),
    )


def run_http(args, device: str) -> None:
    if args.mesh_faults:
        return bench_mesh_faults(args, device)
    if args.fleet_partition:
        return bench_fleet_partition(args)
    if args.fleet:
        return bench_fleet(args)
    if args.trace_overhead:
        return bench_trace_overhead(args, device)
    if args.mixed_lengths:
        return bench_mixed_lengths(args, device)
    if args.overlap:
        return bench_overlap(args, device)
    if args.offline:
        return bench_offline(args, device)
    extra_env = None
    if args.overload:
        extra_env = {"ADMISSION_MAX_INFLIGHT": str(args.concurrency),
                     "ADMISSION_MAX_QUEUE_DEPTH": str(2 * args.concurrency)}
        os.environ.setdefault("FAKE_UPSTREAM_DELAY_MS", "100")
    if args.faults is not None:
        extra_env = {"FAULT_PLAN": args.faults, "RESILIENCE_QUORUM": "0.6"}
    trio = not (args.overload or args.faults is not None
                or args.cache is not None)
    warmup = warmup_r = ""
    embedder = None
    if trio:
        embedder = build(args.model, args.quantize, device)
        s_gen = int(embedder.tokenize(
            ["This is a fake upstream completion."])[0].shape[1])
        warmup, warmup_r = consensus_warmup(
            embedder, args.n, args.concurrency, extra=(f"4x{s_gen}",))
    svc = start_service(
        args.model, device, args.window_ms, args.quantize,
        cache_ttl_sec=600.0 if args.cache in ("cold", "warm") else 0.0,
        extra_env=extra_env, warmup=warmup, warmup_r=warmup_r,
        embedder=embedder)
    try:
        if args.overload:
            return bench_score_overload(svc, args.requests,
                                        args.concurrency,
                                        args.overload_factor)
        if args.faults is not None:
            return bench_score_faults(svc, args.requests, args.concurrency,
                                      args.faults)
        if args.cache is not None:
            return bench_score_cache(svc, args.requests, args.concurrency,
                                     args.cache)
        bench_consensus_endpoint(svc, args.n, args.requests,
                                 args.concurrency, args.quantize)
        bench_score_endpoint(svc, args.requests, args.concurrency)
        bench_multichat_endpoint(svc, args.requests, args.concurrency)
    finally:
        svc.close()


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="bench http")
    p.add_argument("--model", default=None,
                   help="default bge-large-en on the card, test-tiny on "
                   "--device cpu")
    p.add_argument("--quantize", choices=("none", "int8"), default="none")
    p.add_argument("--cache", choices=("off", "cold", "warm"), default=None)
    p.add_argument("--faults", nargs="?", default=None, const=DEFAULT_FAULTS,
                   metavar="SPEC")
    p.add_argument("--overload", action="store_true")
    p.add_argument("--overload-factor", type=float, default=4.0)
    p.add_argument("--trace-overhead", action="store_true")
    p.add_argument("--mixed-lengths", action="store_true")
    p.add_argument("--overlap", action="store_true")
    p.add_argument("--offline", action="store_true")
    p.add_argument("--mesh-faults", action="store_true",
                   help="/consensus on a 4x2 mesh through a scripted "
                   "persistent device fault: healthy, degraded, "
                   "recovered")
    p.add_argument("--fleet", action="store_true",
                   help="three host-only replicas: cold, warm and "
                   "hot-stampede rounds")
    p.add_argument("--fleet-partition", action="store_true",
                   help="the --fleet trio, then a second one under a "
                   "{a} | {b, c} partition plan")
    p.add_argument("--n", type=int, default=64)
    p.add_argument("--requests", type=int, default=100)
    p.add_argument("--concurrency", type=int, default=16)
    p.add_argument("--window-ms", type=float, default=3.0)
    p.add_argument("--quick", action="store_true",
                   help="small counts (requests <= 20, n <= 8)")
    common.add_device_flag(p)
    return p


def parse(argv=None) -> argparse.Namespace:
    """The flags, with ``--quick``'s caps and the default model applied."""
    args = parser().parse_args(argv)
    if args.quick:
        args.requests = min(args.requests, 20)
        args.n = min(args.n, 8)
    if args.model is None:
        args.model = "bge-large-en" if args.device == "cuda" else "test-tiny"
    from ..models.configs import PRESETS, usable_positions

    args.max_tokens = usable_positions(PRESETS[args.model])
    return args


def main(argv=None) -> int:
    args = parse(argv)
    base = {"metric": "served answers/sec + p50", "model": args.model}
    device = common.select_device(NAME, args.device, base)
    return common.run(NAME, base, lambda: run_http(args, device))
