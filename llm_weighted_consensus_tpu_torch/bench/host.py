"""Device-free host-path bench: tokenize + ballot + merge per request (the
counterpart of the reference's ``bench_host.py``).

Runs the port's real host path — ``WordPieceTokenizer.encode_batch``,
the seeded ``PrefixTree`` ballot, ``ScoreClient.create_streaming`` with
the per-judge stream merge and the weighted tally — against scripted
in-memory judges (``serve/fake_upstream.py``'s ``ScriptedTransport``):
no card, no network.  Device-free is checked, not assumed: every record
carries ``cuda_initialized`` (``torch.cuda.is_initialized()``), and the
bench fails when it is true.

Scenarios (the reference's flags): the default host-path record;
``--hostpath`` (per-chunk phase p50s with the ``HOST_FASTPATH`` lane unset
and set, the fast lane's phases banded against the committed
``analysis/host_budgets.json`` with the machine-speed canary;
``--write-budgets`` writes that file instead, on the card's machine: it
records the host's CPU model and the card's name and power limit, and is
refused without a card); ``--metrics-overhead``, ``--quality-overhead``,
``--overlap-overhead``, ``--ingest-bounds`` and ``--witness-overhead``
(each a hot-path cost as a share of the host-path p50, against the 2%
budget); ``--analysis-time`` (the analysis CLI's wall time by part: the
lint, the concurrency audit, the dispatch audit's CPU half).

Run: ``python -m llm_weighted_consensus_tpu_torch.bench host [--judges 8]
[--n 64] [--requests 50]``.
"""

from __future__ import annotations

import argparse
import asyncio
import gc
import json
import os
import platform
import random
import re
import statistics
import subprocess
import sys
import time

from . import common

NAME = "host"
BUDGET_PCT = 2.0
# the analysis CLI's budget without the mesh audit, and the mesh
# audit's own (the reference's)
ANALYSIS_BUDGET_S = 30
MESH_BUDGET_S = 60
HOST_BUDGETS = os.path.join(common.REPO, "llm_weighted_consensus_tpu_torch",
                            "analysis", "host_budgets.json")
GATED_PHASES = ("per_chunk_p50_us", "ingest_p50_us", "merge_p50_us",
                "tally_p50_ms", "encode_p50_us")


def cuda_initialized() -> bool:
    import torch

    return bool(torch.cuda.is_initialized())


def build_engine(judges: int, n: int, requests: int, seed: int,
                 host_fastpath: bool = False):
    """A ``ScoreClient`` over scripted judge streams (``requests`` calls'
    worth, one attempt per judge) and the panel it scores with."""
    from .. import archive, registry
    from ..ballot import PrefixTree, branch_limit
    from ..clients.chat import ApiBase, BackoffPolicy, DefaultChatClient
    from ..clients.score import ScoreClient
    from ..serve.fake_upstream import Script, ScriptedTransport, chunk_obj

    # replay the seeded ballot the engine builds (rng_factory hands it the
    # same stream) so the judges vote real keys
    rng = random.Random(seed)
    tree = PrefixTree.build(rng, n, branch_limit(None))
    keys = {idx: key for key, idx in tree.key_indices(rng)}
    vote_rng = random.Random(seed + 1)
    scripts = []
    for _ in range(requests):
        for _ in range(judges):  # a contested vote among the top few
            key = keys[vote_rng.randrange(3)]
            scripts.append(Script([
                chunk_obj("I pick ", model="up-model"),
                chunk_obj(f"{key} as best.", model="up-model",
                          finish="stop"),
            ]))
    chat = DefaultChatClient(ScriptedTransport(scripts),
                             [ApiBase("https://up.example", "key")],
                             backoff=BackoffPolicy(max_elapsed_ms=0))
    client = ScoreClient(chat, registry.InMemoryModelRegistry(),
                         archive_fetcher=archive.InMemoryArchive(),
                         rng_factory=lambda: random.Random(seed),
                         host_fastpath=host_fastpath)
    model_json = {"llms": [
        {"model": f"judge-{j}",
         "weight": {"type": "static", "weight": 1 + j % 3}}
        for j in range(judges)
    ]}
    return client, model_json


def scorer(client, model_json):
    """``texts`` -> every item of one consensus stream."""
    from ..types.score_request import ChatCompletionCreateParams

    async def score_one(texts):
        params = ChatCompletionCreateParams.from_json_obj({
            "messages": [{"role": "user", "content": "pick the best"}],
            "model": model_json, "choices": texts,
        })
        stream = await client.create_streaming(None, params)
        return [item async for item in stream]

    return score_one


def host_p50(args, n_requests: int, reset=None, skip_first=False) -> tuple:
    """(p50 ms, per-request ms) of the real host path over ``n_requests``
    requests, after one warm request; ``reset`` runs before the timed
    ones."""
    client, model_json = build_engine(args.judges, args.n, n_requests + 1,
                                      args.seed)
    texts = common.make_requests(n_requests, args.n, seed=args.seed)
    score_one = scorer(client, model_json)
    loop = asyncio.new_event_loop()
    try:
        loop.run_until_complete(score_one(texts[0]))
        if reset is not None:
            reset()
        total = []
        for t in texts[1:] if skip_first else texts:
            t0 = time.perf_counter()
            loop.run_until_complete(score_one(t))
            total.append((time.perf_counter() - t0) * 1e3)
    finally:
        loop.close()
    return round(statistics.median(total), 3), total


def loop_ns(fn, reps: int, arg=None) -> float:
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(arg)
    return (time.perf_counter() - t0) / reps * 1e9


def overhead_record(args, metric: str, pct: float, **fields) -> dict:
    return {
        "metric": metric, "value": pct, "unit": "%",
        "budget_pct": BUDGET_PCT, "within_budget": pct <= BUDGET_PCT,
        **fields,
        "requests": min(args.requests, 20), "judges": args.judges,
        "n_candidates": args.n, "cuda_initialized": cuda_initialized(),
        "baseline_basis": common.BASELINE_BASIS,
    }


def metrics_overhead_record(args) -> dict:
    """The phase histogram's observe hot path as a share of the host p50:
    observes/request x the lock-guarded ``observe_phase`` ns."""
    from ..obs import phases as phases_mod
    from ..obs.histogram import Histogram

    values = [0.05 * (1 + (i % 997)) for i in range(1000)]
    reps = 300_000

    def run(fn) -> float:
        t0 = time.perf_counter()
        for i in range(reps):
            fn(values[i % 1000])
        return (time.perf_counter() - t0) / reps * 1e9

    baseline_ns = run(lambda v: None)
    observe_ns = max(0.0, run(Histogram().observe) - baseline_ns)
    agg = phases_mod.PhaseAggregator()
    observe_phase_ns = max(0.0, run(
        lambda v: agg.observe_phase("host_tally", v)) - baseline_ns)
    n_requests = min(args.requests, 20)
    p50_ms, _ = host_p50(args, n_requests, reset=phases_mod.reset_phases)
    snap = phases_mod.phases_snapshot()
    observes = sum(row["count"] for row in snap.values()
                   if isinstance(row, dict))
    per_request = observes / max(1, n_requests)
    pct = round(per_request * observe_phase_ns / (p50_ms * 1e6) * 100, 4)
    return overhead_record(
        args, "phase-histogram observe() share of host-path p50", pct,
        observe_ns=round(observe_ns, 1),
        observe_phase_ns=round(observe_phase_ns, 1),
        observes_per_request=round(per_request, 2), host_p50_ms=p50_ms,
        note=("overhead = observes/request x lock-guarded observe ns / "
              "host p50 (clients/score.py host_tally + upstream_judge)"))


def quality_overhead_record(args) -> dict:
    """``QualityAggregator.observe_outcome`` on a panel-shaped outcome as
    a share of the host p50 (one outcome per scored request)."""
    from decimal import Decimal

    from ..obs import quality as quality_mod

    n, judges = max(2, args.n), max(2, args.judges)
    ballots = []
    for j in range(judges):
        vote = [0.4 / (n - 1)] * n
        vote[(j * 7) % n] = 0.6
        ballots.append(quality_mod.JudgeBallot(
            model=f"bench-judge-{j}", model_index=j, weight=Decimal(1),
            vote=vote))
    outcome = quality_mod.Outcome(
        winner=0, margin=0.25, weight_sum=Decimal(judges), n_choices=n,
        degraded=False, quorum_degraded=False, all_failed=False,
        trace_id="bench-trace", judges=ballots)
    reps = 50_000
    baseline_ns = loop_ns(lambda o: None, reps, outcome)
    agg = quality_mod.QualityAggregator()
    observe_ns = max(0.0, loop_ns(agg.observe_outcome, reps, outcome)
                     - baseline_ns)
    n_requests = min(args.requests, 20)
    p50_ms, _ = host_p50(args, n_requests, reset=quality_mod.reset_quality)
    observed = quality_mod.quality_snapshot()["requests"]
    pct = round(observe_ns / (p50_ms * 1e6) * 100.0, 4)
    return overhead_record(
        args, "quality observe_outcome share of host-path p50", pct,
        observe_outcome_ns=round(observe_ns, 1),
        outcomes_per_request=round(observed / max(1, n_requests), 2),
        host_p50_ms=p50_ms,
        note="overhead = lock-guarded observe_outcome ns / host p50")


def overlap_overhead_record(args) -> dict:
    """The dispatch seam's and the staging pool's bookkeeping (no-op
    waiter, unpinned buffers) as a share of the host p50, at one dispatch
    group per request."""
    import torch

    from ..models import dispatch_seam as seam

    reps = 200_000

    def seam_cycle(_):
        sink = seam.DispatchSink()
        with seam.deferred_readiness(sink):
            sink.add(seam.PendingDispatch("bench(b=1)", time.perf_counter(),
                                          None, wait=lambda out: None))
        seam.drain_sink(sink, observe_device=lambda label, ms: None,
                        observe_interval=lambda s, e: None)

    baseline_ns = loop_ns(lambda _: None, reps)
    seam_cycle_ns = max(0.0, loop_ns(seam_cycle, reps) - baseline_ns)
    pool = seam.StagingPool(per_bucket=2)
    shape = (max(1, args.n), args.seq)
    pool.release(pool.acquire(shape, torch.int32))

    def staging_cycle(_):
        pool.release(pool.acquire(shape, torch.int32))

    staging_cycle_ns = max(0.0, loop_ns(staging_cycle, reps) - baseline_ns)
    p50_ms, _ = host_p50(args, min(args.requests, 20))
    pct = round((seam_cycle_ns + 2 * staging_cycle_ns) / (p50_ms * 1e6)
                * 100.0, 4)
    return overhead_record(
        args, "dispatch-seam bookkeeping share of host-path p50", pct,
        seam_cycle_ns=round(seam_cycle_ns, 1),
        staging_cycle_ns=round(staging_cycle_ns, 1),
        staging_pool=pool.stats(), host_p50_ms=p50_ms,
        note=("overhead = (seam cycle + 2 staging cycles) ns / host p50 "
              "at one dispatch group per request; the device wait is "
              "excluded (a no-op waiter)"))


def witness_overhead_record(args) -> dict:
    """``LOCK_WITNESS=1``'s proxies as a share of the host p50: the ns a
    wrapped ``with lock:`` cycle costs over a raw one, times the real
    acquisitions per request of the phase aggregator's lock (the hottest
    registered lock on the host path, wrapped in a live witness)."""
    import threading

    from ..analysis.witness import LockWitness
    from ..obs import phases as phases_mod

    reps = 200_000
    witness = LockWitness()
    raw = threading.Lock()
    proxy = witness.wrap_lock("PhaseAggregator._lock", threading.Lock())

    def raw_cycle(_):
        with raw:
            pass

    def wrapped_cycle(_):
        with proxy:
            pass

    baseline_ns = loop_ns(lambda _: None, reps)
    raw_ns = max(0.0, loop_ns(raw_cycle, reps) - baseline_ns)
    wrapped_ns = max(0.0, loop_ns(wrapped_cycle, reps) - baseline_ns)
    witness_ns = max(0.0, wrapped_ns - raw_ns)

    n_requests = min(args.requests, 20)
    live = LockWitness()
    agg = phases_mod._AGG
    bare = agg._lock
    agg._lock = live.wrap_lock("PhaseAggregator._lock", bare)
    before = {}

    def mark():
        before["n"] = live.snapshot()["acquisitions"]

    try:
        p50_ms, _ = host_p50(args, n_requests, reset=mark)
    finally:
        agg._lock = bare  # leave the aggregator as it was
    snap = live.snapshot()
    per_request = (snap["acquisitions"] - before["n"]) / max(1, n_requests)
    pct = round(per_request * witness_ns / (p50_ms * 1e6) * 100.0, 4)
    return {
        "metric": "lock-witness proxy share of host-path p50",
        "value": pct, "unit": "%", "budget_pct": BUDGET_PCT,
        "within_budget": pct <= BUDGET_PCT,
        "witness_ns": round(witness_ns, 1),
        "raw_lock_ns": round(raw_ns, 1),
        "wrapped_lock_ns": round(wrapped_ns, 1),
        "acquisitions_per_request": round(per_request, 2),
        "violations": len(snap["violations"]),
        "host_p50_ms": p50_ms, "requests": n_requests,
        "judges": args.judges, "n_candidates": args.n,
        "cuda_initialized": cuda_initialized(),
        "baseline_basis": common.BASELINE_BASIS,
        "note": ("overhead = acquisitions/request x marginal witness ns / "
                 "host p50, acquisitions counted by the live witness on "
                 "the phase aggregator's lock"),
    }


def analysis_time_record(args) -> dict:
    """The analysis CLI's wall time by part: the AST lint (the
    per-function rules) and the concurrency audit (LWC014-016) in this
    process (stdlib only), the dispatch audit's CPU half and the mesh
    audit (JXA006-013, its own budget) each in a subprocess (they import
    torch and build test-tiny embedders on the CPU)."""
    from ..analysis import apply_baseline, load_baseline, run_lint
    from ..analysis.rules import ALL_RULES

    conc_names = {"LWC014", "LWC015", "LWC016"}
    t0 = time.perf_counter()
    findings = run_lint(
        rules=[r for r in ALL_RULES if r.name not in conc_names])
    lint_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    findings += run_lint(rules=[r for r in ALL_RULES if r.name in conc_names])
    concurrency_s = time.perf_counter() - t0
    kept, _suppressed, stale = apply_baseline(findings, load_baseline())

    def audit(module, entry, timeout):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c",
             "import sys\n"
             f"from llm_weighted_consensus_tpu_torch.analysis.{module} "
             f"import {entry}\n"
             f"sys.exit(1 if {entry}() else 0)"],
            cwd=common.REPO, timeout=timeout,
        )
        return time.perf_counter() - t0, proc.returncode == 0

    audit_s, audit_clean = audit("dispatch_audit", "run_dispatch_audit", 600)
    mesh_s, mesh_clean = audit("mesh_audit", "run_mesh_audit",
                               MESH_BUDGET_S * 2)
    total_s = lint_s + concurrency_s + audit_s + mesh_s
    return {
        "metric": ("full-package analysis wall time (AST lint + "
                   "concurrency audit + dispatch audit + mesh audit)"),
        "value": round(total_s, 3), "unit": "s",
        "lint_seconds": round(lint_s, 3),
        "concurrency_seconds": round(concurrency_s, 3),
        "audit_seconds": round(audit_s, 3),
        "mesh_seconds": round(mesh_s, 3),
        "lint_findings": len(kept), "stale_baseline": len(stale),
        "audit_clean": audit_clean,
        "mesh_clean": mesh_clean,
        "budget_seconds": ANALYSIS_BUDGET_S,
        "within_budget": lint_s + concurrency_s + audit_s < ANALYSIS_BUDGET_S,
        "mesh_budget_seconds": MESH_BUDGET_S,
        "mesh_within_budget": mesh_s < MESH_BUDGET_S,
        "cuda_initialized": cuda_initialized(),
        "note": ("lint + concurrency audit in-process (stdlib ast only), "
                 "the dispatch audit's CPU half and the mesh audit in "
                 "subprocesses"),
    }


def ingest_bounds_record(args) -> dict:
    """The SSE byte-budget accounting (capped against uncapped parser)
    per upstream frame, as a share of the host p50."""
    from ..clients.sse import SSEParser

    payload = json.dumps({"id": "bench", "choices": [
        {"index": 0, "delta": {"content": "I pick a candidate key"}}]}
    ).encode()
    frames = [b"data: " + payload + b"\n\n"] * 2 + [b"data: [DONE]\n\n"]
    reps = 30_000

    def parse_ns(make_parser) -> float:
        t0 = time.perf_counter()
        for _ in range(reps):
            parser = make_parser()
            for frame in frames:
                for _event in parser.feed(frame):
                    pass
            parser.flush()
        return (time.perf_counter() - t0) / (reps * len(frames)) * 1e9

    uncapped_ns = parse_ns(SSEParser)
    capped_ns = parse_ns(lambda: SSEParser(max_buffer_bytes=4 * 1024 * 1024,
                                           max_event_bytes=4 * 1024 * 1024))
    overhead_ns = max(0.0, capped_ns - uncapped_ns)
    p50_ms, _ = host_p50(args, min(args.requests, 20), skip_first=True)
    frames_per_request = args.judges * len(frames)
    pct = round(frames_per_request * overhead_ns / (p50_ms * 1e6) * 100.0,
                4)
    return overhead_record(
        args, "SSE byte-budget accounting share of host-path p50", pct,
        uncapped_ns_per_frame=round(uncapped_ns, 1),
        capped_ns_per_frame=round(capped_ns, 1),
        overhead_ns_per_frame=round(overhead_ns, 1),
        frames_per_request=frames_per_request, host_p50_ms=p50_ms,
        note=("overhead = upstream frames/request x (capped - uncapped) "
              "parser ns/frame / host p50"))


def host_speed_canary(reps: int = 2000) -> float:
    """Median per-rep cost (µs) of a fixed pure-Python workload (the
    reference's canary): compact JSON encode and decode, a precompiled
    regex scan, dict/list churn and a bounded-queue task switch per rep,
    the primitives the gated phases spend their time in, touching none of
    the engine's code.  Host CPU contention that slows the phases slows
    it by the same factor; a code regression does not move it."""
    pat = re.compile(r"\b(cand_[0-9]+)\b")
    text = " ".join(f"cand_{i} token{i}" for i in range(64))
    obj = {"choices": [{"index": i, "delta": {"content": f"tok {i}"}}
                       for i in range(16)]}

    async def pump(n):
        q = asyncio.Queue(maxsize=1)

        async def producer():
            for i in range(n):
                await q.put(i)

        task = asyncio.ensure_future(producer())
        for _ in range(n):
            await q.get()
        await task

    loop = asyncio.new_event_loop()
    try:
        samples = []
        for _ in range(reps):
            t0 = time.perf_counter()
            for _ in range(8):
                json.loads(json.dumps(obj, separators=(",", ":")))
                pat.findall(text)
                sorted(range(256), key=lambda v: (v * 2654435761) & 0xFFFF)
            loop.run_until_complete(pump(8))
            samples.append((time.perf_counter() - t0) * 1e6)
    finally:
        loop.close()
    return statistics.median(samples)


def band_check(fast: dict, budgets: dict, canary_us: float) -> tuple:
    """The fast lane's phase p50s against ``budgets`` (a
    ``host_budgets.json``): each limit is budget x band x machine scale,
    the scale the measured canary over the committed one, capped at 2 and
    never below 1.  -> (within_budget, {phase: {measured, limit, ok}},
    machine_scale)."""
    base = budgets.get("canary_us")
    scale = min(2.0, max(1.0, canary_us / base)) if base else 1.0
    detail, within = {}, True
    for phase in GATED_PHASES:
        limit = budgets["phases"][phase] * budgets["band"] * scale
        ok = fast[phase] <= limit
        detail[phase] = {"measured": fast[phase], "limit": round(limit, 2),
                         "ok": ok}
        within = within and ok
    return within, detail, scale


def host_cpu() -> str:
    """The host's CPU model: ``/proc/cpuinfo``'s model name (or its
    vendor and family fields where a virtual machine hides the name),
    with the machine type and the cores this process sees."""
    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                fields.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    model = fields.get("model name", "")
    if model in ("", "unknown"):
        model = " ".join(
            f"{k} {fields[k]}" for k in ("vendor_id", "cpu family", "model",
                                         "cpu MHz", "CPU implementer",
                                         "CPU part")
            if fields.get(k) not in (None, "", "unknown"))
    return (f"{model or 'model not reported'} ({platform.machine()}, "
            f"{os.cpu_count()} cores)")


def budgets_doc(fast: dict, canary_us: float, args, card) -> dict:
    """The ``host_budgets.json`` a ``--write-budgets`` run commits: the
    fast lane's gated phases, the healthy canary, the host's CPU model and
    the card's name and power limit.  Refused (ValueError) without a
    card's name: the budgets describe the card's machine."""
    if not card:
        raise ValueError(
            "--write-budgets needs the card's machine: no nvidia-smi name "
            "and power limit in the record")
    return {
        "band": 1.25, "judges": args.judges, "n_candidates": args.n,
        "phases": {k: fast[k] for k in GATED_PHASES},
        "canary_us": round(canary_us, 2),
        "host_cpu": host_cpu(), "card": card,
        "note": ("fast-lane (HOST_FASTPATH=1) host-path p50 budgets from "
                 "bench host --hostpath --write-budgets on the card's "
                 "machine; --hostpath fails when a phase p50 exceeds "
                 "budget x band x machine_scale (measured canary / "
                 "canary_us, capped at 2.0, never < 1.0)"),
    }


def hostpath_record(args) -> dict:
    """Per-chunk host-path p50 per phase (ingest / merge / tally /
    encode), ``HOST_FASTPATH`` unset against set, over real engine
    streams; the headline is the per-chunk ratio (slow / fast).  The fast
    lane's phases are banded against the committed host budgets, or, with
    ``--write-budgets``, written as the new budgets."""
    from ..ballot import PrefixTree, branch_limit
    from ..ballot.vote import extract_vote
    from ..clients.score import merge_streams
    from ..obs import phases as phases_mod
    from ..serve import frames

    n_requests = min(args.requests, 20)
    texts = common.make_requests(n_requests + 1, args.n, seed=args.seed)
    rng = random.Random(args.seed)
    tree = PrefixTree.build(rng, args.n, branch_limit(None))
    key_indices = tree.key_indices(rng)
    w_src, wo_src = PrefixTree.regex_patterns([k for k, _ in key_indices])
    key_by_idx = {idx: k for k, idx in key_indices}
    vote_rng = random.Random(args.seed + 1)
    contents = [f"I pick {key_by_idx[vote_rng.randrange(3)]} as best."
                for _ in range(args.judges)]

    def measure_lane(fastpath: bool) -> dict:
        client, model_json = build_engine(args.judges, args.n,
                                          n_requests + 1, args.seed,
                                          host_fastpath=fastpath)
        score_one = scorer(client, model_json)
        loop = asyncio.new_event_loop()
        try:
            chunks = loop.run_until_complete(score_one(texts[0]))
            tally_samples = []
            for t in texts[1:]:
                phases_mod.reset_phases()
                loop.run_until_complete(score_one(t))
                row = phases_mod.phases_snapshot().get("host_tally") or {}
                tally_samples.append(row.get("sum_ms", 0.0))
        finally:
            loop.close()
        per_frame = [[] for _ in chunks]
        gc.disable()
        try:
            for _ in range(120):
                enc = frames.FrameEncoder(fastpath)
                for i, item in enumerate(chunks):
                    t0 = time.perf_counter()
                    enc.encode(item)
                    per_frame[i].append(time.perf_counter() - t0)
                if fastpath and enc.fallbacks:
                    raise AssertionError(
                        f"the fast lane fell back {enc.fallbacks}x")
        finally:
            gc.enable()
        frame_us = [statistics.median(t) * 1e6 for t in per_frame]
        pats = ((re.compile(w_src), re.compile(wo_src)) if fastpath
                else (w_src, wo_src))
        ingest = []
        for _ in range(300):
            t0 = time.perf_counter()
            for content in contents:
                extract_vote(tree, pats[0], pats[1], args.n, content, None)
            ingest.append((time.perf_counter() - t0) * 1e6 / args.judges)
        ingest_us = statistics.median(ingest)
        per_judge = max(1, (len(chunks) - 2) // args.judges + 1)

        async def one_judge():
            for i in range(per_judge):
                yield i

        async def drain():
            t0 = time.perf_counter()
            n_items = 0
            async for _ in merge_streams([one_judge()
                                          for _ in range(args.judges)]):
                n_items += 1
            return (time.perf_counter() - t0) * 1e6 / n_items

        loop = asyncio.new_event_loop()
        try:
            merge_us = statistics.median(
                [loop.run_until_complete(drain()) for _ in range(120)])
        finally:
            loop.close()
        n_frames = len(chunks)
        per_chunk = [merge_us + enc_us + (
            ingest_us if n_frames - 1 - args.judges <= i < n_frames - 1
            else 0.0) for i, enc_us in enumerate(frame_us)]
        return {
            "per_chunk_p50_us": round(statistics.median(per_chunk), 3),
            "ingest_p50_us": round(ingest_us, 3),
            "merge_p50_us": round(merge_us, 3),
            "tally_p50_ms": (round(statistics.median(tally_samples), 4)
                             if tally_samples else 0.0),
            "encode_p50_us": round(statistics.median(frame_us), 3),
            "encode_stream_total_us": round(sum(frame_us), 1),
            "frames_per_stream": n_frames,
        }

    canary_pre = host_speed_canary()
    slow = measure_lane(False)
    canary_mid = host_speed_canary()
    fast = measure_lane(True)
    canary_post = host_speed_canary()
    if getattr(args, "write_budgets", False):
        # the budgets take each phase's slowest of three fast-lane runs:
        # on the card's shared host one run's phase p50s moved by up to
        # 1.6x between two processes, which a single run's budget turns
        # into a failing band
        runs = [fast, measure_lane(True), measure_lane(True)]
        fast = {k: max(r[k] for r in runs) for k in fast}
    ratio = round(slow["per_chunk_p50_us"] / fast["per_chunk_p50_us"], 3)
    embed_assembly = embeddings_assembly(args.n)
    if getattr(args, "write_budgets", False):
        # the healthy floor: the fastest canary of the window
        canary_us = min(canary_pre, canary_mid, canary_post)
        budgets = budgets_doc(fast, canary_us, args, common.gpu_line())
        with open(HOST_BUDGETS, "w") as fh:
            json.dump(budgets, fh, indent=2, sort_keys=True)
            fh.write("\n")
        within, detail, scale = True, {"written": HOST_BUDGETS}, 1.0
    else:
        # the most contended view of the window the phases ran in
        canary_us = max(canary_pre, canary_mid, canary_post)
        with open(HOST_BUDGETS) as fh:
            budgets = json.load(fh)
        within, detail, scale = band_check(fast, budgets, canary_us)
    return {
        "metric": ("host-path per-chunk p50 ratio (HOST_FASTPATH unset / "
                   f"set), {args.judges} judges x N={args.n}"),
        "value": ratio, "unit": "x", "min_ratio": 2.0,
        "meets_min_ratio": ratio >= 2.0,
        "within_budget": within, "budget_band": budgets["band"],
        "budget_detail": detail, "canary_us": round(canary_us, 2),
        "machine_scale": round(scale, 3),
        "embed_assembly": embed_assembly,
        "slow_lane": slow, "fast_lane": fast,
        "requests": n_requests, "judges": args.judges, "n_candidates": args.n,
        "cuda_initialized": cuda_initialized(),
        "baseline_basis": common.BASELINE_BASIS,
        "note": ("per-chunk host path = merge hop + frame encode per "
                 "streamed frame (+ ballot scan on judge-final frames), "
                 "p50 over one real stream's frames; tally per request"),
    }


def embeddings_assembly(n: int) -> dict:
    """``/embeddings`` response assembly at [n, 768] f32: per-element
    ``float(v)`` against one bulk ``tolist()`` (the embedder's
    ``wire_response``), values identical."""
    import numpy as np

    emb = (np.arange(n * 768, dtype=np.float32).reshape(n, 768) % 97) / 97.0

    def median_ms(fn, reps=30):
        samples = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            samples.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(samples)

    def per_element():
        return [[float(v) for v in row] for row in emb]

    if per_element() != np.asarray(emb).tolist():
        raise AssertionError("bulk tolist must equal per-element float()")
    before = median_ms(per_element)
    after = median_ms(lambda: np.asarray(emb).tolist())
    return {"shape": f"{n}x768 f32",
            "before_per_element_float_ms": round(before, 3),
            "after_bulk_tolist_ms": round(after, 3),
            "speedup": round(before / after, 1)}


def default_record(args) -> dict:
    tok = common.bench_tokenizer()
    client, model_json = build_engine(args.judges, args.n, args.requests + 1,
                                      args.seed)
    score_one = scorer(client, model_json)
    texts_per_request = common.make_requests(args.requests, args.n,
                                             seed=args.seed)
    loop = asyncio.new_event_loop()
    tokenize_ms, score_ms, total_ms = [], [], []
    chunks_seen = 0
    try:
        loop.run_until_complete(score_one(texts_per_request[0]))
        for texts in texts_per_request:
            t0 = time.perf_counter()
            ids, mask = tok.encode_batch(texts, args.seq)
            t1 = time.perf_counter()
            items = loop.run_until_complete(score_one(texts))
            t2 = time.perf_counter()
            if ids.shape != (args.n, args.seq) or mask.shape != ids.shape:
                raise AssertionError(f"tokenized to {ids.shape}")
            chunks_seen += len(items)
            tokenize_ms.append((t1 - t0) * 1e3)
            score_ms.append((t2 - t1) * 1e3)
            total_ms.append((t2 - t0) * 1e3)
    finally:
        loop.close()

    def pct(xs, q):
        return round(statistics.quantiles(xs, n=100)[q - 1]
                     if len(xs) >= 2 else xs[0], 3)

    return {
        "metric": (f"host path ms/request (tokenize + ballot + merge), "
                   f"{args.judges} judges x N={args.n}"),
        "value": pct(total_ms, 50), "unit": "ms",
        "p50_ms": pct(total_ms, 50), "p99_ms": pct(total_ms, 99),
        "breakdown": {"tokenize_p50_ms": pct(tokenize_ms, 50),
                      "score_engine_p50_ms": pct(score_ms, 50)},
        "requests": args.requests, "judges": args.judges,
        "n_candidates": args.n, "seq": args.seq,
        "stream_chunks_per_request": chunks_seen / max(1, args.requests),
        "cuda_initialized": cuda_initialized(),
        "baseline_basis": common.BASELINE_BASIS,
        "note": ("real host path (WordPiece encode_batch, seeded PrefixTree "
                 "ballot, ScoreClient stream merge + weighted tally) over "
                 "scripted in-memory judges; no card, no network"),
    }


SCENARIOS = {
    "analysis_time": analysis_time_record,
    "witness_overhead": witness_overhead_record,
    "ingest_bounds": ingest_bounds_record,
    "hostpath": hostpath_record,
    "overlap_overhead": overlap_overhead_record,
    "quality_overhead": quality_overhead_record,
    "metrics_overhead": metrics_overhead_record,
}


def run_host(args) -> None:
    scenario = next((name for name in SCENARIOS if getattr(args, name)),
                    None)
    record = (SCENARIOS[scenario] if scenario else default_record)(args)
    record.update(common.envelope(args.seed))
    common.emit(record)
    if record["cuda_initialized"]:
        raise AssertionError("the host bench created a CUDA context")
    if "within_budget" in record and not record["within_budget"]:
        raise AssertionError(f"{record['metric']}: {record['value']} "
                             f"{record['unit']} is past its budget: "
                             f"{record.get('budget_detail', '')}")


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="bench host")
    p.add_argument("--judges", type=int, default=8)
    p.add_argument("--n", type=int, default=64, help="candidates/request")
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--requests", type=int, default=50)
    p.add_argument("--seed", type=int, default=42)
    for flag in ("--hostpath", "--metrics-overhead", "--quality-overhead",
                 "--overlap-overhead", "--ingest-bounds", "--analysis-time",
                 "--witness-overhead"):
        p.add_argument(flag, action="store_true")
    p.add_argument("--write-budgets", action="store_true",
                   help="with --hostpath: write analysis/host_budgets.json "
                   "(on the card's machine)")
    common.add_device_flag(p)
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    base = {"metric": "host path", "seed": args.seed}
    if args.write_budgets:
        args.hostpath = True  # the budgets are the --hostpath fast lane's
    # device-free either way; the flag names the machine whose host the
    # record describes, and without a card it stops as every bench does
    common.select_device(NAME, args.device, base)
    return common.run(NAME, base, lambda: run_host(args))
