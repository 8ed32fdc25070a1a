"""Headline bench: consensus answers/s and p50 at N=64, bge-large, on the
card (the counterpart of the reference's ``bench.py``).

One answer is one self-consistency consensus: tokenize N candidate texts
on the host (the bench WordPiece vocabulary), embed them at the fixed
``--seq`` and vote, through the served embedder: ``build_embedder`` from
the serving environment (``EMBEDDER_MODEL=--model``,
``EMBEDDER_QUANTIZE=--quantize``, ``EMBEDDER_MAX_TOKENS=--seq``, random
weights from seed 0 unless ``EMBEDDER_WEIGHTS`` names a checkpoint), its
buckets warmed as CUDA graphs first, so every timed dispatch is a
replay.

* Throughput is pipelined the serving way: each dispatch returns at
  enqueue through the dispatch seam (``models/dispatch_seam.py``) and a
  pool of 8 threads waits for the results, at most 32 in flight, while
  the host tokenizes the next request.  ``--no-pipeline`` waits for each.
* p50 and p99 over ``--latency-requests`` serial requests.
* Device time per answer is each dispatch's CUDA events (recorded around
  the copy-in, the replay, the vote and the copy-out on the stream);
  beside it the roofline gauge's log-bucket p50, ``sol_ms`` and
  attainment for the same bucket, and their ratio.
* ``mfu_h100_bf16`` = FLOPs per answer / (device s x 989e12).
* ``dispatch_evidence``: kernel launches by route over the timed windows,
  per dispatch (24 ``tma`` attention launches and one ``cluster`` vote per
  bge-large answer; under int8 144 ``tma`` W8A8 launches).
* Under ``--quantize`` an accuracy delta against a same-seed unquantized
  twin.

On ``--device cpu`` the plain versions run (a rehearsal): every device
metric is null.  Run: ``python -m llm_weighted_consensus_tpu_torch.bench
headline [--model M] [--n 64] [--seq 128] [--quantize none|int8|int4-pallas]``.
"""

from __future__ import annotations

import argparse
import os
import statistics
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from . import common

NAME = "headline"
QUANTIZE_MODES = ("none", "int8", "int4-pallas")
# at most this many dispatches in flight in the pipelined window
MAX_IN_FLIGHT = 32


def base_record(args) -> dict:
    return {
        "metric": (f"consensus answers/sec + p50 latency at N={args.n} "
                   f"candidates, {args.model}"),
        "value": None, "unit": "answers/sec", "vs_baseline": None,
        "baseline_basis": common.BASELINE_BASIS, "n_candidates": args.n,
        "seq": args.seq, "model": args.model, "quantize": args.quantize,
    }


def build(model: str, quantize: str, device: str, seq: int = None):
    """The served embedder (``serve.__main__.build_embedder`` from the
    serving environment; ``seq``, if given, its ``EMBEDDER_MAX_TOKENS``)
    with the bench tokenizer."""
    from ..serve.__main__ import build_embedder

    env = dict(os.environ)
    env.update(EMBEDDER_MODEL=model, EMBEDDER_QUANTIZE=quantize,
               LWC_ALLOW_RANDOM_PARAMS="1")
    if seq is not None:
        env["EMBEDDER_MAX_TOKENS"] = str(seq)
    embedder = build_embedder(env, device=device)
    embedder.tokenizer = common.bench_tokenizer()
    return embedder


def answer(embedder, texts: list, seq: int):
    """One bench answer: ``texts`` tokenized at the fixed ``seq``, embedded
    and voted (a dispatch handle under a sink, else the confidences)."""
    ids, mask = common.tokenize_fixed(embedder, texts, seq)
    return embedder.consensus_confidence_tokens(ids, mask)


class Seam:
    """Dispatches through the deferred-readiness seam, as the batcher
    does: ``launch`` returns at enqueue, ``finish`` (on a fetch thread)
    waits, records the dispatch's device ms and hands its buffers back."""

    def __init__(self, embedder) -> None:
        self.embedder = embedder
        self.device_ms: list = []

    def launch(self, fn, *args):
        from ..models.dispatch_seam import DispatchSink, deferred_readiness

        sink = DispatchSink()
        with deferred_readiness(sink):
            handle = fn(*args)
        return sink, handle

    def finish(self, launched) -> np.ndarray:
        from ..models.dispatch_seam import drain_sink
        from ..obs import phases

        sink, handle = launched
        pool = self.embedder.staging_pool
        timed = self.device_ms

        def observe(label, ms):
            phases.observe_device(label, ms)
            timed.append(ms)

        drain_sink(sink, observe_device=observe,
                   observe_interval=phases.observe_device_interval,
                   release=pool.release, retain=pool.retain)
        return handle.result()


def pipelined_rate(seam: Seam, fn, requests: list) -> tuple:
    """(answers/s, results): dispatch after dispatch through the seam,
    results awaited on 8 fetch threads, at most ``MAX_IN_FLIGHT`` in
    flight."""
    fetch = ThreadPoolExecutor(8)
    futures = []
    try:
        t0 = time.perf_counter()
        for texts in requests:
            futures.append(fetch.submit(seam.finish, seam.launch(fn, texts)))
            while sum(not f.done() for f in futures) > MAX_IN_FLIGHT:
                time.sleep(0.001)
        results = [f.result() for f in futures]
        total = time.perf_counter() - t0
    finally:
        fetch.shutdown()
    return len(requests) / total, results


def dispatch_evidence(before: dict, after: dict, dispatches: int,
                      layers: int, graphs_before: dict,
                      graphs_after: dict) -> dict:
    """Launches by route over a window of ``dispatches`` consensus
    dispatches, and the graph counters' rise."""
    delta = common.launch_delta(before, after)
    per = {name: row["launches"] / max(1, dispatches)
           for name, row in delta.items()}
    dense = per["w8a8_matmul"] + per["w4a8_matmul"]
    return {
        "dispatches": dispatches,
        "launches": delta,
        "attention_per_dispatch": per["attention"],
        "vote_per_dispatch": per["cosine_vote"],
        "quantized_matmul_per_dispatch": dense,
        "attention_per_layer": per["attention"] / max(1, layers),
        "replays": graphs_after["replays"] - graphs_before["replays"],
        "eager_dispatches": (graphs_after["eager_dispatches"]
                             - graphs_before["eager_dispatches"]),
        "captures": graphs_after["captures"] - graphs_before["captures"],
    }


def roofline_reading(embedder, label: str, event_p50: float,
                     on_card: bool) -> dict:
    """The gauge's reading of ``label`` (log-bucket p50, ``sol_ms``,
    attainment) beside the CUDA events' p50 of the same dispatches."""
    from ..analysis.cost import bucket_cost
    from ..analysis.roofline import (
        DEFAULT_PEAKS,
        RooflineGauge,
        load_roofline,
        sol_ms,
    )

    roofline = load_roofline()
    gauge = RooflineGauge(roofline, "cuda" if on_card else "cpu").snapshot()
    row = gauge["buckets"].get(label, {})
    width = 2 if str(embedder.dtype).endswith("bfloat16") else 4
    figures = bucket_cost(embedder.config, label, width)
    sol = sol_ms(figures, DEFAULT_PEAKS["cuda"])
    gauge_p50 = row.get("device_p50_ms") if on_card else None
    event = event_p50 if on_card else None
    return {
        "label": label,
        "committed": label in roofline.get("buckets", {}),
        "sol_ms": round(sol, 4) if sol else None,
        "gauge_device_p50_ms": gauge_p50,
        "gauge_attainment": row.get("attainment") if on_card else None,
        "event_device_p50_ms": event,
        "event_attainment": round(sol / event, 4) if sol and event else None,
        "gauge_over_events": (round(gauge_p50 / event, 4)
                              if gauge_p50 and event else None),
    }


def quantize_accuracy(embedder, args, device: str, requests: list) -> dict:
    """Vote top-1 agreement and the least embedding cosine against a
    same-seed unquantized twin on the same texts."""
    twin = build(args.model, "none", device, args.seq)
    agree, cos_min = 0, 1.0
    probe = requests[:8]
    for texts in probe:
        ids, mask = common.tokenize_fixed(embedder, texts, args.seq)
        cq = np.asarray(embedder.consensus_confidence_tokens(ids, mask))
        cr = np.asarray(twin.consensus_confidence_tokens(ids, mask))
        agree += int(cq.argmax() == cr.argmax())
        eq = np.asarray(embedder.embed_tokens(ids, mask), np.float32)
        er = np.asarray(twin.embed_tokens(ids, mask), np.float32)
        cos_min = min(cos_min, float((eq * er).sum(axis=1).min()))
    del twin
    return {
        "vote_top1_agreement": f"{agree}/{len(probe)}",
        "embedding_cosine_min": round(cos_min, 4),
        "weights": "same-seed random (no checkpoint is downloaded)",
    }


def run_headline(args, device: str, embedder=None) -> dict:
    """The headline record; ``embedder`` (default: ``build`` from the
    flags) is the served embedder to drive."""
    from ..obs import reset_phases

    on_card = device == "cuda"
    if embedder is None:
        embedder = build(args.model, args.quantize, device, args.seq)
    layers = embedder.config.num_layers
    requests = common.make_requests(args.requests, args.n)
    seam = Seam(embedder)
    label = f"vote1(n={args.n},s={args.seq})"

    def consensus(texts):
        return answer(embedder, texts, args.seq)

    def serial(texts):
        t0 = time.perf_counter()
        out = seam.finish(seam.launch(consensus, texts))
        return out, (time.perf_counter() - t0) * 1e3

    embedder.warmup([(args.n, args.seq)])
    for w in range(3):
        warm, _ = serial(requests[w % len(requests)])
    if abs(float(warm.sum()) - 1.0) > 1e-3:
        raise AssertionError(f"the warm answer sums to {warm.sum()}")

    before = common.launch_counts()
    graphs_before = embedder.graph_stats()
    dispatches = 0
    # latency: strictly serial, one request at a time
    reset_phases()
    seam.device_ms.clear()
    latencies = []
    for texts in requests[: args.latency_requests]:
        _, ms = serial(texts)
        latencies.append(ms)
    dispatches += len(latencies)
    event_samples = list(seam.device_ms)
    reading = roofline_reading(
        embedder, label, statistics.median(event_samples), on_card)
    # throughput: the seam's pipelined shape, or serial with --no-pipeline
    if args.no_pipeline:
        t0 = time.perf_counter()
        results = [serial(texts)[0] for texts in requests]
        rate = len(requests) / (time.perf_counter() - t0)
    else:
        rate, results = pipelined_rate(seam, consensus, requests)
    dispatches += len(requests)
    for r in results:
        if abs(float(np.sum(r)) - 1.0) > 1e-2:
            raise AssertionError(f"an answer sums to {np.sum(r)}")
    evidence = dispatch_evidence(before, common.launch_counts(), dispatches,
                                 layers, graphs_before,
                                 embedder.graph_stats())

    # the serving path's number: embedder.tokenize buckets the corpus
    # (about 104 tokens: the s=112 bucket), warmed as its own graph
    serving_seq = serving_rate = None
    if not args.no_pipeline:
        serving_seq = int(embedder.tokenize(requests[0])[0].shape[1])
        if serving_seq != args.seq:
            embedder.warmup([(args.n, serving_seq)])
            serial_fn = embedder.consensus_confidence
            seam.finish(seam.launch(serial_fn, requests[0]))
            serving_rate, _ = pipelined_rate(seam, serial_fn, requests)
            serving_rate = round(serving_rate, 3)

    quant_check = None
    if args.quantize != "none":
        quant_check = quantize_accuracy(embedder, args, device, requests)

    p50 = statistics.median(latencies)
    ordered = sorted(latencies)
    p99 = ordered[min(len(ordered) - 1, int(len(ordered) * 0.99))]
    device_ms = statistics.median(event_samples) if on_card else None
    chunks = np.array_split(np.asarray(event_samples), 5)
    device_runs = (sorted(round(float(np.median(c)), 4) for c in chunks
                          if len(c)) if on_card else None)
    flops = common.flops_per_answer(embedder.config, args.n, args.seq)
    eff_tflops = flops / 1e12 / (device_ms / 1e3) if device_ms else None
    record = base_record(args)
    record.update(
        value=round(rate, 3),
        vs_baseline=round(rate / common.BASELINE_A100_ANSWERS_PER_SEC, 3),
        baseline=("estimated candle-CUDA A100 rate: 25 answers/sec (312 "
                  "TFLOP/s peak x 40% MFU / 5.06 TFLOP per answer); not "
                  "measured"),
        p50_ms=round(p50, 3),
        p99_ms=round(p99, 3),
        device_only_ms=round(device_ms, 4) if device_ms else None,
        device_only_ms_runs=device_runs,
        serving_bucketed_answers_per_sec=serving_rate,
        serving_bucketed_seq=serving_seq,
        effective_tflops=round(eff_tflops, 2) if eff_tflops else None,
        mfu_h100_bf16=(round(eff_tflops * 1e12 / common.H100_PEAKS[
            "bfloat16"], 4) if eff_tflops else None),
        tflop_per_answer=round(flops / 1e12, 4),
        backend=device,
        quantize_accuracy=quant_check,
        requests=len(requests),
        latency_requests=len(latencies),
        roofline=reading,
        dispatch_evidence=evidence,
        graphs=embedder.graph_stats(),
        numerics=("erf GELU (the A&S form in bf16, models/layers.py); "
                  "device time from each dispatch's CUDA events"),
        **common.envelope(0),
    )
    return record


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="bench headline")
    p.add_argument("--model", default="bge-large-en")
    p.add_argument("--n", type=int, default=64)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--requests", type=int, default=100)
    p.add_argument("--latency-requests", type=int, default=50)
    p.add_argument("--no-pipeline", action="store_true")
    p.add_argument("--quantize", default="none",
                   help="none, int8 (W8A8) or int4-pallas (W4A8); "
                   "int8-xla and int8-pallas are refused")
    common.add_device_flag(p)
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    base = base_record(args)
    if args.quantize not in QUANTIZE_MODES:
        common.emit({**base, "bench": NAME, "error": (
            f"--quantize {args.quantize!r} is not a mode of this bench; "
            f"valid values: {', '.join(QUANTIZE_MODES)}")})
        return 2
    device = common.select_device(NAME, args.device, base)
    return common.run(NAME, base,
                      lambda: common.emit(run_headline(args, device)))
