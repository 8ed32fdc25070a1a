"""The dp sweep: closed-loop consensus answers/s through the serving
path at dp = 1/2/4/8 (the counterpart of the reference's
``bench_scaling.py``).

Every dp serves the same fixed workload (``--workers`` closed-loop
workers, each sending ``--requests-per-worker`` requests of ``--n``
candidates, ``common.make_requests``) through a ``DeviceBatcher`` on a
mesh embedder (``shard_embedder_mesh`` over a dp x 1 mesh, every bucket
the traffic forms warmed: one CUDA graph per bucket on one card; one set
of weights, built once, serves every row), so the dp=1 row is the
baseline and every other row is the same work on a wider mesh.  Per dp: answers/s of a timed pass after an untimed one, the
batcher's dispatches per request (one dispatch per group at every dp: no
hidden per-shard round trip), the rows each shard holds, the graph
table's bracket (no capture and no eager dispatch in the timed pass) and
the first requests' answers held to a one-device embedder of the same
seed (2e-4, the reference's).

The mesh's devices are the local cards where there are dp of them; with
fewer, the dp shards share the first card by an explicit device list (as
``chip_smoke.py`` phase 20 builds its meshes), and the record says so:
``cards`` (distinct cards under the widest mesh) and ``efficiency_basis``.
On a shared card the shards' work is serialized, so answers/s cannot grow
with dp: efficiency = rate(dp) / rate(1) then measures the extra work
the sharded program adds (dp launches of smaller products, the gathers,
the sharded vote).  ``required_efficiency`` (0.75, the reference's bar)
is recorded against it, not enforced: the reference's bar is a claim
about a virtual mesh on one CPU core.

Run: ``python -m llm_weighted_consensus_tpu_torch.bench scaling [--model
M] [--dps 1,2,4,8]``.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from . import common

NAME = "scaling"
N_CANDIDATES = 64
WORKERS = 8  # fixed offered concurrency at every dp
REQUESTS_PER_WORKER = 3
REQUIRED_EFFICIENCY = 0.75
CONF_TOL = 2e-4


def efficiency_basis(cards: int) -> str:
    if cards > 1:
        return (f"{cards} distinct cards: rate(dp)/rate(dp=1) is the "
                "scaling of the sharded program across cards")
    return ("one card shared by every dp shard (an explicit device list): "
            "the shards' work is serialized, so answers/sec cannot grow "
            "with dp; efficiency = rate(dp)/rate(dp=1) measures the total "
            "extra work the sharded program adds (smaller products per "
            "launch, gathers, the sharded vote), not a throughput claim")


def mesh_devices(dp: int, device: str) -> list:
    """dp devices: the local cards where there are enough, else the first
    card (or the CPU) repeated."""
    import torch

    if device == "cuda" and torch.cuda.device_count() >= dp:
        return [torch.device("cuda", i) for i in range(dp)]
    first = torch.device("cuda", 0) if device == "cuda" else torch.device(
        "cpu")
    return [first] * dp


def build_embedder(model: str, device: str, max_tokens: int, shared=None):
    """The bench embedder (seed 0, the bench tokenizer); ``shared``, an
    embedder whose model (its weights) the new one serves: every dp row
    serves the same weights, built once."""
    from ..models.embedder import TorchEmbedder

    if shared is not None:
        return TorchEmbedder(model, model=shared.model, config=shared.config,
                             max_tokens=max_tokens,
                             tokenizer=common.bench_tokenizer(),
                             device=device, dtype=shared.dtype)
    return TorchEmbedder(model, max_tokens=max_tokens, seed=0,
                         tokenizer=common.bench_tokenizer(), device=device)


def run_closed_loop(args, device: str) -> dict:
    import torch

    from ..obs import reset_phases
    from ..parallel.mesh import make_mesh
    from ..parallel.sharding import shard_embedder_mesh
    from ..serve.batcher import DeviceBatcher
    from ..serve.metrics import Metrics
    from .http import phase_summary

    workers, per_worker, n = args.workers, args.requests_per_worker, args.n
    n_requests = workers * per_worker
    requests = common.make_requests(n_requests, n)
    ref = build_embedder(args.model, device, args.max_tokens)
    ref_conf = [np.asarray(ref.consensus_confidence(texts))
                for texts in requests[:4]]

    def closed_loop(batcher) -> list:
        from concurrent.futures import ThreadPoolExecutor

        def worker(w):
            return [batcher.consensus(requests[w * per_worker + i])[0]
                    for i in range(per_worker)]

        with ThreadPoolExecutor(workers) as pool:
            per = list(pool.map(worker, range(workers)))
        return [c for confs in per for c in confs]

    rows, cards = [], 1
    for dp in args.dps:
        embedder = build_embedder(args.model, device, args.max_tokens,
                                  shared=ref)
        devices = mesh_devices(dp, device)
        mesh = make_mesh(dp=dp, tp=1, devices=devices)
        cards = max(cards, len(mesh.distinct_devices()))
        shard_embedder_mesh(embedder, mesh)
        specs = sorted({(n, embedder.tokenize(texts)[0].shape[1])
                        for texts in requests})
        r_buckets = [r for r in (2, 4, 8) if r <= workers]
        embedder.warmup(specs, r_buckets=r_buckets)
        ids, _ = embedder.tokenize(requests[0])
        padded = ids.shape[0] + (-ids.shape[0]) % dp
        with DeviceBatcher(embedder, Metrics(), window_ms=3.0) as batcher:
            closed_loop(batcher)  # untimed: absorbs first touches
            before = embedder.graph_stats()
            reset_phases()
            t0 = time.perf_counter()
            confs = closed_loop(batcher)
            elapsed = time.perf_counter() - t0
            after = embedder.graph_stats()
            util = batcher.utilization()
        if (after["captures"], after["eager_dispatches"]) != (
                before["captures"], before["eager_dispatches"]):
            raise RuntimeError(
                f"dp={dp}: the timed pass captured or ran eager "
                f"({before} -> {after})")
        errors = [float(np.max(np.abs(confs[i] - want)))
                  for i, want in enumerate(ref_conf)]
        if max(errors) > CONF_TOL:
            raise RuntimeError(
                f"dp={dp}: answers off the one-device run by "
                f"{max(errors):.3g} > {CONF_TOL}")
        row = {
            "dp": dp,
            "devices_used": dp,
            "cards": len(mesh.distinct_devices()),
            "n_candidates": n,
            "rows_per_device": padded // dp,
            "answers": n_requests,
            "answers_per_sec": round(n_requests / elapsed, 3),
            # two closed-loop passes went through this batcher
            "dispatches_per_request": round(
                util["dispatches"] / (2.0 * n_requests), 4),
            "aot_buckets": after["graphs"],
            "graphs": {"captures": after["captures"],
                       "replays": after["replays"] - before["replays"],
                       "eager_dispatches": after["eager_dispatches"]},
            "matches_single_device": True,
            "max_abs_err": max(errors),
            "phase_breakdown": phase_summary(),
        }
        rows.append(row)
        common.emit({"bench": NAME, **row})
        del embedder, batcher
        if device == "cuda":
            torch.cuda.empty_cache()

    base = rows[0]["answers_per_sec"]
    for row in rows:
        row["efficiency_vs_dp1"] = round(row["answers_per_sec"] / base, 4)
    by_dp = {row["dp"]: row["efficiency_vs_dp1"] for row in rows}
    disp = {row["dispatches_per_request"] for row in rows}
    return {
        "metric": (f"closed-loop consensus answers/sec at N={n}, dp sweep "
                   f"{'/'.join(map(str, args.dps))}, {workers} workers "
                   "(fixed workload)"),
        "unit": "answers/sec",
        "value": rows[-1]["answers_per_sec"],
        "baseline_basis": common.BASELINE_BASIS,
        "model": args.model,
        "backend": device,
        "nproc": len(os.sched_getaffinity(0)),
        "cards": cards,
        "efficiency_basis": efficiency_basis(cards),
        "rows": rows,
        "efficiency_dp8_vs_dp1": by_dp.get(8),
        "efficiency_by_dp": by_dp,
        "required_efficiency": REQUIRED_EFFICIENCY,
        "dispatches_per_request_dp_invariant": len(disp) == 1,
        **common.envelope(0),
    }


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="bench scaling")
    p.add_argument("--model", default="test-tiny")
    p.add_argument("--max-tokens", type=int, default=32)
    p.add_argument("--dps", default="1,2,4,8")
    p.add_argument("--n", type=int, default=N_CANDIDATES)
    p.add_argument("--workers", type=int, default=WORKERS)
    p.add_argument("--requests-per-worker", type=int,
                   default=REQUESTS_PER_WORKER)
    common.add_device_flag(p)
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    args.dps = [int(x) for x in args.dps.split(",") if x.strip()]
    base = {"metric": "closed-loop consensus answers/sec, dp sweep",
            "model": args.model}
    device = common.select_device(NAME, args.device, base)
    return common.run(NAME, base,
                      lambda: common.emit(run_closed_loop(args, device)))
