"""The five BASELINE configs on the card, one JSON line each, plus the
int8 headline and the learning effect (the counterpart of the reference's
``bench_all.py``).

1. N=8 single-model self-consistency, bge-small-en cosine vote;
2. N=32 multichat over 3 backends, weighted consensus, bge-large-en;
3. reward-model re-ranking (deberta-v3-base) in place of the cosine vote;
4. archive batch re-score, 10k completions in one device batch;
5. streaming multichat with incremental device consensus updates,
   concurrent streams through the serving ``DeviceBatcher``;
7. the int8 W8A8 headline (bge-large, N=64, s=128);
6. the learning effect (``bench/learning.py``).

Configs 2 and 5 run the port's multichat client over an in-memory
scripted upstream (``serve/fake_upstream.py``'s ``ScriptedTransport``),
so they time the port's fan-out and device consensus, not a provider.
Embedders are built once (``serve.__main__.build_embedder``, the bench
WordPiece vocabulary) and shared by the reproducibility runs; each
config's buckets are captured as CUDA graphs before it is timed, and each
record says how many of its dispatches were replays.  Config 3's
reranker comes from ``build_reranker`` with a synthetic ``spm.model``
written under ``build/bench/``.  Each config runs 3 times (2 with
``--quick``, 1 with ``--single-run``) and prints the median run with the
raw values and their spread.

Run: ``python -m llm_weighted_consensus_tpu_torch.bench configs [--quick]``.
"""

from __future__ import annotations

import argparse
import asyncio
import os
import statistics
import struct
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from . import common
from .headline import Seam, answer, build, pipelined_rate

NAME = "configs"


def result(config: int, metric: str, value: float, unit: str,
           **extra) -> dict:
    return {"config": config, "metric": metric, "value": round(value, 3),
            "unit": unit, "baseline_basis": common.BASELINE_BASIS, **extra,
            **common.envelope(0)}


def graph_delta(model, before: dict) -> dict:
    after = model.graph_stats()
    return {"replays": after["replays"] - before["replays"],
            "eager_dispatches": (after["eager_dispatches"]
                                 - before["eager_dispatches"])}


def bench_self_consistency(model: str, n: int, seq: int, requests: int,
                           config_num: int, embedder) -> dict:
    """Config 1 (and 7): the headline harness at other shapes."""
    reqs = common.make_requests(requests, n)
    seam = Seam(embedder)

    def consensus(texts):
        return answer(embedder, texts, seq)

    embedder.warmup([(n, seq)])
    for w in range(3):
        seam.finish(seam.launch(consensus, reqs[w % len(reqs)]))
    graphs = embedder.graph_stats()
    before = common.launch_counts()
    latencies = []
    for texts in reqs[: min(20, len(reqs))]:
        t0 = time.perf_counter()
        seam.finish(seam.launch(consensus, texts))
        latencies.append((time.perf_counter() - t0) * 1e3)
    rate, results = pipelined_rate(seam, consensus, reqs)
    for r in results:
        if abs(float(np.sum(r)) - 1.0) > 1e-3:
            raise AssertionError(f"an answer sums to {np.sum(r)}")
    return result(
        config_num, f"self-consistency answers/sec, N={n}, {model}", rate,
        "answers/sec",
        p50_ms=round(statistics.median(latencies), 3),
        requests=len(reqs),
        graphs=graph_delta(embedder, graphs),
        launches=common.launch_delta(before, common.launch_counts()),
    )


def make_panel(n_slots: int, backends: int):
    from ..identity.model import ModelBase

    return ModelBase.from_json_obj({"llms": [
        {"model": f"backend-{i % backends}",
         "weight": {"type": "static", "weight": 1 + i % 3}}
        for i in range(n_slots)
    ]}).into_model_validate()


def multichat_client(scripts):
    from .. import registry
    from ..clients.chat import ApiBase, BackoffPolicy, DefaultChatClient
    from ..clients.multichat import MultichatClient
    from ..serve.fake_upstream import ScriptedTransport

    chat = DefaultChatClient(ScriptedTransport(scripts),
                             [ApiBase("https://up.example", "k")],
                             backoff=BackoffPolicy(max_elapsed_ms=0))
    return MultichatClient(chat, registry.InMemoryModelRegistry())


def multichat_params(model, content: str):
    from ..types.multichat_request import ChatCompletionCreateParams

    return ChatCompletionCreateParams.from_json_obj({
        "messages": [{"role": "user", "content": content}],
        "model": {"llms": [llm.base.to_json_obj() for llm in model.llms]},
    })


def bench_multichat_weighted(n: int, backends: int, requests: int,
                             embedder, seq: int = 128) -> dict:
    """Config 2: multichat fan-out -> device cosine vote x generator
    weights -> normalized weighted consensus."""
    from ..serve.fake_upstream import Script, chunk_obj

    model = make_panel(n, backends)
    params = multichat_params(model, "solve it")
    weights = np.array([float(llm.base.weight.weight) for llm in model.llms],
                       dtype=np.float32)

    def scripts(r):
        return [Script([chunk_obj(f"candidate {r} answer {i % 4} from slot "
                                  f"{i}", finish="stop")]) for i in range(n)]

    phase = {"gen_ms": [], "tokenize_ms": [], "device_fetch_ms": []}

    async def one(r, record=False, pool=None):
        t0 = time.perf_counter()
        mc = await multichat_client(scripts(r)).create_unary(None, params)
        t1 = time.perf_counter()
        texts = [c.message.content or "" for c in mc.choices]
        ids, mask = common.tokenize_fixed(embedder, texts, seq)
        t2 = time.perf_counter()
        if pool is not None:
            vote = await asyncio.get_running_loop().run_in_executor(
                pool, lambda: np.asarray(
                    embedder.consensus_confidence_tokens(ids, mask)))
        else:
            vote = np.asarray(embedder.consensus_confidence_tokens(ids, mask))
        t3 = time.perf_counter()
        if record:
            phase["gen_ms"].append((t1 - t0) * 1e3)
            phase["tokenize_ms"].append((t2 - t1) * 1e3)
            phase["device_fetch_ms"].append((t3 - t2) * 1e3)
        weighted = vote * weights[: len(vote)]
        return weighted / weighted.sum()

    async def pipelined():
        pool = ThreadPoolExecutor(8)
        sem = asyncio.Semaphore(8)

        async def bounded(r):
            async with sem:
                return await one(r, pool=pool)

        try:
            t0 = time.perf_counter()
            await asyncio.gather(*(bounded(r) for r in range(requests)))
            return time.perf_counter() - t0
        finally:
            pool.shutdown()

    embedder.warmup([(n, seq)])
    loop = asyncio.new_event_loop()
    try:
        conf = loop.run_until_complete(one(0))
        if abs(conf.sum() - 1.0) > 1e-3:
            raise AssertionError(f"the warm answer sums to {conf.sum()}")
        graphs = embedder.graph_stats()
        lat = []
        for r in range(min(requests, 20)):
            t1 = time.perf_counter()
            loop.run_until_complete(one(r, record=True))
            lat.append((time.perf_counter() - t1) * 1e3)
        total = loop.run_until_complete(pipelined())
    finally:
        loop.close()
    med = {k: round(statistics.median(v), 3) for k, v in phase.items()}
    serial_ms = sum(statistics.median(v) for v in phase.values())
    return result(
        2, f"multichat weighted consensus answers/sec, N={n}, {backends} "
        "backends, bge-large-en", requests / total, "answers/sec",
        p50_ms=round(statistics.median(lat), 3),
        requests=requests,
        serial_answers_per_sec=round(1000.0 / max(serial_ms, 1e-9), 3),
        phase_ms=med,
        device_fraction=round(med["device_fetch_ms"] / max(serial_ms, 1e-9),
                              3),
        breakdown=("serial p50 = gen (host asyncio fan-out) + tokenize "
                   "(host) + one device dispatch and fetch; the throughput "
                   "number runs 8 in flight"),
        graphs=graph_delta(embedder, graphs),
    )


def spm_proto(pieces: list) -> bytes:
    """[(piece, score, type)] serialized as a SentencePiece ModelProto
    (field 1 repeated {piece (1), score (2, f32), type (3)})."""
    def varint(value: int) -> bytes:
        out = b""
        while True:
            byte, value = value & 0x7F, value >> 7
            if not value:
                return out + bytes([byte])
            out += bytes([byte | 0x80])

    proto = b""
    for piece, score, ptype in pieces:
        raw = piece.encode("utf-8")
        msg = (b"\x0a" + varint(len(raw)) + raw + b"\x15"
               + struct.pack("<f", score) + b"\x18" + varint(ptype))
        proto += b"\x0a" + varint(len(msg)) + msg
    return proto


def bench_spm_path() -> str:
    """The bench SentencePiece vocabulary written as ``build/bench/
    spm.model`` in the checkout (never committed)."""
    path = os.path.join(common.REPO, "build", "bench", "spm.model")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tokenizer = common.bench_spm_tokenizer(128100)
    with open(path, "wb") as f:
        f.write(spm_proto(tokenizer.pieces))
    return path


def bench_rm_reranking(n: int, seq: int, requests: int, device: str,
                       state: dict) -> dict:
    """Config 3: deberta-v3 RM scores; softmax(reward) replaces the
    cosine vote, through the served scorer (``build_reranker``)."""
    if "rr" not in state:
        from ..serve.__main__ import build_reranker

        env = {"RM_MODEL": "deberta-v3-base", "RM_VOCAB": bench_spm_path(),
               "RM_MAX_TOKENS": str(seq), "LWC_ALLOW_RANDOM_PARAMS": "1"}
        state["rr"] = build_reranker(env, device=device)
    reranker = state["rr"]
    reqs = common.make_requests(requests, n)
    s = int(reranker.tokenize(reqs[0])[0].shape[1])
    reranker.warmup([(n, s)])

    def score(texts):
        conf, _tokens = reranker.rerank_confidence(texts)
        return conf

    for w in range(2):
        score(reqs[w % len(reqs)])
    graphs = reranker.graph_stats()
    lat = []
    for texts in reqs[: min(20, len(reqs))]:
        t0 = time.perf_counter()
        score(texts)
        lat.append((time.perf_counter() - t0) * 1e3)
    pool = ThreadPoolExecutor(8)
    t0 = time.perf_counter()
    futs = [pool.submit(score, texts) for texts in reqs]
    for f in futs:
        f.result()
    total = time.perf_counter() - t0
    pool.shutdown()
    return result(
        3, f"RM re-ranking answers/sec, N={n}, deberta-v3-base",
        len(reqs) / total, "answers/sec",
        p50_ms=round(statistics.median(lat), 3),
        requests=len(reqs),
        numerics=("random-init RM weights from seed 0 (no checkpoint is "
                  "downloaded); real unigram spm tokenization on the host "
                  "path (models/spm.py)"),
        graphs=graph_delta(reranker, graphs),
    )


def bench_archive_rescore(total_completions: int, device: str) -> dict:
    """Config 4: re-tally stored votes for 10k archived completions in
    one device batch."""
    from ..parallel.batch import rescore_batch

    m, n = 8, 4
    rng = np.random.default_rng(0)
    votes = rng.random((total_completions, m, n)).astype(np.float32)
    votes /= votes.sum(axis=2, keepdims=True)
    weights = rng.random((total_completions, m)).astype(np.float32)
    rescore_batch(votes, weights, device=device)
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        _, conf = rescore_batch(votes, weights, device=device)
        times.append(time.perf_counter() - t0)
    total = statistics.median(times)
    if not np.allclose(conf.sum(axis=1), 1.0, atol=1e-4):
        raise AssertionError("re-scored confidences do not sum to 1")
    return result(
        4, f"archive batch re-score, {total_completions} completions "
        f"(M={m}, N={n})", total_completions / total, "completions/sec",
        batch_seconds=round(total, 6), batches_sampled=len(times),
    )


def bench_streaming_incremental(n: int, requests: int, embedder,
                                concurrency: int = 8) -> dict:
    """Config 5: multichat streams with live consensus updates, run
    concurrently through the serving ``DeviceBatcher``."""
    from ..clients.multichat import StreamingSelfConsistency
    from ..serve.batcher import DeviceBatcher
    from ..serve.fake_upstream import Script, chunk_obj

    model = make_panel(n, 3)
    params = multichat_params(model, "solve")

    async def one(r, batcher):
        client = multichat_client([
            Script([chunk_obj(f"req {r} answer {i % 4}", finish="stop")])
            for i in range(n)
        ])
        sc = StreamingSelfConsistency(embedder, batcher=batcher)
        updates = 0
        async for chunk in await client.create_streaming(None, params):
            if await sc.push_chunk_async(chunk) is not None:
                updates += 1
        if updates != n - 1:
            raise AssertionError(f"{updates} updates for {n} candidates")
        if abs(sum(sc.confidence.values()) - 1.0) > 1e-3:
            raise AssertionError("stream confidences do not sum to 1")
        return updates

    async def run_all():
        batcher = DeviceBatcher(embedder)
        try:
            # warm-up at full concurrency: every stream bucket the timed
            # window forms is dispatched once first
            await asyncio.gather(*(one(0, batcher)
                                   for _ in range(concurrency)))
            graphs = embedder.graph_stats()
            sem = asyncio.Semaphore(concurrency)

            async def bounded(r):
                async with sem:
                    return await one(r, batcher)

            t0 = time.perf_counter()
            counts = await asyncio.gather(*(bounded(r)
                                            for r in range(1, requests + 1)))
            return sum(counts), time.perf_counter() - t0, graphs
        finally:
            batcher.close()

    s = int(embedder.tokenize(["req 0 answer 0"])[0].shape[1])
    embedder.warmup([(concurrency, s)])
    loop = asyncio.new_event_loop()
    try:
        updates, total, graphs = loop.run_until_complete(run_all())
    finally:
        loop.close()
    return result(
        5, f"streaming incremental consensus updates/sec, N={n}, "
        "bge-large-en", updates / total, "updates/sec",
        stream_seconds_per_request=round(total / requests, 4),
        requests=requests, concurrency=concurrency,
        graphs=graph_delta(embedder, graphs),
    )


def bench_int8_headline(requests: int, embedder, model: str = "bge-large-en",
                        n: int = 64, seq: int = 128) -> dict:
    """Config 7: the int8 W8A8 serving config at the headline shape, with
    the launches that prove which path ran."""
    rec = bench_self_consistency(model, n=n, seq=seq,
                                 requests=requests, config_num=7,
                                 embedder=embedder)
    rec["metric"] = f"int8 W8A8 {rec['metric']}"
    rec["quantize"] = embedder.config.quantize
    launches = rec["launches"]
    calls = launches["cosine_vote"]["launches"]
    w8 = launches["w8a8_matmul"]
    rec["int8_dispatch"] = {
        "w8a8_launches": w8["launches"],
        "w8a8_routes": w8["routes"],
        "w8a8_per_dispatch": w8["launches"] / max(1, calls),
        "fused_path": w8["launches"] > 0 or embedder.device.type == "cpu",
    }
    return rec


def bench_learning_effect(device: str) -> dict:
    """Config 6: learned training-table weights against static ones on
    held-out prompts (``bench/learning.py``)."""
    from ..weights.learning import populate_from_archive
    from ..weights.training_table import (
        TorchTrainingTableFetcher,
        TrainingTableStore,
    )
    from . import learning

    embedder = learning.make_embedder(device)
    model = learning.make_panel()
    n_train = 40
    store, labels = learning.build_archive(model, n_train)
    tables = TrainingTableStore()
    t0 = time.perf_counter()
    rows = populate_from_archive(store, embedder, model, tables,
                                 labels=labels)
    learn_s = time.perf_counter() - t0
    fetcher = TorchTrainingTableFetcher(embedder, tables)
    learned_acc, static_acc, total, _ = learning.evaluate_held_out(
        fetcher, model, n_train, device=device)
    return result(
        6, "trained-weights closed loop: held-out top-1 accuracy uplift",
        learned_acc - static_acc, "accuracy uplift (learned - static)",
        learned_accuracy=round(learned_acc, 3),
        static_accuracy=round(static_acc, 3),
        held_out_prompts=total,
        rows_learned=rows,
        learn_rows_per_sec=round(rows / max(learn_s, 1e-9), 1),
        scenario="llm_weighted_consensus_tpu_torch/bench/learning.py "
        "(planted reliabilities)",
    )


def shared_embedders(device: str) -> dict:
    """Built once and shared by the reproducibility runs: run 2 measures
    steady state."""
    return {
        "small": build("bge-small-en", "none", device, 128),
        "large": build("bge-large-en", "none", device, 128),
        "large_int8": build("bge-large-en", "int8", device, 128),
    }


def run_configs(args, device: str) -> None:
    q = args.quick
    shared = shared_embedders(device)
    n_runs = 1 if args.single_run else (2 if q else 3)

    def reproducible(fn, *fn_args, **fn_kwargs):
        runs = [fn(*fn_args, **fn_kwargs) for _ in range(n_runs)]
        if args.single_run:
            common.emit(runs[0])
        else:
            common.emit_reproducible(runs)

    reproducible(bench_self_consistency, "bge-small-en", n=8, seq=128,
                 requests=10 if q else 100, config_num=1,
                 embedder=shared["small"])
    reproducible(bench_multichat_weighted, n=32, backends=3,
                 requests=10 if q else 100, embedder=shared["large"])
    state: dict = {}
    reproducible(bench_rm_reranking, n=16, seq=128,
                 requests=5 if q else 50, device=device, state=state)
    state.clear()
    reproducible(bench_archive_rescore, 10_000, device=device)
    reproducible(bench_streaming_incremental, n=8 if q else 32,
                 requests=4 if q else 100, embedder=shared["large"])
    reproducible(bench_int8_headline, requests=5 if q else 100,
                 embedder=shared["large_int8"])
    common.emit(bench_learning_effect(device))


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="bench configs")
    p.add_argument("--quick", action="store_true")
    p.add_argument("--single-run", action="store_true",
                   help="skip the reproducibility runs (no runs/max_dev_pct)")
    common.add_device_flag(p)
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    base = {"metric": "bench configs 1-7", "value": None}
    device = common.select_device(NAME, args.device, base)
    return common.run(NAME, base, lambda: run_configs(args, device))
