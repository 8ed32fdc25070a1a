"""The system under test: the port's own server, built through the
port's own loading entries from the benchmark's weights.

This module and the family modules (``families/<family>.py``) are the
ones of the harness that import the program
(``llm_weighted_consensus_tpu_torch``).  The configuration's family
builds the served models (its ``build``: for ``bert`` the
``TorchEmbedder`` over ``bert.from_hf_state_dict``, for ``deberta`` the
``TorchReranker`` over ``deberta.from_hf_weights``, each with the
configuration's vocabulary in the port's own tokenizer classes);
``System`` builds the server around them with
``serve.__main__.build_server`` from a ``ServeConfig`` read from the
benchmark's environment dict (not the process's), starts it on an
ephemeral loopback port and captures the cell's buckets
(``serve.__main__.warm_up``).  Every other setting is the server's
default."""

from __future__ import annotations

import gc
from pathlib import Path

from . import spec

PORT = "llm_weighted_consensus_tpu_torch"


def package_dir(root: Path) -> Path:
    return root / PORT


def concurrency(mix: dict) -> int:
    """The most requests a mix can have in flight: its clients (closed
    loop) or its senders (open loop)."""
    return int(mix.get("clients") or mix.get("senders") or 1)


def warmup_env(cfg: dict, mix: dict) -> dict:
    """The server's bucket knobs for this cell's traffic: the one
    (N, S) shape its requests form, and for a cosine cell with more than
    one client (or sender) the power-of-two request counts the batcher
    can group under its 512-row cap."""
    n = mix["candidates"]
    longest = mix["candidate_tokens"][1] + 2
    if mix.get("prompt_tokens"):
        longest += mix["prompt_tokens"][1]
    if cfg["scorer"] == "rm":
        return {"RM_WARMUP": f"{n}x{longest}"}
    env = {"WARMUP": f"{n}x{longest}"}
    buckets, r = [], 2
    while r <= min(concurrency(mix), 512 // n):
        buckets.append(str(r))
        r *= 2
    if buckets:
        env["WARMUP_R"] = ",".join(buckets)
    return env


class System:
    """The running server, its models and its counters."""

    def __init__(self, cfg: dict, mix: dict, state: dict, device: str,
                 quantize: str = "none"):
        import time

        import torch

        from llm_weighted_consensus_tpu_torch.serve.__main__ import (
            build_server, warm_up)
        from llm_weighted_consensus_tpu_torch.serve.config import ServeConfig

        marks = [time.perf_counter()]
        dtype = getattr(torch, cfg["serving_dtype"])
        self.embedder, self.reranker = spec.family(cfg["family"]).build(
            cfg, state, device, dtype, quantize)
        marks.append(time.perf_counter())
        config = ServeConfig.from_env(warmup_env(cfg, mix))
        self.server = build_server(self.embedder, self.reranker, config,
                                   "127.0.0.1", 0, device=device)
        self.server.start()
        marks.append(time.perf_counter())
        self.warmup = warm_up(self.server, config)
        marks.append(time.perf_counter())
        self.port = self.server.port
        # seconds of: the family's build (the port's loader and model),
        # the server, the graph captures
        self.setup_parts = [b - a for a, b in zip(marks, marks[1:])]

    def counters(self) -> dict:
        """The program's own counters: the batcher's ``stats()``, the
        dispatches per device-timing bucket (``obs/phases.py``) and the
        models' ``graph_stats()``."""
        from llm_weighted_consensus_tpu_torch.obs import phases

        batcher = self.server.batcher
        buckets = {label: row.get("count", 0) for label, row in
                   phases.aggregator().device_snapshot().items()}
        model = self.embedder or self.reranker
        return {"batcher": batcher.stats() if batcher is not None else None,
                "device_buckets": buckets, "graphs": model.graph_stats()}

    def close(self) -> None:
        """Stop the server and drop every tensor the program holds."""
        self.server.close()
        self.server = self.embedder = self.reranker = None
        gc.collect()
