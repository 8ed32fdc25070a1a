"""The system under test: the port's own server, built through the
port's own loading entries from the benchmark's weights.

This is the one module of the harness that imports the program
(``llm_weighted_consensus_tpu_torch``).  ``build`` hands the HF-named
state dict to ``bert.from_hf_state_dict`` (the embedder) or
``deberta.from_hf_weights`` (the reward model), wraps it in the served
``TorchEmbedder`` / ``TorchReranker`` with the configuration's
vocabulary in the port's own tokenizer classes, builds the server with
``serve.__main__.build_server`` from a ``ServeConfig`` read from the
benchmark's environment dict (not the process's), starts it on an
ephemeral loopback port and captures the cell's buckets
(``serve.__main__.warm_up``).  Every other setting is the server's
default."""

from __future__ import annotations

import gc
from pathlib import Path

PORT = "llm_weighted_consensus_tpu_torch"


def package_dir(root: Path) -> Path:
    return root / PORT


def _bert_config(cfg: dict):
    from llm_weighted_consensus_tpu_torch.models.configs import BertConfig

    return BertConfig(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        intermediate_size=cfg["intermediate_size"],
        max_position_embeddings=cfg["max_position_embeddings"],
        type_vocab_size=cfg["type_vocab_size"],
        layer_norm_eps=cfg["layer_norm_eps"],
        pad_token_id=cfg["pad_token_id"], pooling=cfg["pooling"])


def _deberta_config(cfg: dict):
    from llm_weighted_consensus_tpu_torch.models.configs import DebertaConfig

    max_rel = cfg["max_relative_positions"]
    if max_rel < 1:
        max_rel = cfg["max_position_embeddings"]
    return DebertaConfig(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        intermediate_size=cfg["intermediate_size"],
        max_relative_positions=max_rel,
        position_buckets=cfg["position_buckets"],
        layer_norm_eps=cfg["layer_norm_eps"])


def _tokenizer(vocab: dict):
    if vocab["kind"] == "wordpiece":
        from llm_weighted_consensus_tpu_torch.models.tokenizer import (
            WordPieceTokenizer)

        return WordPieceTokenizer({t: i for i, t in
                                   enumerate(vocab["tokens"])})
    from llm_weighted_consensus_tpu_torch.models import spm

    kinds = {"normal": spm.NORMAL, "control": spm.CONTROL,
             "unknown": spm.UNKNOWN}
    return spm.UnigramTokenizer(
        [(p, float(s), kinds[k]) for p, s, k in vocab["pieces"]],
        scheme="deberta")


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

        # the port's loaders take host arrays; float32 holds every bf16
        # value exactly, and the loader casts back to the serving type
        marks = [time.perf_counter()]
        host = {k: v.detach().to("cpu", torch.float32)
                for k, v in state.items()}
        marks.append(time.perf_counter())
        dtype = getattr(torch, cfg["serving_dtype"])
        self.embedder = self.reranker = None
        if cfg["family"] == "bert":
            from llm_weighted_consensus_tpu_torch.models import bert
            from llm_weighted_consensus_tpu_torch.models.embedder import (
                TorchEmbedder)

            config = _bert_config(cfg)
            model = bert.from_hf_state_dict(host, config, dtype=dtype,
                                            device=device)
            self.embedder = TorchEmbedder(
                cfg["name"], model=model, config=config,
                tokenizer=_tokenizer(cfg["vocab"]), dtype=dtype,
                device=device, quantize=quantize)
        else:
            from llm_weighted_consensus_tpu_torch.models import deberta
            from llm_weighted_consensus_tpu_torch.models.reranker import (
                TorchReranker)

            config = _deberta_config(cfg)
            model = deberta.from_hf_weights(host, config, dtype=dtype,
                                            device=device)
            self.reranker = TorchReranker(
                cfg["name"], model=model, config=config,
                tokenizer=_tokenizer(cfg["vocab"]), dtype=dtype,
                device=device, quantize=quantize)
        del host, model
        marks.append(time.perf_counter())
        config = ServeConfig.from_env(warmup_env(cfg, mix))
        self.server = build_server(self.embedder, self.reranker, config,
                                   "127.0.0.1", 0, device=device)
        self.server.start()
        marks.append(time.perf_counter())
        self.warmup = warm_up(self.server, config)
        marks.append(time.perf_counter())
        self.port = self.server.port
        # seconds of: the weights to the host, the port's loader and
        # model, the server, the graph captures
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
