"""Serve the port: ``python -m llm_weighted_consensus_tpu_torch.serve
[--port P] [--address A] [--device cuda|cpu] [--fake-upstream]``.

Environment, as the reference's server reads it (a ``.env`` file in the
working directory is loaded first; ``ADDRESS`` and ``PORT``, default
``0.0.0.0:5000``, are where it listens unless ``--address``/``--port``
say otherwise).  ``/chat/completions``,
``/multichat/completions`` and ``/score/completions`` are always served,
through the upstream endpoints of ``OPENAI_APIS`` / ``OPENAI_API_BASE``
(``serve/config.py``);
``--fake-upstream`` starts a scripted loopback provider
(``serve/fake_upstream.py``) and sends them there, and, as the
reference's demo mode, allows synthetic model params.  The device routes
need a model:

* ``EMBEDDER_MODEL`` — encoder preset (``bge-large-en``, ``e5-base-v2``,
  ... ``test-tiny``) behind ``/consensus`` (cosine) and ``/embeddings``;
* ``EMBEDDER_WEIGHTS`` — an HF snapshot directory or a weights file;
  unset = random init, refused unless ``LWC_ALLOW_RANDOM_PARAMS=1``;
* ``EMBEDDER_VOCAB`` — a WordPiece ``vocab.txt`` or a SentencePiece
  proto; defaults to the one beside the weights, else the hash tokenizer
  (also synthetic, same opt-in);
* ``EMBEDDER_MAX_TOKENS`` — truncation window (default 512);
* ``EMBEDDER_QUANTIZE`` — ``none`` (default), ``int8`` or ``int8-pallas``
  (the encoder's dense layers as W8A8 int8 tensor-core kernels) or
  ``int4-pallas`` (W4A8, packed int4 weights); quantized once at load.
  ``int8-xla`` (the reference's XLA composition) is refused, and so is
  any other value, with the list of valid modes;
* ``PACKING_ENABLED`` — continuous batching (default 0, off): embedding
  and consensus requests of any N and temperature share packed dispatches
  whose rows hold many sequences end to end (``serve/packing.py``), with
  the segment-masked attention kernel; composes with
  ``EMBEDDER_QUANTIZE``;
* ``PACKING_ROW_TOKENS`` — tokens per packed row, also the cap of one
  sequence on the packed path (default 512, min 16);
* ``PACKING_MAX_ROWS`` — rows per packed call (default 8, min 1);
* ``PACKING_MAX_SEGMENTS`` — sequences per packed row (default 64, min 1);
* ``PREFIX_DEDUP`` — with packing, embed a consensus request's shared
  candidate prefix once and compose each candidate from its prefix and
  suffix vectors (default 1, on);
* ``PREFIX_DEDUP_MIN_CHARS`` — the shortest shared prefix worth that
  (default 48, min 1);
* ``RM_MODEL`` — reward-model preset (``deberta-v3-base``,
  ``deberta-test-tiny``) behind ``/consensus {"scorer": "rm"}``;
* ``RM_WEIGHTS`` — an HF DeBERTa-v2/v3 snapshot directory or weights
  file; unset = random init, and an encoder-only checkpoint has a
  random-init reward head: both refused unless
  ``LWC_ALLOW_RANDOM_PARAMS=1``;
* ``RM_VOCAB`` — the SentencePiece ``spm.model`` (deberta id scheme) or
  a ``vocab.txt``; defaults to the one beside ``RM_WEIGHTS``, else the
  hash tokenizer (synthetic, same opt-in);
* ``RM_MAX_TOKENS`` — truncation window of a (prompt, candidate) pair
  (default 512);
* ``RM_QUANTIZE`` — as ``EMBEDDER_QUANTIZE``, for the reward model's
  content and MLP dense layers (its position projections and head stay
  full precision).

The batching, warmup, overload and timing knobs (``BATCH_*``,
``HOST_TOKENIZER_WORKERS``, ``STAGING_BUFFERS``, ``WARMUP``,
``WARMUP_R``, ``RM_WARMUP``, ``ADMISSION_*``, ``DRAIN_TIMEOUT_MILLIS``,
``DEVICE_WATCHDOG_MILLIS``, ``METRICS_DEVICE_TIMING``), the upstream
knobs (``OPENAI_*``, ``*_CHUNK_TIMEOUT_MILLIS``, ``BACKOFF_*``,
``CONNECT_TIMEOUT_MILLIS``, ``JUDGE_STREAM_MAX_BYTES``,
``SSE_MAX_EVENT_BYTES``, ``FAKE_UPSTREAM_DELAY_MS``) and the score
route's knobs (``TABLES_PATH``, ``HOST_FASTPATH``, ``SCORE_CACHE_*``) are
documented in ``serve/config.py``, and so are the archive's
(``ARCHIVE_PATH``, ``ARCHIVE_WRITE``, ``ARCHIVE_STREAMING``,
``ARCHIVE_MAX_COMPLETIONS``), ``MAX_BODY_BYTES``, request tracing
(``TRACE_SAMPLE_RATE``, ``TRACE_ENABLED``, ``TRACE_RING``, ``TRACE_DIR``:
``GET /v1/traces``), judge quality (``QUALITY_WINDOW``,
``QUALITY_DRIFT_THRESHOLD``: ``GET /v1/judges``), the outcome ledger
(``LEDGER_RING``, ``LEDGER_DIR``, ``LEDGER_ROTATE_BYTES``), judge-side
resilience (``RESILIENCE_*``, ``FAULT_PLAN``, ``JUDGE_BIAS_PLAN``) and
the memory governor (``MEMGUARD``, ``MEM_SOFT_BYTES``,
``MEM_HARD_BYTES``, ``MEMGUARD_INTERVAL_MILLIS``; on by default), and
the fleet tier (``FLEET_SELF``, ``FLEET_PEERS``, ``FLEET_PEERS_FILE``,
``FLEET_VNODES``, ``FLEET_LEASE_MILLIS``, ``FLEET_FETCH_TIMEOUT_MILLIS``,
``FLEET_FAULT_PLAN``, ``FLEET_QUARANTINE_FAILURES``,
``FLEET_PROBE_MILLIS``: ``/fleet/v1/*``; ``AOT_CACHE_DIR``,
``WARMUP_AOT`` and ``COMPILE_CACHE_DIR`` are read and reported inert),
live weights and the offline lane (``WEIGHTS_ENABLED``, ``WEIGHTS_PATH``:
``GET``/``PUT /v1/weights``; ``OFFLINE_ENABLED``, ``OFFLINE_INFLIGHT``:
``POST /v1/train/rescore``), device faults (``DEVICE_WATCHDOG_CPU_FALLBACK``:
the CPU twin; ``MESH_FAULT_*``, ``DEVICE_FAULT_PLAN``), the serving mesh
(``MESH_ENABLED``, ``MESH_SHAPE``, ``LONG_CONTEXT_WARMUP``, the legacy
``MESH_DP``/``MESH_TP``/``MESH_SP``: one process drives every local
card; ``MULTIHOST`` forms the process group first) and ``PROFILE_DIR``
(``POST /v1/profile``).  With an
embedder, a training-table panel's weights come from
``TorchTrainingTableFetcher`` on the served embedder and batcher (the tables loaded from
``TABLES_PATH``), and ``POST /weights/learn`` learns table rows from the
archive; without one such a panel is a 501.  ``POST /archive/rescore``
re-tallies the archive on the device (``serve/archive_routes.py``).  The
server listens at once and answers ``/livez``; ``/readyz`` turns 200 once
the CUDA graphs of the ``WARMUP`` and ``RM_WARMUP`` buckets are
captured.  SIGTERM or SIGINT drains it: new
requests shed with 503, in-flight ones finish within
``DRAIN_TIMEOUT_MILLIS``, then the process exits 0.

The native tokenizer library (``native/*.cpp``) is built at first use
into ``build/native/`` (``utils.native``; ``LWC_NATIVE=0`` keeps the
Python tokenizers).  The device defaults to CUDA; without a card that
raises.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os
import signal
import sys
import threading

from .config import (
    ServeConfig,
    env_truthy,
    load_dotenv,
    process_env,
    staging_buffers,
)
from .config import packing_options  # noqa: F401  (the server's env API)

log = logging.getLogger("lwc.torch.serve")


def mesh_settings(env) -> dict:
    """The mesh knobs of the environment, parsed as ``ServeConfig`` does
    (which also refuses their bad combinations)."""
    from .config import _parse_mesh_shape

    return {
        "enabled": env_truthy(env.get("MESH_ENABLED", "0")),
        "shape": _parse_mesh_shape(env.get("MESH_SHAPE")),
        "dp": int(env["MESH_DP"]) if env.get("MESH_DP") else None,
        "tp": int(env.get("MESH_TP", 1)),
        "sp": int(env["MESH_SP"]) if env.get("MESH_SP") else None,
    }


def mesh_devices_for(device) -> list:
    """The devices a server's mesh may take: every local card for a CUDA
    server, the CPU for a CPU one.  Never a list that repeats a card."""
    import torch

    from ..parallel.mesh import local_devices

    if torch.device(device).type == "cuda":
        return local_devices()
    return [torch.device("cpu")]


def build_mesh(settings: dict, devices: list):
    """The first-class mesh of ``MESH_ENABLED`` (``MESH_SHAPE``, unset =
    every device on dp) over ``devices``: host-local, as the reference's
    (a request must be servable without another host's cooperation).  A
    shape past the devices fails with the reference's message."""
    from ..parallel.mesh import make_mesh

    shape = settings["shape"]
    return make_mesh(
        dp=shape[0] if shape else None,
        tp=shape[1] if shape else 1,
        sp=shape[2] if shape and len(shape) > 2 else 1,
        devices=devices,
    )


def shard_for_env(embedder, settings: dict, devices: list) -> None:
    """The reference's three mesh branches: ``MESH_ENABLED`` (the
    first-class mesh), the legacy ``MESH_SP`` ring and the legacy
    ``MESH_DP``/``MESH_TP`` hooks; none of them leaves the embedder on
    its one device."""
    from ..parallel.mesh import make_mesh
    from ..parallel.ring import shard_embedder_sp
    from ..parallel.sharding import shard_embedder, shard_embedder_mesh

    if settings["enabled"]:
        mesh = build_mesh(settings, devices)
        shard_embedder_mesh(embedder, mesh)
    elif settings["sp"] is not None:
        if settings["tp"] > 1:
            raise ValueError(
                "MESH_SP and MESH_TP are mutually exclusive (sequence "
                "parallelism replicates encoder params)"
            )
        # MESH_DP unset = every device not consumed by sp
        mesh = make_mesh(dp=settings["dp"], tp=settings["sp"],
                         devices=devices, names=("dp", "sp"))
        dp = mesh.shape["dp"]
        shard_embedder_sp(embedder, mesh, dp_axis="dp" if dp > 1 else None)
    elif settings["dp"] is not None or settings["tp"] > 1:
        mesh = make_mesh(dp=settings["dp"], tp=settings["tp"],
                         devices=devices)
        shard_embedder(embedder, mesh, tp=settings["tp"] > 1)
    else:
        return
    log.info("embedder mesh: %s", mesh.layout())


def build_embedder(env, device=None, dtype=None, mesh_devices=None):
    """A ``TorchEmbedder`` from the environment (see module doc).
    Synthetic state — random weights or the hash tokenizer — embeds
    garbage that looks valid, so it needs ``LWC_ALLOW_RANDOM_PARAMS``.
    The mesh knobs (``MESH_*``) shard it over ``mesh_devices`` (default:
    ``mesh_devices_for(device)``; a caller may pass a list that repeats
    one card, so that several shards share it)."""
    from ..models.bert import resolve_device
    from ..models.configs import PRESETS
    from ..models.embedder import TorchEmbedder
    from ..models.loading import find_vocab, load_params
    from ..models.tokenizer import HashTokenizer, load_tokenizer

    name = env.get("EMBEDDER_MODEL")
    if not name or name not in PRESETS:
        raise ValueError(
            f"EMBEDDER_MODEL={name!r} is not a known preset; valid values: "
            + ", ".join(sorted(PRESETS))
        )
    config = PRESETS[name]
    quantize = env.get("EMBEDDER_QUANTIZE") or "none"
    _check_quantize("EMBEDDER_QUANTIZE", quantize)
    device = resolve_device(device)
    model = None
    vocab = env.get("EMBEDDER_VOCAB")
    weights = env.get("EMBEDDER_WEIGHTS")
    if weights:
        model = load_params(weights, config, dtype=dtype, device=device)
        vocab = vocab or find_vocab(weights)
    settings = mesh_settings(env)
    max_tokens = env.get("EMBEDDER_MAX_TOKENS")
    if not max_tokens:
        from ..models.configs import usable_positions

        # MESH_SP exists to serve long inputs: a default of 512 would
        # truncate exactly the documents it is configured for
        max_tokens = (usable_positions(config)
                      if settings["sp"] is not None else 512)
    embedder = TorchEmbedder(
        name,
        model=model,
        config=config,
        tokenizer=load_tokenizer(vocab) if vocab else None,
        max_tokens=int(max_tokens),
        device=device,
        dtype=dtype,
        quantize=quantize,
        staging_buffers=staging_buffers(env),
    )
    shard_for_env(embedder, settings, mesh_devices
                  if mesh_devices is not None else mesh_devices_for(device))
    synthetic = []
    if model is None:
        synthetic.append("random-init weights (no EMBEDDER_WEIGHTS)")
    if isinstance(embedder.tokenizer, HashTokenizer):
        synthetic.append("hash tokenizer (no vocab.txt)")
    if synthetic:
        detail = f"EMBEDDER_MODEL={name} would serve " + " and ".join(
            synthetic
        )
        if not env_truthy(env.get("LWC_ALLOW_RANDOM_PARAMS", "")):
            raise ValueError(
                detail + ". Point EMBEDDER_WEIGHTS at a checkpoint, or opt "
                "into synthetic params with LWC_ALLOW_RANDOM_PARAMS=1."
            )
        log.warning("SYNTHETIC EMBEDDER PARAMS: %s; serving anyway", detail)
    return embedder


# the knobs the CPU twin does not take from the card's environment: it is
# the unquantized embedder on one CPU device
TWIN_STRIPPED = ("EMBEDDER_QUANTIZE", "MESH_ENABLED", "MESH_SHAPE", "MESH_DP",
                 "MESH_TP", "MESH_SP")


def build_cpu_twin(env):
    """The CPU twin of ``DEVICE_WATCHDOG_CPU_FALLBACK`` (the reference's
    ``_build_cpu_fallback``): ``build_embedder`` from the same
    environment with quantization and mesh stripped, on the CPU in f32,
    built at startup while the card is healthy.  It computes the card
    embedder's function on the same weights (a checkpoint reloads; a
    random-init preset draws the same seed).  Its device-timing labels
    carry ``@cpu``.  A failure to build it degrades to the watchdog
    without a twin (device routes shed while the card is unhealthy)
    rather than failing startup: None."""
    from ..resilience.memguard import read_rss_bytes

    before = read_rss_bytes() or 0
    try:
        twin = build_embedder(
            {k: v for k, v in env.items() if k not in TWIN_STRIPPED},
            device="cpu",
        )
    except Exception:
        log.warning(
            "DEVICE_WATCHDOG_CPU_FALLBACK: could not build the CPU twin; "
            "device routes will shed while the watchdog holds the card "
            "unhealthy", exc_info=True)
        return None
    twin.label_suffix = "@cpu"
    log.info("CPU twin ready (%s, f32; host RSS +%.0f MB)", twin.model_name,
             ((read_rss_bytes() or 0) - before) / 2**20)
    return twin


def _check_quantize(var: str, quantize: str) -> None:
    from ..models.configs import QUANT_MODES

    if quantize not in QUANT_MODES:
        raise ValueError(
            f"{var}={quantize!r} is not a quantize mode; valid values: "
            + ", ".join(QUANT_MODES)
        )


def build_reranker(env, device=None, dtype=None, mesh_devices=None):
    """A ``TorchReranker`` from the environment (see module doc), or None
    without ``RM_MODEL``.  Synthetic state — random weights, a random
    reward head or the hash tokenizer — scores garbage that looks valid,
    so it needs ``LWC_ALLOW_RANDOM_PARAMS``.  Under ``MESH_ENABLED`` its
    params go on the mesh (``shard_reranker_mesh``; its batch stays
    unsharded)."""
    name = env.get("RM_MODEL")
    if not name:
        return None
    from ..models.bert import resolve_device
    from ..models.loading import find_vocab, load_rm_params
    from ..models.reranker import RM_PRESETS, TorchReranker
    from ..models.spm import scheme_for_model
    from ..models.tokenizer import HashTokenizer, load_tokenizer

    if name not in RM_PRESETS:
        raise ValueError(
            f"RM_MODEL={name!r} is not a known preset; valid values: "
            + ", ".join(sorted(RM_PRESETS))
        )
    quantize = env.get("RM_QUANTIZE") or "none"
    _check_quantize("RM_QUANTIZE", quantize)
    device = resolve_device(device)
    model, head_loaded = None, False
    vocab = env.get("RM_VOCAB")
    weights = env.get("RM_WEIGHTS")
    if weights:
        model, head_loaded = load_rm_params(
            weights, RM_PRESETS[name], dtype=dtype, device=device
        )
        vocab = vocab or find_vocab(weights)
    reranker = TorchReranker(
        name,
        model=model,
        config=RM_PRESETS[name],
        tokenizer=(
            load_tokenizer(vocab, scheme=scheme_for_model(name))
            if vocab else None
        ),
        max_tokens=int(env.get("RM_MAX_TOKENS") or 512),
        device=device,
        dtype=dtype,
        quantize=quantize,
        staging_buffers=staging_buffers(env),
    )
    settings = mesh_settings(env)
    if settings["enabled"]:
        from ..parallel.sharding import shard_reranker_mesh

        shard_reranker_mesh(reranker, build_mesh(
            settings, mesh_devices if mesh_devices is not None
            else mesh_devices_for(device)))
    synthetic = []
    if model is None:
        synthetic.append("random-init RM weights (no RM_WEIGHTS)")
    elif not head_loaded:
        synthetic.append(
            "a random-init reward head (encoder-only checkpoint: no "
            "pooler/classifier weights in RM_WEIGHTS)"
        )
    if isinstance(reranker.tokenizer, HashTokenizer):
        synthetic.append(
            "hash tokenizer (no RM_VOCAB and no vocab/spm file beside "
            "RM_WEIGHTS)"
        )
    if synthetic:
        detail = (
            f"RM_MODEL={name} would serve " + " and ".join(synthetic)
            + ": reward re-ranking would be garbage that looks valid."
        )
        if not env_truthy(env.get("LWC_ALLOW_RANDOM_PARAMS", "")):
            raise ValueError(
                detail + " Point RM_WEIGHTS at a checkpoint, or opt in "
                "with LWC_ALLOW_RANDOM_PARAMS=1."
            )
        log.warning("SYNTHETIC RM PARAMS: %s Serving anyway.", detail)
    return reranker


def build_chat_clients(config: ServeConfig, score_cache=None, store=None,
                       ledger=None, resilience=None, fault_plan=None,
                       live_weights=None, fleet=None):
    """The chat client over the configured upstream endpoints (the stdlib
    transport, wrapped in the fault injector under a ``fault_plan``), and
    the multichat and score clients over it.  Panels
    resolve through an empty model registry (inline panels only) and
    archive references through ``store`` (an empty archive when None);
    with ``ARCHIVE_WRITE`` the score client records its ballots there, and
    with an outcome ``ledger`` one record per scored request.  The chat
    and score clients share the ``resilience`` policy; the score client
    takes ``JUDGE_BIAS_PLAN``, the ``live_weights`` store and the
    ``fleet`` coordinator (``FLEET_*``).
    The score client answers a training-table panel with 501 until
    ``build_server`` plugs the training-table fetcher in."""
    from ..archive import InMemoryArchive
    from ..clients.chat import (
        ApiBase,
        BackoffPolicy,
        DefaultChatClient,
        StdlibTransport,
    )
    from ..clients.multichat import MultichatClient
    from ..clients.score import ScoreClient
    from ..registry import InMemoryModelRegistry

    up = config.upstream
    if store is None:
        store = InMemoryArchive()
    transport = StdlibTransport(
        connect_timeout_ms=up["connect_timeout_ms"],
        max_body_bytes=up["judge_stream_max_bytes"],
    )
    if fault_plan is not None:
        # FAULT_PLAN (chaos runs): the seeded fault injector around the
        # real transport; its close() closes the inner one
        from ..resilience import FaultInjectionTransport

        transport = FaultInjectionTransport(transport, fault_plan)
    chat_client = DefaultChatClient(
        transport,
        [ApiBase.from_json_obj(a) for a in up["api_bases"]],
        backoff=BackoffPolicy(**up["backoff"]),
        user_agent=up["user_agent"],
        x_title=up["x_title"],
        referer=up["referer"],
        first_chunk_timeout_ms=up["first_chunk_timeout_ms"],
        other_chunk_timeout_ms=up["other_chunk_timeout_ms"],
        archive_fetcher=store,
        resilience=resilience,
        judge_stream_max_bytes=up["judge_stream_max_bytes"],
        sse_max_event_bytes=up["sse_max_event_bytes"],
    )
    models = InMemoryModelRegistry()
    multichat_client = MultichatClient(
        chat_client, models, archive_fetcher=store
    )
    score_client = ScoreClient(
        chat_client, models, archive_fetcher=store, cache=score_cache,
        host_fastpath=config.host_fastpath,
        # the archived ballots let /archive/rescore re-extract votes
        ballot_sink=store.put_ballot if config.archive_write else None,
        ledger=ledger,
        # RESILIENCE_*: shared retry budget + weight-quorum degradation
        resilience=resilience,
        # JUDGE_BIAS_PLAN: deterministic vote perturbation (drills only)
        bias_plan=config.judge_bias_injection_plan(),
        # WEIGHTS_*: versioned live judge-weight tables (weights/live.py)
        live_weights=live_weights,
        # FLEET_*: peer fetch and cross-replica leases on a miss
        fleet=fleet,
    )
    return chat_client, multichat_client, score_client


def load_archive(config: ServeConfig):
    """The completions archive: ``ARCHIVE_PATH``'s snapshot when it
    exists, else empty, capped at ``ARCHIVE_MAX_COMPLETIONS``; a set path
    must be writable (it is saved at close), and is written at once when
    it does not exist yet."""
    from ..archive import InMemoryArchive

    path = config.archive_path
    store = (
        InMemoryArchive.load(path)
        if path and os.path.exists(path) else InMemoryArchive()
    )
    store.max_completions = config.archive_max_completions or None
    store.enforce_cap()  # an over-cap snapshot trims at startup
    if path:
        from ..utils.io import probe_writable_config

        probe_writable_config(
            path, "ARCHIVE_PATH", "snapshots would be lost at shutdown"
        )
        if not os.path.exists(path):
            store.save(path)
    return store


def load_tables(config: ServeConfig):
    """The training tables: ``TABLES_PATH``'s snapshot when it exists,
    else empty; a set path must be writable (it is saved at close)."""
    from ..weights.training_table import TrainingTableStore

    path = config.tables_path
    tables = (
        TrainingTableStore.load(path)
        if path and os.path.exists(path) else TrainingTableStore()
    )
    if path:
        from ..utils.io import probe_writable_config

        probe_writable_config(
            path, "TABLES_PATH", "learned weights would be lost at shutdown"
        )
    return tables


def build_meshfault(embedder, config: ServeConfig):
    """``MESH_FAULT_ENABLED``'s ``MeshFaultManager`` over the embedder's
    mesh shape (``MESH_FAULT_TRANSIENT_RETRIES``,
    ``MESH_FAULT_PROBE_MILLIS``, ``DEVICE_FAULT_PLAN``), or None; an
    embedder the mesh never placed is the 1x1 shape.  The ladder is
    declared and logged here, and warmed with the buckets at startup
    (``Server.warmup``).  Its ``probe_fn`` is a one-token consensus
    dispatch at the first ``WARMUP`` spec on the full shape (a warmed
    bucket replays); the server wires the rescale hooks."""
    if not config.mesh_fault_enabled or embedder is None:
        return None
    import numpy as np

    from ..models.embedder import _seq_bucket
    from ..resilience import MeshFaultManager

    shape = (tuple(embedder.mesh_shape) if embedder.mesh_mode
             else (1, 1))
    manager = MeshFaultManager(
        embedder, shape=shape,
        transient_retries=config.mesh_fault_transient_retries,
        probe_millis=config.mesh_fault_probe_millis,
        fault_plan=config.device_fault_injection_plan(),
    )
    log.info("mesh fault ladder: %s", " -> ".join(
        f"{d}x{t}" for d, t in manager.build_ladder()))
    n, s = config.warmup[0] if config.warmup else (2, 8)
    s = _seq_bucket(s, embedder.max_tokens)

    def probe():
        ids = np.zeros((n, s), np.int32)
        mask = np.zeros((n, s), np.int32)
        mask[:, 0] = 1  # one real token per row: a clean forward
        embedder.consensus_confidence_tokens(ids, mask)

    manager.probe_fn = probe
    return manager


def build_server(embedder, reranker, config: ServeConfig,
                 host: str = "127.0.0.1", port: int = 0, device=None,
                 twin=None):
    """The ``Server`` the configuration describes (the device routes of
    its models, the chat and score routes over its upstream, the archive
    and ``/archive/rescore``), not ready until ``warm_up``.  With an
    embedder the score client's training-table weights come from
    ``TorchTrainingTableFetcher`` on the server's embedder and batcher
    (``server.tables``, saved to ``TABLES_PATH`` at close) and
    ``/weights/learn`` learns their rows; without one a training-table
    panel is a 501.  ``server.archive`` is the archive (saved to
    ``ARCHIVE_PATH`` at close).  Re-scoring runs on the embedder's (or
    the reranker's) device, else on ``device`` (the card unless
    ``"cpu"``).  ``TRACE_*`` give the server its trace sink
    (``server.trace_sink``), ``LEDGER_*`` the score client its outcome
    ledger (``server.ledger``), and ``QUALITY_*`` configure the
    process-global quality aggregator.  ``RESILIENCE_*`` give the chat and
    score clients their policy and ``FAULT_PLAN`` the transport its fault
    injector (``server.resilience``, ``server.fault_plan``); ``MEMGUARD``
    starts the memory governor over the score and row caches, the trace
    ring and the admission limit (``server.memguard``, stopped at
    close).  ``WEIGHTS_*`` give the score client its live weight store
    (``server.live_weights``, ``/v1/weights``; a set ``WEIGHTS_PATH``
    must be writable) and ``OFFLINE_*`` serve ``/v1/train/rescore``.
    ``twin`` is the CPU twin (``build_cpu_twin``); under
    ``DEVICE_WATCHDOG_CPU_FALLBACK`` the caller builds it from the same
    environment as the embedder (``main`` does), and it is dropped when
    the knob is off.  ``MESH_FAULT_*`` give the batcher its
    ``MeshFaultManager`` (``server.meshfault``), ``MESH_ENABLED`` labels
    the device timings ``@dp1xtp1`` and adds the ``mesh`` section, and
    ``PROFILE_DIR`` turns the profiler routes on.  ``FLEET_*`` (with the
    score cache the config guarantees) build the ``FleetCoordinator``
    over that cache (``server.fleet``): the score client's miss path
    asks it, ``/fleet/v1/*`` serve it, and the drain hands off through
    it.  ``AOT_CACHE_DIR``, ``WARMUP_AOT`` and ``COMPILE_CACHE_DIR`` are
    logged once as inert here."""
    from ..obs import configure_quality
    from ..weights import WeightFetchers
    from .archive_routes import (
        archiving_clients,
        learn_handler,
        rescore_handler,
    )
    from .config import score_caches
    from .gateway import Server

    if embedder is not None and not embedder.mesh_mode:
        # the reference's mesh labels: an embedder the mesh never placed
        # is the 1x1 shape
        embedder.label_suffix = "@dp1xtp1" if config.mesh_enabled else ""
    for note in config.inert_knob_notes():
        log.warning("%s", note)
    score_cache, embed_cache = score_caches(config)
    # FLEET_*: the replicated-cache tier (fleet/).  Config validation
    # guarantees the score cache exists whenever the fleet is on; the
    # coordinator serves /fleet/v1 from it and publishes into it
    fleet = None
    fleet_cfg = config.fleet_config()
    if fleet_cfg is not None and score_cache is not None:
        from ..fleet import FleetCoordinator

        fleet = FleetCoordinator(fleet_cfg)
        fleet.cache = score_cache
    store = load_archive(config)
    # QUALITY_*: the drift knobs of the always-on quality aggregator
    configure_quality(
        window=config.quality_window,
        drift_threshold=config.quality_drift_threshold,
    )
    # LEDGER_*: one outcome record per scored request; None keeps the
    # tally ledger-free
    ledger = config.outcome_ledger()
    # RESILIENCE_* / FAULT_PLAN: None keeps the clients and the transport
    # on their pre-resilience paths
    resilience = config.resilience_policy()
    fault_plan = config.fault_injection_plan()
    # WEIGHTS_*: versioned live judge-weight tables behind atomic
    # hot-swap; None keeps the fetched weights
    live_weights = config.live_weights()
    if live_weights is not None and config.weights_path:
        from ..utils.io import probe_writable_config

        probe_writable_config(
            config.weights_path,
            "WEIGHTS_PATH",
            "hot-swapped weight tables would be lost at shutdown",
        )
    chat_client, multichat_client, score_client = build_chat_clients(
        config, score_cache, store, ledger, resilience, fault_plan,
        live_weights, fleet,
    )
    served = (chat_client, multichat_client, score_client)
    if config.archive_write:
        served = archiving_clients(store, config, *served)
    tables = load_tables(config) if embedder is not None else None
    # MEMGUARD: None when off or when an auto watermark cannot be read
    memguard = config.memguard()
    trace_sink = config.trace_sink()
    batching = dict(config.packing)
    if embedder is not None:
        batching["embed_cache"] = embed_cache
    server = Server(
        embedder, host=host, port=port, reranker=reranker,
        chat_client=served[0], multichat_client=served[1],
        score_client=served[2],
        max_batch=config.batch_max, window_ms=config.batch_window_ms,
        pipeline_depth=config.batch_pipeline,
        max_rows=config.batch_max_rows,
        host_tokenizer_workers=config.host_tokenizer_workers,
        admission=config.admission_config(),
        drain_timeout_ms=config.drain_timeout_millis,
        watchdog_ms=config.device_watchdog_millis,
        watchdog_interval_ms=config.device_watchdog_interval_millis,
        max_body_bytes=config.max_body_bytes,
        device_timing=config.metrics_device_timing,
        ready=False,
        # TRACE_*: None keeps every instrumentation site on its no-op path
        trace_sink=trace_sink,
        ledger=ledger,
        resilience=resilience,
        fault_plan=fault_plan,
        memguard=memguard,
        # HOST_FASTPATH: the streams' frames on the splice lane
        host_fastpath=config.host_fastpath,
        # WEIGHTS_* / OFFLINE_*: the live weight hot-swap endpoints and
        # the offline lane's rescore drive
        live_weights=live_weights,
        offline_enabled=config.offline_enabled,
        offline_inflight=config.offline_inflight,
        # DEVICE_WATCHDOG_CPU_FALLBACK / MESH_* / PROFILE_DIR
        fallback_embedder=(
            twin if config.device_watchdog_cpu_fallback
            and embedder is not None else None),
        meshfault=build_meshfault(embedder, config),
        mesh=config.mesh_enabled,
        profile_dir=config.profile_dir,
        fleet=fleet,
        **batching,
    )
    if memguard is not None:
        # soft pressure shrinks these budgets (restored on recovery)
        memguard.govern(
            caches=[c for c in (score_cache, embed_cache) if c is not None],
            sinks=[s for s in (trace_sink,) if s is not None],
            admission=server.admission,
        )
        memguard.start()
    server.resilience = resilience
    server.fault_plan = fault_plan
    server.tables = tables
    server.ledger = ledger
    server.archive = store
    server.fleet = fleet
    model = embedder if embedder is not None else reranker
    # one lock for every handler that mutates the archive or the tables
    lock = asyncio.Lock()
    routes = server.chat_routes
    routes.add_json_route("/archive/rescore", rescore_handler(
        store, lock, model.device if model is not None else device))
    if tables is not None:
        routes.add_json_route(
            "/weights/learn", learn_handler(store, embedder, tables, lock))
    if embedder is not None:
        from ..weights.training_table import TorchTrainingTableFetcher

        score_client.weight_fetchers = WeightFetchers(
            training_table_fetcher=TorchTrainingTableFetcher(
                embedder, tables, batcher=server.batcher
            )
        )
        if config.tables_path:
            server.on_close.append(
                lambda: tables.save(config.tables_path))
    if config.archive_path:
        server.on_close.append(lambda: store.save(config.archive_path))
    if score_cache is not None:
        server.on_close.append(score_cache.flush)
    # LOCK_WITNESS=1: runtime lockdep over the registered primitives,
    # wrapped here, before warmup's first dispatch; None leaves every
    # lock bare
    server.lock_witness = (
        install_lock_witness(server, embedder, reranker)
        if config.lock_witness else None
    )
    return server


def install_lock_witness(server, embedder, reranker):
    """Wrap every registered threading primitive a served request
    reaches in ``LockWitness`` proxies (``analysis/witness.py``, the keys
    of ``analysis/concurrency_model.py``): the per-device launch locks
    (the ``models.graphs`` table and every ``GraphTable`` holding one,
    the CPU twin's included), the staging pools, the batcher's condition
    and (with an embed cache) its join-table lock, the shape gate and
    the manager lock, the watchdog, the admission gate, the memory
    governor, the metrics series, the phase and quality aggregators, the
    kernel launch counters, the trace sink, the ledger and the live
    weight store.  The snapshot, with acquisitions per lock, is the
    ``lock_witness`` section of ``/metrics``; at close the summary line
    is printed and every proxy is taken out again, so objects the server
    shares (an embedder) are bare for the next one."""
    from ..analysis.witness import LockWitness
    from ..models import graphs
    from ..obs import phases, quality
    from ..ops import launches

    witness = LockWitness()
    proxies: dict = {}
    undo: list = []

    def proxy_for(lock, key):
        if id(lock) not in proxies:
            proxies[id(lock)] = witness.wrap_lock(key, lock)
        return proxies[id(lock)]

    def wrap(obj, attr, key):
        if obj is None:
            return
        lock = getattr(obj, attr)
        setattr(obj, attr, proxy_for(lock, key))
        undo.append(lambda: setattr(obj, attr, lock))

    for dev, lock in list(graphs._locks.items()):
        graphs._locks[dev] = proxy_for(lock, "launch_lock.lock")
        undo.append(lambda d=dev, l=lock: graphs._locks.__setitem__(d, l))
    batcher = server.batcher
    twin = getattr(batcher, "fallback_embedder", None)
    for model in (embedder, reranker, twin):
        if model is None:
            continue
        wrap(model.graphs, "lock", "launch_lock.lock")
        wrap(getattr(model, "staging_pool", None), "_lock",
             "StagingPool._lock")
    if batcher is not None:
        wrap(batcher, "_cond", "DeviceBatcher._cond")
        if batcher.embed_cache is not None:
            wrap(batcher, "_embed_lock", "DeviceBatcher._embed_lock")
    meshfault = server.meshfault
    if meshfault is not None:
        wrap(meshfault, "_lock", "MeshFaultManager._lock")
        gate = meshfault._shape_gate
        witness.wrap_gate(gate)
        undo.append(lambda: [gate.__dict__.pop(name, None)
                             for name in ("shared", "exclusive")])
    wrap(server.watchdog, "_lock", "DeviceWatchdog._lock")
    wrap(server.admission, "_lock", "AdmissionController._lock")
    wrap(server.memguard, "_lock", "MemGuard._lock")
    wrap(server.metrics, "_lock", "Metrics._lock")
    wrap(phases._AGG, "_lock", "PhaseAggregator._lock")
    wrap(quality._AGG, "_lock", "QualityAggregator._lock")
    wrap(launches, "_lock", "launches._lock")
    wrap(server.trace_sink, "_lock", "TraceSink._lock")
    wrap(getattr(server, "ledger", None), "_lock", "OutcomeLedger._lock")
    wrap(server.live_weights, "_lock", "LiveWeightStore._lock")
    server.metrics.register_provider(
        "lock_witness",
        lambda: dict(witness.snapshot(), locks=witness.counts()),
    )

    def report_and_unwrap() -> None:
        print(witness.summary_line(), flush=True)
        for step in reversed(undo):
            step()

    server.on_close.append(report_and_unwrap)
    return witness


def warm_up(server, config: ServeConfig) -> list:
    """Capture the configured buckets' CUDA graphs, then turn the server
    ready (``/readyz`` 200).  Returns [(label, seconds)]."""
    timings = server.warmup(config.warmup, config.warmup_r,
                            config.packed_buckets(), config.rm_warmup,
                            ring_buckets=config.long_context_warmup)
    for label, seconds in timings:
        log.info("warmup %s in %.2fs", label, seconds)
    return timings


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m llm_weighted_consensus_tpu_torch.serve"
    )
    parser.add_argument("--port", type=int, default=None)
    parser.add_argument("--address", default=None)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument(
        "--fake-upstream", action="store_true",
        help="serve the chat routes from a scripted loopback provider",
    )
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    load_dotenv()
    env = process_env()
    # MULTIHOST: the process group forms before any mesh is built
    from ..parallel.dist import maybe_initialize_distributed

    maybe_initialize_distributed(env, device=args.device)
    fake = None
    if args.fake_upstream:
        from .fake_upstream import FakeUpstream

        fake = FakeUpstream()
        env["LWC_ALLOW_RANDOM_PARAMS"] = "1"  # the reference's demo mode
        log.info("fake upstream at %s", fake.url)
    config = ServeConfig.from_env(env)
    if args.port is not None:
        config.port = args.port
    if args.address is not None:
        config.address = args.address
    if fake is not None:
        config.upstream["api_bases"] = [
            {"api_base": fake.url, "api_key": "fake-key"}
        ]
    embedder = (
        build_embedder(env, device=args.device)
        if env.get("EMBEDDER_MODEL") else None
    )
    reranker = build_reranker(env, device=args.device)
    twin = (
        build_cpu_twin(env)
        if embedder is not None and config.device_watchdog_cpu_fallback
        else None
    )
    server = build_server(embedder, reranker, config, config.address,
                          config.port, device=args.device, twin=twin)
    for what, served in (("embedder", embedder), ("reranker", reranker)):
        if served is not None:
            log.info(
                "serving %s %s on %s:%d (%s, %s, quantize=%s)", what,
                served.model_name, config.address, server.port,
                served.device, served.dtype, served.config.quantize,
            )
    if embedder is not None:
        log.info("packing=%s", config.packing["packing"])
    log.info(
        "serving /chat/completions, /multichat/completions and "
        "/score/completions on %s:%d (%d upstream endpoints)%s",
        config.address, server.port,
        len(config.upstream["api_bases"]),
        "" if embedder or reranker
        else "; no EMBEDDER_MODEL or RM_MODEL: the chat routes only",
    )
    stop = threading.Event()
    for signum in (signal.SIGTERM, signal.SIGINT):
        signal.signal(signum, lambda *_: stop.set())
    server.start()
    try:
        warm_up(server, config)
        log.info("ready")
        stop.wait()
        log.info("draining (budget %.0f ms)", config.drain_timeout_millis)
        clean = server.drain()
        log.info("drained %s", "clean" if clean else "past its budget")
    finally:
        server.close()
        if fake is not None:
            fake.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
