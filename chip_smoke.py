"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card's name and power limit (nvidia-smi), and the build of
   the hand-written CUDA kernels from ``llm_weighted_consensus_tpu_torch/
   csrc`` (timed);
2. kernels: every kernel against its plain PyTorch version on the card,
   at every shape the main paths give it (``MAIN_PATH_ATTENTION_SHAPES``
   for attention, ``QUANT_MAIN_SHAPES`` at ``QUANT_M`` and
   ``QUANT_SMALL_M`` rows for the W8A8 and W4A8 matmuls and their row
   quantisation, every packed call shape ``PACKED_SHAPES`` for the
   segment attention) and at odd shapes, each call held to the route it
   must take (both attentions: TMA for bf16 hd 64, also at
   ``ATTN_RAGGED`` and the segment one's hard layouts; mma.sync for bf16
   hd 16/32; FMA for f32, hd 24 and unaligned views; W8A8: TMA where
   K % 16 == 0, else mma.sync; W4A8: TMA, and byte for byte the mma.sync
   route's output; the vote: the cluster kernel at every R, N, D the
   server makes, also with padding rows and unaligned rows, bit-equal from
   call to call, and the block kernel past the cluster plan's shared
   memory; and with a count per request, ``STREAM_RS`` x
   ``STREAM_CAPS`` at D=1024, f32 and bf16, mixed counts from 1 to CAP,
   on both routes, the scalar count bit-equal to a tensor of equal
   counts, a count of 0 a request of zeros), max |diff| beside the
   stated tolerance, with the
   kernel's, the plain version's and (for both attentions; the segment
   one with its boolean same-segment mask)
   ``scaled_dot_product_attention``'s time
   and the least time the card could take (bytes at 3.35 TB/s or
   operations at the type's peak, whichever is larger); the quantized
   matmuls are timed beside bf16 ``F.linear`` and ``torch._int_mm`` on
   pre-quantised operands, yardsticks the port never calls; the TMA
   attentions and GEMMs also beside the mma.sync kernels they replaced, on
   the same inputs in the same run (the attentions also by device time
   per launch from torch.profiler: at the small shapes the wrapper's host
   time per call exceeds the kernel's; the vote's two kernels also in one
   profile with a one-float fill, the shortest launch, and the cluster
   kernel at every cluster size; the segment one also with the
   dense tile work the plain schedule visits, ``visited_ops``, counted
   on the host from the ids, and its schedule read back from the kernel
   and held to the plain one);
3. bge_micro: the committed fixture, loaded by the port's loader, served
   through ``/consensus`` on the card and on the CPU; the confidences
   must agree, unquantized and under ``int8`` / ``int4-pallas``; packed
   embeddings on the card against the CPU's and the padded path's, and
   a segment beside row-mates against itself alone (f32); and the
   streaming consensus (``StreamingSelfConsistency``) on the card against
   the CPU over one arrival order of 20 candidates (the buffer grows past
   16), and one grouped ``stream_vote_update_many`` of 5 streams against
   5 single ones (f32, ``MICRO_TOL``);
4. main path: the port's HTTP server on the card at full bge-large width
   (random weights from a fixed seed, bf16): bursts of 8 concurrent
   ``/consensus`` requests of 64 candidates in the s=128 bucket, one
   request in the s=512 bucket and one ``/embeddings`` request; outputs
   and buckets checked, kernel launch counts checked against the
   dispatches (every attention launch on the TMA route), latency and
   answers/s reported; then the same traffic with tokenization on the
   dispatch thread (``host_tokenizer_workers=0``): the buckets each
   setting's grouping reached, and one request's tokenization time;
5. packed path: the main path's embedder served with ``PACKING`` (the
   ``PACKING_ENABLED`` defaults) under the reference's mixed-length
   traffic, 3 bursts of 32 concurrent ``/consensus`` requests (N in
   {3, 4, 6, 8}) each with one ``/embeddings`` request of 16 texts, and
   the same traffic through a padded server; p50, answers/s, packed call
   shapes and real/slot tokens of both; segment-attention launches
   checked against the packed calls (no padded kernel, every launch on
   the TMA route); answers held against the padded path with prefix
   dedup off and against the dedup contract with it on; then the segment
   kernel's times at every packed shape the traffic dispatched and at
   the bucket;
6. quantized paths: the same server with ``quantize="int8"`` (3 bursts
   and ``/embeddings``, then one packed burst) and ``"int4-pallas"`` (1
   burst and ``/embeddings``) on the same weights; launch counts checked
   (6 quantized matmuls per layer per encoder call, every W8A8 and W4A8
   one on the TMA route), answers held against
   the unquantized path's on the same texts (embedding cosine and
   confidence bars of the reference's own quantization tests);
7. profiles: device time by kernel for one coalesced dispatch of the main
   path (unquantized, ``int8`` and ``int4-pallas``) and one packed
   [8, 512] call (unquantized and ``int8``) from torch.profiler, the full
   tables in ``chiprun_out/profile_*.txt``; the device's idle share as
   measured, failing if the summed device time exceeds the wall time, if
   a cuBLAS GEMM runs in a quantized dispatch, or unless each dispatch ran
   ``attention_tma_kernel<false>`` once per layer (and no
   ``attention_mma_kernel<64, false>``) and ``cosine_vote_cluster_kernel``
   once (and no ``cosine_vote_kernel``), each packed call
   ``attention_tma_kernel<true>`` once per layer (and no
   ``attention_mma_kernel<64, true>``) and, quantized, the W8 or W4
   ``quant_gemm_tma_kernel`` six times per layer (and no
   ``quant_gemm_kernel``);
8. the reward-model path (``/consensus {"scorer": "rm"}``): the native
   tokenizer library loads (512 texts through WordPiece and the unigram
   tokenizer, native and Python, the same ids, both timed); the tiny
   DeBERTa configs (clamp and log buckets) served on the card in f32
   against the port on the CPU, unquantized and under ``int8`` /
   ``int4-pallas``, with the quantized launches counted, and
   ``reward_packed`` against per-row rewards on the card;
   deberta-v3-base at full width (random weights from seed 0, bf16, a
   synthetic ``spm.model`` written under ``build/rm_smoke/``) served
   through ``build_reranker`` with BASELINE config 3's traffic (50
   requests of N=16 in the s=128 bucket, 8 in flight) and one N=64
   request in the s=512 bucket, answers and buckets checked, no port
   kernel launched unquantized; one N=4 request in f32 on the card
   against the CPU and bf16 against f32; the same server under
   ``RM_QUANTIZE=int8`` and ``int4-pallas`` (one burst each, 72 GEMM
   launches per reward call on the TMA route, one row quantisation per
   GEMM, answers against the unquantized ones); device time by kernel
   for one N=16 request unquantized and under int8
   (``chiprun_out/profile_rm*.txt``; int8 must show
   ``quant_gemm_tma_kernel`` 72 times and no ``quant_gemm_kernel``).
   Phase 2 also holds and times W8A8 / W4A8 at the RM's shapes
   (``RM_QUANT_SHAPES`` at ``RM_QUANT_M`` rows);
9. serving: every served path through the port's own server and full
   batcher, built by the entry points a user calls (``build_embedder``,
   ``build_reranker``, ``build_server``, ``warm_up``): bge-large padded
   (the main path's traffic, ``WARMUP=64x128,16x512,32x64``,
   ``WARMUP_R=2,4,8``), packed (the mixed traffic, every packed [b, L]
   warmed), ``int8`` (3 bursts) and ``int4-pallas`` (1 burst), and
   deberta-v3-base (BASELINE config 3, ``RM_WARMUP=16x128``) unquantized
   and under ``int8`` (one burst).  Each path is served eagerly first,
   then by a new server that answers ``/readyz`` 503 until its CUDA
   graphs are captured and 200 after; the graphed run's launch counts
   are set to 0 before its traffic and read after, and it fails unless
   no graph was captured after warmup, the counts (replays included)
   equal the dispatches' and every launch took its ``tma`` / ``cluster``
   route, each dispatch's output equals an eager call's at the same
   bucket on the same inputs within ``GRAPH_TOL`` (a planted cross-talk
   fault, another dispatch's inputs at that bucket, must read over
   ``FAULT_MARGIN`` times that), its answers equal the eager run's
   within ``RUN_TOL`` (the batcher may group the two runs apart), and a
   ``/metrics`` scrape parses as JSON and as OpenMetrics text with the
   kernels' own counts.  Each row gives p50, answers/s and one call's
   wall, device time and idle share, eager against graphed, and the
   graph pool's bytes; on the main path a drain with a burst in flight
   must finish every admitted request while new ones shed 503;
10. multichat path: BASELINE config 5 (streaming multichat with
   incremental consensus) through ``build_embedder``, ``build_server``
   and ``warm_up`` at bge-large width (``WARMUP=16x112,16x128,32x128``), the
   generators a scripted stdlib SSE server on loopback
   (``ScriptedGenerators``): a panel of 32 slots over 3 backends, 16
   streaming ``/multichat/completions`` requests with ``"consensus":
   true``, 8 in flight, candidates of 100-120 words from 4 answer
   families, then 2 unary requests with consensus, one streamed
   ``/chat/completions`` and one stream whose fifth update meets a
   planted embed failure.  It fails unless every stream ends with
   ``[DONE]`` and carries 31 consensus frames, the last one summing to 1
   within 1e-3 and within ``STREAM_CONF_TOL`` of an eager vote over the
   same 32 texts embedded in one call (the unary answers too), every
   vote launch took ``cluster`` and every attention launch ``tma``, the
   vote launches equal the stream and unary dispatches, no graph was
   captured after warmup, and the planted failure left its stream plain
   multichat (3 frames, every candidate, ``[DONE]``).  It prints
   updates/s, the server's per-update p50, the dispatches, the largest
   group, replays against eager dispatches, and one grouped update
   dispatch's wall and device idle share, eager and replayed;
11. score path (``/score/completions``): ``training_table_weights_batched``
   on the card against float64 on the host at full width (32 judges, 256
   rows of 1024, padded rows, k past the rows, exact ties at the k-th
   place; ``LOOKUP_F64_TOL``); bge_micro in f32 through the port's
   ``ScoreClient`` on the card and on the CPU with the same scripted
   judges, seeded ballots and training tables (static-weight frames byte
   for byte, training-table weights and confidences within
   ``MICRO_TOL``); then BASELINE config 2's panel (32 judges over 3
   backends, soft votes from 8 ``top_logprobs``) at bge-large width
   through ``build_embedder``, ``build_server`` and ``warm_up``, the
   judges a scripted stdlib SSE server on loopback (``ScriptedJudges``),
   the training tables (256 prompts embedded on the card) from
   ``TABLES_PATH``: 16 training-table requests of 8 candidates, 8 in
   flight, then 4 static-weight requests, and a second server with
   ``SCORE_CACHE_TTL=60`` (one request, 2 repeats, one identical
   concurrent pair).  It fails unless every final frame's confidences
   sum to 1 within ``SCORE_SUM_TOL``, every trained weight lies in
   [1, 5], no graph was captured and no prompt embed ran eagerly after
   warmup (``WARMUP`` covers 16 rows at every sequence bucket the prompts
   fall in), the attention launches equal 24 per prompt-embed dispatch,
   all ``tma``, with no vote launch, the repeats make no upstream call
   and no dispatch, and the pair makes one fan-out of 32 judge calls and
   one collapse.  It prints requests/s and client p50 for both weight
   kinds, the server's weight-fetch p50, one fetch by part (prompt embed,
   host padding, upload, lookup) and under torch.profiler, the embed
   dispatches and rows per dispatch, upstream calls, hits and collapses;
12. archive path (``/archive/rescore``, ``/weights/learn``): the device
   tally (``tally``, ``tally_batch``, ``judge_confidence``,
   ``incremental_tally``) on the card against the exact Decimal host
   tally and float64 (``TALLY_TOL``), with failed judges and an
   all-failed request, TF32 off, and ``softmax_votes`` against its CPU
   run with ids of -1 and past N and rows without a valid alternative;
   BASELINE config 4 (``bench_all.py:374-402``: 10,000 completions of
   M = 8, N = 4, seed 0) through ``rescore_batch`` on prebuilt arrays and
   through ``rescore_archive`` over an archive of 10,000 wire-type
   completions, completions/s with the host's extraction time and the
   device's (CUDA events) apart; bge_micro completions re-scored
   (plain, ``revote``, an override) and learned from on the card and on
   the CPU; then phase 11's panel at bge-large width through
   ``build_embedder``, ``build_server`` and ``warm_up`` with
   ``ARCHIVE_PATH``, ``TABLES_PATH`` and ``ARCHIVE_STREAMING=1``: 16
   streamed and 4 unary training-table requests, one taking an archived
   choice by id; ``/archive/rescore`` plain, with ``revote`` (and every
   judge's soft vote re-extracted on the card against its stored one),
   with a weight override (against an exact Decimal re-tally) and with
   ``apply`` (the next fetch sees it); ``/weights/learn`` twice (the
   rows against the archive's count, then 0; 24 ``tma`` attention
   launches per embed dispatch, none captured after warmup; the rows
   against ``embed_texts`` of the same prompts within ``LEARN_ROW_TOL``);
   the snapshot saved at close loaded anew.  It prints the rescore
   route's wall with its host and device parts and the learn pass's
   wall, embed device time and dispatches (eager ones apart);
13. traced serving (``obs/``): one bge-large build through
   ``build_embedder``, ``build_server`` and ``warm_up``.  (a) Phase 1's
   bursts (3 x 8 ``/consensus`` of N=64 at s=128, a 1 s window so each
   burst is one R=8 group) through a server per tracing mode: off,
   ``TRACE_ENABLED=1`` at rate 0, and ``TRACE_SAMPLE_RATE=1`` with
   ``TRACE_DIR`` and ``LEDGER_DIR``, half of those requests carrying a
   caller's ``traceparent``.  It fails unless every traced answer has
   ``x-trace-id`` (the caller's trace adopted), ``/v1/traces/{id}``
   returns the tree ``gateway:POST /consensus`` -> ``batcher:consensus``
   -> ``device:dispatch`` with every parent resolved, the named phases
   hold 90% of ``e2e_ms``, the answers equal the untraced server's
   (bit-equal at the same bucket, 1e-6 otherwise), and every mode made
   the same launches per dispatch on ``tma`` / ``cluster``, all replayed,
   none captured or eager.  (b) One burst of the mixed-length traffic
   packed, untraced then traced: each item's ``batcher:*`` span carries
   ``pack_plan_ms`` and ``host_tally_ms``, the same segment-attention
   launches per packed call on ``tma``, the 90% bar on every
   ``/consensus`` trace and over the burst (the ``/embeddings`` answer's
   JSON encode of 16 x 1024 floats is host time no phase names; its
   share is printed).  The load comes from a client process of its own
   (``LOAD_CLIENT``), so client threads do not share the server's
   interpreter lock.  (c) Phase 11's
   panel with training-table weights at rate 1 with ``LEDGER_DIR``: 8
   streamed and 4 unary requests, 8 in flight; every judge call's
   ``traceparent`` names its request's trace and its ``judge:attempt``
   span, the final frame's ``trace_id`` is ``x-trace-id``,
   ``consensus:tally`` carries the explain record, ``/v1/judges`` counts
   12 ballots per panel slot on each distinct judge id (the aggregator
   is process-global: it is reset first), the ledger holds
   12 records that ``load_ledger_records`` reads back; an all-failed
   panel at rate 0 (``TRACE_ENABLED=1``) is kept with ``force_reason``
   ``all_failed`` while a healthy request is dropped.  It prints p50 and
   answers/s per mode, and the median of each named phase and of
   ``other`` for (a), (b) and (c), and the garbage collector's pauses
   during (a) and (b), beside the nvidia-smi line;
14. resilient path (``resilience/``, ``serve/frames.py``): one bge-large
   build through ``build_embedder``, ``build_server`` and ``warm_up``
   (``WARMUP`` at the prompts' 16-row buckets and the 64-candidate
   ``/consensus`` bucket), phase 11's panel with training-table weights
   on ``ScriptedJudges`` whose judges mostly agree
   (``RESILIENT_AGREEMENT``), behind three endpoints: one answering 503,
   then the judges' server twice.  The same 16 streamed and 4 unary
   requests (8 in flight, ``LOAD_CLIENT``) through a server with every
   knob unset, then through one with ``RESILIENT_ENV`` (the splice lane,
   quorum 0.5, breakers, retry budget 8, 150 ms hedges, a 5 s default
   deadline, ``FAULT_PLAN`` stalling 35% of first chunks for 20 s),
   ``SCORE_CACHE_TTL=60`` and ``TRACE_ENABLED=1``.  It fails unless
   every stream ends ``[DONE]``, no request outlives the deadline by
   more than ``RESILIENT_DEADLINE_MARGIN_MS``, every final frame's
   confidences sum to 1 within ``SCORE_SUM_TOL``, a degraded answer's
   judge errors are 499 or 504 entries, ``resilience`` counts quorum
   degrades, hedges and breaker rejections, the 503 endpoint's breaker
   is open and took fewer calls than the attempts routed to it, no
   splice frame fell back and each is the slow lane's bytes for its item
   and the bytes the client read, every prompt embed was 24 ``tma``
   launches replayed (none captured or eager), a repeated degraded
   request fans out again, and the sockets the stragglers and hedge
   losers held are closed.  Then the memory drill on the same server:
   the governor's watermarks lowered under the RSS, ``/consensus`` (N=64,
   s=128) sheds 503 ``shed_reason: memory``, ``/livez`` and ``/readyz``
   (``degraded_mem``) answer 200, the trace ring and cache budgets are
   halved; the watermarks raised, everything is restored and
   ``/consensus`` answers bit-equal to before, with one ``cluster``
   vote.  It prints both servers' requests/s and client p50, µs per frame
   of the splice and slow lanes over the served items, the counters, the
   breaker states, the RSS and the watermarks, beside the nvidia-smi
   line;
15. learning path (``weights/live.py``, ``train/``): one bge-large build
   through ``build_embedder`` and two servers through ``build_server``
   and ``warm_up``.  (a) ``OFFLINE_ENABLED=1``, ``BATCH_MAX=1``, every
   bucket warmed: phase 4's bursts (2 x 8 ``/consensus``, N=64, s=128)
   alone, ``POST /v1/train/rescore`` (64 groups of 8, 4 in flight) alone,
   the drive again while the bursts run (their answers bit-equal to the
   first run's, and no latency dispatch's queue time covered by offline
   dispatches for longer than the longest of them), and a second drive
   posted during a third (409).  (b) The
   learner drill: phase 11's judges one slot per backend (weights 1, 1,
   3) with ``LEDGER_DIR``, ``LEDGER_ROTATE_BYTES`` and
   ``WEIGHTS_ENABLED``, the weight-3 judge mis-voting after 8 ballots
   (``JUDGE_BIAS_PLAN``): 24 requests, then ``python -m
   llm_weighted_consensus_tpu_torch.train fit --device cuda --put`` while
   requests flow, 4 more; it fails on a client error, unless every
   ledger record names the version that scored it (``base``, then the
   fitted one), the biased judge gets the smallest weight, the fitted
   held-out accuracy beats base, the card's fit matches a CPU fit of the
   same shards within ``LEARN_FIT_TOL``, and a shadow ``PUT`` moves
   ``lwc_weights_shadow_total``.  Every launch of (a) and (b) is a
   ``tma`` attention or a ``cluster`` vote replayed from a graph.  (c)
   The trainers at full width in f32 (TF32 off): ``TRAIN_STEPS``
   InfoNCE steps on bge-large at ``TRAIN_BERT_SHAPE`` and Bradley-Terry
   steps on deberta-v3-base at ``TRAIN_RM_SHAPE``, losses finite and
   falling, every ``attn_q/k/v`` weight with a nonzero gradient, no
   kernel launched, a full-state resume within ``TRAIN_RESUME_RTOL`` of
   the straight run; ms per step and peak memory printed.  Then one
   bge_micro InfoNCE step on the card against the CPU: every gradient
   within ``TRAIN_GRAD_ATOL`` of the largest plus ``TRAIN_GRAD_RTOL``
   relative, and a step with the attention's gradient cut outside it;
16. fault path (``resilience/meshfault.py``, the CPU twin,
   ``serve/profiling.py``, ``analysis/roofline.py``): one bge-large build
   (``build_embedder``, bf16) and its CPU twin (``build_cpu_twin``, f32)
   through servers of ``build_server`` and ``warm_up``
   (``WARMUP=64x128,8x32``, ``WARMUP_R=8``).  (a) ``MESH_ENABLED=1
   MESH_FAULT_ENABLED=1`` and ``FAULT_SCRIPT``, no twin: 4 bursts of 8
   ``/consensus`` (N=64, s=128); a single transient re-dispatches on the
   card, the third in a row escalates to persistent and fails its group
   with the 500 envelope, the next burst answers 200, ``re_dispatches``
   is the retried transients' items, every 200 within ``RUN_TOL`` of a
   clean server's answer, the vote and attention launches those of the
   dispatches that reached the card, no graph captured after warmup.  (b)
   the same with ``DEVICE_WATCHDOG_MILLIS=2000``, the twin and a 3 s
   ``hang``: ``/readyz`` 503 ``device_unhealthy`` while overdue,
   ``/consensus`` admitted meanwhile, the hang classified persistent, the
   twin on (and still on after the recovery), its answers within
   ``MICRO_TOL`` of the port's CPU answers and within the
   quantized-vs-padded bars of the card's, ``fallback_dispatches`` the
   twin's dispatches, no launch while it serves.  (c) the watchdog and the
   twin alone, one dispatch behind a 6 s ``torch.cuda._sleep`` spin: the
   requests sent after the trip answer from the twin while the spin runs,
   then the twin turns off and the next burst runs on the card with its
   launches counted.  (d) an allocation past the card's memory classifies
   transient; a subprocess (bge_micro, the twin under the ladder) meets a
   real device-side assert, classifies it persistent and answers from the
   twin (exception type, message and exit code recorded).  (e) ``POST
   /v1/profile`` with ``PROFILE_DIR`` during two bursts: the Chrome trace
   parses and, for the second burst's launch calls, names
   ``attention_tma_kernel<false>`` and ``cosine_vote_cluster_kernel`` as
   often as the launch counters rose over it (the first takes the
   tracer's loss of a capture's first device records), a
   concurrent ``/profile/start`` is a 400, ``/v1/profile`` answers under a
   saturated gate and 403 without ``PROFILE_DIR``.  (f) the ``roofline``
   section: ``sol_ms``, ``device_p50_ms`` and ``attainment`` (at most 1.0)
   for every card bucket that ran, and both Prometheus families.

17. bench path (``llm_weighted_consensus_tpu_torch/bench/``): each bench
   of ``BENCH_RUNS`` in a subprocess with its own time limit, two lanes
   at once: ``headline`` (bge-large, N=64, s=128, none and int8),
   ``configs --quick --single-run`` (BASELINE configs 1-5, the int8
   headline, the learning effect), ``fwd``, ``attn``, ``http`` (the trio,
   ``--trace-overhead``, ``--offline``, at a small depth) and ``host``.
   Each run exits 0 with exactly its expected records, one parseable JSON
   line each, keys equal to ``BENCH_KEYS`` of its kind, rates, latencies
   and times finite and positive, ``device`` equal to the nvidia-smi
   line; the headline runs' launch counters rose by 24 ``tma`` attention
   launches and one ``cluster`` vote per consensus dispatch (int8: 144
   ``tma`` W8A8 launches), all replayed, and every bench held its warm
   answers to a sum of 1 within 1e-3 (it fails otherwise).

Then one JSON line with every kernel's numbers (phase 9's graphed
launches beside the earlier paths'), the nvidia-smi line, and
as the last line ``{"ok": true, "device": {...}}``.  Any failure exits
nonzero before that line.  Without a CUDA device the script exits 2.
"""

from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

# published H100 SXM peaks (NVIDIA data sheet, dense), from the port's
# roofline module: the bounds here and its gauge divide by the same peaks
from llm_weighted_consensus_tpu_torch.analysis.roofline import (  # noqa: E402
    H100_HBM_BYTES_PER_S as HBM_BYTES_PER_S,
    H100_PEAKS,
)

PEAK_FLOPS = {k: H100_PEAKS[k] for k in ("bfloat16", "float32")}
PEAK_INT8_OPS = H100_PEAKS["int8"]

VOTE_TOL = 1e-5
# the main path's traffic (phase 4): candidates per /consensus request,
# requests per burst, words per candidate (one hash-tokenizer token each,
# plus [CLS] and [SEP]: 122 tokens, the s=128 bucket), the s=512 request
# and the /embeddings request
N_CANDIDATES, BURST, BURST_WORDS = 64, 8, 120
LONG_N, LONG_WORDS = 16, 450
EMBED_N, EMBED_WORDS = 32, 60
MAIN_PATH_ATTENTION_SHAPES = (
    (N_CANDIDATES, 128), (BURST * N_CANDIDATES, 128), (LONG_N, 512),
    (EMBED_N, 64),
)
# the multichat path's stream dispatch: up to 16 new candidates padded to
# the embed bucket of 16 rows at s=128
STREAM_ATTENTION_SHAPE = (16, 128)
# the device time summed from the profile may exceed the wall time it
# was taken in by this much (timer skew) before the sum counts as wrong
DEVICE_TIME_SLACK = 1.01
ATTN_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# ragged [b, s] of the TMA attention route (bge-large's 16 heads of 64)
ATTN_RAGGED = ((5, 77), (4, 100), (3, 130), (2, 200))
MICRO_TOL = 1e-5  # /consensus confidences, card (f32) vs CPU (f32)
# quantized bge_micro confidences, card (f32) vs CPU (f32): an upstream
# ulp can flip one int8 activation rounding
QUANT_MICRO_TOL = 1e-3
# W8A8 / W4A8 kernel vs plain: |diff| <= tol * (1 + |want|); f32 differs
# only by the card's erf/exp ulps, bf16 by one rounding (one ulp at ~4)
QUANT_TOL = {"bfloat16": 2e-2, "float32": 2e-5}
# rows of one R=8 dispatch of N=64 candidates at s=128, and the (K, N,
# GELU) of bge-large's six dense layers: q, k, v and attention output,
# MLP in (GELU in the epilogue), MLP out
QUANT_M = BURST * N_CANDIDATES * 128
QUANT_MAIN_SHAPES = ((1024, 1024, False), (1024, 4096, True),
                     (4096, 1024, False))
QUANT_ODD_SHAPES = ((5, 48, 24), (37, 96, 384), (130, 192, 96),
                    (17, 1000, 40))
# rows of the int8 packed burst's largest call, 8 rows of 512 tokens
QUANT_SMALL_M = 8 * 512
# quantized vs unquantized answers on the same weights and texts: the
# reference's bars (tests/test_quant.py) as (min cosine, max |conf diff|).
# Its int4 cosine bar (0.95) was set on test-tiny's 2 layers; at
# bge-large's 24 the int4 scheme itself loses more (PERF.md), so int4 is
# held to what the scheme loses on the same weights and texts: the port's
# plain versions on the CPU in f32 (the reference's numerics, held equal
# to it in tests/test_torch_quant*.py), min cosine within SCHEME_MARGIN
QUANT_BARS = {"int8": (0.98, 0.1), "int4-pallas": (None, 0.15)}
SCHEME_MARGIN = 0.05
SCHEME_TEXTS = 8
# kernel names of a cuBLAS / cuBLASLt GEMM in a profile
CUBLAS_GEMM = ("nvjet", "cublas", "gemm", "xmma", "cutlass", "gemv")
# the port's own GEMM kernels (exact function names), exempt from it
PORT_GEMMS = ("quant_gemm_kernel", "quant_gemm_tma_kernel")
# the template arguments that tell the instantiations apart in a profile
# key: the padded and the segment TMA attention, the W8 and W4 TMA GEMM
PADDED, SEG, W8, W4 = "<false>", "<true>", ", false>", ", true>"
# the packed path (phase 5): PACKING_ENABLED with the reference's
# defaults, and the reference's mixed-length traffic (bench_http.py,
# --mixed-lengths, seed 11): bursts of concurrent /consensus requests
# with one concurrent /embeddings request of mixed-length texts each
PACKING = {
    "packing": True, "packing_row_tokens": 512, "packing_max_rows": 8,
    "packing_max_segments": 64, "prefix_dedup": True,
    "prefix_dedup_min_chars": 48,
}
PACKED_BURSTS, PACKED_BURST, PACKED_EMBED_N = 3, 32, 16
BENCH_WORDS = [  # bench.py's vocabulary
    "the", "answer", "is", "42", "41", "value", "result", "compute",
    "therefore", "because", "number", "final", "we", "get", "so",
]
# every [b, L] a packed call can take at those defaults: b a power of two
# up to 8 rows, L on packing._L_BUCKETS up to 512
PACKED_SHAPES = tuple(
    (b, l) for b in (1, 2, 4, 8) for l in (64, 128, 192, 256, 384, 512)
)
SEG_BUCKET = (8, 512)
# the reward-model path (phase 8): BASELINE config 3 (bench_all.py's
# bench_rm_reranking, n=16, seq=128, 50 requests, 8 in flight) on
# deberta-v3-base, each candidate bench.py's 96 words and two tags after
# a prompt (113-118 tokens: the s=128 bucket), then one request of 64
# candidates of 440 words (the s=512 bucket)
RM_N, RM_REQUESTS, RM_INFLIGHT, RM_WORDS = 16, 50, 8, 96
RM_LONG_N, RM_LONG_WORDS = 64, 440
RM_PROMPT = "we compute the final value so the answer is"
# the RM's six dense layers per encoder layer, as (K, N, GELU): q, k, v
# and attention output, MLP in (GELU in the epilogue), MLP out; at the
# rows of one N=16, s=128 request and of the N=64, s=512 one
RM_QUANT_SHAPES = ((768, 768, False), (768, 3072, True), (3072, 768, False))
RM_QUANT_M = (RM_N * 128, RM_LONG_N * 512)
# full width: f32 on the card against the CPU (12 layers of f32
# summation order), and bf16 against f32 on the card: the order of every
# pair f32 separates by more than RM_BF16_SEP, and the bar of
# tests/test_models.py's bf16 RM test
RM_FULL_F32_TOL, RM_BF16_SEP, RM_BF16_TOL = 1e-4, 5e-3, 0.05
# quantized against unquantized confidences (tests/test_quant.py's int8 RM
# bar; the int4 bar of QUANT_BARS)
RM_QUANT_BARS = {"int8": 0.1, "int4-pallas": 0.15}
# the tiny configs held card against CPU: DEBERTA_TEST_TINY (clamp) and
# the same with 8 log buckets out to 32 positions, texts up to s=64
RM_LOG_TINY = {"position_buckets": 8, "max_relative_positions": 32}
# (candidates, prompt, temperature) of the tiny configs' requests
RM_TINY_REQUESTS = ((6, "which", 1.0), (2, None, 0.3), (4, "t1 t2 t3", 2.0))
# packed against padded on bge-large in bf16, the same texts: the bf16
# rounding of another key-tile order, amplified by T = 0.05 in the vote
PACKED_MIN_COS, PACKED_CONF_TOL = 0.999, 2e-2
# bge_micro in f32 on the card: packed against the CPU and against the
# padded path, and a segment beside other row-mates
PACKED_MICRO_TOL, ROW_MATE_TOL = 1e-5, 1e-6
# phase 9: each graphed dispatch's output against an eager call at the
# same bucket on the same staged inputs (the same kernels; only cuBLAS's
# algorithm choice under capture could differ), and the least a planted
# cross-talk fault (another dispatch's inputs at that bucket) moves it,
# which must exceed the limit FAULT_MARGIN times over
GRAPH_TOL, FAULT_MARGIN = 1e-6, 10.0
# phase 9: the graphed run's served answers against the eager run's: the
# batcher may group (or pack) the same traffic differently in the two
# runs, and another grouping changes the bf16 rounding as PACKED_CONF_TOL
# allows
RUN_TOL = PACKED_CONF_TOL
# the streaming consensus (phases 2, 3 and 10): the vote with a count per
# request at every R a stream dispatch can hold and every capacity a
# stream's buffer grows through, D of bge-large
STREAM_RS, STREAM_CAPS = (1, 2, 8, 16), (16, 32, 64, 128)
STREAM_MICRO_N = 20  # bge_micro candidates: the buffer grows past 16
# BASELINE config 5 (bench_all.py:130-143, 406-495): a panel of 32
# generator slots over 3 backends, weights 1 + i % 3; 16 streaming
# requests with consensus, 8 in flight; candidates of 100-120 words (the
# s=128 bucket) from 4 answer families; then 2 unary requests and one
# streamed /chat/completions
STREAM_SLOTS, STREAM_BACKENDS, STREAM_FAMILIES = 32, 3, 4
STREAM_REQUESTS, STREAM_INFLIGHT, STREAM_WORDS = 16, 8, (100, 120)
# the stream dispatches pad to the embed bucket of 16 rows, at s=112 (a
# group whose longest candidate has at most 110 words) or s=128; the
# unary consensus is one request of 32 candidates at s=128
STREAM_WARMUP = "16x112,16x128,32x128"
# the last frame's confidences against one eager vote over the same
# texts embedded in one call (bf16 rows of other batches)
STREAM_CONF_TOL = PACKED_CONF_TOL
# the score path (phase 11): BASELINE config 2's panel (bench_all.py
# _make_panel(32, 3)) with soft votes (8 top_logprobs) and training-table
# weights (top 16, the prompt embedded at 128 tokens) from 256 table rows;
# 16 requests of 8 candidates of 100-120 words, 8 in flight, prompts of
# 80-110 words; then 4 static-weight requests; judges answer after 20-40 ms
SCORE_JUDGES, SCORE_BACKENDS, SCORE_TOP_LOGPROBS = 32, 3, 8
SCORE_TABLE_ROWS, SCORE_TOP, SCORE_MAX_TOKENS = 256, 16, 128
SCORE_REQUESTS, SCORE_INFLIGHT, SCORE_N = 16, 8, 8
SCORE_STATIC_REQUESTS = 4
SCORE_PROMPT_WORDS, SCORE_JUDGE_MS = (80, 110), (20, 40)
# a final frame's candidate confidences (exact Decimal shares) sum to 1
SCORE_SUM_TOL = 1e-6
# the lookup on the card (f32) against float64 on the host
LOOKUP_F64_TOL = 1e-5
# the prompt embed's dispatch shapes: 16 rows at the sequence buckets the
# prompts fall in (phase 2 holds and times the attention there)
SCORE_ATTENTION_SHAPES = ((16, 96), (16, 112))
# the archive path (phase 12): BASELINE config 4 (bench_all.py:374-402),
# 10,000 archived completions of M = 8 judges and N = 4 candidates from
# seed 0; then the served loop on phase 11's panel: 16 streamed and 4
# unary training-table requests, 8 in flight
ARCHIVE_B, ARCHIVE_M, ARCHIVE_N = 10000, 8, 4
ARCHIVE_STREAMED, ARCHIVE_UNARY = 16, 4
# the device tally (f32) against the exact Decimal host tally and float64:
# absolute on confidences, relative past 1 on choice weights
TALLY_TOL = 1e-6
# learned table rows against embed_texts of the same prompts on the card
LEARN_ROW_TOL = 1e-5
# the learn pass embeds the 20 archived prompts in one dispatch: the embed
# bucket of 32 rows at s=112 (phase 2 holds and times the attention there)
ARCHIVE_ATTENTION_SHAPE = (32, 112)
# traced serving (phase 13): phase 1's bursts (3 x 8 /consensus of N=64
# at s=128) through one server per tracing mode; a 1 s window, so each
# burst of 8 is one R=8 group in every mode (the same bucket, so the
# traced and untraced answers must be bit-equal), half of the traced
# requests carrying a caller's traceparent; the score path's 8 streamed
# and 4 unary requests of phase 11's panel, 8 in flight
TRACED_WINDOW_MS = 1000
TRACED_SCORE_STREAMED, TRACED_SCORE_UNARY = 8, 4
# the reference's bar (tests/test_perfobs.py:478): the named phases of a
# traced request account for >= 90% of its end-to-end latency
PHASE_BAR = 0.9
# traced and untraced answers at different buckets
TRACED_ANSWER_TOL = 1e-6
# judge-side resilience (phase 14): phase 11's panel, 16 streamed and 4
# unary requests, 8 in flight, behind the reference's resilience drive
# (the verify skill's FAULT_PLAN and RESILIENCE_QUORUM) with breakers,
# hedges, a shared retry budget, a default deadline and the splice lane
RESILIENT_STREAMED, RESILIENT_UNARY = 16, 4
RESILIENT_ENV = {
    "HOST_FASTPATH": "1", "RESILIENCE_QUORUM": "0.5",
    "RESILIENCE_BREAKER_THRESHOLD": "0.5", "RESILIENCE_RETRY_BUDGET": "8",
    "RESILIENCE_HEDGE_MILLIS": "150", "RESILIENCE_DEADLINE_MILLIS": "5000",
    "FAULT_PLAN": "seed=7,stall_first=0.35,stall_ms=20000",
}
# a request may outlive its deadline by what runs after the deadline
# fires: the handler's stamp is taken after its body is read, and the
# final frame is built and written once the late judges have failed
RESILIENT_DEADLINE_MARGIN_MS = 2000
# the judges mostly agree, as a panel on an easy question does: each
# names the candidate whose text sorts first with this probability (its
# soft vote peaked there), else a key of its own ballot's hash
RESILIENT_AGREEMENT = 0.8
# phase 15: the offline drive (groups of candidates, in flight), the main
# path's bursts beside it, the learner drill's requests (before the fit,
# at least during it, after the swap; a cap), its ledger's shard size, the
# fit's steps and the card-vs-CPU tolerance on its mean-normalized
# weights, and the trainers' steps, (b, s) and resume tolerance (the
# card's scatter-add backward sums in a run-dependent order)
LEARN_GROUPS, LEARN_N, LEARN_INFLIGHT, LEARN_BURSTS = 64, 8, 4, 2
LEARN_DRILL_BEFORE, LEARN_DRILL_DURING, LEARN_DRILL_AFTER = 24, 16, 4
LEARN_DRILL_MAX = 160
LEARN_ROTATE_BYTES = 4096
LEARN_FIT_STEPS, LEARN_FIT_TOL = 300, 1e-5
LEARN_CHOICES = ("alpha: the answer is four", "beta: the answer is five")
TRAIN_STEPS, TRAIN_RESUME_RTOL = 5, 1e-5
# one bge_micro InfoNCE step, card against CPU: each gradient within
# 1e-4 of the largest gradient plus 1e-3 relative (tests/test_torch_cuda.py
# holds the same)
TRAIN_GRAD_ATOL, TRAIN_GRAD_RTOL = 1e-4, 1e-3
TRAIN_BERT_SHAPE, TRAIN_RM_SHAPE = (16, 128), (8, 128)
# phase 16 (device faults): bge-large served at FAULT_WARMUP / _R; (a) the
# main path's bursts through FAULT_SCRIPT, whose 2nd dispatch is a
# transient retried once and whose 4th-6th are three transients in a row
# (MESH_FAULT_TRANSIENT_RETRIES=2: the third escalates to persistent),
# FAULT_RETRIED re-queues of a burst each; a 1 s window makes each burst
# one group; (b) and (c) N=8 requests in the s=32 bucket (the twin is
# bge-large on the CPU), (b) a hang past the watchdog, (c) a spin of
# FAULT_SPIN_S on the card past its watchdog; (e) a 1 s capture
FAULT_WARMUP, FAULT_WARMUP_R, FAULT_WINDOW_MS = "64x128,8x32", "8", "1000"
FAULT_SCRIPT = "ok|transient|ok|transient|transient|transient|ok"
FAULT_RETRIED = 3
FAULT_SMALL_N, FAULT_SMALL_WORDS = 8, 20
FAULT_WATCHDOG_MS, FAULT_HANG_MS = 2000, 3000
FAULT_WEDGE_WATCHDOG_MS, FAULT_SPIN_S = 1000, 6.0
FAULT_PROFILE_MS, FAULT_STICKY_TIMEOUT_S = 1000, 120
# the gap between a trace window's edges and the traced work
# (``profile_call``; ``analysis/trace_stamps.py`` counts the traces that
# lose a kernel record with and without it)
PROFILE_MARGIN_S = 0.05


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20, replays: int = 10) -> float:
    """Time per call of ``fn`` replayed from a CUDA graph of ``iters``
    calls (CUDA events over ``replays`` replays): the kernels back to
    back with no host time between them, where a short kernel's wrapper
    would otherwise set the pace.  ``fn`` must only launch kernels on the
    current stream into memory it already holds."""
    import torch

    fn()  # the first call sets the kernel's attributes, outside capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# -- phase 2: kernels against their plain versions ---------------------------


def vote_inputs(r, n, d, dtype, seed):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    # clustered rows, as real candidate embeddings are
    center = rng.normal(size=(r, 1, d))
    x = center + 0.5 * rng.normal(size=(r, n, d))
    return torch.tensor(x, dtype=dtype, device="cuda")


def vote_case(r, n, d, dtype, temp, n_valid, route, seed) -> float:
    """One wrapper call held to its route (by ``cosine_vote.routes``),
    to the plan's shared memory as the kernel computes it (cluster), and
    to the plain version: max |diff| <= VOTE_TOL, finite, sums 1 +- 1e-5,
    rows past n_valid exactly 0, n_valid = 1 exactly 1."""
    import torch

    from llm_weighted_consensus_tpu_torch.ops import _build, kernels

    what = f"vote r={r} n={n} d={d} n_valid={n_valid} {dtype} T={temp}"
    if kernels.vote_route(r, n, d, dtype) != route:
        raise AssertionError(f"{what}: route is not {route}")
    if route == "cluster":
        plan = kernels.vote_plan(r, n, d, dtype)
        kernel_smem = _build.library().lwc_cosine_vote_cluster_smem(
            n, plan.cols, plan.cluster, 0 if dtype == torch.float32 else 1)
        if kernel_smem != plan.smem_bytes:
            raise AssertionError(f"{what}: plan {plan}, kernel {kernel_smem}")
    emb = vote_inputs(r, n, d, dtype, seed)
    before = kernels.cosine_vote.routes[route]
    got = kernels.cosine_vote(emb, n_valid, temp)
    if kernels.cosine_vote.routes[route] != before + 1:
        raise AssertionError(f"{what}: not launched on route {route}")
    want = kernels.cosine_vote_plain(emb, n_valid, temp)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    sums = got.sum(-1)
    if (not torch.isfinite(got).all()
            or (sums - 1).abs().max().item() > 1e-5
            or (got[:, n_valid:] != 0).any()
            or (n_valid == 1 and (got[:, 0] != 1).any())):
        raise AssertionError(f"{what}: bad output")
    if err > VOTE_TOL:
        raise AssertionError(f"{what}: max|diff| {err} > {VOTE_TOL}")
    return err


def vote_launchers(emb, n, counts=None):
    """The two vote kernels on ``emb`` through their C entries (T =
    0.05): ``cluster(c, cols)`` with any partition, ``block()``; with
    ``counts`` (int32 [R] on the card) a count per request, else ``n``
    for every request."""
    import torch

    from llm_weighted_consensus_tpu_torch.ops import _build

    lib = _build.library()
    r, width, d = emb.shape
    conf = torch.empty((r, width), dtype=torch.float32, device="cuda")
    dtype = 0 if emb.dtype == torch.float32 else 1
    ptr = None if counts is None else counts.data_ptr()

    def cluster(c, cols):
        _build.check(lib.lwc_cosine_vote_cluster(
            emb.data_ptr(), conf.data_ptr(), r, width, d, n, ptr, 0.05,
            dtype, c, cols, torch.cuda.current_stream().cuda_stream),
            "lwc_cosine_vote_cluster")
        return conf

    def block():
        _build.check(lib.lwc_cosine_vote(
            emb.data_ptr(), conf.data_ptr(), r, width, d, n, ptr, 0.05,
            dtype, torch.cuda.current_stream().cuda_stream),
            "lwc_cosine_vote")
        return conf

    return cluster, block


def vote_device_times(cluster, block, iters: int = 20) -> dict:
    """Device ms per launch of the cluster and the block kernel, and of
    the shortest kernel, in one profile of ``iters`` rounds of both
    kernels and a one-float fill (the floor any launch pays)."""
    import torch

    one = torch.empty(1, device="cuda")
    names = ("cosine_vote_cluster_kernel", "cosine_vote_kernel")

    def rounds():
        for _ in range(iters):
            cluster()
            block()
            one.zero_()

    rows, _, traces = profile_call(
        rounds,
        lambda rows: all(launches_of(rows, k) == iters for k in names),
        tries=5,
    )
    per = {}
    for name in names:
        count = launches_of(rows, name)
        if count != iters:
            raise AssertionError(
                f"{name}: {count} of {iters} launches in {traces} traces")
        per[name] = sum(ms for ms, _, key in rows
                        if port_kernel(key) == name) / count
    return {
        "device_ms": per[names[0]], "previous_device_ms": per[names[1]],
        "launch_floor_ms": min(ms / count for ms, count, _ in rows),
        "launch_floor_kernel": min(rows, key=lambda r: r[0] / r[1])[2][:80],
    }


def vote_cluster_sweep(r, n, d) -> list:
    """The cluster kernel at [r, n, d] f32 with every cluster size C
    whose blocks fit: time per launch replayed from a CUDA graph, max
    |diff| against the plain version.  ``vote_plan``'s choice of C per R
    rests on this turn."""
    import torch

    from llm_weighted_consensus_tpu_torch.ops import kernels

    emb = vote_inputs(r, n, d, torch.float32, seed=r + n)
    cluster, _ = vote_launchers(emb, n)
    want = kernels.cosine_vote_plain(emb, n, 0.05)
    sweep = []
    for c in (1, 2, 4, 8, 16):
        cols = -(-d // c)
        cols += -cols % kernels.VOTE_COL_ALIGN
        smem = kernels.vote_smem_bytes(n, cols, c, torch.float32)
        if smem > kernels.VOTE_SMEM_LIMIT:
            sweep.append({"cluster": c, "cols": cols, "smem_bytes": smem,
                          "fits": False})
            continue
        err = (cluster(c, cols) - want).abs().max().item()
        if err > VOTE_TOL:
            raise AssertionError(f"vote C={c} [{r}, {n}, {d}]: {err}")
        sweep.append({
            "cluster": c, "cols": cols, "smem_bytes": smem, "fits": True,
            "graph_ms": graph_ms(lambda: cluster(c, cols)),
            "max_abs_err": err,
        })
    return sweep


def time_vote(gpu, r, n, d) -> dict:
    """At [r, n, d] f32: the wrapper (events), the cluster kernel's and
    the block kernel's device time per launch in one profile with the
    launch floor, both kernels replayed from a CUDA graph, the block
    kernel by events, the plain version, and the sweep of C."""
    import torch

    from llm_weighted_consensus_tpu_torch.ops import kernels

    emb = vote_inputs(r, n, d, torch.float32, seed=r + n)
    plan = kernels.vote_plan(r, n, d, torch.float32)
    cluster, block = vote_launchers(emb, n)
    ms = time_ms(lambda: kernels.cosine_vote(emb, n, 0.05), iters=200)
    plain = time_ms(lambda: kernels.cosine_vote_plain(emb, n, 0.05), iters=50)
    previous = time_ms(block, iters=200)
    times = vote_device_times(lambda: cluster(plan.cluster, plan.cols), block)
    times["graph_ms"] = graph_ms(lambda: cluster(plan.cluster, plan.cols))
    times["previous_graph_ms"] = graph_ms(block)
    # reads each input once, writes conf; three passes of 2 r n d FLOPs
    # (norms, column sum, dots) plus the self terms
    bound, by = bound_ms(r * n * d * 4 + r * n * 4, 8.0 * r * n * d, "float32")
    row = {
        "phase": "kernel_timing", "kernel": "cosine_vote", "gpu": gpu,
        "shape": [r, n, d], "dtype": "float32", "route": "cluster",
        "plan": plan._asdict(), "kernel_ms": ms, **times,
        "previous_ms": previous, "plain_ms": plain, "bound_ms": bound,
        "bound_by": by, "library_ms": None,
        "cluster_sweep": vote_cluster_sweep(r, n, d),
    }
    emit(row)
    return row


def check_vote(gpu: str) -> dict:
    import torch

    from llm_weighted_consensus_tpu_torch.ops import kernels

    f32, bf16 = torch.float32, torch.bfloat16
    routes0 = dict(kernels.cosine_vote.routes)
    # the main path votes [1, 64], [8, 64] and [1, 16] f32 embeddings;
    # N=2 and N=256 are the gateway's limits, R=16 the batcher's
    errs = []
    for r in (1, BURST, 16):
        for n in (2, LONG_N, N_CANDIDATES, 256):
            for dtype in (f32, bf16):
                for temp in (0.05, 0.7):
                    errs.append(vote_case(r, n, 1024, dtype, temp, n,
                                          "cluster", seed=r * 1000 + n))
    # bge-small and bge-base widths, bge_micro's, and a ragged D
    for d in (384, 768):
        for r in (1, BURST, 16):
            for n in (2, N_CANDIDATES, 256):
                for dtype in (f32, bf16):
                    errs.append(vote_case(r, n, d, dtype, 0.05, n, "cluster",
                                          seed=d + r * 1000 + n))
    for r, n, d in ((4, 64, 64), (3, 37, 1000), (2, 9, 100)):
        for dtype in (f32, bf16):
            errs.append(vote_case(r, n, d, dtype, 0.3, n, "cluster", seed=d))
    # padding rows on the cluster route, n_valid = 1 among them
    for r, n, d, n_valid in ((BURST, 64, 1024, 50), (16, 40, 384, 33),
                             (1, 256, 768, 1), (2, 64, 1000, 63)):
        for dtype in (f32, bf16):
            errs.append(vote_case(r, n, d, dtype, 0.05, n_valid, "cluster",
                                  seed=n_valid))
    # past the plan's shared memory: the block route, both dtypes
    for dtype in (f32, bf16):
        for n_valid in (1024, 700):
            errs.append(vote_case(2, 1024, 2048, dtype, 0.05, n_valid,
                                  "block", seed=n_valid))
    # rows off 16-byte alignment: the kernel's element-wise copy
    for dtype in (f32, bf16):
        emb = vote_inputs(BURST, 64, 1024, dtype, seed=5)
        flat = torch.empty(emb.numel() + 1, dtype=dtype, device="cuda")
        view = flat[1:].view(emb.shape)
        view.copy_(emb)
        got = kernels.cosine_vote(view, 64, 0.05)
        err = (got - kernels.cosine_vote_plain(emb, 64, 0.05)).abs().max()
        if err.item() > VOTE_TOL:
            raise AssertionError(f"vote unaligned {dtype}: {err.item()}")
        errs.append(err.item())
    # n_valid < N gives the same vote as the sliced input
    emb = vote_inputs(8, 64, 1024, f32, seed=7)
    got = kernels.cosine_vote(emb, 50, 0.05)
    want = kernels.cosine_vote(emb[:, :50].contiguous(), 50, 0.05)
    torch.cuda.synchronize()
    pad_err = max(
        (got[:, :50] - want).abs().max().item(),
        got[:, 50:].abs().max().item(),
    )
    if pad_err > VOTE_TOL:
        raise AssertionError(f"vote n_valid padding: max|diff| {pad_err}")
    # two calls, bit-equal outputs
    for r, n, d, dtype in ((BURST, 64, 1024, f32), (16, 256, 1024, bf16),
                           (1, 256, 768, f32)):
        emb = vote_inputs(r, n, d, dtype, seed=n + d)
        first = kernels.cosine_vote(emb, n, 0.05)
        second = kernels.cosine_vote(emb, n, 0.05)
        if not torch.equal(first, second):
            raise AssertionError(f"vote [{r}, {n}, {d}] {dtype}: two calls "
                                 "differ")
    routes = {k: v - routes0[k] for k, v in kernels.cosine_vote.routes.items()}
    # the main path's shape, then a lone request; the sweep of C at the
    # batcher's other powers of two
    timed = [time_vote(gpu, BURST, N_CANDIDATES, 1024),
             time_vote(gpu, 1, N_CANDIDATES, 1024)]
    for r in (2, 4, 16):
        emit({"phase": "kernel_timing", "kernel": "cosine_vote", "gpu": gpu,
              "shape": [r, N_CANDIDATES, 1024], "dtype": "float32",
              "plan": kernels.vote_plan(r, N_CANDIDATES, 1024, f32)._asdict(),
              "cluster_sweep": vote_cluster_sweep(r, N_CANDIDATES, 1024)})
    row = {
        "phase": "kernel", "kernel": "cosine_vote", "gpu": gpu,
        "cases": len(errs), "routes": routes, "max_abs_err": max(errs),
        "tolerance": VOTE_TOL, "pad_err": pad_err, "bit_equal_calls": 3,
        **{k: timed[0][k] for k in (
            "shape", "dtype", "kernel_ms", "device_ms", "previous_ms",
            "previous_device_ms", "launch_floor_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")},
        "lone_request": {k: timed[1][k] for k in (
            "shape", "kernel_ms", "device_ms", "previous_ms",
            "previous_device_ms", "launch_floor_ms", "bound_ms")},
    }
    emit(row)
    return row


def stream_counts(r, cap, seed):
    """Counts of live rows per request, mixed: the first request 1, the
    last ``cap`` (a lone request takes 1 or ``cap`` by seed)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    counts = rng.integers(1, cap + 1, r)
    counts[0] = 1 if r > 1 or seed % 2 else cap
    counts[-1] = cap if r > 1 else counts[0]
    return torch.tensor(counts, dtype=torch.int32, device="cuda")


def vote_counts_case(r, cap, d, dtype, counts, route, seed) -> float:
    """One call with a count per request, held to the plain version
    (max |diff| <= VOTE_TOL), finite, each live request summing to 1 +-
    1e-5, rows at and past its count exactly 0, a count of 1 exactly 1.
    ``cluster`` goes through the wrapper (held to its route); ``block``
    through the block kernel's C entry at the same shape."""
    import torch

    from llm_weighted_consensus_tpu_torch.ops import kernels

    what = (f"vote counts r={r} cap={cap} d={d} {dtype} {route} "
            f"{counts.tolist()}")
    emb = vote_inputs(r, cap, d, dtype, seed)
    if route == "cluster":
        if kernels.vote_route(r, cap, d, dtype) != "cluster":
            raise AssertionError(f"{what}: route is not cluster")
        before = kernels.cosine_vote.routes["cluster"]
        got = kernels.cosine_vote(emb, counts, 0.05)
        if kernels.cosine_vote.routes["cluster"] != before + 1:
            raise AssertionError(f"{what}: not launched on route cluster")
    else:
        _, block = vote_launchers(emb, cap, counts)
        got = block()
    want = kernels.cosine_vote_plain(emb, counts, 0.05)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    rows = torch.arange(cap, device="cuda")[None, :]
    live = rows < counts.clamp(0, cap)[:, None].long()
    sums = got.sum(-1)
    ones = counts == 1
    if (not torch.isfinite(got).all()
            or (got[~live] != 0).any()
            or ((sums - 1).abs() > 1e-5)[counts > 0].any()
            or (ones.any() and (got[ones, 0] != 1).any())):
        raise AssertionError(f"{what}: bad output")
    if err > VOTE_TOL:
        raise AssertionError(f"{what}: max|diff| {err} > {VOTE_TOL}")
    return err


def check_vote_counts(gpu: str) -> dict:
    """The vote with a count per request (the streaming consensus: one
    dispatch holds streams of different lengths) on both routes against
    the plain version; the scalar count bit-equal to a tensor of equal
    counts on both routes; a count of 0 gives zeros; then the wrapper at
    the multichat path's shape, [8, 32, 1024] f32 with mixed counts."""
    import torch

    from llm_weighted_consensus_tpu_torch.ops import kernels

    f32, bf16 = torch.float32, torch.bfloat16
    routes0 = dict(kernels.cosine_vote.routes)
    errs = []
    for r in STREAM_RS:
        for cap in STREAM_CAPS:
            for dtype in (f32, bf16):
                for route in ("cluster", "block"):
                    seed = r * 1000 + cap
                    cases = [stream_counts(r, cap, seed)]
                    if r == 1:  # a lone request at both ends
                        cases.append(stream_counts(r, cap, seed + 1))
                    for counts in cases:
                        errs.append(vote_counts_case(
                            r, cap, 1024, dtype, counts, route, seed))
    # the wrapper's block route (past the plan's shared memory) with counts
    for dtype in (f32, bf16):
        counts = torch.tensor([700, 1], dtype=torch.int32, device="cuda")
        emb = vote_inputs(2, 1024, 2048, dtype, seed=3)
        before = kernels.cosine_vote.routes["block"]
        got = kernels.cosine_vote(emb, counts, 0.05)
        if kernels.cosine_vote.routes["block"] != before + 1:
            raise AssertionError("vote counts [2, 1024, 2048]: not block")
        err = (got - kernels.cosine_vote_plain(emb, counts, 0.05)).abs().max()
        if err.item() > VOTE_TOL or (got[0, 700:] != 0).any():
            raise AssertionError(f"vote counts block wrapper: {err.item()}")
        errs.append(err.item())
    # the scalar count against a tensor of equal counts, bit for bit, and
    # a count of 0, on both routes
    for dtype in (f32, bf16):
        emb = vote_inputs(BURST, 64, 1024, dtype, seed=17)
        plan = kernels.vote_plan(BURST, 64, 1024, dtype)
        for n in (1, 40, 64):
            same = torch.full((BURST,), n, dtype=torch.int32, device="cuda")
            for label, pick in (("cluster", 0), ("block", 1)):
                scalar = vote_launchers(emb, n)[pick]
                vector = vote_launchers(emb, n, same)[pick]
                call = ((lambda f: f(plan.cluster, plan.cols))
                        if label == "cluster" else (lambda f: f()))
                a, b = call(scalar).clone(), call(vector).clone()
                if not torch.equal(a, b):
                    raise AssertionError(
                        f"vote {label} {dtype} n={n}: the scalar count and "
                        "a vector of it differ")
        zero = torch.tensor([0, 64, 5] + [64] * (BURST - 3),
                            dtype=torch.int32, device="cuda")
        for label, pick in (("cluster", 0), ("block", 1)):
            launch = vote_launchers(emb, 64, zero)[pick]
            got = (launch(plan.cluster, plan.cols) if label == "cluster"
                   else launch())
            torch.cuda.synchronize()
            if (got[0] != 0).any() or (got[2, 5:] != 0).any():
                raise AssertionError(f"vote {label} {dtype}: count 0 or 5 "
                                     "left live rows")
    routes = {k: v - routes0[k] for k, v in kernels.cosine_vote.routes.items()}
    # the multichat path's dispatch shape: 8 streams of capacity 32
    r, cap, d = STREAM_INFLIGHT, 32, 1024
    emb = vote_inputs(r, cap, d, f32, seed=23)
    counts = stream_counts(r, cap, seed=23)
    live = int(counts.sum().item())
    ms = time_ms(lambda: kernels.cosine_vote(emb, counts, 0.05), iters=200)
    plain = time_ms(lambda: kernels.cosine_vote_plain(emb, counts, 0.05),
                    iters=50)
    device = device_ms_per_launch(
        lambda: kernels.cosine_vote(emb, counts, 0.05),
        "cosine_vote_cluster_kernel")
    # this data's work: the live rows read once, the counts read, conf
    # written; three passes of 2 FLOPs per live element and the self terms
    bound, by = bound_ms(live * d * 4 + r * 4 + r * cap * 4, 8.0 * live * d,
                         "float32")
    row = {
        "phase": "kernel", "kernel": "cosine_vote", "variant": "counts",
        "gpu": gpu, "cases": len(errs), "routes": routes,
        "max_abs_err": max(errs), "tolerance": VOTE_TOL,
        "scalar_bit_equal": True, "shape": [r, cap, d], "dtype": "float32",
        "counts": counts.tolist(), "kernel_ms": ms, "device_ms": device,
        "plain_ms": plain, "bound_ms": bound, "bound_by": by,
        "library_ms": None,
    }
    emit(row)
    return row


def attention_inputs(b, s, nh, hd, dtype, seed):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    q, k, v = (
        torch.tensor(rng.normal(size=(b, s, nh, hd)), dtype=dtype,
                     device="cuda")
        for _ in range(3)
    )
    lengths = rng.integers(1, s + 1, size=b)
    lengths[0] = s
    mask = np.arange(s)[None, :] < lengths[:, None]
    mask[-1, :] = False  # one row whose keys are all padding
    bias = torch.tensor(
        np.where(mask, 0.0, -1e9), dtype=torch.float32, device="cuda"
    )
    return q, k, v, bias


def attention_err(q, k, v, bias, scale, route, what: str):
    """(max |kernel - plain|, all-pad row's distance from the mean of v)
    of one ``attention`` call, which must take ``route``; fails past
    ``ATTN_TOL`` or on non-finite output."""
    import torch

    from llm_weighted_consensus_tpu_torch.ops import attention as attn

    name = str(q.dtype).split(".")[-1]
    before = dict(attn.attention.routes)
    got = attn.attention(q, k, v, bias, scale)
    want = attn.attention_plain(q, k, v, bias, scale)
    torch.cuda.synchronize()
    taken = [r for r, n in attn.attention.routes.items() if n != before[r]]
    if taken != [route]:
        raise AssertionError(f"attention {what}: took {taken}, not {route}")
    err = (got.float() - want.float()).abs().max().item()
    if not torch.isfinite(got).all() or err > ATTN_TOL[name]:
        raise AssertionError(
            f"attention {what} {name}: max|diff| {err} > {ATTN_TOL[name]}"
        )
    # the all-padding row is the uniform average of v
    uniform = v[-1].float().mean(dim=0)
    u_err = (got[-1].float() - uniform[None]).abs().max().item()
    if u_err > ATTN_TOL[name]:
        raise AssertionError(f"attention all-pad row {what} {name}: {u_err}")
    return err, u_err


def check_attention(gpu: str) -> dict:
    import torch
    import torch.nn.functional as F

    from llm_weighted_consensus_tpu_torch.ops import attention as attn

    nh, hd = 16, 64
    scale = hd ** -0.5
    rows = []
    # every [b, s] the main path dispatches at bge-large width: one
    # /consensus request of 64 candidates at s=128 (the warm-up), 8 such
    # requests coalesced (the bursts), 16 candidates in the s=512 bucket
    # and the /embeddings batch of 32 texts at s=64
    for b, s in (MAIN_PATH_ATTENTION_SHAPES + (STREAM_ATTENTION_SHAPE,)
                 + SCORE_ATTENTION_SHAPES + (ARCHIVE_ATTENTION_SHAPE,)):
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            q, k, v, bias = attention_inputs(b, s, nh, hd, dtype, seed=b + s)
            route = "tma" if dtype == torch.bfloat16 else "fma"
            err, u_err = attention_err(q, k, v, bias, scale, route,
                                       f"b={b} s={s} {name}")
            ms = time_ms(lambda: attn.attention(q, k, v, bias, scale))
            plain = time_ms(
                lambda: attn.attention_plain(q, k, v, bias, scale), iters=5
            )
            qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
            mask4 = bias[:, None, None, :].to(dtype)
            lib = time_ms(
                lambda: F.scaled_dot_product_attention(
                    qh, kh, vh, attn_mask=mask4, scale=scale
                )
            )
            item = q.element_size()
            nbytes = 4 * b * s * nh * hd * item + b * s * 4
            bound, by = bound_ms(nbytes, 4.0 * b * nh * s * s * hd, name)
            row = {
                "phase": "kernel", "kernel": "attention", "gpu": gpu,
                "shape": [b, s, nh, hd], "dtype": name, "route": route,
                "max_abs_err": err, "all_pad_row_err": u_err,
                "tolerance": ATTN_TOL[name], "kernel_ms": ms,
                "plain_ms": plain, "library_ms": lib, "bound_ms": bound,
                "bound_by": by,
            }
            if route == "tma":
                # the mma.sync kernel this route replaced, same inputs,
                # both through the same launch code; and each kernel's
                # device time alone, which the small shapes need: there
                # the wrapper's host time per call exceeds the kernel's
                def tma():
                    return attn._launch("lwc_attention_tma", q, k, v, bias,
                                        scale)

                def mma():
                    return attn._launch("lwc_attention", q, k, v, bias, scale)

                row.update({
                    "launch_ms": time_ms(tma),
                    "device_ms": device_ms_per_launch(
                        tma, "attention_tma_kernel"),
                    "previous_ms": time_ms(mma),
                    "previous_device_ms": device_ms_per_launch(
                        mma, "attention_mma_kernel"),
                })
            emit(row)
            rows.append(row)
    # the TMA route at ragged s, bge-large's 16 heads of 64
    worst = {}
    for b, s in ATTN_RAGGED:
        q, k, v, bias = attention_inputs(b, s, nh, hd, torch.bfloat16, seed=s)
        worst[f"tma-s{s}"], _ = attention_err(q, k, v, bias, scale, "tma",
                                              f"ragged b={b} s={s}")
    # the other routes at small ragged shapes: bf16 hd 16/32 take the
    # mma.sync kernel, bf16 hd 24 and an unaligned strided view the FMA
    # kernel, f32 always the FMA kernel (and bf16 hd 64 the TMA route, a
    # head-major view too)
    for hd in (16, 24, 32, 64):
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            q, k, v, bias = attention_inputs(5, 77, 4, hd, dtype, seed=hd)
            route = ("fma" if dtype == torch.float32 or hd == 24
                     else "tma" if hd == 64 else "mma")
            cases = [(q, k, v, route, route)]
            if hd == 64:
                # every row start off 16-byte alignment
                wide = torch.zeros(5, 77, 4, hd + 1, dtype=dtype, device="cuda")
                views = []
                for t in (q, k, v):
                    w = wide.clone()
                    w[..., :hd] = t
                    views.append(w[..., :hd])
                cases.append((*views, "fma", "fma"))
                if dtype == torch.bfloat16:
                    # [b, nh, s, hd] storage seen as [b, s, nh, hd]
                    cases.append((*(t.transpose(1, 2).contiguous()
                                    .transpose(1, 2) for t in (q, k, v)),
                                  "tma", "tma-head-major"))
            for qq, kk, vv, route, label in cases:
                key = f"{name}-hd{hd}-{label}"
                err, _ = attention_err(qq, kk, vv, bias, hd ** -0.5, route, key)
                worst[key] = max(worst.get(key, 0), err)
    emit({"phase": "kernel", "kernel": "attention", "gpu": gpu,
          "paths": "TMA at ragged s; hd 16/24/32/64, bf16/f32, aligned, "
                   "strided and head-major, each on its route",
          "max_abs_err": worst})
    rows.append({"max_abs_err": max(worst.values())})
    return {"rows": rows}


def quant_operands(m, k, n, int4, dtype, seed):
    """Hidden-state-like rows (one all zero) and bge-like weights
    N(0, 0.02), quantized by the port's own ``models.quant``."""
    import torch

    from llm_weighted_consensus_tpu_torch.models import quant

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
    x[0] = 0
    w = torch.randn(n, k, generator=gen, device="cuda") * 0.02
    wq, sw = (quant.quantize_weight_int4 if int4 else quant.quantize_weight)(w)
    bias = torch.randn(n, generator=gen, device="cuda") * 0.02
    return x, w, wq, sw, bias


def quant_err(got, want, what: str, dtype: str) -> float:
    """max |diff|; fails where |diff| > tol * (1 + |want|) anywhere."""
    import torch

    diff = (got.float() - want.float()).abs()
    rel = (diff / (1 + want.float().abs())).max().item()
    if not torch.isfinite(got).all() or rel > QUANT_TOL[dtype]:
        raise AssertionError(
            f"{what}: max |diff| / (1 + |want|) {rel} > {QUANT_TOL[dtype]}"
        )
    return diff.max().item()


def gemm_entry(entry, xq, w, sx, sw, bias, out, k, kp, gelu):
    """One checked launch of a GEMM entry point of the kernel library
    (``lwc_quant_matmul`` or ``lwc_quant_matmul_tma``) on quantised rows,
    into ``out``; a uint8 ``w`` is the packed int4 weight."""
    import torch

    from llm_weighted_consensus_tpu_torch.ops import _build

    m, n = out.shape
    _build.check(getattr(_build.library(), entry)(
        xq.data_ptr(), w.data_ptr(), sx.data_ptr(), sw.data_ptr(),
        bias.data_ptr(), out.data_ptr(), m, n, k, kp,
        int(w.dtype == torch.uint8), int(gelu),
        0 if out.dtype == torch.float32 else 1,
        torch.cuda.current_stream().cuda_stream,
    ), entry)
    return out


def time_quant(gpu, name, x, w, wq, sw, bias, kp, gelu) -> dict:
    """One quantized matmul at a main-path shape, bf16: the kernel (row
    quantisation included), the row quantisation alone, the plain
    versions, the yardsticks and the bounds; also the GEMM alone on its
    TMA route and on the mma.sync route it replaced, and for W4A8 the
    W8A8 TMA GEMM on the unpacked weight (the same product)."""
    import torch
    import torch.nn.functional as F

    from llm_weighted_consensus_tpu_torch.ops import kernels

    fn, plain = getattr(kernels, name), getattr(kernels, name + "_plain")
    m, k = x.shape
    n = w.shape[0]
    wb, bb = w.to(torch.bfloat16), bias.to(torch.bfloat16)
    xq, sx = kernels.quantize_rows(x, kp)
    int4 = wq.dtype == torch.uint8
    w8 = kernels.unpack_int4_weights(wq, k) if int4 else wq
    bound, by = bound_ms_ops(
        2 * m * k + wq.numel() + 8 * n + 2 * m * n, 2.0 * m * n * k
    )
    out = torch.empty(m, n, dtype=x.dtype, device="cuda")

    def gemm(entry, act, xq_r, sx_r, weight=wq):
        return gemm_entry(entry, xq_r, weight, sx_r, sw, bias, out, k, kp,
                          act)

    # the GEMM alone on each route, on the same quantised rows: the TMA
    # route the wrapper takes and the mma.sync route it replaced; and the
    # replaced route's whole call, row quantisation then GEMM
    runs = {
        "tma": lambda: gemm("lwc_quant_matmul_tma", gelu, xq, sx),
        "mma": lambda: gemm("lwc_quant_matmul", gelu, xq, sx),
        "mma_call": lambda: gemm("lwc_quant_matmul", gelu,
                                 *kernels.quantize_rows(x, kp)),
    }
    if gelu:
        # what the GELU costs the TMA route's epilogue
        runs["tma_without_gelu"] = lambda: gemm(
            "lwc_quant_matmul_tma", False, xq, sx)
    if int4:
        # the W8A8 TMA GEMM on the unpacked weight: what the unpacking
        # costs against the product it feeds
        runs["w8a8_tma"] = lambda: gemm("lwc_quant_matmul_tma", gelu, xq,
                                        sx, w8)
    routes = {route: time_ms(run) for route, run in runs.items()}
    q_bound, q_by = bound_ms(2 * m * k + m * kp + 4 * m, 2.0 * m * k, "float32")
    # the GEMM alone: the int8 rows and their scales in, no bf16 x (W4:
    # the packed weight)
    g_bound, g_by = bound_ms_ops(
        m * kp + 4 * m + wq.numel() + 8 * n + 2 * m * n, 2.0 * m * n * k
    )
    row = {
        "phase": "kernel", "kernel": name, "gpu": gpu, "shape": [m, k, n],
        "gelu": gelu, "dtype": "bfloat16",
        "kernel_ms": time_ms(lambda: fn(x, wq, sw, bias, gelu=gelu)),
        "quantize_rows_ms": time_ms(lambda: kernels.quantize_rows(x, kp)),
        "quantize_rows_plain_ms": time_ms(
            lambda: kernels.quantize_rows_plain(x, kp), iters=3, warmup=1
        ),
        "quantize_rows_bound_ms": q_bound, "quantize_rows_bound_by": q_by,
        "plain_ms": time_ms(
            lambda: plain(x, wq, sw, bias, gelu=gelu), iters=3, warmup=1
        ),
        "bound_ms": bound, "bound_by": by, "library_ms": None,
        "bf16_linear_ms": time_ms(lambda: F.linear(x, wb, bb)),
        "int_mm_ms": time_ms(lambda: torch._int_mm(xq[:, :k], w8.t())),
        "route": "tma", "gemm_ms": routes["tma"],
        "gemm_bound_ms": g_bound, "gemm_bound_by": g_by,
        "previous_gemm_ms": routes["mma"], "previous_ms": routes["mma_call"],
    }
    if gelu:
        row["gemm_without_gelu_ms"] = routes["tma_without_gelu"]
    if int4:
        row["w8a8_gemm_ms"] = routes["w8a8_tma"]
    emit(row)
    return row


def check_quant(gpu: str) -> dict:
    """W8A8 and W4A8 against their plain versions (and the row
    quantisation byte for byte, and W4A8's TMA route against its mma.sync
    route byte for byte) at the main path's shapes and odd ones, bf16 and
    f32, GELU on and off; times at the main shapes in bf16."""
    import torch

    from llm_weighted_consensus_tpu_torch.ops import kernels

    worst = {"w8a8_matmul": 0.0, "w4a8_matmul": 0.0}
    worst_by_route = {}
    rows, cases, w4_equal = [], 0, 0
    # (M, K, N, the main path's GELU flag, or None at an odd shape)
    shapes = [(QUANT_M, k, n, gelu) for k, n, gelu in QUANT_MAIN_SHAPES]
    shapes += [(QUANT_SMALL_M, k, n, None) for k, n, _ in QUANT_MAIN_SHAPES]
    # the reward model's shapes (phase 8), timed too
    shapes += [(m, k, n, gelu) for m in RM_QUANT_M
               for k, n, gelu in RM_QUANT_SHAPES]
    shapes += [(m, k, n, None) for m, k, n in QUANT_ODD_SHAPES]
    for (m, k, n, main_gelu), int4, dtype in itertools.product(
        shapes, (False, True), (torch.bfloat16, torch.float32)
    ):
        name = "w4a8_matmul" if int4 else "w8a8_matmul"
        wrapper = getattr(kernels, name)
        dname = str(dtype).split(".")[-1]
        route = "mma" if not int4 and k % 16 else "tma"
        x, w, wq, sw, bias = quant_operands(m, k, n, int4, dtype, m + k + n)
        kp = 2 * wq.shape[1] if int4 else -(-k // 64) * 64
        for gelu in (False, True):
            before = dict(wrapper.routes)
            got = wrapper(x, wq, sw, bias, gelu=gelu)
            want = getattr(kernels, name + "_plain")(x, wq, sw, bias, gelu=gelu)
            torch.cuda.synchronize()
            what = f"{name} m={m} k={k} n={n} {dname} gelu={gelu}"
            taken = [r for r, c in wrapper.routes.items() if c != before[r]]
            if taken != [route]:
                raise AssertionError(f"{what}: took {taken}, not {route}")
            err = quant_err(got, want, what, dname)
            if int4:
                # the same int32 sums and the shared epilogue: the mma.sync
                # route's bytes, on the same quantised rows
                xq, sx = kernels.quantize_rows(x, kp)
                mma = gemm_entry("lwc_quant_matmul", xq, wq, sx, sw, bias,
                                 torch.empty_like(got), k, kp, gelu)
                torch.cuda.synchronize()
                if not torch.equal(got, mma):
                    raise AssertionError(
                        f"{what}: the TMA route is not byte-equal to the "
                        "mma.sync route"
                    )
                w4_equal += 1
            worst[name] = max(worst[name], err)
            worst_by_route[f"{name}-{route}"] = max(
                worst_by_route.get(f"{name}-{route}", 0.0), err
            )
            cases += 1
        xq, sx = kernels.quantize_rows(x, kp)
        pq, ps = kernels.quantize_rows_plain(x, kp)
        torch.cuda.synchronize()
        if not (torch.equal(xq, pq) and torch.equal(sx, ps)):
            raise AssertionError(
                f"quantize_rows m={m} k={k} {dname}: not byte-equal to its "
                "plain version"
            )
        if main_gelu is not None and dtype == torch.bfloat16:
            rows.append(
                time_quant(gpu, name, x, w, wq, sw, bias, kp, main_gelu)
            )
    emit({"phase": "kernel", "kernel": "w8a8_matmul+w4a8_matmul",
          "gpu": gpu, "cases": cases, "max_abs_err": worst,
          "max_abs_err_by_route": worst_by_route, "tolerance": QUANT_TOL,
          "w4a8_tma_byte_equal_to_mma": w4_equal,
          "shapes": [[m, k, n] for m in (QUANT_M, QUANT_SMALL_M)
                     for k, n, _ in QUANT_MAIN_SHAPES]
          + [[m, k, n] for m in RM_QUANT_M for k, n, _ in RM_QUANT_SHAPES]
          + [list(shape) for shape in QUANT_ODD_SHAPES],
          "note": "library_ms null: no one PyTorch call quantises, "
                  "multiplies and dequantises; int_mm_ms is torch._int_mm "
                  "on pre-quantised operands, the int32 product only"})
    return {"rows": rows, "worst": worst}


def segment_ids_for(b, s, seed, hard=False):
    """Packed rows of segment ids [b, s] int32: segments of the mixed
    traffic's lengths (a few to a few hundred tokens) laid end to end,
    pad tails; ``hard`` adds an all-pad row, one-token segments, a
    segment straddling the 64-row edge, one straddling the 128-key tile
    edge (with an id out of order), one starting past 64 and, in a third
    row, negative ids (pad slots to the reference)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    seg = np.zeros((b, s), np.int32)
    for r in range(b):
        off, slot = 0, 1
        while off < s - 8:
            n = int(min(rng.choice([rng.integers(6, 22), rng.integers(26, 70),
                                    rng.integers(98, 200)], p=[.6, .3, .1]),
                        s - 4 - off))
            seg[r, off: off + n] = slot
            off, slot = off + n, slot + 1
    if hard:
        seg[0] = 0
        if b > 1:
            seg[1] = 0
            seg[1, :3] = [1, 2, 3]
            if s > 70:
                seg[1, 60:70] = 4
                seg[1, s - 3:] = 5
            if s > 143:
                seg[1, 120:140] = 6
        if b > 2:
            seg[2, 5:9] = -2
            seg[2, s - 2:] = -1
    return seg


def segment_bound(seg, nh, hd, itemsize):
    """The least time of one segment-attention call on these ids: q/k/v
    read and out written once, the ids read once; the operations this
    data needs, 4 len^2 hd per segment and head (QK^T and PV over its own
    keys) and one mean of v per head for a row with pad slots."""
    import numpy as np

    b, s = seg.shape
    ops = 0.0
    for row in seg:
        ids, counts = np.unique(row, return_counts=True)
        ops += 4.0 * nh * hd * float((counts[ids > 0].astype(np.float64) ** 2).sum())
        if (row <= 0).any():
            ops += 2.0 * nh * hd * s
    nbytes = 4 * b * s * nh * hd * itemsize + 4 * b * s
    dtype = "bfloat16" if itemsize == 2 else "float32"
    bound, by = bound_ms(nbytes, ops, dtype)
    return bound, by, ops, 4.0 * b * nh * s * s * hd


def segment_case(b, s, nh, hd, dtype, seed, hard=False):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    q, k, v = (
        torch.tensor(rng.normal(size=(b, s, nh, hd)), dtype=dtype,
                     device="cuda")
        for _ in range(3)
    )
    seg = torch.tensor(segment_ids_for(b, s, seed, hard), device="cuda")
    return q, k, v, seg


def segment_err(q, k, v, seg, scale, route, what: str) -> float:
    """max |kernel - plain| of one ``segment_attention`` call, which must
    take ``route``, failing past the tolerance, on non-finite output, or
    where a pad query row is not the uniform mean of v.  On the TMA route
    also the schedule the kernel ran, read back, against the plain
    ``segment_tile_schedule`` and the kernel's block sizes against the
    ones it assumes."""
    import torch

    from llm_weighted_consensus_tpu_torch.ops import attention as attn

    name = str(q.dtype).split(".")[-1]
    before = dict(attn.segment_attention.routes)
    got = attn.segment_attention(q, k, v, seg, scale)
    want = attn.segment_attention_plain(q, k, v, seg, scale)
    torch.cuda.synchronize()
    taken = [r for r, n in attn.segment_attention.routes.items()
             if n != before[r]]
    if taken != [route]:
        raise AssertionError(
            f"segment_attention {what}: took {taken}, not {route}")
    err = (got.float() - want.float()).abs().max().item()
    pad = seg <= 0
    mean_v = v.float().mean(dim=1, keepdim=True).expand_as(got)
    pad_err = ((got.float() - mean_v).abs().amax(dim=(2, 3))[pad].max().item()
               if pad.any() else 0.0)
    if (not torch.isfinite(got.float()).all() or err > ATTN_TOL[name]
            or pad_err > ATTN_TOL[name]):
        raise AssertionError(
            f"segment_attention {what} {name}: max|diff| {err}, pad rows "
            f"{pad_err} > {ATTN_TOL[name]}"
        )
    if route == "tma":
        same, ran, blocks = attn.kernel_tile_schedule(q, k, v, seg, scale)
        plan = attn.segment_tile_schedule(seg)
        n = plan.shape[1]
        if (blocks != (attn.SEG_BLOCK_Q, attn.SEG_BLOCK_K)
                or ran.shape[2] != plan.shape[2]
                or not torch.equal(ran[:, :n], plan)
                or bool(ran[:, n:].any())
                or not torch.equal(same, got)):
            raise AssertionError(
                f"segment_attention {what}: the kernel's schedule (blocks "
                f"{blocks}, {tuple(ran.shape)}) is not segment_tile_schedule's"
                f" ({attn.SEG_BLOCK_Q}, {attn.SEG_BLOCK_K}, "
                f"{tuple(plan.shape)}), or its output differs")
    return err


def check_segment_attention(gpu: str) -> dict:
    """The segment-attention kernel against its plain version at every
    [b, L] a packed call can take at bge-large width (16 heads of 64),
    bf16 (the TMA route) and f32 (the FMA kernel), and at odd cases, each
    call on its route; its time at the packed bucket and beside SDPA
    with the same-segment boolean mask (built beforehand, a yardstick the
    port never calls)."""
    import torch

    nh, hd = 16, 64
    worst, cases = 0.0, 0
    for (b, s), dtype in itertools.product(
        PACKED_SHAPES, (torch.bfloat16, torch.float32)
    ):
        q, k, v, seg = segment_case(b, s, nh, hd, dtype, seed=b * s)
        route = "tma" if dtype == torch.bfloat16 else "fma"
        worst = max(worst, segment_err(q, k, v, seg, hd ** -0.5, route,
                                       f"b={b} s={s}"))
        cases += 1
    odd = {}
    # hd 16, 24 and 32; L not a multiple of 64; the hard layouts (one-token
    # segments, an all-pad row, segments past 64 and across the 64-row and
    # 128-key edges) at bge-large's heads too, up to the bucket; then 8
    # rows of 64 segments of 8 tokens
    for (b, s, h, d), dtype in itertools.product(
        ((3, 200, 4, 16), (2, 77, 4, 24), (3, 130, 4, 32), (2, 100, 16, 64),
         (3, 300, 16, 64), (8, 512, 16, 64)),
        (torch.bfloat16, torch.float32),
    ):
        q, k, v, seg = segment_case(b, s, h, d, dtype, seed=s, hard=True)
        key = f"{str(dtype).split('.')[-1]}-hd{d}-s{s}"
        route = ("fma" if dtype == torch.float32 or d == 24
                 else "tma" if d == 64 else "mma")
        odd[key] = segment_err(q, k, v, seg, d ** -0.5, route, key)
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, _ = segment_case(8, 512, nh, hd, dtype, seed=64)
        seg = (torch.arange(512, device="cuda", dtype=torch.int32) // 8 + 1
               ).expand(8, 512).contiguous()
        key = f"{str(dtype).split('.')[-1]}-64-segments-per-row"
        route = "tma" if dtype == torch.bfloat16 else "fma"
        odd[key] = segment_err(q, k, v, seg, hd ** -0.5, route, key)
    worst = max(worst, max(odd.values()))
    emit({"phase": "kernel", "kernel": "segment_attention", "gpu": gpu,
          "cases": cases + len(odd), "max_abs_err": worst,
          "shapes": [list(x) for x in PACKED_SHAPES], "odd": odd,
          "tolerance": ATTN_TOL})
    return {"max_abs_err": worst, "checked": set(PACKED_SHAPES)}


def tile_work(seg, block_q, block_k):
    """(full, masked) shares of the dense [s, s] tile area per row that
    ``segment_tile_schedule`` at these tiles gives the ids ``seg``
    (clipped at s)."""
    import torch

    from llm_weighted_consensus_tpu_torch.ops import attention as attn

    kinds = attn.segment_tile_schedule(torch.as_tensor(seg).cpu(), block_q,
                                       block_k)
    s = seg.shape[1]
    full = masked = 0.0
    for qb in range(kinds.shape[1]):
        rows = min(block_q, s - qb * block_q)
        for kt in range(kinds.shape[2]):
            area = rows * min(block_k, s - kt * block_k)
            col = kinds[:, qb, kt]
            full += area * int((col == attn.SEG_FULL).sum())
            masked += area * int((col == attn.SEG_MASKED).sum())
    dense = float(seg.shape[0] * s * s)
    return full / dense, masked / dense


def visited_ops(seg, nh, hd) -> float:
    """The dense tile work the TMA kernel's schedule visits on these ids,
    clipped at s: 4 rows keys hd per head for a full tile (Q K^T and
    P V), 2 for a masked one (P V)."""
    from llm_weighted_consensus_tpu_torch.ops import attention as attn

    full, masked = tile_work(seg, attn.SEG_BLOCK_Q, attn.SEG_BLOCK_K)
    b, s = seg.shape
    return (4 * full + 2 * masked) * b * s * s * hd * nh


def time_segment_attention(gpu, b, s) -> dict:
    """Kernel (TMA route), plain and SDPA-with-mask times (bf16) at one
    [b, s] of bge-large (16 heads of 64), beside the mma.sync ``SEG``
    kernel it replaced on the same inputs, both also by device time per
    launch."""
    import torch
    import torch.nn.functional as F

    from llm_weighted_consensus_tpu_torch.ops import attention as attn

    nh, hd = 16, 64
    q, k, v, seg = segment_case(b, s, nh, hd, torch.bfloat16, seed=b * s)
    scale = hd ** -0.5
    same = (seg[:, :, None] == seg[:, None, :]) & (seg[:, None, :] > 0)
    mask4 = same[:, None]  # [b, 1, s, s]
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    bound, by, ops, dense_ops = segment_bound(seg.cpu().numpy(), nh, hd, 2)

    def tma():
        return attn._launch("lwc_attention_seg_tma", q, k, v, seg, scale)

    def mma():
        return attn._launch("lwc_attention_seg", q, k, v, seg, scale)

    row = {
        "phase": "kernel", "kernel": "segment_attention", "gpu": gpu,
        "shape": [b, s, nh, hd], "dtype": "bfloat16",
        "kernel_ms": time_ms(lambda: attn.segment_attention(q, k, v, seg, scale)),
        "plain_ms": time_ms(
            lambda: attn.segment_attention_plain(q, k, v, seg, scale),
            iters=5, warmup=1,
        ),
        "library_ms": time_ms(
            lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask4, scale=scale
            )
        ),
        "bound_ms": bound, "bound_by": by,
        # counted on the host from the ids, not measured: what the data
        # needs, what the plain schedule visits, the dense work
        "host_counts": {"data_ops": ops,
                        "visited_ops": visited_ops(seg, nh, hd),
                        "dense_ops": dense_ops},
        "kernel_route": attn.segment_attention_route(q, k, v),
        "launch_ms": time_ms(tma),
        "device_ms": device_ms_per_launch(tma, "attention_tma_kernel", SEG),
        "previous_ms": time_ms(mma),
        "previous_device_ms": device_ms_per_launch(
            mma, "attention_mma_kernel", ", true>"),
    }
    emit(row)
    return row


def bound_ms_ops(nbytes: float, int8_ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = int8_ops / PEAK_INT8_OPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# -- phase 3: bge_micro on the card against the CPU ---------------------------


def http(port: int, path: str, body=None, method=None):
    """(status, headers, JSON or text body) of a GET (``body`` None) or a
    POST (or ``method``), error statuses included."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data, method=method,
        headers={"content-type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            status, headers, raw = resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as err:
        status, headers, raw = err.code, dict(err.headers), err.read()
    text = raw.decode()
    try:
        return status, headers, json.loads(text)
    except ValueError:
        return status, headers, text


def post(port: int, path: str, body: dict):
    """The JSON answer of a POST that must succeed."""
    status, _, out = http(port, path, body)
    if status != 200:
        raise AssertionError(f"POST {path}: {status} {out}")
    return out


MICRO_TEXTS = [
    "paris is the capital of france",
    "the capital of france is paris",
    "paris, france's capital city",
    "bananas are curved and yellow",
    "the capital city of france is paris, on the seine",
]


def check_bge_micro(gpu: str) -> dict:
    import numpy as np
    import torch

    from llm_weighted_consensus_tpu_torch.models import loading, tokenizer
    from llm_weighted_consensus_tpu_torch.models.embedder import TorchEmbedder
    from llm_weighted_consensus_tpu_torch.serve.gateway import Server

    fixture = os.path.join(REPO, "tests", "fixtures", "bge_micro")
    cfg = loading.load_hf_config(fixture)
    tok = tokenizer.load_tokenizer(loading.find_vocab(fixture))
    confs, embs = {}, {}
    for device, dtype in (("cpu", torch.float32), ("cuda", torch.float32),
                          ("cuda", torch.bfloat16)):
        model = loading.load_params(fixture, cfg, dtype=dtype, device=device)
        emb = TorchEmbedder(
            "bge-micro", model=model, config=cfg, tokenizer=tok,
            max_tokens=64, device=device, dtype=dtype,
        )
        with Server(emb) as srv:
            out = post(srv.port, "/consensus", {"input": MICRO_TEXTS})
        key = f"{device}-{str(dtype).split('.')[-1]}"
        confs[key] = np.asarray(out["confidence"])
        embs[key] = emb.embed_texts(MICRO_TEXTS)
    f32_err = float(np.abs(confs["cuda-float32"] - confs["cpu-float32"]).max())
    emb_err = float(np.abs(embs["cuda-float32"] - embs["cpu-float32"]).max())
    bf16_err = float(np.abs(embs["cuda-bfloat16"] - embs["cpu-float32"]).max())
    bf16_cos = float((embs["cuda-bfloat16"] * embs["cpu-float32"]).sum(1).min())
    row = {
        "phase": "bge_micro", "gpu": gpu, "conf_f32_err": f32_err,
        "conf_tolerance": MICRO_TOL, "emb_f32_err": emb_err,
        "emb_bf16_err": bf16_err, "emb_bf16_min_cos": bf16_cos,
        "confidence_cuda_f32": confs["cuda-float32"].tolist(),
    }
    emit(row)
    if f32_err > MICRO_TOL or emb_err > 1e-5:
        raise AssertionError(f"bge_micro card vs CPU (f32): {row}")
    if bf16_err > 2e-2 or bf16_cos < 0.999:
        raise AssertionError(f"bge_micro card bf16 vs CPU f32: {row}")
    # quantized: the W8A8 / W4A8 kernels on the card against their plain
    # versions on the CPU, same f32 weights and texts
    for mode in ("int8", "int4-pallas"):
        qconf = {}
        for device in ("cpu", "cuda"):
            model = loading.load_params(
                fixture, cfg, dtype=torch.float32, device=device
            )
            emb = TorchEmbedder(
                "bge-micro", model=model, config=cfg, tokenizer=tok,
                max_tokens=64, device=device, dtype=torch.float32,
                quantize=mode,
            )
            with Server(emb) as srv:
                out = post(srv.port, "/consensus", {"input": MICRO_TEXTS})
            qconf[device] = np.asarray(out["confidence"])
        q_err = float(np.abs(qconf["cuda"] - qconf["cpu"]).max())
        qrow = {
            "phase": "bge_micro", "gpu": gpu, "quantize": mode,
            "conf_f32_err": q_err, "conf_tolerance": QUANT_MICRO_TOL,
            "confidence_cuda_f32": qconf["cuda"].tolist(),
        }
        emit(qrow)
        if q_err > QUANT_MICRO_TOL:
            raise AssertionError(f"bge_micro {mode} card vs CPU: {qrow}")
    return row


def check_bge_micro_packed(gpu: str) -> dict:
    """bge_micro in f32: packed on the card against packed on the CPU
    (plain versions) and against the padded path on the card, and a
    segment's vector beside other row-mates against it alone."""
    import numpy as np
    import torch

    from llm_weighted_consensus_tpu_torch.models import loading, tokenizer
    from llm_weighted_consensus_tpu_torch.models.embedder import TorchEmbedder

    fixture = os.path.join(REPO, "tests", "fixtures", "bge_micro")
    cfg = loading.load_hf_config(fixture)
    tok = tokenizer.load_tokenizer(loading.find_vocab(fixture))
    texts = MICRO_TEXTS + [
        "x", "a much longer answer about the capital city of france, the "
        "river seine that runs through it and the bridges across it",
    ]

    def packed(emb, texts):  # rows of 64 tokens, 4 rows, 8 segments
        return packed_vectors(emb, texts, 64, 4, 8)

    embs = {}
    for device in ("cpu", "cuda"):
        model = loading.load_params(fixture, cfg, dtype=torch.float32,
                                    device=device)
        embs[device] = TorchEmbedder(
            "bge-micro", model=model, config=cfg, tokenizer=tok,
            max_tokens=64, device=device, dtype=torch.float32,
        )
    card = packed(embs["cuda"], texts)
    vs_cpu = float(np.abs(card - packed(embs["cpu"], texts)).max())
    vs_padded = float(np.abs(card - embs["cuda"].embed_texts(texts)).max())
    alone = packed(embs["cuda"], texts[:1])[0]
    mates = max(
        float(np.abs(packed(embs["cuda"], texts[:1] + other)[0] - alone).max())
        for other in (texts[1:3], texts[3:])
    )
    row = {
        "phase": "bge_micro_packed", "gpu": gpu, "dtype": "float32",
        "packed_card_vs_cpu": vs_cpu, "packed_vs_padded_card": vs_padded,
        "tolerance": PACKED_MICRO_TOL, "row_mate_err": mates,
        "row_mate_tolerance": ROW_MATE_TOL,
    }
    emit(row)
    if vs_cpu > PACKED_MICRO_TOL or vs_padded > PACKED_MICRO_TOL or (
        mates > ROW_MATE_TOL
    ):
        raise AssertionError(f"bge_micro packed: {row}")
    return row


# -- phase 4: the main path at full bge-large width ----------------------------


def candidate_texts(rng, n: int, words: int) -> list:
    """n candidate answers of about ``words`` words (one hash-tokenizer
    token each), sharing a common stem as real candidate sets do."""
    vocab = [f"w{i}" for i in range(5000)]
    stem = list(rng.choice(vocab, size=words // 2))
    return [
        " ".join(stem + list(rng.choice(vocab, size=words - len(stem))))
        for _ in range(n)
    ]


def check_answer(conf, n: int) -> None:
    import numpy as np

    conf = np.asarray(conf, dtype=np.float64)
    if conf.shape != (n,) or not np.isfinite(conf).all():
        raise AssertionError(f"confidence shape {conf.shape} or not finite")
    if abs(conf.sum() - 1.0) > 1e-5:
        raise AssertionError(f"confidences sum to {conf.sum()}")


def _wrappers() -> dict:
    """The kernel wrappers, each with its ``launches`` count."""
    from llm_weighted_consensus_tpu_torch.ops import attention, kernels

    return {
        "cosine_vote": kernels.cosine_vote, "attention": attention.attention,
        "segment_attention": attention.segment_attention,
        "quantize_rows": kernels.quantize_rows,
        "w8a8_matmul": kernels.w8a8_matmul, "w4a8_matmul": kernels.w4a8_matmul,
    }


# the route every launch of these wrappers must take on bge-large
BGE_ROUTES = {"attention": "tma", "segment_attention": "tma",
              "w8a8_matmul": "tma", "w4a8_matmul": "tma",
              "cosine_vote": "cluster"}


def reset_launches() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
        for route in getattr(fn, "routes", {}):
            fn.routes[route] = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


def read_routes() -> dict:
    """Launches by route since ``reset_launches``; fails unless every
    launch of a routed wrapper took its ``BGE_ROUTES`` route."""
    wrappers = _wrappers()
    routes = {name: dict(wrappers[name].routes) for name in BGE_ROUTES}
    for name, want in BGE_ROUTES.items():
        if routes[name][want] != wrappers[name].launches:
            raise AssertionError(
                f"{name}: launches by route {routes[name]}, not all {want}"
            )
    return routes


def serve_traffic(emb, bursts, long_texts, embed_texts, model_name,
                  host_tokenizer_workers=2) -> dict:
    """Serve ``bursts`` (lists of concurrent /consensus bodies' texts),
    then the optional long request and one /embeddings request, through
    the port's HTTP server; the launch counts are set to 0 after a
    warm-up request and read at the end, and the dispatches per bucket
    are counted over the same span."""
    import threading

    import numpy as np
    import torch

    from llm_weighted_consensus_tpu_torch.serve.gateway import Server

    r = len(bursts[0])
    with Server(emb, max_batch=r, window_ms=100,
                host_tokenizer_workers=host_tokenizer_workers) as srv:
        # warm-up: cuBLAS handles, allocator pools, the kernel library
        post(srv.port, "/consensus", {"input": bursts[0][0]})
        torch.cuda.synchronize()
        stats0 = srv.batcher.stats()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        records, unwrap = record_dispatches(emb)

        latencies, results = [], {}

        def call(key, body):
            t = time.perf_counter()
            out = post(srv.port, "/consensus", body)
            latencies.append((key, time.perf_counter() - t))
            results[key] = out

        t_burst = time.perf_counter()
        for k, burst in enumerate(bursts):
            threads = [
                threading.Thread(target=call, args=((k, i), {"input": texts}))
                for i, texts in enumerate(burst)
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join(600)
            if any(t.is_alive() for t in threads):
                raise AssertionError("a /consensus request did not return")
        burst_s = time.perf_counter() - t_burst
        long_out, long_ms = None, None
        if long_texts is not None:
            t = time.perf_counter()
            long_out = post(srv.port, "/consensus", {"input": long_texts})
            long_ms = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        emb_out = post(
            srv.port, "/embeddings",
            {"model": model_name, "input": embed_texts},
        )
        embed_ms = (time.perf_counter() - t) * 1e3
        torch.cuda.synchronize()
        unwrap()
        launches = read_launches()
        routes = read_routes()
        stats1 = srv.batcher.stats()
    n = len(bursts[0][0])
    # each request's tokens put it in the bucket whose shapes the kernel
    # phase checked: (112, 128] per candidate is s=128, (48, 64] is s=64
    for key, out in results.items():
        check_answer(out["confidence"], n)
        if not 112 * n < out["usage"]["prompt_tokens"] <= 128 * n:
            raise AssertionError(f"request {key} is not in the s=128 bucket")
    if not (48 * len(embed_texts) < emb_out["usage"]["prompt_tokens"]
            <= 64 * len(embed_texts)):
        raise AssertionError("the /embeddings request is not in the s=64 bucket")
    vecs = np.asarray([row["embedding"] for row in emb_out["data"]])
    if vecs.shape != (len(embed_texts), 1024) or not np.isfinite(vecs).all():
        raise AssertionError(f"/embeddings gave {vecs.shape}")
    if np.abs(np.linalg.norm(vecs, axis=1) - 1).max() > 1e-3:
        raise AssertionError("/embeddings rows are not unit vectors")
    lat_ms = sorted(x[1] * 1e3 for x in latencies)
    return {
        "results": results, "vecs": vecs, "long_out": long_out,
        "long_ms": long_ms, "embed_ms": embed_ms, "launches": launches,
        "routes": routes, "consensus_d": (stats1["dispatches"]["consensus"]
                        - stats0["dispatches"]["consensus"]),
        "embed_d": stats1["dispatches"]["embed"] - stats0["dispatches"]["embed"],
        "largest_group": stats1["largest_group"],
        "buckets": bucket_counts(records),
        "p50_ms": float(np.median(lat_ms)), "max_ms": lat_ms[-1],
        "requests": len(latencies), "answers_per_s": len(latencies) / burst_s,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }


def expected_launches(layers, consensus_d, embed_d, quantize="none",
                      packed_calls=0) -> dict:
    """Launches of ``consensus_d`` padded consensus dispatches,
    ``embed_d`` padded embedding dispatches and ``packed_calls`` packed
    calls: one attention (or segment attention) per layer per encoder
    call, 6 quantized matmuls per layer under a quantize mode."""
    encoder_d = consensus_d + embed_d
    dense = 6 * layers * (encoder_d + packed_calls) if quantize != "none" else 0
    int4 = quantize.startswith("int4")
    return {
        "cosine_vote": consensus_d, "attention": layers * encoder_d,
        "segment_attention": layers * packed_calls,
        "quantize_rows": dense, "w8a8_matmul": 0 if int4 else dense,
        "w4a8_matmul": dense if int4 else 0,
    }


def main_path(gpu: str):
    import numpy as np
    import torch

    from llm_weighted_consensus_tpu_torch.models.embedder import TorchEmbedder

    t0 = time.perf_counter()
    emb = TorchEmbedder(
        "bge-large-en", seed=0, dtype=torch.bfloat16, max_tokens=512,
        device="cuda",
    )
    init_s = time.perf_counter() - t0
    layers = emb.config.num_layers
    rng = np.random.default_rng(0)
    n, r, rounds = N_CANDIDATES, BURST, 3
    bursts = [
        [candidate_texts(rng, n, BURST_WORDS) for _ in range(r)]
        for _ in range(rounds)
    ]
    long_texts = candidate_texts(rng, LONG_N, LONG_WORDS)
    embed_texts = candidate_texts(rng, EMBED_N, EMBED_WORDS)
    out = serve_traffic(emb, bursts, long_texts, embed_texts, "bge-large-en")
    long_out = out["long_out"]
    check_answer(long_out["confidence"], len(long_texts))
    # (384, 512] tokens per candidate is the s=512 bucket
    if not (384 * len(long_texts) < long_out["usage"]["prompt_tokens"]
            <= 512 * len(long_texts)):
        raise AssertionError("the long request is not in the s=512 bucket")
    want = expected_launches(layers, out["consensus_d"], out["embed_d"])
    if out["launches"] != want or out["consensus_d"] < 1:
        raise AssertionError(
            f"kernel launches {out['launches']} != expected {want}"
        )
    # the same traffic with tokenization on the dispatch thread: how the
    # submit-time tokenizer pool changes the grouping of each burst; and
    # what one request's tokenization holds the interpreter lock for
    inline = serve_traffic(emb, bursts, long_texts, embed_texts,
                           "bge-large-en", host_tokenizer_workers=0)
    tokenize_ms = []
    for _ in range(5):
        t = time.perf_counter()
        emb.tokenize(bursts[0][0])
        tokenize_ms.append((time.perf_counter() - t) * 1e3)
    row = {
        "phase": "main_path", "gpu": gpu, "model": "bge-large-en",
        "dtype": "bfloat16", "init_s": init_s,
        "requests": out["requests"], "candidates": n,
        "consensus_dispatches": out["consensus_d"],
        "embed_dispatches": out["embed_d"],
        "largest_group": out["largest_group"], "buckets": out["buckets"],
        "p50_ms": out["p50_ms"], "max_ms": out["max_ms"],
        "answers_per_s": out["answers_per_s"],
        "host_tokenizer_workers_0": {
            k: inline[k] for k in ("consensus_d", "largest_group", "buckets",
                                   "p50_ms", "max_ms", "answers_per_s")},
        "tokenize_ms_per_request": float(np.median(tokenize_ms)),
        "long_request_ms": out["long_ms"], "long_request_tokens":
            long_out["usage"]["prompt_tokens"],
        "embeddings_ms": out["embed_ms"], "launches": out["launches"],
        "routes": out["routes"],
        "expected_launches": want, "peak_mem_gib": out["peak_mem_gib"],
    }
    emit(row)
    return row, emb, bursts, embed_texts


# -- phase 5: the packed path ---------------------------------------------------


def mixed_traffic(seed: int = 11):
    """The reference's mixed-length workload (``bench_http.py
    --mixed-lengths``): per request N in {3, 4, 6, 8} (p .3/.3/.25/.15),
    a shared context of 4-16 words (60%), 24-64 (30%) or 96-192 (10%),
    then ``answer j`` and 6 words per candidate.  -> (bursts of
    ``PACKED_BURST`` requests' texts, one list of ``PACKED_EMBED_N``
    texts of the same length mixture per burst)."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def text(words: int, tag: str) -> str:
        return f"{tag} " + " ".join(
            rng.choice(BENCH_WORDS, size=max(1, words)).tolist()
        )

    def words() -> int:
        kind = rng.random()
        if kind < 0.6:
            return int(rng.integers(4, 17))
        if kind < 0.9:
            return int(rng.integers(24, 65))
        return int(rng.integers(96, 193))

    def request_texts(i: int) -> list:
        n = int(rng.choice([3, 4, 6, 8], p=[0.3, 0.3, 0.25, 0.15]))
        prefix = text(words(), f"ctx {i}")
        return [f"{prefix} answer {j} {text(6, 'a')}" for j in range(n)]

    bursts = [
        [request_texts(k * PACKED_BURST + i) for i in range(PACKED_BURST)]
        for k in range(PACKED_BURSTS)
    ]
    embeds = [
        [text(words(), f"doc {k} {j}") for j in range(PACKED_EMBED_N)]
        for k in range(PACKED_BURSTS)
    ]
    return bursts, embeds


def _delta(after: dict, before: dict) -> dict:
    """The growth of the integer counters of ``stats()`` (nested dicts)
    between two reads."""
    out = {}
    for key, value in after.items():
        prev = before.get(key, 0)
        if isinstance(value, dict):
            out[key] = _delta(value, prev if isinstance(prev, dict) else {})
        elif isinstance(value, int) and not isinstance(value, bool):
            out[key] = value - prev
    return out


def serve_mixed(emb, bursts, embeds, **options) -> dict:
    """Serve ``bursts`` of concurrent /consensus requests, each with one
    concurrent /embeddings request, through the port's HTTP server with
    the batcher ``options``; the launch counts are set to 0 after a
    warm-up request and read at the end.  Checks every answer."""
    import threading

    import numpy as np
    import torch

    from llm_weighted_consensus_tpu_torch.serve.gateway import Server

    model_name = emb.model_name
    with Server(emb, max_batch=PACKED_BURST, window_ms=100,
                **options) as srv:
        post(srv.port, "/consensus", {"input": bursts[0][0]})
        post(srv.port, "/embeddings", {"model": model_name,
                                       "input": embeds[0][:2]})
        torch.cuda.synchronize()
        stats0 = srv.batcher.stats()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        latencies, results = [], {}

        def call(key, path, body):
            t = time.perf_counter()
            out = post(srv.port, path, body)
            if path == "/consensus":
                latencies.append(time.perf_counter() - t)
            results[key] = out

        t_burst = time.perf_counter()
        for k, burst in enumerate(bursts):
            threads = [
                threading.Thread(target=call, args=(
                    (k, i), "/consensus", {"input": texts, "temperature": 0.05}
                ))
                for i, texts in enumerate(burst)
            ]
            threads.append(threading.Thread(target=call, args=(
                (k, "embed"), "/embeddings",
                {"model": model_name, "input": embeds[k]},
            )))
            for t in threads:
                t.start()
            for t in threads:
                t.join(600)
            if any(t.is_alive() for t in threads):
                raise AssertionError("a request did not return")
        burst_s = time.perf_counter() - t_burst
        torch.cuda.synchronize()
        launches = read_launches()
        routes = read_routes()
        stats = _delta(srv.batcher.stats(), stats0)
    for k, burst in enumerate(bursts):
        for i, texts in enumerate(burst):
            check_answer(results[(k, i)]["confidence"], len(texts))
        vecs = np.asarray([r["embedding"] for r in results[(k, "embed")]["data"]])
        if vecs.shape != (len(embeds[k]), emb.config.hidden_size) or (
            not np.isfinite(vecs).all()
            or np.abs(np.linalg.norm(vecs, axis=1) - 1).max() > 1e-3
        ):
            raise AssertionError(f"/embeddings burst {k}: {vecs.shape}")
    lat_ms = sorted(x * 1e3 for x in latencies)
    return {
        "results": results, "launches": launches, "routes": routes,
        "stats": stats,
        "p50_ms": float(np.median(lat_ms)), "max_ms": lat_ms[-1],
        "requests": len(latencies), "answers_per_s": len(latencies) / burst_s,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }


def packed_vectors(emb, texts, row_tokens=PACKING["packing_row_tokens"],
                   max_rows=PACKING["packing_max_rows"],
                   max_segments=PACKING["packing_max_segments"]):
    """Per-text embeddings through the packed path (the batcher's plan
    with prefix dedup off: ``tokenize_ragged``, ``build_calls``, one
    ``embed_packed`` per call), by default at the PACKING defaults."""
    import numpy as np

    from llm_weighted_consensus_tpu_torch.serve import packing

    rows = emb.tokenize_ragged(texts, min(row_tokens, emb.max_tokens))
    calls = packing.build_calls(rows, row_tokens, max_rows, max_segments)
    out = [None] * len(texts)
    for call in calls:
        vecs = emb.embed_packed(
            call.ids, call.segment_ids, call.positions, call.seg_starts
        )
        for si, (r, slot) in call.slots.items():
            out[si] = vecs[r, slot]
    return np.stack(out)


def composed_confidence(emb, texts, temperature=0.05):
    """The prefix-dedup contract on the padded path's embeddings: the
    prefix and the suffixes embedded padded, composed and voted on the
    host, as ``ConsensusBatcher._dispatch_packed`` defines it; None when
    dedup does not apply to ``texts``."""
    from llm_weighted_consensus_tpu_torch.serve import packing

    prefix = packing.shared_prefix(texts, PACKING["prefix_dedup_min_chars"])
    if prefix is None:
        return None
    suffixes = [t[len(prefix):] for t in texts]
    parts = [prefix] + [x for x in suffixes if x]
    rows = emb.tokenize_ragged(parts, PACKING["packing_row_tokens"])
    if len(rows[0]) < 4:
        return None
    vecs = emb.embed_texts(parts)
    it = iter(range(1, len(parts)))
    cand = []
    for x in suffixes:
        i = next(it) if x else None
        cand.append(packing.compose_prefix_suffix(
            vecs[0], len(rows[0]), None if i is None else vecs[i],
            0 if i is None else len(rows[i]),
        ))
    import numpy as np

    return packing.consensus_vote_np(np.stack(cand), temperature)


def packed_path(gpu: str, emb, checked: set) -> dict:
    """The packed path on the main path's bge-large embedder (bf16): the
    mixed traffic through a packed server (PACKING defaults) and through a
    padded one; launch counts; answers held against the padded path with
    dedup off and against the dedup contract with it on."""
    import numpy as np

    layers = emb.config.num_layers
    bursts, embeds = mixed_traffic()
    packed = serve_mixed(emb, bursts, embeds, **PACKING)
    padded = serve_mixed(emb, bursts, embeds)
    pk = packed["stats"]["packing"]
    pk["call_shapes"] = {k: n for k, n in pk["call_shapes"].items() if n}
    calls = sum(pk["call_shapes"].values())
    shapes = sorted(tuple(int(x) for x in key.split("x"))
                    for key in pk["call_shapes"])
    if pk["fallback_items"] or calls < 1:
        raise AssertionError(f"packed path: {pk}")
    want = expected_launches(layers, 0, 0, packed_calls=calls)
    if packed["launches"] != want:
        raise AssertionError(
            f"packed launches {packed['launches']} != expected {want}"
        )
    if not set(shapes) <= checked:
        raise AssertionError(f"packed calls {shapes} outside {checked}")
    pad_d = padded["stats"]["dispatches"]
    want_pad = expected_launches(layers, pad_d["consensus"], pad_d["embed"])
    if padded["launches"] != want_pad:
        raise AssertionError(
            f"padded launches {padded['launches']} != expected {want_pad}"
        )
    # dedup off, the same texts: the padded path's answers
    nodedup = serve_mixed(emb, bursts[:1], embeds[:1],
                          **dict(PACKING, prefix_dedup=False))
    conf_off, conf_on, cos_min = 0.0, 0.0, 1.0
    for i, texts in enumerate(bursts[0]):
        ref = np.asarray(padded["results"][(0, i)]["confidence"])
        got = np.asarray(nodedup["results"][(0, i)]["confidence"])
        conf_off = max(conf_off, float(np.abs(got - ref).max()))
        composed = composed_confidence(emb, texts)
        contract = ref if composed is None else composed
        got_on = np.asarray(packed["results"][(0, i)]["confidence"])
        conf_on = max(conf_on, float(np.abs(got_on - contract).max()))
    texts = [t for req in bursts[0] for t in req] + embeds[0]
    vecs = packed_vectors(emb, texts)
    cos = (vecs * emb.embed_texts(texts)).sum(axis=1)
    cos_min = float(cos.min())
    row = {
        "phase": "packed_path", "gpu": gpu, "model": emb.model_name,
        "dtype": str(emb.dtype).split(".")[-1], "options": PACKING,
        "bursts": PACKED_BURSTS, "requests": packed["requests"],
        "p50_ms": packed["p50_ms"], "max_ms": packed["max_ms"],
        "answers_per_s": packed["answers_per_s"],
        "packed_dispatches": pk["dispatches"], "packed_calls": calls,
        "call_shapes": pk["call_shapes"],
        "real_tokens": pk["real_tokens"], "slot_tokens": pk["slot_tokens"],
        "prefix_dedup_hits": pk["prefix_dedup_hits"],
        "prefix_dedup_tokens_saved": pk["prefix_dedup_tokens_saved"],
        "fallback_items": pk["fallback_items"],
        "launches": packed["launches"], "expected_launches": want,
        "routes": packed["routes"], "peak_mem_gib": packed["peak_mem_gib"],
        "padded_p50_ms": padded["p50_ms"], "padded_max_ms": padded["max_ms"],
        "padded_answers_per_s": padded["answers_per_s"],
        "padded_dispatches": pad_d,
        "padded_real_tokens": padded["stats"]["padded"]["real_tokens"],
        "padded_slot_tokens": padded["stats"]["padded"]["slot_tokens"],
        "padded_peak_mem_gib": padded["peak_mem_gib"],
        "dedup_off_max_conf_diff": conf_off,
        "dedup_on_max_conf_diff_vs_contract": conf_on,
        "min_candidate_cosine_vs_padded": cos_min,
        "bars": {"min_cosine": PACKED_MIN_COS, "conf": PACKED_CONF_TOL},
    }
    emit(row)
    if (conf_off > PACKED_CONF_TOL or conf_on > PACKED_CONF_TOL
            or cos_min < PACKED_MIN_COS):
        raise AssertionError(f"packed path against the padded path: {row}")
    return {"row": row, "shapes": shapes, "bursts": bursts, "embeds": embeds}


def packed_int8_burst(gpu: str, emb, bursts, embeds) -> dict:
    """One packed burst under ``quantize="int8"``: 6 quantized matmuls
    (and row quantisations) and one segment attention per layer per
    packed call, no padded kernel."""
    layers = emb.config.num_layers
    out = serve_mixed(emb, bursts[:1], embeds[:1], **PACKING)
    pk = out["stats"]["packing"]
    calls = sum(pk["call_shapes"].values())
    pk["call_shapes"] = {k: n for k, n in pk["call_shapes"].items() if n}
    want = expected_launches(layers, 0, 0, "int8", packed_calls=calls)
    row = {
        "phase": "packed_int8", "gpu": gpu, "model": emb.model_name,
        "quantize": "int8", "requests": out["requests"],
        "p50_ms": out["p50_ms"], "answers_per_s": out["answers_per_s"],
        "packed_calls": calls, "call_shapes": pk["call_shapes"],
        "launches": out["launches"], "expected_launches": want,
        "routes": out["routes"],
    }
    emit(row)
    if out["launches"] != want or pk["fallback_items"] or calls < 1:
        raise AssertionError(f"packed int8 launches: {row}")
    return row


def scheme_cosines(mode, texts):
    """Per-text cosine between the quantized and the unquantized
    embeddings of the port's plain versions on the CPU, f32, bge-large at
    full width and depth, the main path's seed: what the quantization
    scheme itself loses on these weights and texts."""
    import torch

    from llm_weighted_consensus_tpu_torch.models.embedder import TorchEmbedder

    vecs = []
    for quantize in ("none", mode):
        emb = TorchEmbedder(
            "bge-large-en", seed=0, dtype=torch.float32, max_tokens=512,
            device="cpu", quantize=quantize,
        )
        vecs.append(emb.embed_texts(texts))
        del emb
    return (vecs[0] * vecs[1]).sum(axis=1)


def quant_path(gpu, mode, full, bursts, embed_texts, packed=None) -> dict:
    """The main path's traffic (without the s=512 request) under
    ``quantize=mode`` on the same weights, held against the unquantized
    embedder ``full`` on the same texts; with ``packed`` (the packed
    phase's traffic), one packed burst and a profile of one packed call
    on the same quantized embedder."""
    import numpy as np
    import torch

    from llm_weighted_consensus_tpu_torch.models import quant
    from llm_weighted_consensus_tpu_torch.models.embedder import TorchEmbedder

    t0 = time.perf_counter()
    emb = TorchEmbedder(
        "bge-large-en", seed=0, dtype=torch.bfloat16, max_tokens=512,
        device="cuda", quantize=mode,
    )
    init_s = time.perf_counter() - t0
    layers = emb.config.num_layers
    denses = [m for m in emb.model.modules() if isinstance(m, quant.QuantLinear)]
    if len(denses) != 6 * layers or any(
        d.scale.dtype != torch.float32 for d in denses
    ):
        raise AssertionError(f"{mode}: the layer stack is not quantized")
    out = serve_traffic(emb, bursts, None, embed_texts, "bge-large-en")
    want = expected_launches(layers, out["consensus_d"], out["embed_d"], mode)
    if out["launches"] != want or out["consensus_d"] < 1:
        raise AssertionError(
            f"{mode}: kernel launches {out['launches']} != expected {want}"
        )
    # the unquantized path on the same weights and texts
    min_cos_bar, conf_bar = QUANT_BARS[mode]
    conf_diff = 0.0
    for k, burst in enumerate(bursts):
        ids, mask = full.tokenize([t for texts in burst for t in texts])
        n = len(burst[0])
        ref = full.consensus_confidence_tokens_many(
            ids.reshape(len(burst), n, -1), mask.reshape(len(burst), n, -1)
        )
        for i in range(len(burst)):
            got = np.asarray(out["results"][(k, i)]["confidence"])
            conf_diff = max(conf_diff, float(np.abs(got - ref[i]).max()))
    ref_vecs = full.embed_texts(embed_texts)
    card_cos = (ref_vecs * out["vecs"]).sum(axis=1)
    min_cos = float(card_cos.min())
    scheme_cos = scheme_cosines(mode, embed_texts[:SCHEME_TEXTS])
    row = {
        "phase": "quant_path", "gpu": gpu, "model": "bge-large-en",
        "quantize": mode, "dtype": "bfloat16", "init_s": init_s,
        "requests": out["requests"], "candidates": N_CANDIDATES,
        "consensus_dispatches": out["consensus_d"],
        "embed_dispatches": out["embed_d"],
        "largest_group": out["largest_group"],
        "p50_ms": out["p50_ms"], "max_ms": out["max_ms"],
        "answers_per_s": out["answers_per_s"],
        "embeddings_ms": out["embed_ms"], "launches": out["launches"],
        "routes": out["routes"],
        "expected_launches": want, "peak_mem_gib": out["peak_mem_gib"],
        "max_conf_diff_vs_unquantized": conf_diff,
        "conf_bar": conf_bar, "min_embedding_cosine": min_cos,
        "cosine_bar": min_cos_bar,
        "card_cosine_first": card_cos[:SCHEME_TEXTS].tolist(),
        "cpu_f32_scheme_cosine": scheme_cos.tolist(),
        "scheme_margin": SCHEME_MARGIN,
    }
    emit(row)
    if conf_diff > conf_bar or (
        min_cos_bar is not None and min_cos < min_cos_bar
    ) or card_cos[:SCHEME_TEXTS].min() < scheme_cos.min() - SCHEME_MARGIN:
        raise AssertionError(f"{mode} against the unquantized path: {row}")
    if packed is not None:
        row["packed"] = packed_int8_burst(gpu, emb, packed["bursts"],
                                          packed["embeds"])
        profile_packed(gpu, emb, packed["bursts"], mode)
    del emb
    torch.cuda.empty_cache()
    return row


def profile_dispatch(gpu: str, quantize: str = "none") -> dict:
    """Device time by kernel for one coalesced dispatch (R=8, N=64,
    s=128) of the main path, from torch.profiler, and the host time of
    tokenizing its 512 texts; the table goes to
    chiprun_out/profile_main_path.txt, or profile_quant_path.txt under
    int8 and profile_int4_path.txt under int4-pallas, where a cuBLAS GEMM
    in the dispatch fails the run."""
    import numpy as np

    from llm_weighted_consensus_tpu_torch.models.embedder import TorchEmbedder

    emb = TorchEmbedder(
        "bge-large-en", seed=0, max_tokens=512, device="cuda",
        quantize=quantize,
    )
    rng = np.random.default_rng(1)
    r, n = BURST, N_CANDIDATES
    texts = [t for _ in range(r) for t in candidate_texts(rng, n, BURST_WORDS)]
    t = time.perf_counter()
    ids, mask = emb.tokenize(texts)
    tokenize_ms = (time.perf_counter() - t) * 1e3
    ids, mask = ids.reshape(r, n, -1), mask.reshape(r, n, -1)
    layers = emb.config.num_layers

    # the TMA GEMM instantiation of the weight format
    gemm = W4 if quantize.startswith("int4") else W8

    def complete(rows):
        # every layer's attention, the vote, and the six GEMMs of each
        # layer under a quantize mode
        return (launches_of(rows, "attention_tma_kernel", PADDED) == layers
                and launches_of(rows, "cosine_vote_cluster_kernel") == 1
                and (quantize == "none"
                     or launches_of(rows, "quant_gemm_tma_kernel", gemm)
                     == 6 * layers))

    rows, wall_ms, traces = profile_call(
        lambda: emb.consensus_confidence_tokens_many(ids, mask), complete
    )
    device_ms = sum(r[0] for r in rows)
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    name = {"none": "profile_main_path.txt", "int8": "profile_quant_path.txt",
            "int4-pallas": "profile_int4_path.txt"}[quantize]
    with open(os.path.join(out_dir, name), "w") as f:
        f.write(f"# {gpu}; one dispatch R=8 N=64 s={ids.shape[2]}, "
                f"quantize={quantize}, wall {wall_ms:.3f} ms\n")
        for ms, count, key in rows:
            f.write(f"{ms:10.3f} ms  {count:6d}  {key[:110]}\n")
    top = [
        {"kernel": key[:80], "ms": ms, "count": count}
        for ms, count, key in rows[:8]
    ]
    cublas = cublas_gemms(rows)
    new_kernels = {
        "attention_tma_kernel<false>": launches_of(
            rows, "attention_tma_kernel", PADDED),
        "attention_mma_kernel<64, false>": launches_of(
            rows, "attention_mma_kernel", "<64, false>"),
        "quant_gemm_tma_kernel<W8>": launches_of(
            rows, "quant_gemm_tma_kernel", W8),
        "quant_gemm_tma_kernel<W4>": launches_of(
            rows, "quant_gemm_tma_kernel", W4),
        "quant_gemm_kernel": launches_of(rows, "quant_gemm_kernel"),
        "cosine_vote_cluster_kernel": launches_of(
            rows, "cosine_vote_cluster_kernel"),
        "cosine_vote_kernel": launches_of(rows, "cosine_vote_kernel"),
    }
    vote_ms = sum(ms for ms, _, key in rows
                  if port_kernel(key) == "cosine_vote_cluster_kernel")
    row = {
        "phase": "profile", "gpu": gpu, "quantize": quantize,
        "kernel_launches": new_kernels, "vote_device_ms": vote_ms,
        "traces": traces,
        "shape": list(ids.shape),
        "tokenize_ms": tokenize_ms, "wall_ms": wall_ms,
        "device_ms": device_ms,
        "device_idle_share": 1.0 - device_ms / wall_ms,
        "top": top, "cublas_gemm_kernels": cublas,
    }
    emit(row)
    # every layer's attention on the TMA route, none on the mma.sync one
    if (new_kernels["attention_tma_kernel<false>"] != layers
            or new_kernels["attention_mma_kernel<64, false>"]):
        raise AssertionError(f"profile ({quantize}): attention {new_kernels}")
    # the dispatch's one vote on the cluster route, none on the block one
    if (new_kernels["cosine_vote_cluster_kernel"] != 1
            or new_kernels["cosine_vote_kernel"]):
        raise AssertionError(f"profile ({quantize}): vote {new_kernels}")
    if quantize != "none":
        if cublas:
            raise AssertionError(
                f"profile ({quantize}): cuBLAS GEMMs in the layer stack: "
                f"{cublas}"
            )
        # six quantized GEMMs per layer, all on the TMA route of the
        # weight format
        want, other = (("<W4>", "<W8>") if gemm == W4 else ("<W8>", "<W4>"))
        if (new_kernels[f"quant_gemm_tma_kernel{want}"] != 6 * layers
                or new_kernels[f"quant_gemm_tma_kernel{other}"]
                or new_kernels["quant_gemm_kernel"]
                or not launches_of(rows, "quantize_rows_kernel")):
            raise AssertionError(
                f"profile ({quantize}): the quantized kernels {new_kernels}"
            )
    if device_ms > wall_ms * DEVICE_TIME_SLACK:
        # one stream runs one kernel at a time: more device time than
        # wall time means the sum counted something twice or off the card
        raise AssertionError(
            f"profile: device time {device_ms} ms exceeds the wall time "
            f"{wall_ms} ms it was taken in"
        )
    return row


def port_kernel(key: str):
    """The function name of one of the port's kernels in a profile key
    (``[void ](anonymous namespace)::[mma::]name[<...>](...)``: templates
    carry their return type), else None."""
    import re

    found = re.match(
        r"(?:void )?\(anonymous namespace\)::(?:\w+::)*(\w+)[<(]", key
    )
    return found.group(1) if found else None


def cublas_gemms(rows) -> list:
    """Profile keys that look like a cuBLAS GEMM and are not the port's."""
    return [
        key for _, _, key in rows
        if any(pat in key.lower() for pat in CUBLAS_GEMM)
        and port_kernel(key) not in PORT_GEMMS
    ]


def launches_of(rows, name: str, template: str = "") -> int:
    """Launches of the port's kernel ``name`` (whose key holds
    ``template``, e.g. ``<64, false>``) in a profile."""
    return sum(count for _, count, key in rows
               if port_kernel(key) == name and template in key)


def profile_call(fn, complete=None, tries: int = 3):
    """(``device_table`` rows, wall ms, traces taken) of one call of
    ``fn``.  A first call runs while the profiler already traces and its
    events are dropped (the schedule's warm-up step): a trace that starts
    with the measured call can miss its first kernels (one layer of a
    dispatch).  The profiler drops every device record stamped outside
    its window, and on the H100 a kernel's record can be stamped up to
    ~5 ms before its own launch call: so the measured call starts, and
    the window closes, ``PROFILE_MARGIN_S`` away from the window's
    edges.  Where ``complete(rows)`` is still false the call is traced
    anew, up to ``tries`` traces; the last is returned either way and
    the caller's checks judge it."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    for traces in range(1, tries + 1):
        with profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
        ) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            time.sleep(PROFILE_MARGIN_S)
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
            time.sleep(PROFILE_MARGIN_S)
            prof.step()
        rows = device_table(prof)
        if complete is None or complete(rows):
            break
    return rows, wall_ms, traces


def device_ms_per_launch(fn, kernel: str, template: str = "",
                         iters: int = 20) -> float:
    """Device time of one launch of the port's kernel ``kernel`` (a
    ``port_kernel`` name, whose key holds ``template``) that ``fn``
    makes, averaged over ``iters`` calls.  Up to 5 traces: a trace late
    in a long run has lost every device record of its step three times
    in a row on the H100."""
    rows, _, traces = profile_call(
        lambda: [fn() for _ in range(iters)],
        lambda rows: launches_of(rows, kernel, template) == iters,
        tries=5,
    )
    count = launches_of(rows, kernel, template)
    if count != iters:
        raise AssertionError(
            f"{kernel}{template}: {count} of {iters} launches in {traces} "
            "traces"
        )
    return sum(ms for ms, _, key in rows
               if port_kernel(key) == kernel and template in key) / count


def device_table(prof):
    """(device ms, count, name) per kernel from a profile, largest first:
    device kernels, memcpys and memsets only (host-side entries, launch
    calls and "Command Buffer Full" waits, carry device time of the
    kernels they wait on; the schedule's step annotation spans the
    device time of the whole step)."""
    import torch

    rows = []
    for ev in prof.key_averages():
        if (ev.device_type != torch.autograd.DeviceType.CUDA
                or ev.key.startswith("ProfilerStep")):
            continue
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = ev.cuda_time_total
        if dev_us:
            rows.append((dev_us / 1e3, ev.count, ev.key))
    return sorted(rows, reverse=True)


def profile_packed(gpu: str, emb, bursts, quantize: str = "none") -> dict:
    """Device time by kernel for one packed call of [8, 512] rows (the
    bucket), made from the packed traffic's candidate texts with dedup
    off; the table goes to chiprun_out/profile_packed_path.txt (or
    profile_packed_int8.txt, where a cuBLAS GEMM fails the run)."""
    from llm_weighted_consensus_tpu_torch.serve import packing

    texts = [t for burst in bursts for req in burst for t in req]
    rows = emb.tokenize_ragged(texts, PACKING["packing_row_tokens"])
    call = next(
        c for c in packing.build_calls(
            rows, PACKING["packing_row_tokens"], PACKING["packing_max_rows"],
            PACKING["packing_max_segments"],
        ) if c.ids.shape == SEG_BUCKET
    )
    args = (call.ids, call.segment_ids, call.positions, call.seg_starts)
    layers = emb.config.num_layers
    rows, wall_ms, traces = profile_call(
        lambda: emb.embed_packed(*args),
        lambda rows: launches_of(rows, "attention_tma_kernel", SEG) == layers,
    )
    device_ms = sum(r[0] for r in rows)
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    name = ("profile_packed_path.txt" if quantize == "none"
            else f"profile_packed_{quantize}.txt")
    with open(os.path.join(out_dir, name), "w") as f:
        f.write(f"# {gpu}; one packed call {list(call.ids.shape)}, "
                f"{len(call.slots)} segments, {call.real_tokens} real tokens, "
                f"quantize={quantize}, wall {wall_ms:.3f} ms\n")
        for ms, count, key in rows:
            f.write(f"{ms:10.3f} ms  {count:6d}  {key[:110]}\n")
    cublas = cublas_gemms(rows)
    seg_kernels = {
        "attention_tma_kernel<true>": launches_of(
            rows, "attention_tma_kernel", SEG),
        "attention_mma_kernel<64, true>": launches_of(
            rows, "attention_mma_kernel", "<64, true>"),
    }
    row = {
        "phase": "profile_packed", "gpu": gpu, "quantize": quantize,
        "shape": list(call.ids.shape), "segments": len(call.slots),
        "real_tokens": call.real_tokens, "traces": traces,
        "kernel_launches": seg_kernels,
        "wall_ms": wall_ms,
        "device_ms": device_ms,
        "device_idle_share": 1.0 - device_ms / wall_ms,
        "top": [{"kernel": key[:80], "ms": ms, "count": count}
                for ms, count, key in rows[:8]],
        "cublas_gemm_kernels": cublas,
    }
    emit(row)
    if quantize != "none" and cublas:
        raise AssertionError(f"packed profile ({quantize}): cuBLAS {cublas}")
    # every layer's segment attention on the TMA route, none on the
    # mma.sync one
    if (seg_kernels["attention_tma_kernel<true>"] != layers
            or seg_kernels["attention_mma_kernel<64, true>"]):
        raise AssertionError(
            f"packed profile ({quantize}): segment attention {seg_kernels}")
    if device_ms > wall_ms * DEVICE_TIME_SLACK:
        raise AssertionError(
            f"packed profile: device time {device_ms} ms exceeds the wall "
            f"time {wall_ms} ms"
        )
    return row


# -- phase 8: the reward-model path ---------------------------------------------


def rm_spm_proto() -> bytes:
    """The unigram SentencePiece proto of bench.py's bench_spm_tokenizer
    (deberta id scheme: [PAD] [CLS] [SEP] [UNK] control pieces, then a
    whole-word piece per bench word scored -len(word), then single
    characters scored -10), serialized as a ModelProto: field 1 repeated
    {piece (1), score (2, f32), type (3)}."""
    import struct

    from llm_weighted_consensus_tpu_torch.models import spm

    pieces = [("[PAD]", 0.0, spm.CONTROL), ("[CLS]", 0.0, spm.CONTROL),
              ("[SEP]", 0.0, spm.CONTROL), ("[UNK]", 0.0, spm.UNKNOWN)]
    pieces += [(spm.SPACE + w, -float(len(w)), spm.NORMAL) for w in BENCH_WORDS]
    pieces += [(ch, -10.0, spm.NORMAL)
               for ch in "abcdefghijklmnopqrstuvwxyz0123456789" + spm.SPACE]

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


def rm_vocab_path() -> str:
    """Write the synthetic ``spm.model`` under the checkout's build/."""
    path = os.path.join(REPO, "build", "rm_smoke", "spm.model")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(rm_spm_proto())
    return path


def rm_requests(n_requests: int, n: int, words: int, seed: int = 0) -> list:
    """bench.py's make_requests: each candidate ``words`` bench words and
    the tags ``v<request>`` and ``c<candidate>``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [
        [" ".join(rng.choice(BENCH_WORDS, size=words).tolist()
                  + [f"v{r}", f"c{i}"]) for i in range(n)]
        for r in range(n_requests)
    ]


def check_native_tokenizers(gpu: str, vocab: str) -> dict:
    """The native tokenizer library loads on the card's machine; 512
    texts through WordPiece (bge_micro's vocab.txt) and the unigram
    tokenizer (the synthetic spm.model), native and Python, with the same
    ids."""
    from llm_weighted_consensus_tpu_torch.models import spm, tokenizer
    from llm_weighted_consensus_tpu_torch.utils import native

    t = time.perf_counter()
    lib = native.load_library()
    load_ms = (time.perf_counter() - t) * 1e3
    if lib is None:
        raise AssertionError(
            f"the native tokenizer library did not build or load "
            f"({native.NATIVE_SO})")
    texts = [t for req in rm_requests(32, RM_N, RM_WORDS, seed=7) for t in req]
    fixture_vocab = os.path.join(REPO, "tests", "fixtures", "bge_micro",
                                 "vocab.txt")
    vocab_wp = tokenizer.WordPieceTokenizer.from_vocab_file(fixture_vocab).vocab
    pairs = {
        "wordpiece": (tokenizer.WordPieceTokenizer(vocab_wp),
                      tokenizer.WordPieceTokenizer(vocab_wp, use_native=False)),
        "unigram": (spm.UnigramTokenizer.from_model_file(vocab, "deberta"),
                    spm.UnigramTokenizer(spm.parse_model_proto(
                        open(vocab, "rb").read()), "deberta",
                        use_native=False)),
    }
    row = {"phase": "native_tokenizers", "gpu": gpu, "library":
           os.path.relpath(str(native.NATIVE_SO), REPO),
           "load_ms": load_ms, "texts": len(texts)}
    for name, (fast, slow) in pairs.items():
        if fast._native is None:
            raise AssertionError(f"{name}: no native path")
        times = {}
        for label, tok in (("native", fast), ("python", slow)):
            t = time.perf_counter()
            ids, mask = tok.encode_batch(texts, 512)
            times[label] = (time.perf_counter() - t) * 1e3
            times[label + "_ids"] = ids
        if not (times["native_ids"] == times["python_ids"]).all():
            raise AssertionError(f"{name}: native ids differ from Python's")
        row[f"{name}_native_ms"] = times["native"]
        row[f"{name}_python_ms"] = times["python"]
        row[f"{name}_tokens"] = int(mask.sum())
    emit(row)
    return row


def _rm_state(cfg, seed: int) -> dict:
    """Random weights of ``cfg`` from ``seed`` (the port's init), f32."""
    from llm_weighted_consensus_tpu_torch.models import deberta

    model = deberta.init_params(cfg, seed=seed, device="cpu")
    return {k: v.numpy() for k, v in model.state_dict().items()}


def _rm_on(state, cfg, device, quantize="none", tokenizer=None,
           max_tokens=512):
    """A reranker of ``state`` on ``device`` in f32."""
    import torch

    from llm_weighted_consensus_tpu_torch.models import deberta
    from llm_weighted_consensus_tpu_torch.models.reranker import TorchReranker

    dtype = torch.float32
    return TorchReranker(
        "rm", model=deberta.from_state(state, cfg, dtype, device),
        tokenizer=tokenizer, device=device, dtype=dtype,
        max_tokens=max_tokens, quantize=quantize,
    )


def check_rm_tiny(gpu: str) -> dict:
    """DEBERTA_TEST_TINY and its log-bucket twin in f32: /consensus
    {"scorer": "rm"} served on the card against the port on the CPU,
    unquantized and under int8 / int4-pallas; reward_packed on the card
    against per-row rewards on the card."""
    import dataclasses

    import numpy as np
    import torch

    from llm_weighted_consensus_tpu_torch.models import configs, deberta
    from llm_weighted_consensus_tpu_torch.serve import packing
    from llm_weighted_consensus_tpu_torch.serve.gateway import Server

    rng = np.random.default_rng(5)
    vocab = [f"t{i}" for i in range(300)]
    # 3 to 62 words: the s=16, 32, 48 and 64 buckets
    texts = [" ".join(rng.choice(vocab, size=n)) for n in (3, 62, 20, 40, 9, 30)]
    rows, worst = [], {"none": 0.0, "int8": 0.0, "int4-pallas": 0.0}
    for name, cfg in (
        ("clamp", configs.DEBERTA_TEST_TINY),
        ("log", dataclasses.replace(configs.DEBERTA_TEST_TINY, **RM_LOG_TINY)),
    ):
        state = _rm_state(cfg, seed=3)
        for mode in ("none", "int8", "int4-pallas"):
            cpu = _rm_on(state, cfg, "cpu", mode, max_tokens=64)
            card = _rm_on(state, cfg, "cuda", mode, max_tokens=64)
            reset_launches()
            with Server(reranker=card) as srv:
                outs = [post(srv.port, "/consensus", {
                    "input": texts[:k], "scorer": "rm", "prompt": p,
                    "temperature": temp,
                }) for k, p, temp in RM_TINY_REQUESTS]
            launches = read_launches()
            errs = []
            for out, (k, p, temp) in zip(outs, RM_TINY_REQUESTS):
                want, tokens = cpu.rerank_confidence(texts[:k], p, temp)
                check_answer(out["confidence"], k)
                if out["usage"]["prompt_tokens"] != tokens:
                    raise AssertionError(f"rm tiny {name}: usage {out}")
                errs.append(float(np.abs(np.asarray(out["confidence"])
                                         - want).max()))
            dense = 6 * cfg.num_layers * len(outs) if mode != "none" else 0
            want_l = {"w8a8_matmul": dense if mode == "int8" else 0,
                      "w4a8_matmul": dense if mode == "int4-pallas" else 0,
                      "quantize_rows": dense}
            if {k: launches[k] for k in want_l} != want_l:
                raise AssertionError(
                    f"rm tiny {name} {mode}: launches {launches}, want "
                    f"{want_l}")
            tol = MICRO_TOL if mode == "none" else QUANT_MICRO_TOL
            worst[mode] = max(worst[mode], max(errs))
            if max(errs) > tol:
                raise AssertionError(
                    f"rm tiny {name} {mode}: card vs CPU {errs} > {tol}")
        # packed on the card against per-row on the card, unquantized
        card = _rm_on(state, cfg, "cuda", max_tokens=64)
        ids, mask = card.tokenize(texts)
        lens = mask.sum(axis=1)

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).cuda()

        with torch.inference_mode():
            per_row = deberta.reward(card.model, dev(ids), dev(mask)).cpu()
            ragged = [ids[i, :lens[i]] for i in range(len(texts))]
            packed_err = 0.0
            for call in packing.build_calls(ragged, 64, 4, 8):
                out = deberta.reward_packed(
                    card.model, dev(call.ids), dev(call.segment_ids),
                    dev(call.seg_starts)).cpu()
                if not torch.isfinite(out).all():
                    raise AssertionError(f"rm tiny {name}: packed not finite")
                for si, (r, slot) in call.slots.items():
                    packed_err = max(packed_err,
                                     abs(float(out[r, slot] - per_row[si])))
        if packed_err > MICRO_TOL:
            raise AssertionError(
                f"rm tiny {name}: packed vs per-row {packed_err}")
        rows.append({"config": name, "packed_vs_per_row": packed_err})
    row = {"phase": "rm_tiny", "gpu": gpu, "dtype": "float32",
           "max_conf_err": worst,
           "tolerance": {"none": MICRO_TOL, "quantized": QUANT_MICRO_TOL},
           "packed": rows, "packed_tolerance": MICRO_TOL}
    emit(row)
    return row


def rm_bucket_ok(out, n: int, lo: int, hi: int) -> None:
    check_answer(out["confidence"], n)
    if not lo * n < out["usage"]["prompt_tokens"] <= hi * n:
        raise AssertionError(
            f"rm request of {n} with {out['usage']} is not in the s={hi} "
            "bucket")


def serve_rm(reranker, requests, long_texts=None) -> dict:
    """``requests`` (lists of candidate texts) as /consensus {"scorer":
    "rm", "prompt": RM_PROMPT} through the port's server, RM_INFLIGHT at
    a time, then the optional long request; the launch counts are set to
    0 after one warm-up request and read at the end."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from llm_weighted_consensus_tpu_torch.serve.gateway import Server

    def body(texts):
        return {"input": texts, "scorer": "rm", "prompt": RM_PROMPT}

    with Server(reranker=reranker) as srv:
        post(srv.port, "/consensus", body(requests[0]))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()

        def call(texts):
            t = time.perf_counter()
            out = post(srv.port, "/consensus", body(texts))
            return out, (time.perf_counter() - t) * 1e3

        t0 = time.perf_counter()
        with ThreadPoolExecutor(RM_INFLIGHT) as pool:
            results = list(pool.map(call, requests, timeout=600))
        burst_s = time.perf_counter() - t0
        long_out = long_ms = None
        if long_texts is not None:
            long_out, long_ms = call(long_texts)
        torch.cuda.synchronize()
        launches = read_launches()
        routes = {name: dict(_wrappers()[name].routes)
                  for name in ("w8a8_matmul", "w4a8_matmul")}
    for out, _ in results:
        rm_bucket_ok(out, len(requests[0]), 112, 128)
    lat = sorted(ms for _, ms in results)
    return {
        "answers": [np.asarray(out["confidence"]) for out, _ in results],
        "launches": launches, "routes": routes,
        "p50_ms": float(np.median(lat)), "max_ms": lat[-1],
        "answers_per_s": len(results) / burst_s, "requests": len(results),
        "long_out": long_out, "long_ms": long_ms,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }


def rm_env(vocab: str, quantize: str = "none") -> dict:
    """The server's environment for deberta-v3-base with random weights
    from seed 0 (the opt-in) and the synthetic spm.model."""
    return {"RM_MODEL": "deberta-v3-base", "RM_VOCAB": vocab,
            "RM_MAX_TOKENS": "512", "RM_QUANTIZE": quantize,
            "LWC_ALLOW_RANDOM_PARAMS": "1"}


def rm_path(gpu: str, vocab: str) -> dict:
    """deberta-v3-base at full width, bf16, served by the port's server
    (``build_reranker``, the entry point a user calls): BASELINE config
    3's traffic and one N=64 request in the s=512 bucket; then one N=4
    request in f32 on the card against the CPU, and bf16 against f32."""
    import numpy as np
    import torch

    from llm_weighted_consensus_tpu_torch.models import configs
    from llm_weighted_consensus_tpu_torch.serve.__main__ import build_reranker

    t0 = time.perf_counter()
    served = build_reranker(rm_env(vocab), device="cuda")
    init_s = time.perf_counter() - t0
    if served.dtype != torch.bfloat16 or served.config != configs.DEBERTA_V3_BASE:
        raise AssertionError(f"served {served.config} in {served.dtype}")
    requests = rm_requests(RM_REQUESTS, RM_N, RM_WORDS)
    long_texts = rm_requests(1, RM_LONG_N, RM_LONG_WORDS, seed=1)[0]
    out = serve_rm(served, requests, long_texts)
    rm_bucket_ok(out["long_out"], RM_LONG_N, 384, 512)
    if any(out["launches"].values()):
        # the unquantized RM runs no kernel of the port: the disentangled
        # attention and the dense layers are torch ops (cuBLAS)
        raise AssertionError(f"rm: port kernels launched {out['launches']}")
    # full-width numerics on one N=4 request: f32 on the card against the
    # CPU, bf16 (the served model) against f32 on the card
    cfg = configs.DEBERTA_V3_BASE
    state = _rm_state(cfg, seed=0)
    texts = requests[0][:4]
    confs = {}
    for key, rr in (("cpu", _rm_on(state, cfg, "cpu", tokenizer=served.tokenizer)),
                    ("cuda_f32", _rm_on(state, cfg, "cuda",
                                        tokenizer=served.tokenizer)),
                    ("cuda_bf16", served)):
        confs[key] = rr.rerank_confidence(texts, prompt=RM_PROMPT)[0]
        del rr
    del state
    f32_err = float(np.abs(confs["cuda_f32"] - confs["cpu"]).max())
    bf16_err = float(np.abs(confs["cuda_bf16"] - confs["cuda_f32"]).max())
    cf, cb = confs["cuda_f32"], confs["cuda_bf16"]
    pairs = [(i, j) for i in range(4) for j in range(4)
             if cf[i] - cf[j] > RM_BF16_SEP]
    flipped = [(i, j) for i, j in pairs if not cb[i] > cb[j]]
    row = {
        "phase": "rm_path", "gpu": gpu, "model": "deberta-v3-base",
        "dtype": "bfloat16", "init_s": init_s, "requests": out["requests"],
        "candidates": RM_N, "in_flight": RM_INFLIGHT,
        "p50_ms": out["p50_ms"], "max_ms": out["max_ms"],
        "answers_per_s": out["answers_per_s"],
        "long_request_ms": out["long_ms"],
        "long_request_tokens": out["long_out"]["usage"]["prompt_tokens"],
        "launches": out["launches"], "peak_mem_gib": out["peak_mem_gib"],
        "f32_card_vs_cpu": f32_err, "f32_tolerance": RM_FULL_F32_TOL,
        "bf16_vs_f32": bf16_err, "bf16_tolerance": RM_BF16_TOL,
        "bf16_pairs_checked": len(pairs), "bf16_pairs_flipped": flipped,
        "confidence": {k: v.tolist() for k, v in confs.items()},
    }
    emit(row)
    if f32_err > RM_FULL_F32_TOL or bf16_err > RM_BF16_TOL or flipped:
        raise AssertionError(f"rm full-width numerics: {row}")
    return {"row": row, "served": served, "requests": requests,
            "answers": out["answers"]}


def rm_quant_path(gpu: str, vocab: str, mode: str, full: dict) -> dict:
    """The same server under RM_QUANTIZE=mode: one burst of RM_INFLIGHT
    requests, 72 quantized GEMM launches (12 layers x 6) per reward call,
    all on the TMA route, one row quantisation per GEMM; answers against
    the unquantized path's on the same texts."""
    import numpy as np

    from llm_weighted_consensus_tpu_torch.models import quant
    from llm_weighted_consensus_tpu_torch.serve.__main__ import build_reranker

    t0 = time.perf_counter()
    rr = build_reranker(rm_env(vocab, mode), device="cuda")
    init_s = time.perf_counter() - t0
    layers = rr.config.num_layers
    denses = [m for m in rr.model.modules() if isinstance(m, quant.QuantLinear)]
    if len(denses) != 6 * layers:
        raise AssertionError(f"rm {mode}: {len(denses)} quantized layers")
    burst = full["requests"][:RM_INFLIGHT]
    out = serve_rm(rr, burst)
    name = "w4a8_matmul" if mode.startswith("int4") else "w8a8_matmul"
    other = "w8a8_matmul" if name == "w4a8_matmul" else "w4a8_matmul"
    want = 6 * layers * len(burst)
    launches = out["launches"]
    if (launches[name] != want or launches[other]
            or launches["quantize_rows"] != want
            or out["routes"][name]["tma"] != want):
        raise AssertionError(
            f"rm {mode}: launches {launches}, routes {out['routes']}, "
            f"want {want} on tma")
    diff = max(float(np.abs(got - ref).max())
               for got, ref in zip(out["answers"], full["answers"]))
    row = {
        "phase": "rm_quant_path", "gpu": gpu, "model": "deberta-v3-base",
        "quantize": mode, "dtype": "bfloat16", "init_s": init_s,
        "requests": out["requests"], "p50_ms": out["p50_ms"],
        "answers_per_s": out["answers_per_s"], "launches": launches,
        "routes": out["routes"], "launches_per_reward_call":
            launches[name] / len(burst),
        "max_conf_diff_vs_unquantized": diff,
        "conf_bar": RM_QUANT_BARS[mode], "peak_mem_gib": out["peak_mem_gib"],
    }
    emit(row)
    if diff > RM_QUANT_BARS[mode]:
        raise AssertionError(f"rm {mode} against unquantized: {row}")
    row["reranker"] = rr
    return row


def profile_rm(gpu: str, rr, texts, quantize: str) -> dict:
    """Device time by kernel for one full-width RM request (N=16, s=128)
    into chiprun_out/profile_rm.txt (profile_rm_int8.txt under int8),
    with the idle share.  cuBLAS GEMMs are expected there (the position
    projections, the score einsums, P·V, the head, and unquantized every
    dense layer) and are named; under int8 the profile must show
    ``quant_gemm_tma_kernel`` 72 times and no ``quant_gemm_kernel``."""
    texts = [f"{RM_PROMPT}\n{t}" for t in texts]
    ids, mask = rr.tokenize(texts)
    layers = rr.config.num_layers

    def complete(rows):
        return quantize == "none" or launches_of(
            rows, "quant_gemm_tma_kernel", W8) == 6 * layers

    rows, wall_ms, traces = profile_call(
        lambda: rr.confidence_tokens(ids, mask), complete)
    device_ms = sum(r[0] for r in rows)
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    name = ("profile_rm.txt" if quantize == "none"
            else f"profile_rm_{quantize}.txt")
    with open(os.path.join(out_dir, name), "w") as f:
        f.write(f"# {gpu}; one deberta-v3-base RM request N={ids.shape[0]} "
                f"s={ids.shape[1]} bf16, quantize={quantize}, wall "
                f"{wall_ms:.3f} ms\n")
        for ms, count, key in rows:
            f.write(f"{ms:10.3f} ms  {count:6d}  {key[:110]}\n")
    cublas = cublas_gemms(rows)
    cublas_ms = sum(ms for ms, _, key in rows if key in cublas)
    gemms = {
        "quant_gemm_tma_kernel<W8>": launches_of(
            rows, "quant_gemm_tma_kernel", W8),
        "quant_gemm_kernel": launches_of(rows, "quant_gemm_kernel"),
        "quantize_rows_kernel": launches_of(rows, "quantize_rows_kernel"),
    }
    row = {
        "phase": "profile_rm", "gpu": gpu, "quantize": quantize,
        "shape": list(ids.shape), "traces": traces, "wall_ms": wall_ms,
        "device_ms": device_ms, "device_idle_share": 1.0 - device_ms / wall_ms,
        "kernel_launches": gemms, "cublas_gemm_kernels": cublas,
        "cublas_gemm_launches": sum(c for _, c, k in rows if k in cublas),
        "cublas_gemm_ms": cublas_ms,
        "top": [{"kernel": key[:80], "ms": ms, "count": count}
                for ms, count, key in rows[:8]],
    }
    emit(row)
    if quantize != "none" and (
        gemms["quant_gemm_tma_kernel<W8>"] != 6 * layers
        or gemms["quant_gemm_kernel"]
    ):
        raise AssertionError(f"rm profile ({quantize}): {gemms}")
    if device_ms > wall_ms * DEVICE_TIME_SLACK:
        raise AssertionError(
            f"rm profile: device time {device_ms} ms exceeds the wall "
            f"time {wall_ms} ms")
    return row


def rm_phase(gpu: str, timed) -> dict:
    """Phase 8: native tokenizers, the tiny configs card against CPU, the
    full-width served path, its quantized twins and two profiles."""
    import torch

    vocab = rm_vocab_path()
    timed("rm_path", check_native_tokenizers, gpu, vocab)
    timed("rm_path", check_rm_tiny, gpu)
    full = timed("rm_path", rm_path, gpu, vocab)
    timed("rm_path", profile_rm, gpu, full["served"], full["requests"][0],
          "none")
    del full["served"]
    torch.cuda.empty_cache()
    q = {}
    for mode in ("int8", "int4-pallas"):
        q[mode] = timed("rm_path", rm_quant_path, gpu, vocab, mode, full)
        rr = q[mode].pop("reranker")
        if mode == "int8":
            timed("rm_path", profile_rm, gpu, rr, full["requests"][0], mode)
        del rr
        torch.cuda.empty_cache()
    return {"row": full["row"], "int8": q["int8"], "int4": q["int4-pallas"]}


# -- phase 9: the served paths through the full batcher, eager and graphed ----


def serving_env(**extra) -> dict:
    """The server's environment for bge-large with random weights from
    seed 0 (the opt-in), and the earlier phases' 100 ms window."""
    env = {"EMBEDDER_MODEL": "bge-large-en", "EMBEDDER_MAX_TOKENS": "512",
           "LWC_ALLOW_RANDOM_PARAMS": "1", "BATCH_WINDOW_MS": "100",
           "BATCH_MAX": str(BURST)}
    env.update(extra)
    return env


def drive_bursts(port, bursts, model_name=None, embeds=(),
                 long_texts=None) -> dict:
    """Each burst's /consensus requests at once, with the /embeddings
    request ``embeds[k]`` of burst k where there is one, then the optional
    long request; -> every answer in order, p50 and answers/s of the
    bursts."""
    import threading

    import numpy as np

    results, latencies = {}, []

    def call(key, path, body):
        t = time.perf_counter()
        status, _, out = http(port, path, body)
        if status != 200:
            raise AssertionError(f"{path} {key}: {status} {out}")
        if path == "/consensus":
            latencies.append((time.perf_counter() - t) * 1e3)
        results[key] = out

    t0 = time.perf_counter()
    for k, burst in enumerate(bursts):
        threads = [threading.Thread(target=call, args=(
            (k, i), "/consensus", {"input": texts}))
            for i, texts in enumerate(burst)]
        if k < len(embeds):
            threads.append(threading.Thread(target=call, args=(
                (k, "embed"), "/embeddings",
                {"model": model_name, "input": embeds[k]})))
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        if any(t.is_alive() for t in threads):
            raise AssertionError("a request did not return")
    burst_s = time.perf_counter() - t0
    if long_texts is not None:
        call("long", "/consensus", {"input": long_texts})
    answers = []
    for k, burst in enumerate(bursts):
        for i, texts in enumerate(burst):
            check_answer(results[(k, i)]["confidence"], len(texts))
            answers.append(np.asarray(results[(k, i)]["confidence"]))
        if k < len(embeds):
            vecs = np.asarray(
                [r["embedding"] for r in results[(k, "embed")]["data"]])
            if vecs.shape[0] != len(embeds[k]) or not np.isfinite(vecs).all():
                raise AssertionError(f"/embeddings burst {k}: {vecs.shape}")
            answers.append(vecs)
    if long_texts is not None:
        check_answer(results["long"]["confidence"], len(long_texts))
        answers.append(np.asarray(results["long"]["confidence"]))
    return {"answers": answers, "p50_ms": float(np.median(latencies)),
            "answers_per_s": len(latencies) / burst_s,
            "requests": len(latencies)}


def drive_rm(port, requests) -> dict:
    """``requests`` as /consensus {"scorer": "rm"} RM_INFLIGHT at a time;
    -> answers, p50 and answers/s."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    def call(texts):
        t = time.perf_counter()
        status, _, out = http(port, "/consensus", {
            "input": texts, "scorer": "rm", "prompt": RM_PROMPT})
        if status != 200:
            raise AssertionError(f"rm request: {status} {out}")
        rm_bucket_ok(out, len(texts), 112, 128)
        return np.asarray(out["confidence"]), (time.perf_counter() - t) * 1e3

    t0 = time.perf_counter()
    with ThreadPoolExecutor(RM_INFLIGHT) as pool:
        results = list(pool.map(call, requests, timeout=600))
    burst_s = time.perf_counter() - t0
    return {"answers": [a for a, _ in results],
            "p50_ms": float(np.median([ms for _, ms in results])),
            "answers_per_s": len(results) / burst_s,
            "requests": len(results)}


def profile_one(fn, want_launches=None) -> dict:
    """Wall, device time and idle share of one synchronous call: the
    profiler's sum over the call's device records, traced again (up to 3
    traces) while fewer than ``want_launches`` records came back (a
    replay runs the eager call's kernels, so the eager count is the
    want).  Where every trace lost records, the device time and the idle
    share are None: the profiler is their one source."""

    def count(rows):
        return sum(c for _, c, _ in rows)

    rows, wall_ms, traces = profile_call(
        fn, None if want_launches is None
        else lambda rows: count(rows) >= want_launches)
    device_ms = sum(r[0] for r in rows)
    if want_launches is not None and count(rows) < want_launches:
        device_ms = None
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "device_idle_share": None if device_ms is None
            else 1.0 - device_ms / wall_ms,
            "device_records": count(rows), "traces": traces}


def scrape_metrics(port) -> dict:
    """/metrics as JSON and as OpenMetrics text; fails unless both parse
    and the text's kernel counters are the wrappers' own."""
    import re

    status, _, snap = http(port, "/metrics")
    if status != 200 or not isinstance(snap, dict):
        raise AssertionError(f"/metrics: {status}")
    status, headers, text = http(port, "/metrics?format=prometheus")
    lines = text.splitlines()
    sample = re.compile(r'^([a-z_]+)(\{[^{}]*\})? (-?[0-9.e+-]+|[+-]?Inf)$')
    bad = [ln for ln in lines[:-1]
           if not ln.startswith("# ") and not sample.match(ln)]
    if status != 200 or lines[-1] != "# EOF" or bad or not headers.get(
            "Content-Type", headers.get("content-type", "")).startswith(
                "application/openmetrics-text"):
        raise AssertionError(f"/metrics?format=prometheus: {status} {bad[:3]}")
    counts = {
        m.group(1): int(m.group(2)) for m in (
            re.match(r'lwc_kernel_launches_total\{kernel="(\w+)"\} (\d+)$', ln)
            for ln in lines) if m
    }
    if counts != read_launches():
        raise AssertionError(f"/metrics kernels {counts} != {read_launches()}")
    return {"sections": sorted(snap), "prometheus_lines": len(lines),
            "kernel_launches": counts}


def drain_check(srv, burst) -> dict:
    """A burst in flight, then the drain: every admitted request finishes
    200, a new one sheds 503 ``draining``, ``/readyz`` turns 503."""
    import threading

    statuses = []

    def call(texts):
        statuses.append(http(srv.port, "/consensus", {"input": texts})[0])

    threads = [threading.Thread(target=call, args=(t,)) for t in burst]
    for t in threads:
        t.start()
    for _ in range(2000):
        if srv.admission.inflight == len(burst):
            break
        time.sleep(0.001)
    inflight = srv.admission.inflight
    drained = srv.lifecycle.begin_drain()
    while srv.lifecycle.state == "ready":
        time.sleep(0.001)
    shed = http(srv.port, "/consensus", {"input": burst[0]})
    readyz = http(srv.port, "/readyz")[0]
    clean = drained.result(120)
    for t in threads:
        t.join(600)
    row = {"in_flight_at_drain": inflight, "statuses": sorted(statuses),
           "shed_status": shed[0],
           "shed_reason": shed[2]["message"]["shed_reason"]
           if shed[0] == 503 else None,
           "readyz_while_draining": readyz, "drained_clean": clean,
           "drain_ms": srv.lifecycle.drain_elapsed_ms}
    if (statuses != [200] * len(burst) or inflight < 1 or shed[0] != 503
            or row["shed_reason"] != "draining" or readyz != 503
            or not clean):
        raise AssertionError(f"drain: {row}")
    return row


def answers_diff(a: list, b: list) -> float:
    import numpy as np

    return max(float(np.abs(x - y).max()) for x, y in zip(a, b))


def record_dispatches(model):
    """Wrap ``model.graphs.dispatch`` (every dispatch the model makes,
    replayed or eager) so each one's bucket, staged host inputs (copied),
    forward, post step and returned value are kept; -> (the records, a
    function that removes the wrap)."""
    import threading

    import numpy as np

    table = model.graphs
    inner = table.dispatch
    records, lock = [], threading.Lock()

    def dispatch(key, label, arrays, forward, post, pool, timed=True):
        kept = {name: np.array(a, copy=True) for name, a in arrays.items()}
        out = inner(key, label, arrays, forward, post, pool, timed)
        with lock:
            records.append((key, kept, forward, post, out))
        return out

    table.dispatch = dispatch
    return records, lambda: delattr(table, "dispatch")


def bucket_counts(records) -> dict:
    """Dispatches per bucket label, e.g. ``{"many(4,64,128)": 3}``."""
    from llm_weighted_consensus_tpu_torch.models.graphs import key_label

    counts = {}
    for key, *_ in records:
        counts[key_label(key)] = counts.get(key_label(key), 0) + 1
    return dict(sorted(counts.items()))


def same_bucket_check(model, records) -> dict:
    """Each recorded (graphed) dispatch's output against an eager call at
    the same bucket on the same inputs: the forward the graph captured,
    run without it, then the same post step.  Then, once per bucket, the
    planted fault a shared static input makes possible: the post step of
    one dispatch on another dispatch's inputs at that bucket (or, with
    no other dispatch there, its own token ids shifted by one place),
    read against the first dispatch's output."""
    import numpy as np
    import torch

    from llm_weighted_consensus_tpu_torch.models.graphs import key_label

    table = model.graphs

    def eager(arrays, forward, post):
        with table.lock, torch.inference_mode():
            out = post(forward(**{
                name: torch.from_numpy(a).to(table.device)
                for name, a in arrays.items()}))
            return out.float().cpu().numpy()

    def served(out):
        result = getattr(out, "result", None)
        return np.asarray(result() if result is not None else out,
                          np.float32)

    worst, bit_equal, faults = 0.0, 0, {}
    for i, (key, arrays, forward, post, out) in enumerate(records):
        got = served(out)
        diff = float(np.abs(got - eager(arrays, forward, post)).max())
        worst = max(worst, diff)
        bit_equal += diff == 0.0
        if key_label(key) in faults:
            continue
        other = next((a for k, a, *_ in records if k == key and any(
            not np.array_equal(a[n], arrays[n]) for n in arrays)), None)
        source = "other_dispatch"
        if other is None:
            other = dict(arrays, ids=np.roll(arrays["ids"], 1))
            source = "rolled_ids"
        faults[key_label(key)] = {
            "max_abs": float(np.abs(got - eager(other, forward, post)).max()),
            "inputs": source}
    return {"dispatches": len(records), "bit_equal": bit_equal,
            "max_abs": worst, "faults": faults,
            "fault_min_abs": min(f["max_abs"] for f in faults.values())}


def graphed_path(gpu, name, model, start_server, warm, drive, profile,
                 expected, drain_burst=None) -> dict:
    """One served path eager, then graphed, in this run: ``start_server()``
    starts the port's server (not ready), ``warm(server)`` captures its
    buckets, ``drive(server)`` sends the path's traffic, ``profile()``
    makes one call at the path's main bucket, ``expected(stats delta)``
    gives the launches the traffic must make.  Fails unless the graphed
    run captured nothing, replayed, launched every kernel ``expected``
    names on its route (counted through replays), gave at every dispatch
    what an eager call at the same bucket on the same inputs gives
    (``GRAPH_TOL``, while a planted cross-talk fault reads at least
    ``FAULT_MARGIN`` times that), answered as the eager run did
    (``RUN_TOL``), and ``/readyz`` flipped from 503 to 200 at warmup."""
    import torch

    srv = start_server()
    srv.lifecycle.mark_ready()  # eager: no graphs
    eager_records, unwrap = record_dispatches(model)
    try:
        eager = drive(srv)
    finally:
        unwrap()
    eager_prof = profile_one(profile)
    srv.close()
    if model.graph_stats()["graphs"]:
        raise AssertionError(f"{name}: graphs before warmup")
    srv = start_server()
    try:
        readyz_before = http(srv.port, "/readyz")[0]
        t = time.perf_counter()
        timings = warm(srv)
        warmup_s = time.perf_counter() - t
        readyz_after = http(srv.port, "/readyz")[0]
        torch.cuda.synchronize()
        stats0 = model.graph_stats()
        batch0 = srv.batcher.stats() if srv.batcher is not None else {}
        reset_launches()
        records, unwrap = record_dispatches(model)
        try:
            graphed = drive(srv)
        finally:
            unwrap()
        torch.cuda.synchronize()
        launches = read_launches()
        routes = read_routes()
        stats1 = model.graph_stats()
        batch = _delta(srv.batcher.stats(), batch0) if batch0 else {}
        scrape = scrape_metrics(srv.port)
        graphed_prof = profile_one(profile, eager_prof["device_records"])
        drain = drain_check(srv, drain_burst) if drain_burst else None
    finally:
        srv.close()
    same = same_bucket_check(model, records)
    want = expected(batch)
    diff = answers_diff(graphed["answers"], eager["answers"])
    row = {
        "phase": "serving", "path": name, "gpu": gpu,
        "warmup_s": warmup_s, "graphs": stats1["graphs"],
        "captures_at_warmup": stats0["captures"],
        "captures_after_warmup": stats1["captures"] - stats0["captures"],
        "replays": stats1["replays"] - stats0["replays"],
        "eager_dispatches": stats1["eager_dispatches"]
        - stats0["eager_dispatches"],
        "pool_bytes": stats1["pool_bytes"],
        "buckets": {"eager": bucket_counts(eager_records),
                    "graphed": bucket_counts(records)},
        "launches": launches, "expected_launches": want, "routes": routes,
        "same_bucket": same, "tolerance": GRAPH_TOL,
        "fault_margin": FAULT_MARGIN,
        "runs_max_abs": diff, "runs_tolerance": RUN_TOL,
        "readyz": [readyz_before, readyz_after],
        "eager": {k: eager[k] for k in ("p50_ms", "answers_per_s",
                                        "requests")} | {"call": eager_prof},
        "graphed": {k: graphed[k] for k in ("p50_ms", "answers_per_s",
                                            "requests")}
        | {"call": graphed_prof},
        "metrics": scrape, "drain": drain,
        "warmed": [label for label, _ in timings],
    }
    emit(row)
    launched = {k: v for k, v in want.items() if v}
    if (row["captures_after_warmup"] or row["replays"] < 1
            or readyz_before != 503 or readyz_after != 200
            or same["max_abs"] > GRAPH_TOL
            or same["fault_min_abs"] <= FAULT_MARGIN * GRAPH_TOL
            or diff > RUN_TOL or launches != want
            or any(launches[k] < 1 for k in launched)):
        raise AssertionError(f"serving {name}: {row}")
    return row


def serving_phase(gpu: str, timed) -> dict:
    """Phase 9: every served path through the port's server and the full
    batcher (``build_server``, ``warm_up``), eager and then replayed from
    CUDA graphs captured at warmup, in one run."""
    import numpy as np
    import torch

    from llm_weighted_consensus_tpu_torch.models.embedder import TorchEmbedder
    from llm_weighted_consensus_tpu_torch.serve import packing
    from llm_weighted_consensus_tpu_torch.serve.__main__ import (
        build_embedder,
        build_reranker,
        build_server,
        warm_up,
    )
    from llm_weighted_consensus_tpu_torch.serve.config import ServeConfig

    rows = {}

    def starter(emb, rr, env):
        config = ServeConfig.from_env(env)

        def start():
            return build_server(emb, rr, config).start()

        return start, config

    # main: bge-large padded, the main path's traffic
    env = serving_env(WARMUP="64x128,16x512,32x64", WARMUP_R="2,4,8")
    main = build_embedder(env, device="cuda")
    layers = main.config.num_layers
    rng = np.random.default_rng(0)
    bursts = [[candidate_texts(rng, N_CANDIDATES, BURST_WORDS)
               for _ in range(BURST)] for _ in range(3)]
    long_texts = candidate_texts(rng, LONG_N, LONG_WORDS)
    embeds = [candidate_texts(rng, EMBED_N, EMBED_WORDS)]
    ids, mask = main.tokenize([t for r in bursts[0] for t in r])
    ids, mask = ids.reshape(BURST, N_CANDIDATES, -1), mask.reshape(
        BURST, N_CANDIDATES, -1)
    start, config = starter(main, None, env)

    def padded_expected(quantize):
        return lambda d: expected_launches(
            layers, d["dispatches"]["consensus"], d["dispatches"]["embed"],
            quantize)

    rows["main"] = timed("serving", graphed_path, gpu, "main", main, start,
                         lambda srv: warm_up(srv, config),
                         lambda srv: drive_bursts(
                             srv.port, bursts, "bge-large-en", embeds,
                             long_texts),
                         lambda: main.consensus_confidence_tokens_many(
                             ids, mask),
                         padded_expected("none"), drain_burst=bursts[0])
    # packed: the same weights, PACKING defaults, the mixed traffic; every
    # packed [b, L] the traffic can take is warmed
    packed = TorchEmbedder("bge-large-en", model=main.model,
                           config=main.config, tokenizer=main.tokenizer,
                           max_tokens=512, device="cuda",
                           dtype=torch.bfloat16)
    penv = serving_env(PACKING_ENABLED="1", BATCH_MAX="64", WARMUP="8x128")
    pstart, pconfig = starter(packed, None, penv)
    buckets = [(b, l, PACKING["packing_max_segments"])
               for b, l in PACKED_SHAPES]
    mixed, membeds = mixed_traffic()
    calls = packing.build_calls(
        packed.tokenize_ragged([t for b in mixed for r in b for t in r],
                               PACKING["packing_row_tokens"]),
        PACKING["packing_row_tokens"], PACKING["packing_max_rows"],
        PACKING["packing_max_segments"])
    call = next(c for c in calls if c.ids.shape == SEG_BUCKET)
    rows["packed"] = timed(
        "serving", graphed_path, gpu, "packed", packed, pstart,
        lambda srv: srv.warmup([], [], buckets),
        lambda srv: drive_bursts(srv.port, mixed, "bge-large-en", membeds),
        lambda: packed.embed_packed(call.ids, call.segment_ids,
                                    call.positions, call.seg_starts),
        lambda d: expected_launches(
            layers, 0, 0, packed_calls=sum(d["packing"]["call_shapes"].values())),
    )
    del packed, main
    torch.cuda.empty_cache()
    # quantized: int8 (3 bursts) and int4 (1 burst), fresh weights
    for mode, n_bursts in (("int8", 3), ("int4-pallas", 1)):
        qenv = serving_env(WARMUP="64x128,32x64", WARMUP_R="2,4,8",
                           EMBEDDER_QUANTIZE=mode)
        emb = build_embedder(qenv, device="cuda")
        qstart, qconfig = starter(emb, None, qenv)
        rows[mode] = timed(
            "serving", graphed_path, gpu, mode, emb, qstart,
            lambda srv, qconfig=qconfig: warm_up(srv, qconfig),
            lambda srv, n=n_bursts: drive_bursts(
                srv.port, bursts[:n], "bge-large-en", embeds),
            lambda emb=emb: emb.consensus_confidence_tokens_many(ids, mask),
            padded_expected(mode))
        del emb
        torch.cuda.empty_cache()
    # the reward model: BASELINE config 3, unquantized and under int8
    vocab = rm_vocab_path()
    requests = rm_requests(RM_REQUESTS, RM_N, RM_WORDS)
    for mode, reqs in (("none", requests), ("int8", requests[:RM_INFLIGHT])):
        renv = dict(rm_env(vocab, mode), RM_WARMUP="16x128")
        rr = build_reranker(renv, device="cuda")
        rids, rmask = rr.tokenize([f"{RM_PROMPT}\n{t}" for t in requests[0]])
        rstart, rconfig = starter(None, rr, renv)
        dense = 6 * rr.config.num_layers * len(reqs) if mode != "none" else 0
        rows["rm" if mode == "none" else "rm_int8"] = timed(
            "serving", graphed_path, gpu, "rm" if mode == "none" else
            "rm_int8", rr, rstart,
            lambda srv, rconfig=rconfig: warm_up(srv, rconfig),
            lambda srv, reqs=reqs: drive_rm(srv.port, reqs),
            lambda rr=rr, rids=rids, rmask=rmask: rr.confidence_tokens(
                rids, rmask),
            lambda d, dense=dense: {
                "cosine_vote": 0, "attention": 0, "segment_attention": 0,
                "quantize_rows": dense, "w8a8_matmul": dense,
                "w4a8_matmul": 0})
        del rr
        torch.cuda.empty_cache()
    return rows


# -- the streaming consensus (slice 9) ----------------------------------------


def stream_chunk(slot: int, text: str, finish="stop"):
    """A multichat chunk that finishes ``slot`` with ``text``."""
    from llm_weighted_consensus_tpu_torch.types import (
        chat_response as cr,
        multichat_response as mr,
    )

    return mr.ChatCompletionChunk(
        id="mchcpl-smoke", created=0, model="panel", usage=None,
        choices=[mr.StreamingChoice(
            delta=cr.Delta(content=text), finish_reason=finish, index=slot,
            logprobs=None, error=None, model="g", model_index=slot,
            completion_metadata=None)],
    )


def check_stream_bge_micro(gpu: str) -> dict:
    """bge_micro in f32: the card's ``StreamingSelfConsistency`` against
    the port's CPU run over one arrival order of ``STREAM_MICRO_N``
    candidates (the buffer grows past 16), every update within
    ``MICRO_TOL``; one grouped ``stream_vote_update_many`` of 5 streams
    against the 5 single-stream updates, on the card and against the
    CPU."""
    import numpy as np
    import torch

    from llm_weighted_consensus_tpu_torch.clients.multichat import (
        StreamingSelfConsistency,
    )
    from llm_weighted_consensus_tpu_torch.models import loading, tokenizer
    from llm_weighted_consensus_tpu_torch.models.embedder import TorchEmbedder
    from llm_weighted_consensus_tpu_torch.ops import kernels

    fixture = os.path.join(REPO, "tests", "fixtures", "bge_micro")
    cfg = loading.load_hf_config(fixture)
    tok = tokenizer.load_tokenizer(loading.find_vocab(fixture))
    words = " ".join(MICRO_TEXTS).replace(",", "").split()
    rng = np.random.default_rng(9)
    texts = [" ".join(rng.choice(words, size=int(rng.integers(3, 14))))
             for _ in range(STREAM_MICRO_N)]
    order = [int(i) for i in rng.permutation(STREAM_MICRO_N)]
    embs, updates = {}, {}
    for device in ("cpu", "cuda"):
        model = loading.load_params(fixture, cfg, dtype=torch.float32,
                                    device=device)
        embs[device] = TorchEmbedder(
            "bge-micro", model=model, config=cfg, tokenizer=tok,
            max_tokens=64, device=device, dtype=torch.float32)
        sc = StreamingSelfConsistency(embs[device])
        before = kernels.cosine_vote.routes["cluster"]
        updates[device] = [sc.push_chunk(stream_chunk(slot, texts[slot]))
                           for slot in order]
        if device == "cuda":
            if kernels.cosine_vote.routes["cluster"] != before + len(order):
                raise AssertionError("stream_bge_micro: a vote off cluster")
            if sc._buf.device.type != "cuda" or sc._buf.shape[0] != 32:
                raise AssertionError(f"stream buffer {sc._buf.shape} on "
                                     f"{sc._buf.device}")
    worst = 0.0
    for want, got in zip(updates["cpu"], updates["cuda"]):
        if (want is None) != (got is None) or (
                want is not None and want.keys() != got.keys()):
            raise AssertionError("stream_bge_micro: updates differ in shape")
        if want is not None:
            worst = max(worst, max(abs(want[k] - got[k]) for k in want))
    # one grouped update of 5 streams against 5 single ones
    r, cap, hidden = 5, 16, cfg.hidden_size
    counts = [1, 4, 0, 9, 15]
    base = rng.normal(size=(r, cap, hidden)).astype(np.float32)
    for i, c in enumerate(counts):
        base[i, c:] = 0.0
    group_texts = texts[:r]
    grouped = {}
    for device, emb in embs.items():
        bufs = [torch.tensor(base[i], device=device) for i in range(r)]
        grouped[device] = (emb.stream_vote_update_many(
            group_texts, bufs, counts, 0.05), bufs)
    singles = []
    for i in range(r):
        buf = torch.tensor(base[i], device="cuda")
        singles.append(embs["cuda"].stream_vote_update(
            group_texts[i], buf, counts[i], 0.05))
    many, bufs = grouped["cuda"]
    many_err = float(np.abs(many - np.stack(singles)).max())
    cpu_err = float(np.abs(many - grouped["cpu"][0]).max())
    buf_err = max(
        float((bufs[i].cpu() - grouped["cpu"][1][i]).abs().max())
        for i in range(r))
    row = {
        "phase": "stream_bge_micro", "gpu": gpu, "updates": len(order),
        "capacity": 32, "max_abs_err": worst, "tolerance": MICRO_TOL,
        "grouped_vs_single_err": many_err, "grouped_card_vs_cpu_err": cpu_err,
        "buffer_card_vs_cpu_err": buf_err,
    }
    emit(row)
    if max(worst, many_err, cpu_err, buf_err) > MICRO_TOL:
        raise AssertionError(f"stream_bge_micro: {row}")
    return row


def stream_candidate(request: int, slot: int) -> str:
    """Slot ``slot``'s answer to request ``request``: 100-120 words, most
    from one of ``STREAM_FAMILIES`` answer families (so the vote has a
    structure), the rest from bench.py's vocabulary."""
    import numpy as np

    rng = np.random.default_rng(request * 1000 + slot)
    family = (7 * slot + request) % STREAM_FAMILIES
    own = [f"f{family}w{j}" for j in range(25)]
    n = int(rng.integers(STREAM_WORDS[0], STREAM_WORDS[1] + 1))
    return " ".join(
        own[int(rng.integers(0, 25))] if rng.random() < 0.8
        else BENCH_WORDS[int(rng.integers(0, len(BENCH_WORDS)))]
        for _ in range(n)
    )


class ScriptedGenerators:
    """The generator models on loopback (a stdlib SSE server, as
    bench_all.py's FakeTransport scripts stand in for them): an upstream
    chat request with seed ``1000 k + slot`` streams
    ``stream_candidate(k, slot)`` in three chunked frames, starting
    2 ms x slot (plus up to 10 ms) after it arrives, 5 ms apart."""

    def __init__(self) -> None:
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def do_POST(self):
                import numpy as np

                body = json.loads(self.rfile.read(
                    int(self.headers["content-length"])))
                request, slot = divmod(int(body.get("seed") or 0), 1000)
                text = stream_candidate(request, slot)
                rng = np.random.default_rng(int(body.get("seed") or 0))
                time.sleep(0.002 * slot + 0.01 * rng.random())
                words = text.split(" ")
                cut = [0, len(words) // 3, 2 * len(words) // 3, len(words)]
                parts = [" ".join(words[a:b]) + (" " if i < 2 else "")
                         for i, (a, b) in enumerate(zip(cut, cut[1:]))]
                self.send_response(200)
                self.send_header("content-type", "text/event-stream")
                self.send_header("transfer-encoding", "chunked")
                self.end_headers()
                for i, part in enumerate(parts):
                    chunk = {
                        "id": f"gen-{body.get('seed')}", "created": 1,
                        "object": "chat.completion.chunk",
                        "model": body.get("model"),
                        "choices": [{"index": 0, "delta": {"content": part},
                                     "finish_reason": "stop" if i == 2
                                     else None}],
                    }
                    frame = f"data: {json.dumps(chunk)}\n\n".encode()
                    if i == 2:
                        frame += b"data: [DONE]\n\n"
                    self.wfile.write(b"%x\r\n%s\r\n" % (len(frame), frame))
                    self.wfile.flush()
                    time.sleep(0.005)
                self.wfile.write(b"0\r\n\r\n")

        class Server(ThreadingHTTPServer):
            daemon_threads = True
            request_queue_size = 1024

        self.httpd = Server(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}/v1"

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(10)


def stream_panel() -> dict:
    return {"llms": [
        {"model": f"backend-{i % STREAM_BACKENDS}",
         "weight": {"type": "static", "weight": 1 + i % 3}}
        for i in range(STREAM_SLOTS)
    ]}


def sse_post(port: int, path: str, body: dict):
    """(status, the ``data:`` payloads parsed, seconds) of one POST."""
    import http.client

    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", path, body=json.dumps(body),
                     headers={"content-type": "application/json"})
        resp = conn.getresponse()
        raw = resp.read()
        status = resp.status
    finally:
        conn.close()
    events = [blk[len(b"data: "):].decode() for blk in raw.split(b"\n\n")
              if blk.startswith(b"data: ")]
    return status, events, time.perf_counter() - t0


def read_stream(events: list) -> dict:
    """A multichat stream's texts by slot, its consensus frames, and
    whether it ended with [DONE]."""
    texts, frames = {}, []
    for ev in events:
        if ev == "[DONE]":
            continue
        obj = json.loads(ev)
        if obj.get("object") == "multichat.consensus":
            frames.append(obj["confidence"])
            continue
        for choice in obj.get("choices", []):
            if choice.get("error") is not None:
                raise AssertionError(f"slot error: {choice['error']}")
            content = choice.get("delta", {}).get("content") or ""
            texts[choice["index"]] = texts.get(choice["index"], "") + content
    return {"texts": texts, "frames": frames,
            "done": bool(events) and events[-1] == "[DONE]"}


def eager_vote(emb, texts: list):
    """One eager vote over ``texts`` embedded in one call."""
    import torch

    from llm_weighted_consensus_tpu_torch.ops import kernels

    vecs = torch.tensor(emb.embed_texts(texts), device="cuda")
    return kernels.cosine_vote(vecs[None], len(texts), 0.05)[0].cpu().numpy()


def multichat_path(gpu: str) -> dict:
    """Phase 10: BASELINE config 5 through the port's server at full
    bge-large width (random weights from seed 0, bf16), built by the
    entry points (``build_embedder``, ``build_server``, ``warm_up``),
    the generators a scripted loopback server: 16 streaming
    ``/multichat/completions`` requests with consensus, 8 in flight, then
    2 unary ones, one streamed ``/chat/completions`` and one stream whose
    fifth update meets a planted embed failure.  Launch counts are set to
    0 before that traffic and read after it."""
    import concurrent.futures

    import numpy as np
    import torch

    from llm_weighted_consensus_tpu_torch.models.embedder import TorchEmbedder
    from llm_weighted_consensus_tpu_torch.serve.__main__ import (
        build_embedder,
        build_server,
        warm_up,
    )
    from llm_weighted_consensus_tpu_torch.serve.config import ServeConfig

    gens = ScriptedGenerators()
    env = {"EMBEDDER_MODEL": "bge-large-en", "EMBEDDER_MAX_TOKENS": "512",
           "LWC_ALLOW_RANDOM_PARAMS": "1", "WARMUP": STREAM_WARMUP,
           "OPENAI_API_BASE": gens.url, "OPENAI_API_KEY": "smoke-key"}
    config = ServeConfig.from_env(env)
    emb = build_embedder(env, device="cuda")
    layers = emb.config.num_layers
    srv = build_server(emb, None, config).start()
    try:
        t0 = time.perf_counter()
        warm_up(srv, config)
        warm_s = time.perf_counter() - t0
        port, batcher = srv.port, srv.batcher

        def body(k, stream=True):
            return {"messages": [{"role": "user", "content": f"question {k}"}],
                    "model": stream_panel(), "seed": 1000 * k,
                    "stream": stream, "consensus": True}

        graphs0, stats0 = emb.graph_stats(), batcher.stats()
        snap0 = srv.metrics.snapshot()["series"]
        reset_launches()
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(STREAM_INFLIGHT) as pool:
            answers = list(pool.map(
                lambda k: sse_post(port, "/multichat/completions", body(k)),
                range(1, STREAM_REQUESTS + 1)))
        stream_s = time.perf_counter() - t0
        unary = [post(port, "/multichat/completions", body(k, stream=False))
                 for k in (101, 102)]
        chat_status, chat_events, _ = sse_post(port, "/chat/completions", {
            "model": "backend-0", "seed": 99000, "stream": True,
            "messages": [{"role": "user", "content": "question 99"}]})
        # the planted failure: the fifth stream update of one more request
        real = batcher.submit_stream
        calls = {"n": 0}

        def planted(*args, **kwargs):
            calls["n"] += 1
            if calls["n"] == 5:
                failed = concurrent.futures.Future()
                failed.set_exception(RuntimeError("planted embed failure"))
                return failed
            return real(*args, **kwargs)

        batcher.submit_stream = planted
        try:
            fail_status, fail_events, _ = sse_post(
                port, "/multichat/completions", body(200))
        finally:
            del batcher.submit_stream
        torch.cuda.synchronize()
        launches, routes = read_launches(), read_routes()
        graphs1, stats1 = emb.graph_stats(), batcher.stats()
        snap1 = srv.metrics.snapshot()["series"]
        # every stream: [DONE], 31 frames, the last one a distribution
        # that an eager vote over the same texts gives
        worst, sums = 0.0, 0.0
        frames = 0
        for k, (status, events, _) in zip(range(1, STREAM_REQUESTS + 1),
                                          answers):
            out = read_stream(events)
            if status != 200 or not out["done"]:
                raise AssertionError(f"stream {k}: {status}, no [DONE]")
            if len(out["frames"]) != STREAM_SLOTS - 1:
                raise AssertionError(
                    f"stream {k}: {len(out['frames'])} consensus frames")
            texts = [out["texts"][s] for s in range(STREAM_SLOTS)]
            if texts != [stream_candidate(k, s) for s in range(STREAM_SLOTS)]:
                raise AssertionError(f"stream {k}: candidates garbled")
            last = out["frames"][-1]
            got = np.array([last[str(s)] for s in range(STREAM_SLOTS)])
            sums = max(sums, abs(got.sum() - 1.0))
            worst = max(worst, float(np.abs(got - eager_vote(emb, texts))
                                     .max()))
            frames += len(out["frames"])
        for k, out in zip((101, 102), unary):
            texts = {c["index"]: c["message"]["content"]
                     for c in out["choices"]}
            conf = np.array([out["consensus"][str(s)]
                             for s in range(STREAM_SLOTS)])
            sums = max(sums, abs(conf.sum() - 1.0))
            worst = max(worst, float(np.abs(conf - eager_vote(
                emb, [texts[s] for s in range(STREAM_SLOTS)])).max()))
        chat = read_stream(chat_events)
        if chat_status != 200 or not chat["done"] or chat["texts"].get(0) \
                != stream_candidate(99, 0):
            raise AssertionError(f"/chat/completions: {chat_status}")
        failed = read_stream(fail_events)
        if fail_status != 200 or not failed["done"] or len(
                failed["texts"]) != STREAM_SLOTS or len(failed["frames"]) != 3:
            raise AssertionError(
                f"planted failure: {fail_status}, {len(failed['frames'])} "
                f"frames, {len(failed['texts'])} slots")
        if sums > 1e-3 or worst > STREAM_CONF_TOL:
            raise AssertionError(f"multichat confidences: sum off by {sums}, "
                                 f"{worst} from the eager vote")
        stream_d = stats1["stream"]["dispatches"] - stats0["stream"][
            "dispatches"]
        unary_d = (stats1["dispatches"]["consensus"]
                   - stats0["dispatches"]["consensus"])
        embed_d = stats1["dispatches"]["embed"] - stats0["dispatches"]["embed"]
        want = {"cosine_vote": stream_d + unary_d,
                "attention": layers * (stream_d + unary_d + embed_d)}
        if any(launches[name] != n for name, n in want.items()):
            raise AssertionError(f"multichat launches {launches} != {want}")
        captures = graphs1["captures"] - graphs0["captures"]
        if captures:
            raise AssertionError(f"{captures} captures after warmup")
        updates = snap1["device:consensus_update"]
        errors = updates["errors"] - snap0.get(
            "device:consensus_update", {}).get("errors", 0)
        if errors != 1:
            raise AssertionError(f"{errors} failed updates, want the planted 1")
        # one grouped update dispatch (8 streams at capacity 32, s=128):
        # replayed from the warmed embed graph, and eager on a twin
        # embedder that warmed nothing
        rng = np.random.default_rng(31)
        counts = [int(c) for c in rng.integers(1, 32, STREAM_INFLIGHT)]
        group_texts = [stream_candidate(300, s) for s in range(STREAM_INFLIGHT)]
        ids, mask = emb.tokenize(group_texts)
        twin = TorchEmbedder("bge-large-en", model=emb.model,
                             config=emb.config, tokenizer=emb.tokenizer,
                             max_tokens=512, device="cuda",
                             dtype=torch.bfloat16)
        profiles = {}
        for label, model in (("eager", twin), ("replayed", emb)):
            bufs = [model.stream_buffer(32) for _ in counts]
            profiles[label] = profile_one(
                lambda model=model, bufs=bufs: model.stream_vote_update_tokens(
                    ids, mask, bufs, counts, 0.05),
                None if label == "eager"
                else profiles["eager"]["device_records"])
        del twin
        row = {
            "phase": "multichat_path", "gpu": gpu, "nvidia_smi": gpu,
            "model": "bge-large-en", "dtype": "bfloat16", "layers": layers,
            "slots": STREAM_SLOTS, "requests": STREAM_REQUESTS,
            "in_flight": STREAM_INFLIGHT, "warmup": STREAM_WARMUP,
            "warmup_s": warm_s, "stream_s": stream_s,
            "updates": frames, "updates_per_s": frames / stream_s,
            "update_p50_ms": updates.get("p50_ms"),
            "stream_dispatches": stream_d, "unary_dispatches": unary_d,
            "largest_group": stats1["stream"]["largest_group"],
            "replays": graphs1["replays"] - graphs0["replays"],
            "eager_dispatches": (graphs1["eager_dispatches"]
                                 - graphs0["eager_dispatches"]),
            "captures_after_warmup": captures, "launches": launches,
            "routes": routes, "max_conf_err": worst,
            "conf_tolerance": STREAM_CONF_TOL, "max_sum_err": sums,
            "planted_failure_frames": len(failed["frames"]),
            "dispatch_profile": profiles,
        }
        emit(row)
        return row
    finally:
        srv.close()
        gens.close()
        del emb
        torch.cuda.empty_cache()


# -- the score path -----------------------------------------------------------


def ballot_keys_of(body: dict) -> tuple:
    """(ballot text, its keys in ballot order) of a judge's upstream chat
    request: the JSON map in its last system message."""
    text = body["messages"][-1]["content"]
    ballot = text.split("Select the response:\n\n", 1)[1].split(
        "\n\nOutput", 1)[0]
    return ballot, list(json.loads(ballot))


def judge_answer(body: dict, agree: float = 0.0) -> tuple:
    """A scripted judge's answer to one ballot: (content, logprobs).  It
    names one key of its own ballot, chosen from a hash of the ballot, and
    gives ``top_logprobs`` alternatives on the key's letter token (soft
    votes) when the request asks for logprobs.  With ``agree`` > 0 it
    names, with that probability, the candidate whose text sorts first,
    its letter's logit raised by 4 (the soft vote peaked there)."""
    import zlib

    import numpy as np

    ballot, keys = ballot_keys_of(body)
    rng = np.random.default_rng(zlib.crc32(ballot.encode()))
    pick = keys[int(rng.integers(0, len(keys)))]
    favored = False
    if agree and rng.random() < agree:
        texts = json.loads(ballot)
        pick, favored = min(keys, key=lambda k: texts[k]), True
    content = f"I select {pick}"
    top = body.get("top_logprobs")
    if not body.get("logprobs") or not top:
        return content, None
    letters = [k[-2] for k in keys if k[:-2] == pick[:-2]][:top]
    lps = rng.normal(size=len(letters)) * 1.5
    if favored and pick[-2] in letters:
        lps[letters.index(pick[-2])] += 4.0
    lps = lps - np.log(np.exp(lps).sum())
    alts = [{"token": c, "logprob": float(lp)}
            for c, lp in zip(letters, lps)]
    chosen = next(a["logprob"] for a in alts if a["token"] == pick[-2])
    return content, {"content": [
        {"token": "I select ", "logprob": -0.01, "top_logprobs": []},
        {"token": pick[:-2], "logprob": -0.01, "top_logprobs": []},
        {"token": pick[-2], "logprob": chosen, "top_logprobs": alts},
        {"token": "`", "logprob": -0.01, "top_logprobs": []},
    ]}


def judge_frames(body: dict, agree: float = 0.0) -> bytes:
    """The SSE body a scripted judge answers ``body`` with."""
    content, logprobs = judge_answer(body, agree)
    choice = {"index": 0, "delta": {"role": "assistant", "content": content},
              "finish_reason": "stop"}
    if logprobs is not None:
        choice["logprobs"] = logprobs
    chunk = {"id": "judge-1", "object": "chat.completion.chunk",
             "created": 1, "model": body.get("model"), "choices": [choice],
             "usage": {"prompt_tokens": 100, "completion_tokens": 4,
                       "total_tokens": 104}}
    return f"data: {json.dumps(chunk)}\n\ndata: [DONE]\n\n".encode()


class ScriptedJudges:
    """The judge models on loopback (a stdlib SSE server): each answers
    ``judge_frames`` of its request after a scripted ``SCORE_JUDGE_MS``
    delay (drawn from the ballot's hash), counts the calls and keeps each
    call's ``traceparent`` header (None when absent); a model named
    ``broken-*`` answers 418 at once.  Any path under ``/down`` is a
    browned-out backend: 503 at once, counted in ``down_calls``.
    ``agree`` is ``judge_answer``'s."""

    def __init__(self, agree: float = 0.0) -> None:
        import threading
        import zlib
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        judges = self
        self.calls = 0
        self.down_calls = 0
        self.agree = agree
        self.traceparents = []
        self.lock = threading.Lock()

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def do_POST(self):
                body = json.loads(self.rfile.read(
                    int(self.headers["content-length"])))
                if self.path.startswith("/down"):
                    with judges.lock:
                        judges.down_calls += 1
                    raw = b'{"error":{"code":503,"message":"unavailable"}}'
                    self.send_response(503)
                    self.send_header("content-type", "application/json")
                    self.send_header("content-length", str(len(raw)))
                    self.end_headers()
                    self.wfile.write(raw)
                    return
                with judges.lock:
                    judges.calls += 1
                    judges.traceparents.append(
                        self.headers.get("traceparent"))
                if str(body.get("model", "")).startswith("broken-"):
                    self.send_response(418)
                    self.send_header("content-type", "application/json")
                    self.send_header("content-length", "2")
                    self.end_headers()
                    self.wfile.write(b"{}")
                    return
                ballot, _ = ballot_keys_of(body)
                lo, hi = SCORE_JUDGE_MS
                time.sleep((lo + zlib.crc32(ballot.encode()) % (hi - lo + 1))
                           / 1e3)
                frame = judge_frames(body, judges.agree)
                try:
                    self.send_response(200)
                    self.send_header("content-type", "text/event-stream")
                    self.send_header("transfer-encoding", "chunked")
                    self.end_headers()
                    self.wfile.write(b"%x\r\n%s\r\n" % (len(frame), frame))
                    self.wfile.write(b"0\r\n\r\n")
                    self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError):
                    # the client hung up first: a cancelled straggler or
                    # a hedge loser
                    self.close_connection = True

        class Server(ThreadingHTTPServer):
            daemon_threads = True
            request_queue_size = 1024

        self.httpd = Server(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}/v1"

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(10)


def score_prompt(k: int) -> str:
    """Request ``k``'s question: ``SCORE_PROMPT_WORDS`` words of
    bench.py's vocabulary and a topic of its own."""
    import numpy as np

    rng = np.random.default_rng(50000 + k)
    n = int(rng.integers(SCORE_PROMPT_WORDS[0], SCORE_PROMPT_WORDS[1] + 1))
    topic = [f"t{k % 13}w{j}" for j in range(20)]
    return " ".join(
        topic[int(rng.integers(0, 20))] if rng.random() < 0.5
        else BENCH_WORDS[int(rng.integers(0, len(BENCH_WORDS)))]
        for _ in range(n))


def score_panel(weight: str, n_judges: int = SCORE_JUDGES,
                backends: int = SCORE_BACKENDS,
                top_logprobs: int = SCORE_TOP_LOGPROBS, top: int = SCORE_TOP,
                max_tokens: int = SCORE_MAX_TOKENS) -> dict:
    """BASELINE config 2's panel (``_make_panel(32, 3)``) with soft votes:
    training-table weights in [1, 5] (base 1), or static ``1 + i % 3``."""
    llms = []
    for i in range(n_judges):
        llm = {"model": f"backend-{i % backends}",
               "top_logprobs": top_logprobs}
        llm["weight"] = (
            {"type": "training_table", "base_weight": 1, "min_weight": 1,
             "max_weight": 5} if weight == "training_table"
            else {"type": "static", "weight": 1 + i % 3})
        llms.append(llm)
    panel = {"llms": llms}
    if weight == "training_table":
        panel["weight"] = {"type": "training_table", "top": top,
                           "embeddings": {"model": "bge-large-en",
                                          "max_tokens": max_tokens}}
    return panel


def score_body(k: int, weight: str, **panel) -> dict:
    return {"messages": [{"role": "user", "content": score_prompt(k)}],
            "model": score_panel(weight, **panel),
            "choices": [stream_candidate(2000 + k, s)
                        for s in range(SCORE_N)]}


def lookup_f64(tables, mask, scores, query, lo, hi, k):
    """``training_table_weights_batched`` in float64 numpy: the plain
    math of the reference, ties broken toward the lower index."""
    import numpy as np

    t64 = tables.astype(np.float64)
    q = query.astype(np.float64)
    nt = t64 / np.maximum(np.linalg.norm(t64, axis=-1, keepdims=True), 1e-12)
    nq = q / max(np.linalg.norm(q), 1e-12)
    sims = np.where(mask > 0, nt @ nq, -np.inf)
    k = min(k, sims.shape[1])
    idx = np.argsort(-sims, axis=-1, kind="stable")[:, :k]
    top = np.take_along_axis(sims, idx, -1)
    valid = np.isfinite(top)
    logits = np.where(valid, top / 0.05, -np.inf)
    mx = np.max(np.where(valid, logits, -1e30), axis=-1, keepdims=True)
    e = np.where(valid, np.exp(logits - mx), 0.0)
    attn = e / np.maximum(e.sum(-1, keepdims=True), 1e-30)
    quality = (attn * np.take_along_axis(scores.astype(np.float64), idx,
                                         -1)).sum(-1)
    return lo + (hi - lo) * quality


def lookup_inputs(seed: int):
    """Full-width lookup inputs: 32 judges, 256 rows of D=1024 padded to
    280, judge 1 with 10 rows (fewer than k) and judge 2 with 1, a zero
    row, and six identical nearest rows with different scores in judge 4
    (exact ties across the k-th place at k = 3)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    j, t, d = SCORE_JUDGES, SCORE_TABLE_ROWS + 24, 1024
    q = rng.normal(size=d).astype(np.float32)
    tables = rng.normal(size=(j, t, d)).astype(np.float32)
    mask = np.ones((j, t), np.float32)
    mask[:, SCORE_TABLE_ROWS:] = 0
    mask[1, 10:] = 0
    mask[2, 1:] = 0
    tables[3, 7] = 0.0
    near = q + 0.5 * rng.normal(size=d).astype(np.float32)
    for r in (0, 1, 2, 3, 4, 200):
        tables[4, r] = near
    tables[mask == 0] = 0.0
    scores = rng.random((j, t)).astype(np.float32)
    lo = np.ones(j, np.float32)
    hi = np.full(j, 5.0, np.float32)
    return tables, mask, scores, q, lo, hi


def check_lookup(gpu: str) -> dict:
    """``training_table_weights_batched`` on the card against the f64
    numpy computation on the same arrays, at k = 3 (ties straddle the
    k-th place), 16 (the panel's top) and 300 (past every table)."""
    import numpy as np
    import torch

    from llm_weighted_consensus_tpu_torch.ops import similarity

    worst = 0.0
    for seed in (1, 2):
        args = lookup_inputs(seed)
        dev = [torch.from_numpy(a).cuda() for a in args]
        for k in (3, SCORE_TOP, 300):
            got = similarity.training_table_weights_batched(*dev, k)
            got = got.cpu().numpy()
            want = lookup_f64(*args, k)
            if got.dtype != np.float32 or not np.isfinite(got).all():
                raise AssertionError(f"lookup k={k}: {got.dtype}, not finite")
            worst = max(worst, float(np.max(np.abs(got - want)
                                             / np.abs(want))))
    row = {"phase": "score_lookup", "gpu": gpu,
           "shape": [SCORE_JUDGES, SCORE_TABLE_ROWS + 24, 1024],
           "ks": [3, SCORE_TOP, 300], "max_rel_err_vs_f64": worst,
           "tolerance": LOOKUP_F64_TOL}
    emit(row)
    if worst > LOOKUP_F64_TOL:
        raise AssertionError(f"score_lookup: {row}")
    return row


class InProcessJudges:
    """``judge_frames`` as a port ``Transport``, in process (the bge_micro
    comparison's judges)."""

    def __new__(cls):
        from llm_weighted_consensus_tpu_torch.clients import chat

        class Transport(chat.Transport):
            async def post_sse(self, url, headers, body):
                frames = judge_frames(json.loads(body))

                class Resp(chat.TransportResponse):
                    status = 200

                    async def read_body(self):
                        return b""

                    async def byte_stream(self):
                        yield frames

                return Resp()

        return Transport()


def frames_close(want: list, got: list, tol: float) -> float:
    """Largest relative difference of the ``weight`` / ``confidence``
    numbers of two frame lists whose other values must be equal; raises
    where anything else differs."""
    worst = 0.0

    def walk(a, b, key=None):
        nonlocal worst
        if key in ("weight", "confidence") and a is not None:
            a, b = float(a), float(b)
            worst = max(worst, abs(a - b) / max(abs(a), 1e-30))
            return
        if isinstance(a, dict) and isinstance(b, dict) and a.keys() == b.keys():
            for name in a:
                walk(a[name], b[name], name)
        elif isinstance(a, list) and isinstance(b, list) and len(a) == len(b):
            for x, y in zip(a, b):
                walk(x, y, key)
        elif key == "embedding":
            worst = max(worst, abs(float(a) - float(b)))
        elif a != b:
            raise AssertionError(f"frames differ at {key}: {a!r} != {b!r}")

    if len(want) != len(got):
        raise AssertionError(f"{len(got)} frames, want {len(want)}")
    for a, b in zip(want, got):
        walk(json.loads(a), json.loads(b))
    return worst


def check_score_bge_micro(gpu: str) -> dict:
    """bge_micro in f32: the same scripted judges, seeded ballots and
    training tables through the port's ``ScoreClient`` (the fetcher
    through a batcher) on the card and on the CPU.  Static-weight frames
    byte-equal once id and created are masked; training-table frames
    equal but for the weights and confidences, which agree within
    ``MICRO_TOL`` relative (and the echoed embedding, absolute)."""
    import asyncio
    import random

    import numpy as np
    import torch

    from llm_weighted_consensus_tpu_torch import archive, registry
    from llm_weighted_consensus_tpu_torch.clients import chat
    from llm_weighted_consensus_tpu_torch.clients.score import ScoreClient
    from llm_weighted_consensus_tpu_torch.identity.model import ModelBase
    from llm_weighted_consensus_tpu_torch.models import loading, tokenizer
    from llm_weighted_consensus_tpu_torch.models.embedder import TorchEmbedder
    from llm_weighted_consensus_tpu_torch.serve.batcher import DeviceBatcher
    from llm_weighted_consensus_tpu_torch.types.score_request import (
        ChatCompletionCreateParams,
    )
    from llm_weighted_consensus_tpu_torch.utils import jsonutil
    from llm_weighted_consensus_tpu_torch.weights import WeightFetchers
    from llm_weighted_consensus_tpu_torch.weights.training_table import (
        TorchTrainingTableFetcher,
        TrainingTableStore,
    )

    fixture = os.path.join(REPO, "tests", "fixtures", "bge_micro")
    cfg = loading.load_hf_config(fixture)
    tok = tokenizer.load_tokenizer(loading.find_vocab(fixture))
    micro = dict(n_judges=5, backends=5, top_logprobs=4, top=3,
                 max_tokens=32)
    bodies = []
    for k in range(3):
        for weight in ("static", "training_table"):
            bodies.append((weight, {
                "messages": [{"role": "user", "content": MICRO_TEXTS[k]}],
                "model": score_panel(weight, **micro),
                "choices": MICRO_TEXTS[k:] + MICRO_TEXTS[:k], "stream": True,
            }))
    model = ModelBase.from_json_obj(
        score_panel("training_table", **micro)).into_model_validate()
    frames = {}
    table_rows = None
    for device in ("cpu", "cuda"):
        emb = TorchEmbedder(
            "bge-micro", model=loading.load_params(
                fixture, cfg, dtype=torch.float32, device=device),
            config=cfg, tokenizer=tok, max_tokens=64, device=device,
            dtype=torch.float32)
        if table_rows is None:
            table_rows = emb.embed_texts(MICRO_TEXTS * 2, max_tokens=32)
        store = TrainingTableStore()
        rng = np.random.default_rng(3)
        for llm in model.llms:
            store.add_rows(llm.training_table_id, table_rows,
                           rng.random(len(table_rows)))
        with DeviceBatcher(emb, window_ms=1) as batcher:
            client = ScoreClient(
                chat.DefaultChatClient(
                    InProcessJudges(), [chat.ApiBase("https://judges", "k")],
                    backoff=chat.BackoffPolicy(max_elapsed_ms=0)),
                registry.InMemoryModelRegistry(),
                archive_fetcher=archive.InMemoryArchive(),
                weight_fetchers=WeightFetchers(
                    training_table_fetcher=TorchTrainingTableFetcher(
                        emb, store, batcher=batcher)),
                rng_factory=lambda: random.Random(5))

            async def run(body):
                params = ChatCompletionCreateParams.from_json_obj(body)
                stream = await client.create_streaming(None, params)
                out = []
                async for item in stream:
                    obj = item.to_json_obj()
                    obj["id"], obj["created"] = "scrcpl", 0
                    out.append(jsonutil.dumps(obj))
                return out

            loop = asyncio.new_event_loop()
            frames[device] = [loop.run_until_complete(run(b))
                              for _, b in bodies]
            loop.close()
            if device == "cuda" and batcher.stats()["dispatches"][
                    "embed"] != 3:
                raise AssertionError("score_bge_micro: prompt embeds "
                                     f"{batcher.stats()['dispatches']}")
        del emb
    worst, static_equal = 0.0, True
    for (weight, _), want, got in zip(bodies, frames["cpu"], frames["cuda"]):
        if weight == "static":
            static_equal &= want == got
        else:
            worst = max(worst, frames_close(want, got, MICRO_TOL))
    row = {"phase": "score_bge_micro", "gpu": gpu, "requests": len(bodies),
           "static_frames_byte_equal": static_equal,
           "trained_max_rel_err": worst, "tolerance": MICRO_TOL}
    emit(row)
    if not static_equal or worst > MICRO_TOL:
        raise AssertionError(f"score_bge_micro: {row}")
    return row


def score_tables(emb, model, path: str) -> list:
    """The panel's training tables saved to ``path``: 256 prompts
    embedded once, each distinct table with its own seeded scores;
    -> the table ids."""
    import numpy as np

    from llm_weighted_consensus_tpu_torch.weights.training_table import (
        TrainingTableStore,
    )

    rows = emb.embed_texts(
        [f"user: {score_prompt(10000 + i)}"
         for i in range(SCORE_TABLE_ROWS)], max_tokens=SCORE_MAX_TOKENS)
    store = TrainingTableStore()
    rng = np.random.default_rng(17)
    table_ids = sorted({llm.training_table_id for llm in model.llms})
    for tid in table_ids:
        store.add_rows(tid, rows, rng.random(SCORE_TABLE_ROWS))
    store.save(path)
    return table_ids


def read_score_stream(events: list) -> dict:
    """A /score/completions stream's final frame, checked: it ends with
    [DONE], carries no error item, and its candidates' confidences sum to
    1 within ``SCORE_SUM_TOL``; -> its judge weights and the sum's
    error."""
    if not events or events[-1] != "[DONE]":
        raise AssertionError("score stream without [DONE]")
    final = json.loads(events[-2])
    if "code" in final or final.get("weight_data") is None:
        raise AssertionError(f"score stream ended with {events[-2][:300]}")
    conf = [float(c["confidence"]) for c in final["choices"]
            if c["index"] < SCORE_N]
    if len(conf) != SCORE_N or abs(sum(conf) - 1.0) > SCORE_SUM_TOL:
        raise AssertionError(f"score confidences {conf}")
    weights = [float(c["weight"]) for c in final["choices"]
               if c["index"] >= SCORE_N]
    if len(weights) != SCORE_JUDGES:
        raise AssertionError(f"{len(weights)} judge choices")
    return {"weights": weights, "sum_err": abs(sum(conf) - 1.0),
            "final": final}


def drive_score(port: int, bodies: list, inflight: int) -> dict:
    """Stream ``bodies`` through /score/completions, ``inflight`` at a
    time -> checked final frames, per-request seconds and the wall."""
    import concurrent.futures

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(inflight) as pool:
        answers = list(pool.map(
            lambda b: sse_post(port, "/score/completions",
                               {**b, "stream": True}), bodies))
    wall = time.perf_counter() - t0
    outs = []
    for status, events, _ in answers:
        if status != 200:
            raise AssertionError(f"/score/completions: {status} {events[:1]}")
        outs.append(read_score_stream(events))
    return {"outs": outs, "seconds": [s for _, _, s in answers],
            "wall_s": wall}


def score_path(gpu: str) -> dict:
    """Phase 11: ``/score/completions`` at full bge-large width (random
    weights from seed 0, bf16) through ``build_embedder``,
    ``build_server`` and ``warm_up``, the judges a scripted stdlib SSE
    server on loopback (``ScriptedJudges``): BASELINE config 2's panel of
    32 judges over 3 backends with soft votes (``top_logprobs`` 8),
    training-table weights from ``TABLES_PATH`` (256 prompts embedded on
    the card, seeded scores per table), 16 requests of 8 candidates, 8 in
    flight, then 4 static-weight requests; one weight fetch by part and
    under torch.profiler; then a second server with ``SCORE_CACHE_TTL=60``:
    one request, 2 repeats, one identical concurrent pair."""
    import statistics

    import numpy as np
    import torch

    from llm_weighted_consensus_tpu_torch.identity.model import ModelBase
    from llm_weighted_consensus_tpu_torch.models.embedder import _seq_bucket
    from llm_weighted_consensus_tpu_torch.obs import phases
    from llm_weighted_consensus_tpu_torch.ops.similarity import (
        training_table_weights_batched,
    )
    from llm_weighted_consensus_tpu_torch.serve.__main__ import (
        build_embedder,
        build_server,
        warm_up,
    )
    from llm_weighted_consensus_tpu_torch.serve.config import ServeConfig
    from llm_weighted_consensus_tpu_torch.types.score_request import (
        ChatCompletionCreateParams,
    )

    judges = ScriptedJudges()
    work = os.path.join(REPO, "build", "score_smoke")
    os.makedirs(work, exist_ok=True)
    tables_path = os.path.join(work, "tables.npz")
    env = {"EMBEDDER_MODEL": "bge-large-en", "EMBEDDER_MAX_TOKENS": "512",
           "LWC_ALLOW_RANDOM_PARAMS": "1", "OPENAI_API_BASE": judges.url,
           "OPENAI_API_KEY": "smoke-key", "TABLES_PATH": tables_path}
    emb = build_embedder(env, device="cuda")
    layers = emb.config.num_layers
    srv = srv2 = None
    try:
        # the tables: 256 prompts embedded once on the card, each of the
        # panel's distinct tables with its own seeded scores
        tt_bodies = [score_body(k, "training_table")
                     for k in range(1, SCORE_REQUESTS + 1)]
        static_bodies = [score_body(100 + k, "static")
                         for k in range(SCORE_STATIC_REQUESTS)]
        model = ModelBase.from_json_obj(
            tt_bodies[0]["model"]).into_model_validate()
        table_ids = score_tables(emb, model, tables_path)
        # warm the prompt embed's buckets: 16 rows at every sequence
        # bucket the prompts fall in
        seqs = sorted({_seq_bucket(int(emb.tokenize(
            [f"user: {score_prompt(k)}"], SCORE_MAX_TOKENS)[1].sum()),
            SCORE_MAX_TOKENS) for k in list(range(1, SCORE_REQUESTS + 1))
            + [101, 102, 103]})
        env["WARMUP"] = ",".join(f"16x{s}" for s in seqs)
        config = ServeConfig.from_env(env)
        srv = build_server(emb, None, config).start()
        t0 = time.perf_counter()
        warm_up(srv, config)
        warm_s = time.perf_counter() - t0
        port, batcher = srv.port, srv.batcher
        fetcher = srv.score_client.weight_fetchers.training_table
        if len(fetcher.store) != len(table_ids):
            raise AssertionError("TABLES_PATH did not load")
        fetch_ms = []
        real_fetch = fetcher.fetch

        async def timed_fetch(ctx, request, model):
            t = time.perf_counter()
            out = await real_fetch(ctx, request, model)
            fetch_ms.append((time.perf_counter() - t) * 1e3)
            return out

        fetcher.fetch = timed_fetch
        graphs0, stats0 = emb.graph_stats(), batcher.stats()
        calls0 = judges.calls
        phases.reset_phases()
        reset_launches()
        tt = drive_score(port, tt_bodies, SCORE_INFLIGHT)
        torch.cuda.synchronize()
        launches, routes = read_launches(), read_routes()
        graphs1, stats1 = emb.graph_stats(), batcher.stats()
        # the server's view of the training-table traffic (its first
        # score requests): a judge's ballot-stream lifetime, the tally,
        # the prompt embed's queue and device time, the route's latency
        snap = srv.metrics.snapshot()
        server_view = {
            "phases": {name: snap["phases"].get(name) for name in (
                "upstream_judge", "host_tally", "batcher_queue",
                "device_dispatch")},
            "route": snap["series"].get("http:/score/completions"),
        }
        static = drive_score(port, static_bodies, SCORE_STATIC_REQUESTS)
        calls = judges.calls - calls0
        fetcher.fetch = real_fetch
        embed_d = stats1["dispatches"]["embed"] - stats0["dispatches"][
            "embed"]
        embed_rows = stats1["requests"]["embed"] - stats0["requests"]["embed"]
        captures = graphs1["captures"] - graphs0["captures"]
        eager = graphs1["eager_dispatches"] - graphs0["eager_dispatches"]
        weights = [w for out in tt["outs"] for w in out["weights"]]
        sums = max(o["sum_err"] for o in tt["outs"] + static["outs"])
        want = {"attention": layers * embed_d, "cosine_vote": 0}
        if captures or eager:
            raise AssertionError(f"score path: {captures} captures, {eager} "
                                 "eager embed dispatches after warmup")
        if embed_rows != SCORE_REQUESTS or not embed_d:
            raise AssertionError(f"score path: {embed_rows} prompt rows in "
                                 f"{embed_d} dispatches")
        if any(launches[name] != n for name, n in want.items()):
            raise AssertionError(f"score launches {launches} != {want}")
        if not all(1.0 <= w <= 5.0 for w in weights) or len(weights) != \
                SCORE_REQUESTS * SCORE_JUDGES:
            raise AssertionError("a training-table weight outside [1, 5]")
        if calls != SCORE_JUDGES * (SCORE_REQUESTS + SCORE_STATIC_REQUESTS):
            raise AssertionError(f"{calls} upstream judge calls")
        want_w = sorted(float(1 + i % 3) for i in range(SCORE_JUDGES))
        if any(sorted(out["weights"]) != want_w for out in static["outs"]):
            raise AssertionError("static weights garbled")
        # one weight fetch by part, then whole under the profiler
        body = tt_bodies[0]
        params = ChatCompletionCreateParams.from_json_obj(body)
        text = params.template_content()
        parts = {}
        for _ in range(3):  # the last of three, each part synchronized
            t = time.perf_counter()
            vec, _tokens = batcher.submit_embed(
                [text], max_tokens=SCORE_MAX_TOKENS).result()
            parts["prompt_embed_ms"] = (time.perf_counter() - t) * 1e3
            t = time.perf_counter()
            padded = fetcher.pad_tables(model)
            parts["host_padding_ms"] = (time.perf_counter() - t) * 1e3
            t = time.perf_counter()
            args = fetcher.upload(padded, np.asarray(vec[0], np.float32))
            torch.cuda.synchronize()
            parts["upload_ms"] = (time.perf_counter() - t) * 1e3
            t = time.perf_counter()
            training_table_weights_batched(*args, padded.k).cpu()
            parts["lookup_ms"] = (time.perf_counter() - t) * 1e3
        parts["padded_tables_bytes"] = int(padded.tables.nbytes)

        def one_fetch():
            import asyncio

            loop = asyncio.new_event_loop()
            try:
                loop.run_until_complete(fetcher.fetch(None, params, model))
            finally:
                loop.run_until_complete(loop.shutdown_default_executor())
                loop.close()

        fetch_profile = profile_one(one_fetch)
        # the cache: a second server, SCORE_CACHE_TTL=60
        srv.close()
        srv = None
        config2 = ServeConfig.from_env({**env, "SCORE_CACHE_TTL": "60"})
        srv2 = build_server(emb, None, config2).start()
        warm_up(srv2, config2)
        port2, batcher2 = srv2.port, srv2.batcher

        def cache_counts():
            snap = http(port2, "/metrics")[2]
            return (judges.calls, batcher2.stats()["dispatches"]["embed"],
                    snap["score_cache"])

        first_body = score_body(101, "training_table")
        c0 = cache_counts()
        first = drive_score(port2, [first_body], 1)
        c1 = cache_counts()
        repeats = drive_score(port2, [first_body, first_body], 1)
        c2 = cache_counts()
        pair = drive_score(port2, [score_body(102, "training_table")] * 2, 2)
        c3 = cache_counts()
        if c1[0] - c0[0] != SCORE_JUDGES or c1[1] - c0[1] != 1:
            raise AssertionError(f"cache miss: {c0[:2]} -> {c1[:2]}")
        if c2[:2] != c1[:2] or c2[2]["hits"] - c1[2]["hits"] != 2:
            raise AssertionError(f"cache repeats: {c1} -> {c2}")
        repeat_frames = [json.dumps(o["final"], sort_keys=True)
                         for o in first["outs"] + repeats["outs"]]
        if len({f.replace(first["outs"][0]["final"]["id"], "")
                for f in repeat_frames}) != 1:
            raise AssertionError("a cache repeat differs from its miss")
        collapses = (c3[2]["inflight_collapses"]
                     - c2[2]["inflight_collapses"])
        if c3[0] - c2[0] != SCORE_JUDGES or collapses != 1:
            raise AssertionError(f"concurrent pair: {c3[0] - c2[0]} upstream "
                                 f"calls, {collapses} collapses")
        if pair["outs"][0]["final"]["id"] != pair["outs"][1]["final"]["id"]:
            raise AssertionError("the pair's follower did not replay")

        def p50(xs):
            return statistics.median(xs) * 1e3

        row = {
            "phase": "score_path", "gpu": gpu, "nvidia_smi": gpu,
            "model": "bge-large-en", "dtype": "bfloat16", "layers": layers,
            "judges": SCORE_JUDGES, "backends": SCORE_BACKENDS,
            "distinct_tables": len(table_ids),
            "table_rows": SCORE_TABLE_ROWS, "candidates": SCORE_N,
            "requests": SCORE_REQUESTS, "in_flight": SCORE_INFLIGHT,
            "static_requests": SCORE_STATIC_REQUESTS,
            "judge_delay_ms": list(SCORE_JUDGE_MS),
            "warmup": env["WARMUP"], "warmup_s": warm_s,
            "training_table": {
                "requests_per_s": SCORE_REQUESTS / tt["wall_s"],
                "client_p50_ms": p50(tt["seconds"]),
                "wall_s": tt["wall_s"]},
            "static": {
                "requests_per_s": SCORE_STATIC_REQUESTS / static["wall_s"],
                "client_p50_ms": p50(static["seconds"]),
                "wall_s": static["wall_s"]},
            "server": server_view,
            "weight_fetch_p50_ms": statistics.median(fetch_ms),
            "weight_fetches": len(fetch_ms),
            "weight_fetch_parts": parts,
            "weight_fetch_profile": fetch_profile,
            "embed_dispatches": embed_d, "embed_rows": embed_rows,
            "rows_per_dispatch": embed_rows / embed_d,
            "replays": graphs1["replays"] - graphs0["replays"],
            "eager_dispatches": eager, "captures_after_warmup": captures,
            "launches": launches, "routes": routes,
            "weights_min_max": [min(weights), max(weights)],
            "max_sum_err": sums, "upstream_calls": calls,
            "cache": {"miss_upstream_calls": c1[0] - c0[0],
                      "repeat_upstream_calls": c2[0] - c1[0],
                      "repeat_dispatches": c2[1] - c1[1],
                      "hits": c3[2]["hits"], "pair_upstream_calls":
                      c3[0] - c2[0], "collapses": collapses},
        }
        emit(row)
        return row
    finally:
        for s in (srv, srv2):
            if s is not None:
                s.close()
        judges.close()
        del emb
        torch.cuda.empty_cache()


# -- phase 12: the archive path ---------------------------------------------------


def tally_votes(rng, shape):
    """Soft-vote rows summing to 1, every third row one-hot."""
    import numpy as np

    v = rng.random(shape).astype(np.float32) ** 3
    v /= v.sum(axis=-1, keepdims=True)
    flat = v.reshape(-1, shape[-1])
    for r in range(0, len(flat), 3):
        flat[r] = 0.0
        flat[r, rng.integers(0, shape[-1])] = 1.0
    return flat.reshape(shape)


def decimal_tally(votes, weights, mask=None) -> tuple:
    """The host tally's arithmetic in exact Decimal on the same f32
    values: (choice weight, confidence) as floats."""
    from decimal import Decimal

    m, n = votes.shape
    cw = [Decimal(0)] * n
    for j in range(m):
        w = Decimal(repr(float(weights[j])))
        if mask is not None:
            w *= Decimal(repr(float(mask[j])))
        for i in range(n):
            cw[i] += Decimal(repr(float(votes[j, i]))) * w
    total = sum(cw)
    return ([float(c) for c in cw],
            [float(c / total) if total > 0 else 0.0 for c in cw])


def tally_f64(votes, weights, mask=None) -> tuple:
    """(choice weight, confidence) in float64 numpy over the last two
    axes."""
    import numpy as np

    w = weights.astype(np.float64)
    if mask is not None:
        w = w * mask
    cw = np.einsum("...m,...mn->...n", w, votes.astype(np.float64))
    total = cw.sum(axis=-1, keepdims=True)
    conf = np.divide(cw, total, out=np.zeros_like(cw), where=total > 0)
    return cw, conf


def weight_err(got, want) -> float:
    """Largest difference of choice weights, relative past 1 (a weight of
    32 judges holds f32 ulps of 4e-6)."""
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.maximum(1.0, np.abs(want)),
                        initial=0.0))


def soft_vote_inputs(rng, m, k, n):
    """``softmax_votes`` inputs with an id of -1, ids of n and past it
    (``jax.nn.one_hot``'s zero rows), a row without a valid alternative
    and a row of invalid ids."""
    import numpy as np

    lp = np.log(rng.random((m, k)).astype(np.float32) + 1e-3)
    ids = rng.integers(0, n, (m, k)).astype(np.int64)
    valid = (rng.random((m, k)) > 0.3).astype(np.float32)
    ids[0, 0], valid[0, 0] = -1, 1.0
    ids[1, :2], valid[1, :2] = [n, n + 7], 1.0
    valid[2] = 0.0
    ids[3], valid[3] = -1, 1.0
    return lp, ids, valid


def check_device_tally(gpu: str) -> dict:
    """The device tally on the card against the Decimal host tally and
    float64 numpy (``TALLY_TOL`` absolute on confidences, relative past 1
    on choice weights), with failed judges (``vote_mask`` 0) and an
    all-failed request (zeros, not NaN); ``softmax_votes`` on the card
    against its CPU run."""
    import numpy as np
    import torch

    from llm_weighted_consensus_tpu_torch.ops import consensus, votes

    rng = np.random.default_rng(12)
    worst = {"tally_vs_f64": 0.0, "tally_vs_decimal": 0.0,
             "judge_confidence": 0.0, "tally_batch": 0.0,
             "judge_confidence_batch": 0.0, "incremental_tally": 0.0,
             "softmax_votes_vs_cpu": 0.0, "sum_err": 0.0}

    def upd(key, err):
        worst[key] = max(worst[key], float(err))

    for m, n in ((ARCHIVE_M, ARCHIVE_N), (SCORE_JUDGES, SCORE_N), (5, 3)):
        v = tally_votes(rng, (m, n))
        w = rng.uniform(0.5, 3.0, m).astype(np.float32)
        mask = (rng.random(m) > 0.25).astype(np.float32)
        mask[0] = 0.0
        cw, conf = consensus.tally(v, w, mask, device="cuda")
        if cw.device.type != "cuda":
            raise AssertionError("tally left the card")
        cw, conf = cw.cpu().numpy(), conf.cpu().numpy()
        cw64, conf64 = tally_f64(v, w, mask)
        dcw, dconf = decimal_tally(v, w, mask)
        upd("tally_vs_f64", max(weight_err(cw, cw64),
                                np.abs(conf - conf64).max()))
        upd("tally_vs_decimal", max(weight_err(cw, dcw),
                                    np.abs(conf - dconf).max()))
        upd("sum_err", abs(float(conf.sum(dtype=np.float64)) - 1.0))
        jc = consensus.judge_confidence(v, conf, device="cuda").cpu().numpy()
        upd("judge_confidence", np.abs(jc - v.astype(np.float64) @ conf64)
            .max())
        # every judge failed: zeros, not NaN
        cw0, conf0 = consensus.tally(v, w, np.zeros(m, np.float32),
                                     device="cuda")
        if cw0.abs().sum() or conf0.abs().sum() or not bool(
                consensus.all_failed(np.zeros(m), device="cuda")):
            raise AssertionError("an all-failed tally is not zero")
    b, m, n = 64, ARCHIVE_M, ARCHIVE_N
    v = tally_votes(rng, (b, m, n))
    w = rng.uniform(0.5, 3.0, (b, m)).astype(np.float32)
    mask = (rng.random((b, m)) > 0.25).astype(np.float32)
    mask[5] = 0.0
    cw, conf = consensus.tally_batch(v, w, mask, device="cuda")
    jc = consensus.judge_confidence_batch(v, conf, device="cuda")
    cw, conf, jc = (t.cpu().numpy() for t in (cw, conf, jc))
    cw64, conf64 = tally_f64(v, w, mask)
    upd("tally_batch", max(weight_err(cw, cw64), np.abs(conf - conf64).max()))
    upd("judge_confidence_batch", np.abs(
        jc - np.einsum("bmn,bn->bm", v.astype(np.float64), conf64)).max())
    sums = conf.sum(axis=1, dtype=np.float64)
    if not np.isfinite(conf).all() or sums[5] != 0.0:
        raise AssertionError("tally_batch: the all-failed row is not zero")
    upd("sum_err", np.abs(np.delete(sums, 5) - 1.0).max())
    running = torch.zeros(n, device="cuda")
    for j in range(m):
        running, conf = consensus.incremental_tally(running, v[0, j],
                                                    float(w[0, j]))
    cw64, conf64 = tally_f64(v[0], w[0])
    upd("incremental_tally", max(weight_err(running.cpu().numpy(), cw64),
                                 np.abs(conf.cpu().numpy() - conf64).max()))
    for m, k, n in ((ARCHIVE_M * 64, 20, ARCHIVE_N), (SCORE_JUDGES, 8,
                                                       SCORE_N), (5, 3, 2)):
        lp, ids, valid = soft_vote_inputs(rng, m, k, n)
        got = votes.softmax_votes(lp, ids, valid, n, device="cuda")
        want = votes.softmax_votes(lp, ids, valid, n, device="cpu")
        got = got.cpu().numpy()
        upd("softmax_votes_vs_cpu", np.abs(got - want.numpy()).max())
        if got[2].any() or got[3].any() or not np.isfinite(got).all():
            raise AssertionError("softmax_votes: an invalid row is not zero")
    row = {"phase": "device_tally", "gpu": gpu, "max_err": worst,
           "tolerance": TALLY_TOL,
           "tf32": [torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32]}
    emit(row)
    if max(worst.values()) > TALLY_TOL or any(row["tf32"]):
        raise AssertionError(f"device_tally: {row}")
    return row


class CallTimer:
    """Wraps ``owner.name`` while it lives: each call's wall ms and, on
    the card, the device ms between CUDA events recorded before and after
    it on the calling thread's stream (None on the CPU)."""

    def __init__(self, owner, name: str, device: str = "cuda") -> None:
        import torch

        self.owner, self.name = owner, name
        self.real = getattr(owner, name)
        self.calls = []
        on_card = device == "cuda"

        def timed(*args, **kwargs):
            if on_card:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            t = time.perf_counter()
            out = self.real(*args, **kwargs)
            device_ms = None
            if on_card:
                end.record()
                end.synchronize()
                device_ms = start.elapsed_time(end)
            self.calls.append(((time.perf_counter() - t) * 1e3, device_ms))
            return out

        setattr(owner, name, timed)

    def close(self) -> None:
        setattr(self.owner, self.name, self.real)

    def totals(self) -> tuple:
        """(calls, wall ms, device ms) summed."""
        device = [c[1] for c in self.calls]
        return (len(self.calls), sum(c[0] for c in self.calls),
                None if None in device else sum(device))


def wire_completion(k: int, votes, weights) -> dict:
    """An archived score completion as the port's wire type holds it:
    N candidates, then M judges with their stored vote and weight."""
    from decimal import Decimal

    m, n = votes.shape
    choices = [{"index": i, "finish_reason": "stop", "message": {
        "role": "assistant", "content": f"candidate {i} of {k}",
        "vote": None}, "weight": None, "confidence": None, "model": None,
        "model_index": None} for i in range(n)]
    for j in range(m):
        choices.append({
            "index": n + j, "finish_reason": "stop",
            "message": {"role": "assistant", "content": "I select `AB`",
                        "vote": [Decimal(repr(float(x))) for x in votes[j]]},
            "weight": Decimal(repr(float(weights[j]))), "confidence": None,
            "model": f"judge-{j}", "model_index": j})
    return {"id": f"scrcpl-{k:05d}", "choices": choices, "created": 0,
            "model": "panel", "object": "chat.completion",
            "weight_data": {"type": "static"}}


def config4_rescore(gpu: str, total: int = ARCHIVE_B,
                    device: str = "cuda") -> dict:
    """BASELINE config 4 (bench_all.py:374-402) at its published scale:
    ``total`` archived completions of M = 8 judges and N = 4 candidates
    from seed 0, re-tallied (1) by ``rescore_batch`` on prebuilt arrays,
    the median of 5 calls, and (2) by ``rescore_archive`` over an
    ``InMemoryArchive`` of ``total`` completions built from the port's
    wire types; each against float64 numpy (``TALLY_TOL``), with the
    host's extraction time and the device's (CUDA events around each
    ``rescore_batch`` call) apart."""
    import statistics

    import numpy as np

    from llm_weighted_consensus_tpu_torch import archive
    from llm_weighted_consensus_tpu_torch.archive.rescore import (
        rescore_archive,
    )
    from llm_weighted_consensus_tpu_torch.parallel import batch
    from llm_weighted_consensus_tpu_torch.types import score_response

    m, n = ARCHIVE_M, ARCHIVE_N
    rng = np.random.default_rng(0)
    votes = rng.random((total, m, n)).astype(np.float32)
    votes /= votes.sum(axis=2, keepdims=True)
    weights = rng.random((total, m)).astype(np.float32)
    cw64, conf64 = tally_f64(votes, weights)
    batch.rescore_batch(votes, weights, device=device)  # first call
    timer = CallTimer(batch, "rescore_batch", device)
    walls = []
    try:
        for _ in range(5):
            t = time.perf_counter()
            cw, conf = batch.rescore_batch(votes, weights, device=device)
            walls.append(time.perf_counter() - t)
        device_ms = [c[1] for c in timer.calls]
        arrays = {"wall_ms": statistics.median(walls) * 1e3,
                  "device_ms": None if None in device_ms
                  else statistics.median(device_ms),
                  "max_weight_err": weight_err(cw, cw64),
                  "max_conf_err": float(np.abs(conf - conf64).max()),
                  "sum_err": float(np.abs(conf.sum(1, dtype=np.float64)
                                          - 1.0).max())}
        arrays["completions_per_s"] = total / (arrays["wall_ms"] / 1e3)
    finally:
        timer.close()
    t = time.perf_counter()
    store = archive.InMemoryArchive()
    for k in range(total):
        store.put_score(score_response.ChatCompletion.from_json_obj(
            wire_completion(k, votes[k], weights[k])))
    build_s = time.perf_counter() - t
    timer = CallTimer(batch, "rescore_batch", device)
    try:
        t = time.perf_counter()
        results = rescore_archive(store, device=device)
        wall = time.perf_counter() - t
    finally:
        timer.close()
    got_cw = np.array([[float(x) for x in results[f"scrcpl-{k:05d}"][
        "weight"]] for k in range(total)])
    got_conf = np.array([[float(x) for x in results[f"scrcpl-{k:05d}"][
        "confidence"]] for k in range(total)])
    calls, batch_wall, device_ms = timer.totals()
    through = {
        "wall_ms": wall * 1e3,
        "completions_per_s": total / wall,
        "rescore_batch_calls": calls,
        "rescore_batch_wall_ms": batch_wall,
        "host_extraction_ms": wall * 1e3 - batch_wall,
        "device_ms": device_ms,
        "max_weight_err": weight_err(got_cw, cw64),
        "max_conf_err": float(np.abs(got_conf - conf64).max()),
        "archive_build_s": build_s,
    }
    row = {"phase": "config4_rescore", "gpu": gpu, "device": device,
           "completions": total, "judges": m, "candidates": n, "seed": 0,
           "rescore_batch": arrays, "rescore_archive": through,
           "tolerance": TALLY_TOL}
    emit(row)
    errs = [arrays["max_weight_err"], arrays["max_conf_err"],
            arrays["sum_err"], through["max_weight_err"],
            through["max_conf_err"]]
    if max(errs) > TALLY_TOL or len(results) != total or calls != 1:
        raise AssertionError(f"config4_rescore: {row}")
    return row


def stored_scores(completion) -> tuple:
    """(candidate weights, candidate confidences, judge choices) of an
    archived score completion, as floats."""
    cands = sorted((c for c in completion.choices if c.model_index is None),
                   key=lambda c: c.index)
    judges = [c for c in completion.choices if c.model_index is not None]
    return ([float(c.weight) for c in cands],
            [float(c.confidence) for c in cands], judges)


def override_recompute(completion, judge_id: str, weight) -> tuple:
    """The host's exact Decimal re-tally of an archived completion with
    judge ``judge_id``'s weight replaced: (weights, confidences)."""
    from decimal import Decimal

    _, _, judges = stored_scores(completion)
    n = len(completion.choices) - len(judges)
    cw = [Decimal(0)] * n
    for choice in judges:
        if choice.message.vote is None:
            continue
        w = Decimal(str(weight)) if choice.model == judge_id else choice.weight
        for i, v in enumerate(choice.message.vote[:n]):
            cw[i] += v * w
    total = sum(cw)
    return ([float(c) for c in cw],
            [float(c / total) if total > 0 else 0.0 for c in cw])


def results_err(results: dict, want: dict) -> tuple:
    """(weight err, confidence err) of /archive/rescore ``results``
    against {id: (weights, confidences)}."""
    import numpy as np

    w_err = c_err = 0.0
    if results.keys() != want.keys():
        raise AssertionError("rescore results cover other ids")
    for cid, (weights, conf) in want.items():
        w_err = max(w_err, weight_err(results[cid]["weight"], weights))
        c_err = max(c_err, float(np.max(np.abs(
            np.asarray(results[cid]["confidence"]) - conf))))
    return w_err, c_err


def archive_path(gpu: str, device: str = "cuda",
                 model_name: str = "bge-large-en") -> dict:
    """Phase 12 (c): the served loop at full bge-large width through
    ``build_embedder``, ``build_server`` and ``warm_up``, with
    ``ARCHIVE_PATH`` and ``TABLES_PATH`` under ``build/`` and
    ``ARCHIVE_STREAMING=1``, the judges phase 11's ``ScriptedJudges``:
    16 streamed and 4 unary training-table score requests of 8
    candidates (32 judges over 3 backends, 8 ``top_logprobs``), one
    request that takes an archived choice by id; ``POST /archive/rescore``
    plain, with ``revote``, with a ``weight_overrides`` on one judge and
    with ``apply``; ``POST /weights/learn`` with the panel, twice; the
    snapshot saved at close loaded anew.  (``device="cpu"`` with a small
    model rehearses the control flow; the kernel counters count only on
    the card.)"""
    import asyncio
    import shutil
    import statistics

    import numpy as np
    import torch

    from llm_weighted_consensus_tpu_torch import archive
    from llm_weighted_consensus_tpu_torch.archive.rescore import (
        revote_inputs,
        vote_matrix,
    )
    from llm_weighted_consensus_tpu_torch.identity.model import ModelBase
    from llm_weighted_consensus_tpu_torch.models.embedder import _seq_bucket
    from llm_weighted_consensus_tpu_torch.models.graphs import launch_lock
    from llm_weighted_consensus_tpu_torch.ops import votes as votes_mod
    from llm_weighted_consensus_tpu_torch.parallel import batch
    from llm_weighted_consensus_tpu_torch.serve.__main__ import (
        build_embedder,
        build_server,
        warm_up,
    )
    from llm_weighted_consensus_tpu_torch.serve.config import ServeConfig
    from llm_weighted_consensus_tpu_torch.weights.training_table import (
        TrainingTableStore,
    )

    judges = ScriptedJudges()
    work = os.path.join(REPO, "build", "archive_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    archive_file = os.path.join(work, "archive.json")
    tables_file = os.path.join(work, "tables.npz")
    env = {"EMBEDDER_MODEL": model_name, "EMBEDDER_MAX_TOKENS": "512",
           "LWC_ALLOW_RANDOM_PARAMS": "1", "OPENAI_API_BASE": judges.url,
           "OPENAI_API_KEY": "smoke-key", "ARCHIVE_PATH": archive_file,
           "TABLES_PATH": tables_file, "ARCHIVE_STREAMING": "1"}
    on_card = device == "cuda"
    emb = build_embedder(env, device=device)
    layers = emb.config.num_layers
    srv = None
    timers = []
    try:
        n_req = ARCHIVE_STREAMED + ARCHIVE_UNARY
        bodies = [score_body(300 + k, "training_table") for k in range(n_req)]
        prompts = [f"user: {score_prompt(300 + k)}" for k in range(n_req)]
        seqs = sorted({_seq_bucket(int(emb.tokenize([p], SCORE_MAX_TOKENS)[
            1].sum()), SCORE_MAX_TOKENS) for p in prompts})
        env["WARMUP"] = ",".join(f"16x{s}" for s in seqs)
        learn_shape = (32, emb.tokenize(prompts, SCORE_MAX_TOKENS)[0].shape[1])
        if on_card and learn_shape != ARCHIVE_ATTENTION_SHAPE:
            raise AssertionError(f"the learn pass embeds at {learn_shape}, "
                                 f"not {ARCHIVE_ATTENTION_SHAPE}")
        config = ServeConfig.from_env(env)
        srv = build_server(emb, None, config).start()
        warm_up(srv, config)
        port, store = srv.port, srv.archive
        graphs0 = emb.graph_stats()
        # 1. 16 streamed (8 in flight) and 4 unary requests, then one that
        # takes an archived choice as a candidate by id
        t = time.perf_counter()
        streamed = drive_score(port, bodies[:ARCHIVE_STREAMED], SCORE_INFLIGHT)
        unary = []
        for body in bodies[ARCHIVE_STREAMED:]:
            status, _, out = http(port, "/score/completions", body)
            if status != 200:
                raise AssertionError(f"unary score: {status} {out}")
            unary.append(out)
        serve_s = time.perf_counter() - t
        served_ids = [o["final"]["id"] for o in streamed["outs"]] + [
            o["id"] for o in unary]
        ids = store.score_ids()
        if sorted(ids) != sorted(served_ids):
            raise AssertionError(f"archived {len(ids)} of {n_req} completions")
        for cid in ids:
            if store.score_request(cid) is None or len(
                    store.score_ballots(cid) or {}) != SCORE_JUDGES:
                raise AssertionError(f"{cid}: request or ballots not archived")
        ref_body = score_body(400, "static")
        ref_body["choices"][0] = {"type": "score_completion", "id": ids[0],
                                  "choice_index": 0}
        status, _, ref_out = http(port, "/score/completions", ref_body)
        if status != 200 or ref_out["id"] not in store.score_ids():
            raise AssertionError(f"the archived reference: {status} {ref_out}")
        ids = store.score_ids()
        stored = {cid: stored_scores(store.score_completion(cid))
                  for cid in ids}
        # 2. /archive/rescore
        timers = [CallTimer(batch, "rescore_batch", device),
                  CallTimer(votes_mod, "softmax_votes", device)]

        def rescore(body):
            for timer in timers:
                timer.calls.clear()
            t = time.perf_counter()
            status, _, out = http(port, "/archive/rescore",
                                  {**body, "include_results": True})
            wall = (time.perf_counter() - t) * 1e3
            if status != 200 or out["rescored"] != len(ids):
                raise AssertionError(f"/archive/rescore {body}: {status} "
                                     f"{str(out)[:300]}")
            spans = [timer.totals()[2] for timer in timers]
            device_ms = None if None in spans else sum(spans)
            calls = [timer.totals()[0] for timer in timers]
            return out, {"wall_ms": wall, "device_ms": device_ms,
                         "host_ms": None if device_ms is None
                         else wall - device_ms,
                         "rescore_batch_calls": calls[0],
                         "softmax_votes_calls": calls[1]}

        plain, plain_t = rescore({})
        stored_want = {cid: (s[0], s[1]) for cid, s in stored.items()}
        plain_err = results_err(plain["results"], stored_want)
        revote, revote_t = rescore({"revote": True})
        revote_err = results_err(revote["results"], stored_want)
        # every judge's soft vote re-extracted on the card against its
        # stored exact vote
        vote_err, reextracted = 0.0, 0
        for cid in ids:
            completion = store.score_completion(cid)
            v, _, _ = vote_matrix(completion)
            m, n = v.shape
            lp, cidx, valid, use = revote_inputs(
                completion, store.score_ballots(cid), m, n)
            with launch_lock(device):
                got = votes_mod.softmax_votes(lp, cidx, valid, n,
                                              device=device).cpu().numpy()
            reextracted += int(use.sum())
            if use.any():
                vote_err = max(vote_err, float(np.abs(got[use] - v[use])
                                               .max()))
        judge_id = stored[ids[0]][2][0].model
        override = {judge_id: 2.5}
        over, over_t = rescore({"weight_overrides": override})
        over_want = {cid: override_recompute(store.score_completion(cid),
                                             judge_id, 2.5) for cid in ids}
        over_err = results_err(over["results"], over_want)
        applied, apply_t = rescore({"weight_overrides": override,
                                    "apply": True})
        if applied["applied"] != len(ids):
            raise AssertionError(f"applied {applied['applied']}")
        loop = asyncio.new_event_loop()
        try:
            fetched = {cid: loop.run_until_complete(
                store.fetch_score_completion(None, cid)) for cid in ids}
        finally:
            loop.close()
        for cid in ids:
            w, c, _ = stored_scores(fetched[cid])
            if (w != applied["results"][cid]["weight"]
                    or c != applied["results"][cid]["confidence"]):
                raise AssertionError(f"{cid}: apply did not write back")
        for timer in timers:
            timer.close()
        timers = []
        # 3. /weights/learn with the panel, twice
        panel = score_panel("training_table")
        model = ModelBase.from_json_obj(panel).into_model_validate()
        table_of = {llm.id: llm.training_table_id for llm in model.llms}
        learned = {}  # table id -> the prompts of its rows, in order
        for cid in ids:
            completion = store.score_completion(cid)
            tids = {table_of.get(c.model) for c in completion.choices
                    if c.model_index is not None
                    and c.message.vote is not None} - {None}
            for tid in sorted(tids):
                learned.setdefault(tid, []).append(
                    store.score_request(cid).template_content())
        want_rows = sum(len(p) for p in learned.values())
        embed_timer = CallTimer(emb, "embed_texts", device)
        timers = [embed_timer]
        g0 = emb.graph_stats()
        reset_launches()
        t = time.perf_counter()
        first = post(port, "/weights/learn", {"model": panel})
        learn_ms = (time.perf_counter() - t) * 1e3
        if on_card:
            torch.cuda.synchronize()
        launches, routes = read_launches(), read_routes()
        g1 = emb.graph_stats()
        again = post(port, "/weights/learn", {"model": panel})
        embed_calls, embed_wall, embed_device = embed_timer.totals()
        embed_timer.close()
        timers = []
        dispatches = (g1["replays"] - g0["replays"]
                      + g1["eager_dispatches"] - g0["eager_dispatches"])
        if first != {"rows_added": want_rows} or again != {"rows_added": 0}:
            raise AssertionError(f"learn: {first} then {again}, want "
                                 f"{want_rows} then 0")
        if (embed_calls != 1 or dispatches != 1
                or launches["attention"] != layers * dispatches * on_card
                or launches["cosine_vote"] or g1["captures"]
                != g0["captures"]):
            raise AssertionError(f"learn dispatches {dispatches}, launches "
                                 f"{launches}, embeds {embed_calls}")
        rows_err = 0.0
        tables = srv.tables
        for tid, texts in learned.items():
            rows = emb.embed_texts(texts, max_tokens=SCORE_MAX_TOKENS)
            rows_err = max(rows_err, float(np.abs(tables.get(tid)[0] - rows)
                                           .max()))
        if rows_err > LEARN_ROW_TOL:
            raise AssertionError(f"learned rows off by {rows_err}")
        graphs1 = emb.graph_stats()
        # 4. close: the snapshots load anew
        srv.close()
        srv = None
        reloaded = archive.InMemoryArchive.load(archive_file)
        if reloaded.score_ids() != ids:
            raise AssertionError("the saved archive holds other ids")
        saved_tables = TrainingTableStore.load(tables_file)
        if sorted(saved_tables._tables) != sorted(learned):
            raise AssertionError("the saved tables differ")
        errs = {"plain": plain_err, "revote": revote_err,
                "overrides": over_err, "revote_votes": vote_err,
                "learned_rows": rows_err}
        row = {
            "phase": "archive_path", "gpu": gpu, "nvidia_smi": gpu,
            "model": model_name, "dtype": str(emb.dtype).split(".")[-1],
            "layers": layers,
            "judges": SCORE_JUDGES, "backends": SCORE_BACKENDS,
            "candidates": SCORE_N, "streamed": ARCHIVE_STREAMED,
            "unary": ARCHIVE_UNARY, "archived": len(ids),
            "warmup": env["WARMUP"], "serve_s": serve_s,
            "client_p50_ms": statistics.median(streamed["seconds"]) * 1e3,
            "rescore": {"plain": plain_t, "revote": revote_t,
                        "overrides": over_t, "apply": apply_t},
            "reextracted_votes": reextracted,
            "learn": {"wall_ms": learn_ms, "rows_added": first["rows_added"],
                      "tables": len(learned), "embed_calls": embed_calls,
                      "embed_wall_ms": embed_wall,
                      "embed_device_ms": embed_device,
                      "dispatches": dispatches,
                      "eager_dispatches": g1["eager_dispatches"]
                      - g0["eager_dispatches"],
                      "replays": g1["replays"] - g0["replays"],
                      "shape": list(learn_shape)},
            "captures_after_warmup": graphs1["captures"] - graphs0["captures"],
            "launches": launches, "routes": routes, "max_err": errs,
            "tolerance": {"confidence": TALLY_TOL, "rows": LEARN_ROW_TOL},
        }
        emit(row)
        if (max(e if isinstance(e, float) else max(e)
                for k, e in errs.items() if k != "learned_rows") > TALLY_TOL
                or reextracted != len(ids) * SCORE_JUDGES
                or row["captures_after_warmup"]):
            raise AssertionError(f"archive_path: {row}")
        return row
    finally:
        for timer in timers:
            timer.close()
        if srv is not None:
            srv.close()
        judges.close()
        del emb
        if on_card:
            torch.cuda.empty_cache()


def check_archive_bge_micro(gpu: str, devices=("cpu", "cuda")) -> dict:
    """Phase 12 (d): one archive of bge_micro score completions (the port's
    ``ScoreClient`` on the CPU with ``InProcessJudges``, seeded ballots,
    static and training-table panels, ballots and requests archived),
    re-scored (plain, ``revote``, a weight override) and learned from
    (``populate_from_archive``, f32) on the card and on the CPU:
    confidences within ``TALLY_TOL``, table rows within ``MICRO_TOL``."""
    import asyncio
    import random

    import numpy as np
    import torch

    from llm_weighted_consensus_tpu_torch import archive, registry
    from llm_weighted_consensus_tpu_torch.archive.rescore import (
        rescore_archive,
    )
    from llm_weighted_consensus_tpu_torch.clients import chat
    from llm_weighted_consensus_tpu_torch.clients.score import ScoreClient
    from llm_weighted_consensus_tpu_torch.identity.model import ModelBase
    from llm_weighted_consensus_tpu_torch.models import loading, tokenizer
    from llm_weighted_consensus_tpu_torch.models.embedder import TorchEmbedder
    from llm_weighted_consensus_tpu_torch.types.score_request import (
        ChatCompletionCreateParams,
    )
    from llm_weighted_consensus_tpu_torch.weights import WeightFetchers
    from llm_weighted_consensus_tpu_torch.weights.learning import (
        populate_from_archive,
    )
    from llm_weighted_consensus_tpu_torch.weights.training_table import (
        TorchTrainingTableFetcher,
        TrainingTableStore,
    )

    fixture = os.path.join(REPO, "tests", "fixtures", "bge_micro")
    cfg = loading.load_hf_config(fixture)
    tok = tokenizer.load_tokenizer(loading.find_vocab(fixture))
    embs = {device: TorchEmbedder(
        "bge-micro", model=loading.load_params(
            fixture, cfg, dtype=torch.float32, device=device),
        config=cfg, tokenizer=tok, max_tokens=64, device=device,
        dtype=torch.float32) for device in devices}
    micro = dict(n_judges=5, backends=5, top_logprobs=4, top=3,
                 max_tokens=32)
    store = archive.InMemoryArchive()
    client = ScoreClient(
        chat.DefaultChatClient(
            InProcessJudges(), [chat.ApiBase("https://judges", "k")],
            backoff=chat.BackoffPolicy(max_elapsed_ms=0)),
        registry.InMemoryModelRegistry(), archive_fetcher=store,
        weight_fetchers=WeightFetchers(
            training_table_fetcher=TorchTrainingTableFetcher(
                embs["cpu"], TrainingTableStore())),
        rng_factory=lambda: random.Random(5), ballot_sink=store.put_ballot)
    loop = asyncio.new_event_loop()
    try:
        for k in range(3):
            for weight in ("static", "training_table"):
                params = ChatCompletionCreateParams.from_json_obj({
                    "messages": [{"role": "user",
                                  "content": MICRO_TEXTS[k]}],
                    "model": score_panel(weight, **micro),
                    "choices": MICRO_TEXTS[k:] + MICRO_TEXTS[:k]})
                result = loop.run_until_complete(
                    client.create_unary(None, params))
                store.put_score(result)
                store.put_score_request(result.id, params)
    finally:
        loop.close()
    judge_id = next(c.model for c in store.score_completion(
        store.score_ids()[0]).choices if c.model_index is not None)
    modes = {"plain": {}, "revote": {"revote": True},
             "overrides": {"weight_overrides": {judge_id: 2.0}}}
    results = {(d, mode): rescore_archive(store, device=d, **kw)
               for d in devices for mode, kw in modes.items()}
    conf_err = 0.0
    for mode in modes:
        a, b = results[(devices[0], mode)], results[(devices[-1], mode)]
        for cid in a:
            conf_err = max(conf_err, float(np.max(np.abs(
                np.array(a[cid]["confidence"], float)
                - np.array(b[cid]["confidence"], float)))))
    model = ModelBase.from_json_obj(
        score_panel("training_table", **micro)).into_model_validate()
    learned = {}
    for d in devices:
        tables = TrainingTableStore()
        learned[d] = (populate_from_archive(store, embs[d], model, tables),
                      tables)
    (n_a, t_a), (n_b, t_b) = learned[devices[0]], learned[devices[-1]]
    rows_err = 0.0
    same = n_a == n_b > 0 and sorted(t_a._tables) == sorted(t_b._tables)
    for tid in t_a._tables:
        rows_err = max(rows_err, float(np.abs(t_a.get(tid)[0]
                                              - t_b.get(tid)[0]).max()))
        same &= bool(np.array_equal(t_a.get(tid)[1], t_b.get(tid)[1]))
    row = {"phase": "archive_bge_micro", "gpu": gpu,
           "completions": len(store.score_ids()), "modes": sorted(modes),
           "conf_max_abs_err": conf_err, "rows_added": n_a,
           "rows_max_abs_err": rows_err, "same_tables_and_scores": same,
           "tolerance": {"confidence": TALLY_TOL, "rows": MICRO_TOL}}
    emit(row)
    if conf_err > TALLY_TOL or rows_err > MICRO_TOL or not same:
        raise AssertionError(f"archive_bge_micro: {row}")
    return row


# -- phase 13: traced serving -----------------------------------------------------


# the load generator of phase 13, run in a process of its own: client
# threads in the server's process would wait on the server's interpreter
# lock, and the server's threads on theirs.  Stdlib only; reads a job
# {"port", "groups": [{"inflight", "calls": [[path, body, headers]]}]}
# on stdin, runs the groups in turn (each call of a group on a pool of
# "inflight" threads) and prints [[status, headers, body text, ms]] per
# call and each group's wall seconds.
LOAD_CLIENT = r"""
import concurrent.futures, http.client, json, sys, time
job = json.load(sys.stdin)

def call(c):
    path, body, headers = c
    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", job["port"], timeout=600)
    try:
        conn.request("POST", path, body=json.dumps(body),
                     headers={"content-type": "application/json",
                              **(headers or {})})
        resp = conn.getresponse()
        raw = resp.read()
        out = [resp.status, {k.lower(): v for k, v in resp.getheaders()},
               raw.decode()]
    finally:
        conn.close()
    return out + [(time.perf_counter() - t0) * 1e3]

results, walls = [], []
for group in job["groups"]:
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(group["inflight"]) as pool:
        results += list(pool.map(call, group["calls"]))
    walls.append(time.perf_counter() - t0)
print(json.dumps({"results": results, "walls": walls}))
"""


def run_load(port: int, groups: list) -> tuple:
    """``groups`` [(inflight, [(path, body, headers)])] through
    ``LOAD_CLIENT`` in a child process -> ([(status, headers, JSON body
    or SSE ``data:`` payloads, ms)] in order, [wall seconds] per group)."""
    import subprocess

    job = {"port": port, "groups": [
        {"inflight": inflight, "calls": [list(c) for c in calls]}
        for inflight, calls in groups]}
    proc = subprocess.run(
        [sys.executable, "-c", LOAD_CLIENT], input=json.dumps(job),
        capture_output=True, text=True, timeout=1200)
    if proc.returncode != 0:
        raise AssertionError(f"load client: {proc.stderr[-2000:]}")
    out = json.loads(proc.stdout)
    calls = []
    for status, headers, text, ms in out["results"]:
        if headers.get("content-type", "").startswith("text/event-stream"):
            body = [blk[len("data: "):] for blk in text.split("\n\n")
                    if blk.startswith("data: ")]
        else:
            body = json.loads(text)
        calls.append((status, headers, body, ms))
    return calls, out["walls"]


class GcPauses:
    """The interpreter's garbage collections while the block runs: a
    collection stops every thread of the server, so a long one shows as
    unattributed time in a trace."""

    def __enter__(self):
        import gc

        self.pauses, self._t = [], None
        gc.callbacks.append(self._on)
        return self

    def _on(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.pauses.append((info["generation"],
                                (time.perf_counter() - self._t) * 1e3))

    def __exit__(self, *exc):
        import gc

        gc.callbacks.remove(self._on)

    def summary(self) -> dict:
        return {"collections": len(self.pauses),
                "full": sum(1 for g, _ in self.pauses if g == 2),
                "max_ms": max((ms for _, ms in self.pauses), default=0.0)}


def drive_traced(port, bursts, parents=None, embeds=(), model_name=None):
    """Each burst's /consensus requests at once (with the /embeddings
    request ``embeds[k]`` of burst k where there is one), from the load
    client's process; request i of the run carries ``traceparent:
    parents[i]`` where that is not None.  -> the calls [(path, texts,
    headers, body, ms)] in order, p50 and answers/s of the /consensus
    requests."""
    import numpy as np

    groups, order, i = [], [], 0
    for k, burst in enumerate(bursts):
        calls = []
        for texts in burst:
            parent = parents[i] if parents is not None else None
            calls.append(("/consensus", {"input": texts},
                          {"traceparent": parent} if parent else None))
            order.append(("/consensus", texts))
            i += 1
        if k < len(embeds):
            calls.append(("/embeddings",
                          {"model": model_name, "input": embeds[k]}, None))
            order.append(("/embeddings", embeds[k]))
            i += 1
        groups.append((len(calls), calls))
    results, walls = run_load(port, groups)
    out, ms = [], []
    for (path, texts), (status, headers, body, took) in zip(order, results):
        if status != 200:
            raise AssertionError(f"{path}: {status} {body}")
        if path == "/consensus":
            check_answer(body["confidence"], len(texts))
            ms.append(took)
        out.append((path, texts, headers, body, took))
    return {"calls": out, "p50_ms": float(np.median(ms)),
            "answers_per_s": len(ms) / sum(walls), "requests": len(ms)}


def request_buckets(emb, records, calls) -> list:
    """The bucket label each /consensus call of ``calls`` was served at,
    matched by its token ids against the recorded dispatches."""
    import numpy as np

    from llm_weighted_consensus_tpu_torch.models.graphs import key_label

    served = {}
    for key, kept, *_ in records:
        ids = np.asarray(kept["ids"]).astype(np.int32)
        n = key[2] if key[0] == "many" else ids.shape[0]
        rows = ids.reshape(-1, ids.shape[-1])
        for g in range(rows.shape[0] // n):
            served[rows[g * n:(g + 1) * n].tobytes()] = key_label(key)
    out = []
    for path, texts, *_ in calls:
        if path != "/consensus":
            continue
        ids = emb.tokenize(texts)[0].astype(np.int32)
        out.append(served.get(ids.tobytes()))
    return out


def check_trace(record: dict, root: str, chains: list,
                caller_parent=None) -> dict:
    """A kept trace's record, checked: its root span is ``root`` (its
    parent the caller's span or None), every other span's parent id
    resolves inside the trace, every span finished, and each chain of
    names ([root, child, grandchild]) hangs together.  -> its
    ``phase_breakdown``, with ``named_share`` (the named phases over
    ``e2e_ms``; ``phase_bar`` holds them to ``PHASE_BAR``) and where the
    root's unattributed time sits."""
    from llm_weighted_consensus_tpu_torch.obs import PHASES

    spans = record["spans"]
    ids = {s["span_id"]: s for s in spans}
    first = spans[0]
    if first["name"] != root or first["parent_id"] != caller_parent:
        raise AssertionError(f"trace root {first['name']} "
                             f"{first['parent_id']}")
    for s in spans[1:]:
        if s["parent_id"] not in ids:
            raise AssertionError(f"{s['name']}: parent {s['parent_id']} "
                                 "is not in the trace")
    if any(s["duration_ms"] is None for s in spans):
        raise AssertionError("a span of a kept trace never finished")
    for chain in chains:
        ok = any(
            s["name"] == chain[-1] and all(
                ids.get(_ancestor(ids, s, up), {}).get("name") == name
                for up, name in enumerate(reversed(chain[:-1]), 1))
            for s in spans)
        if not ok:
            raise AssertionError(f"no span chain {chain}")
    breakdown = dict(first["attributes"]["phase_breakdown"])
    breakdown["named_share"] = sum(
        breakdown[p] for p in PHASES) / breakdown["e2e_ms"]
    # where the root's unattributed time sits: before its first child
    # span opens, and after its last one closes
    if len(spans) > 1:
        breakdown["root_before_children_ms"] = min(
            s["start_ms"] for s in spans[1:]) - first["start_ms"]
        breakdown["root_after_children_ms"] = (
            first["start_ms"] + first["duration_ms"] - max(
                s["start_ms"] + s["duration_ms"] for s in spans[1:]))
    return breakdown


def _ancestor(ids: dict, span: dict, up: int):
    """The span id ``up`` generations above ``span``."""
    sid = span["span_id"]
    for _ in range(up):
        sid = ids[sid]["parent_id"] if sid in ids else None
    return sid


def phase_bar(breakdowns: list, what: str) -> None:
    """Fails unless every traced request's named phases hold
    ``PHASE_BAR`` of its ``e2e_ms`` (called after the row is printed)."""
    short = [b for b in breakdowns if b["named_share"] < PHASE_BAR]
    if short:
        worst = min(short, key=lambda b: b["named_share"])
        raise AssertionError(f"{what}: {len(short)} of {len(breakdowns)} "
                             f"traces under the phase bar; worst {worst}")


def phase_medians(breakdowns: list) -> dict:
    """The median of each named phase, of ``other_ms`` and of ``e2e_ms``,
    over ``breakdowns``; ``named_share`` the least named share seen."""
    import statistics

    from llm_weighted_consensus_tpu_torch.obs import PHASES

    keys = list(PHASES) + ["other_ms", "e2e_ms", "root_before_children_ms",
                           "root_after_children_ms"]
    out = {k: statistics.median(b[k] for b in breakdowns) for k in keys
           if all(k in b for b in breakdowns)}
    out["other_ms_max"] = max(b["other_ms"] for b in breakdowns)
    out["after_children_ms_max"] = max(
        b.get("root_after_children_ms", 0.0) for b in breakdowns)
    out["before_children_ms_max"] = max(
        b.get("root_before_children_ms", 0.0) for b in breakdowns)
    out["named_share_min"] = min(b["named_share"] for b in breakdowns)
    out["requests"] = len(breakdowns)
    return out


def get_trace(port: int, trace_id: str) -> dict:
    status, _, record = http(port, f"/v1/traces/{trace_id}")
    if status != 200:
        raise AssertionError(f"/v1/traces/{trace_id}: {status} {record}")
    return record


def traced_main(gpu, emb, work, on_card) -> dict:
    """(a) the main path under each tracing mode on one build: off,
    ``TRACE_ENABLED=1`` at rate 0, then rate 1 with half the requests
    carrying a caller's ``traceparent``."""
    import numpy as np
    import torch

    from llm_weighted_consensus_tpu_torch.serve.__main__ import (
        build_server,
        warm_up,
    )
    from llm_weighted_consensus_tpu_torch.serve.config import ServeConfig

    layers = emb.config.num_layers
    rng = np.random.default_rng(0)  # phase 1's bursts
    bursts = [[candidate_texts(rng, N_CANDIDATES, BURST_WORDS)
               for _ in range(BURST)] for _ in range(3)]
    requests = sum(len(b) for b in bursts)
    prng = np.random.default_rng(13)
    parents = [
        f"00-{prng.bytes(16).hex()}-{prng.bytes(8).hex()}-01"
        if i % 2 else None for i in range(requests)]
    base = serving_env(EMBEDDER_MODEL=emb.model_name,
                       WARMUP=f"{N_CANDIDATES}x128", WARMUP_R="2,4,8",
                       BATCH_WINDOW_MS=str(TRACED_WINDOW_MS))
    modes = (
        ("off", {}),
        ("enabled_rate_0", {"TRACE_ENABLED": "1"}),
        ("rate_1", {"TRACE_SAMPLE_RATE": "1",
                    "TRACE_DIR": os.path.join(work, "traces"),
                    "LEDGER_DIR": os.path.join(work, "ledger")}),
    )
    runs = {}
    for mode, extra in modes:
        config = ServeConfig.from_env({**base, **extra})
        srv = build_server(emb, None, config).start()
        try:
            warm_up(srv, config)
            if on_card:
                torch.cuda.synchronize()
            graphs0, stats0 = emb.graph_stats(), srv.batcher.stats()
            reset_launches()
            records, unwrap = record_dispatches(emb)
            try:
                with GcPauses() as gc_pauses:
                    out = drive_traced(srv.port, bursts,
                                       parents if mode == "rate_1" else None)
            finally:
                unwrap()
            if on_card:
                torch.cuda.synchronize()
            launches = read_launches()
            routes = read_routes() if on_card else None
            graphs1, stats1 = emb.graph_stats(), srv.batcher.stats()
            run = {
                "mode": mode, "p50_ms": out["p50_ms"],
                "answers_per_s": out["answers_per_s"],
                "requests": out["requests"], "launches": launches,
                "routes": routes,
                "consensus_dispatches": stats1["dispatches"]["consensus"]
                - stats0["dispatches"]["consensus"],
                "captures_after_warmup": graphs1["captures"]
                - graphs0["captures"],
                "replays": graphs1["replays"] - graphs0["replays"],
                "eager_dispatches": graphs1["eager_dispatches"]
                - graphs0["eager_dispatches"],
                "buckets": bucket_counts(records),
                "gc": gc_pauses.summary(),
                "calls": out["calls"],
                "request_buckets": request_buckets(emb, records,
                                                   out["calls"]),
            }
            if mode == "rate_1":
                breakdowns, adopted = [], 0
                for (path, texts, headers, body, _), parent in zip(
                        out["calls"], parents):
                    tid = headers.get("x-trace-id")
                    if not tid:
                        raise AssertionError("a traced answer without "
                                             "x-trace-id")
                    caller = None
                    if parent is not None:
                        caller = parent.split("-")[2]
                        if tid != parent.split("-")[1]:
                            raise AssertionError(
                                f"caller's trace not adopted: {tid}")
                        adopted += 1
                    breakdowns.append(check_trace(
                        get_trace(srv.port, tid), "gateway:POST /consensus",
                        [["gateway:POST /consensus", "batcher:consensus",
                          "device:dispatch"]], caller))
                run["phase_split"] = phase_medians(breakdowns)
                run["breakdowns"] = breakdowns
                run["adopted_traceparents"] = adopted
                run["sink"] = http(srv.port, "/metrics")[2]["traces"]
        finally:
            srv.close()
        runs[mode] = run
    # the same launches per dispatch on the same routes in every mode, all
    # from replays; the answers the untraced server's
    off, traced = runs["off"], runs["rate_1"]
    worst, bit_equal, apart = 0.0, 0, 0
    for i, (a, b) in enumerate(zip(off["calls"], traced["calls"])):
        diff = float(np.abs(np.asarray(a[3]["confidence"])
                            - np.asarray(b[3]["confidence"])).max())
        if off["request_buckets"][i] == traced["request_buckets"][i]:
            bit_equal += diff == 0.0
            if diff != 0.0:
                raise AssertionError(f"request {i}: traced answer differs "
                                     f"by {diff} at the same bucket")
        else:
            apart += 1
            worst = max(worst, diff)
            if diff > TRACED_ANSWER_TOL:
                raise AssertionError(f"request {i}: {diff} apart")
    for run in runs.values():
        want = expected_launches(layers, run["consensus_dispatches"], 0)
        if on_card and (run["launches"] != want
                        or run["captures_after_warmup"]
                        or run["eager_dispatches"]
                        or run["replays"] != run["consensus_dispatches"]):
            raise AssertionError(f"traced main path {run['mode']}: "
                                 f"{run['launches']} != {want}, {run}")
    row = {
        "phase": "traced_path", "part": "main", "gpu": gpu,
        "nvidia_smi": gpu, "model": emb.model_name, "layers": layers,
        "window_ms": TRACED_WINDOW_MS,
        "modes": {m: {k: r[k] for k in (
            "p50_ms", "answers_per_s", "requests", "consensus_dispatches",
            "buckets", "launches", "routes", "captures_after_warmup",
            "replays", "eager_dispatches", "gc")} for m, r in runs.items()},
        "tracing_overhead_p50": {
            m: runs[m]["p50_ms"] / off["p50_ms"] - 1.0
            for m in ("enabled_rate_0", "rate_1")},
        "answers_bit_equal": bit_equal, "answers_at_other_buckets": apart,
        "answers_max_abs_apart": worst,
        "phase_split": traced["phase_split"],
        "adopted_traceparents": traced["adopted_traceparents"],
        "traces": traced["sink"],
    }
    emit(row)
    phase_bar(traced["breakdowns"], "traced main path")
    row["launches"] = traced["launches"]
    return row


def traced_packed(gpu, emb, on_card) -> dict:
    """(b) one burst of the mixed-length traffic under the
    ``PACKING_ENABLED`` defaults, untraced then traced on one build."""
    from llm_weighted_consensus_tpu_torch.models.embedder import TorchEmbedder
    from llm_weighted_consensus_tpu_torch.serve.__main__ import build_server
    from llm_weighted_consensus_tpu_torch.serve.config import ServeConfig

    packed = TorchEmbedder(emb.model_name, model=emb.model,
                           config=emb.config, tokenizer=emb.tokenizer,
                           max_tokens=emb.max_tokens, device=emb.device,
                           dtype=emb.dtype)
    layers = packed.config.num_layers
    buckets = [(b, l, PACKING["packing_max_segments"])
               for b, l in PACKED_SHAPES]
    mixed, membeds = mixed_traffic()
    runs = {}
    for mode, extra in (("off", {}), ("rate_1", {"TRACE_SAMPLE_RATE": "1"})):
        env = serving_env(EMBEDDER_MODEL=emb.model_name, PACKING_ENABLED="1",
                          BATCH_MAX="64", **extra)
        srv = build_server(packed, None, ServeConfig.from_env(env)).start()
        try:
            srv.warmup([], [], buckets)
            graphs0, stats0 = packed.graph_stats(), srv.batcher.stats()
            reset_launches()
            with GcPauses() as gc_pauses:
                out = drive_traced(srv.port, mixed[:1], embeds=membeds[:1],
                                   model_name=emb.model_name)
            launches = read_launches()
            routes = read_routes() if on_card else None
            graphs1, stats1 = packed.graph_stats(), srv.batcher.stats()
            calls = sum(stats1["packing"]["call_shapes"].values()) - sum(
                stats0["packing"]["call_shapes"].values())
            run = {"p50_ms": out["p50_ms"], "answers_per_s":
                   out["answers_per_s"], "packed_calls": calls,
                   "launches": launches, "routes": routes,
                   "captures_after_warmup": graphs1["captures"]
                   - graphs0["captures"],
                   "eager_dispatches": graphs1["eager_dispatches"]
                   - graphs0["eager_dispatches"],
                   "gc": gc_pauses.summary()}
            if mode == "rate_1":
                breakdowns, items, scored = [], 0, []
                for path, _, headers, _, _ in out["calls"]:
                    record = get_trace(srv.port, headers["x-trace-id"])
                    kind = "consensus" if path == "/consensus" else "embed"
                    breakdowns.append(check_trace(
                        record, f"gateway:POST {path}",
                        [[f"gateway:POST {path}", f"batcher:{kind}",
                          "device:dispatch"]]))
                    if kind == "consensus":
                        scored.append(breakdowns[-1])
                    else:
                        run["embeddings_request"] = breakdowns[-1]
                    for s in record["spans"]:
                        if s["name"].startswith("batcher:"):
                            attrs = s["attributes"]
                            if not ("pack_plan_ms" in attrs
                                    and "host_tally_ms" in attrs):
                                raise AssertionError(
                                    f"packed item span {attrs}")
                            items += 1
                run["phase_split"] = phase_medians(breakdowns)
                run["traced_items"] = items
                run["shares"] = sorted(round(b["named_share"], 4)
                                       for b in breakdowns)
                # the burst as a whole: the /embeddings answer's JSON
                # encode (16 x 1024 floats) is host time no phase names
                run["burst_named_share"] = sum(
                    b["named_share"] * b["e2e_ms"] for b in breakdowns
                ) / sum(b["e2e_ms"] for b in breakdowns)
                bars = scored
        finally:
            srv.close()
        want = expected_launches(layers, 0, 0, packed_calls=calls)
        if on_card and (launches != want or run["captures_after_warmup"]):
            raise AssertionError(f"traced packed {mode}: {launches} != "
                                 f"{want} ({run})")
        runs[mode] = run
    per_call = {m: r["launches"]["segment_attention"] / max(
        1, r["packed_calls"]) for m, r in runs.items()}
    if on_card and per_call["off"] != per_call["rate_1"]:
        raise AssertionError(f"segment launches per call {per_call}")
    row = {"phase": "traced_path", "part": "packed", "gpu": gpu,
           "nvidia_smi": gpu, "modes": runs,
           "segment_launches_per_call": per_call}
    emit(row)
    phase_bar(bars, "traced packed burst, /consensus")
    if runs["rate_1"]["burst_named_share"] < PHASE_BAR:
        raise AssertionError(f"traced packed burst: named phases "
                             f"{runs['rate_1']['burst_named_share']}")
    row["launches"] = runs["rate_1"]["launches"]
    return row


def traced_score(gpu, emb, work, on_card) -> dict:
    """(c) phase 11's panel with training-table weights, traced at rate 1
    with ``LEDGER_DIR``: 8 streamed and 4 unary requests, 8 in flight;
    then an all-failed panel at rate 0 with ``TRACE_ENABLED=1``."""
    import statistics

    from llm_weighted_consensus_tpu_torch.identity.model import ModelBase
    from llm_weighted_consensus_tpu_torch.models.embedder import _seq_bucket
    from llm_weighted_consensus_tpu_torch.obs import (
        load_ledger_records,
        parse_traceparent,
        reset_quality,
    )
    from llm_weighted_consensus_tpu_torch.serve.__main__ import (
        build_server,
        warm_up,
    )
    from llm_weighted_consensus_tpu_torch.serve.config import ServeConfig

    judges = ScriptedJudges()
    ledger_dir = os.path.join(work, "score_ledger")
    tables_path = os.path.join(work, "tables.npz")
    n_req = TRACED_SCORE_STREAMED + TRACED_SCORE_UNARY
    bodies = [score_body(200 + k, "training_table") for k in range(n_req)]
    model = ModelBase.from_json_obj(bodies[0]["model"]).into_model_validate()
    slots = {}
    for llm in model.llms:
        slots[llm.id] = slots.get(llm.id, 0) + 1
    env = {"EMBEDDER_MODEL": emb.model_name, "EMBEDDER_MAX_TOKENS": "512",
           "LWC_ALLOW_RANDOM_PARAMS": "1", "OPENAI_API_BASE": judges.url,
           "OPENAI_API_KEY": "smoke-key", "TABLES_PATH": tables_path,
           "TRACE_SAMPLE_RATE": "1", "LEDGER_DIR": ledger_dir}
    srv = srv2 = None
    try:
        score_tables(emb, model, tables_path)
        seqs = sorted({_seq_bucket(int(emb.tokenize(
            [f"user: {score_prompt(200 + k)}"], SCORE_MAX_TOKENS)[1].sum()),
            SCORE_MAX_TOKENS) for k in range(n_req)})
        env["WARMUP"] = ",".join(f"16x{s}" for s in seqs)
        config = ServeConfig.from_env(env)
        srv = build_server(emb, None, config).start()
        warm_up(srv, config)
        graphs0 = emb.graph_stats()
        calls0 = len(judges.traceparents)
        # the scorecards are process-global: count this phase's ballots
        reset_quality()
        reset_launches()

        answers, (wall,) = run_load(srv.port, [(SCORE_INFLIGHT, [
            ("/score/completions",
             {**bodies[k], "stream": k < TRACED_SCORE_STREAMED}, None)
            for k in range(n_req)])])
        launches = read_launches()
        graphs1 = emb.graph_stats()
        traces, response_ids, breakdowns, kept = {}, [], [], []
        for k, (status, headers, out, _) in enumerate(answers):
            if status != 200:
                raise AssertionError(f"score request {k}: {status}")
            final = (read_score_stream(out)["final"]
                     if k < TRACED_SCORE_STREAMED else out)
            tid = headers.get("x-trace-id")
            if not tid or final.get("trace_id") != tid:
                raise AssertionError(f"final frame trace_id "
                                     f"{final.get('trace_id')} != {tid}")
            response_ids.append(final["id"])
            record = get_trace(srv.port, tid)
            kept.append(record)
            breakdowns.append(check_trace(
                record, "gateway:POST /score/completions",
                [["gateway:POST /score/completions", "judge:stream",
                  "judge:attempt"],
                 ["gateway:POST /score/completions", "batcher:embed",
                  "device:dispatch"],
                 ["gateway:POST /score/completions", "consensus:tally"],
                 ["gateway:POST /score/completions", "cache:lookup"]]))
            tally = next(s for s in record["spans"]
                         if s["name"] == "consensus:tally")["attributes"]
            if (len(tally["judges"]) != SCORE_JUDGES
                    or len(tally["candidates"]) != SCORE_N
                    or not {"weight_sum", "winner", "degraded",
                            "n_judges"} <= set(tally)):
                raise AssertionError(f"consensus:tally attributes {tally}")
            traces[tid] = {s["span_id"] for s in record["spans"]
                           if s["name"] == "judge:attempt"}
        # each judge call names its request's trace and its attempt span
        by_trace = {}
        for header in judges.traceparents[calls0:]:
            parsed = parse_traceparent(header)
            if parsed is None or parsed[0] not in traces:
                raise AssertionError(f"judge call traceparent {header}")
            by_trace.setdefault(parsed[0], []).append(parsed[1])
        for tid, attempts in traces.items():
            if sorted(by_trace.get(tid, [])) != sorted(attempts) or len(
                    attempts) != SCORE_JUDGES:
                raise AssertionError(f"trace {tid}: upstream parents "
                                     f"{by_trace.get(tid)} != {attempts}")
        # scorecards: one per distinct judge id, 12 ballots per slot
        status, _, cards = http(srv.port, "/v1/judges")
        got = {c["model"]: c["ballots"] for c in cards["judges"]}
        want = {jid: n_req * n for jid, n in slots.items()}
        if status != 200 or got != want:
            raise AssertionError(f"/v1/judges ballots {got} != {want}")
        # the ledger: the ring, the disk file, read back
        ledger = srv.ledger.snapshot()
        records, torn = load_ledger_records(ledger_dir)
        if (ledger["kept"] != n_req or ledger["size"] != n_req or torn
                or sorted(r["id"] for r in records) != sorted(response_ids)
                or sorted(r["trace_id"] for r in records) != sorted(traces)):
            raise AssertionError(f"ledger {ledger}, {len(records)} records "
                                 f"read back, {torn} torn")
        metrics = http(srv.port, "/metrics")[2]
        # the span trees, for reading where a request's time goes
        out_dir = os.path.join(REPO, "chiprun_out")
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "traces_score.jsonl"), "w") as f:
            for record in kept:
                f.write(json.dumps(record) + "\n")
        captures = graphs1["captures"] - graphs0["captures"]
        eager = graphs1["eager_dispatches"] - graphs0["eager_dispatches"]
        if on_card and (captures or eager or launches["cosine_vote"]):
            raise AssertionError(f"traced score path: {captures} captures, "
                                 f"{eager} eager, {launches}")
        srv.close()
        srv = None
        # an all-failed panel at rate 0: kept, forced "all_failed"
        env2 = {**env, "TRACE_SAMPLE_RATE": "0", "TRACE_ENABLED": "1",
                "BACKOFF_MAX_ELAPSED_TIME_MILLIS": "0", "WARMUP": ""}
        env2.pop("LEDGER_DIR")
        config2 = ServeConfig.from_env(env2)
        srv2 = build_server(emb, None, config2).start()
        warm_up(srv2, config2)
        broken = {"messages": [{"role": "user", "content": "q"}],
                  "model": {"llms": [{"model": f"broken-{i}"}
                                     for i in range(3)]},
                  "choices": ["a", "b"]}
        ((status, headers, body, _), healthy), _ = run_load(srv2.port, [
            (1, [("/score/completions", broken, None),
                 ("/score/completions", {**bodies[0], "stream": False},
                  None)])])
        record = get_trace(srv2.port, headers["x-trace-id"])
        dropped = http(srv2.port, f"/v1/traces/{healthy[1]['x-trace-id']}")
        sink2 = http(srv2.port, "/metrics")[2]["traces"]
        if (record["force_reason"] != "all_failed" or record["sampled"]
                or body.get("trace_id") != headers["x-trace-id"]
                or healthy[0] != 200 or dropped[0] != 404):
            raise AssertionError(f"all-failed at rate 0: {status} {body} "
                                 f"{record['force_reason']} {dropped[0]}")
        row = {
            "phase": "traced_path", "part": "score", "gpu": gpu,
            "nvidia_smi": gpu, "requests": n_req,
            "streamed": TRACED_SCORE_STREAMED, "unary": TRACED_SCORE_UNARY,
            "in_flight": SCORE_INFLIGHT, "judges": SCORE_JUDGES,
            "distinct_judge_ids": len(slots),
            "requests_per_s": n_req / wall,
            "client_p50_ms": statistics.median(a[3] for a in answers),
            "phase_split": phase_medians(breakdowns),
            "upstream_calls_traced": sum(len(v) for v in by_trace.values()),
            "scorecards": got, "ledger": ledger,
            "ledger_read_back": len(records),
            "traces": metrics["traces"], "launches": launches,
            "captures_after_warmup": captures, "eager_dispatches": eager,
            "all_failed": {"status": status,
                           "force_reason": record["force_reason"],
                           "healthy_dropped": dropped[0] == 404,
                           "sink": sink2},
        }
        emit(row)
        return row
    finally:
        for s in (srv, srv2):
            if s is not None:
                s.close()
        judges.close()


def traced_path(gpu: str, device: str = "cuda",
                model_name: str = "bge-large-en") -> dict:
    """Phase 13: request tracing on the served paths at full bge-large
    width (random weights from seed 0, bf16) through ``build_embedder``,
    ``build_server`` and ``warm_up``: (a) the main path's bursts under
    each tracing mode, (b) one packed burst traced, (c) phase 11's score
    panel traced, with the outcome ledger.  (``device="cpu"`` with a
    small model rehearses the control flow; the kernel counters count
    only on the card.)"""
    import shutil

    import torch

    from llm_weighted_consensus_tpu_torch.serve.__main__ import (
        build_embedder,
    )

    work = os.path.join(REPO, "build", "traced_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    on_card = device == "cuda"
    emb = build_embedder(serving_env(EMBEDDER_MODEL=model_name),
                         device=device)
    try:
        main = traced_main(gpu, emb, work, on_card)
        packed = traced_packed(gpu, emb, on_card)
        score = traced_score(gpu, emb, work, on_card)
    finally:
        del emb
        if on_card:
            torch.cuda.empty_cache()
    return {"main": main, "packed": packed, "score": score}



# -- phase 14: judge-side resilience and the memory governor ----------------------


def socket_fds() -> int:
    """Sockets this process holds open."""
    count = 0
    for fd in os.listdir("/proc/self/fd"):
        try:
            if os.readlink(f"/proc/self/fd/{fd}").startswith("socket:"):
                count += 1
        except OSError:
            pass
    return count


class RecordingEncoders:
    """``ChatRoutes.new_encoder`` that keeps every stream's encoder and
    each (item, frame) it encoded."""

    def __init__(self, fastpath: bool) -> None:
        self.fastpath = fastpath
        self.streams = []

    def __call__(self):
        from llm_weighted_consensus_tpu_torch.serve.frames import FrameEncoder

        sent = []

        class Recording(FrameEncoder):
            __slots__ = ()

            def encode(self, item):
                frame = FrameEncoder.encode(self, item)
                sent.append((item, frame))
                return frame

        enc = Recording(self.fastpath)
        self.streams.append((enc, sent))
        return enc


def lane_us_per_frame(streams, fastpath: bool, rounds: int = 5) -> float:
    """µs per frame to encode the recorded streams' items again, one fresh
    encoder per stream, on one lane (the least of ``rounds`` passes)."""
    from llm_weighted_consensus_tpu_torch.serve.frames import FrameEncoder

    frames = sum(len(sent) for _, sent in streams)
    best = None
    for _ in range(rounds):
        t = time.perf_counter()
        for _, sent in streams:
            enc = FrameEncoder(fastpath)
            for item, _ in sent:
                enc.encode(item)
        dt = time.perf_counter() - t
        best = dt if best is None else min(best, dt)
    return best / max(frames, 1) * 1e6


def read_resilient_answer(k: int, streamed: bool, out, ms: float) -> dict:
    """One phase-14 answer, checked: a stream ends [DONE]; the candidate
    confidences sum to 1 within ``SCORE_SUM_TOL``; a degraded answer's
    judge errors are 499 (quorum) or 504 (deadline) entries, a healthy
    one has none; no request outlives the deadline by more than
    ``RESILIENT_DEADLINE_MARGIN_MS`` -> its final frame and verdict."""
    if streamed:
        final = read_score_stream(out)["final"]
        degraded = final.get("degraded") is True
    else:
        final = out
        conf = [float(c["confidence"]) for c in final["choices"]
                if c["index"] < SCORE_N]
        if abs(sum(conf) - 1.0) > SCORE_SUM_TOL:
            raise AssertionError(f"unary {k}: confidences {conf}")
        degraded = None  # the unary fold drops the flag, keeps the entries
    codes = sorted(c["error"]["code"] for c in final["choices"]
                   if c.get("error"))
    if degraded is None:
        degraded = bool(codes)
    if degraded and (not codes or set(codes) - {499, 504}):
        raise AssertionError(f"request {k}: degraded with errors {codes}")
    if not degraded and codes:
        raise AssertionError(f"request {k}: errors {codes}, not degraded")
    deadline = float(RESILIENT_ENV["RESILIENCE_DEADLINE_MILLIS"])
    if ms > deadline + RESILIENT_DEADLINE_MARGIN_MS:
        raise AssertionError(f"request {k} took {ms:.0f} ms")
    return {"final": final, "degraded": degraded, "codes": codes}


def memory_drill(srv, texts, layers, on_card) -> dict:
    """The governor under pressure on the live server: watermarks lowered
    under the current RSS, one ``check()`` -> hard: ``/consensus`` sheds
    503 ``shed_reason: memory`` with ``Retry-After``, ``/livez`` 200,
    ``/readyz`` 200 with ``degraded_mem``, the ``memguard`` section at
    level 2, the trace ring and the cache budgets halved; watermarks
    raised, one ``check()`` -> level 0, the budgets restored, and
    ``/consensus`` answers bit-equal to its answer before the pressure,
    with one ``cluster`` vote launch."""
    from llm_weighted_consensus_tpu_torch.resilience.memguard import (
        read_rss_bytes,
    )

    mg = srv.memguard
    sink = srv.trace_sink
    caches = {"score_cache": srv.score_client.cache,
              "embed_cache": srv.batcher.embed_cache}
    budgets0 = {name: c.max_bytes for name, c in caches.items()}
    ring0 = sink.capacity
    before = post(srv.port, "/consensus", {"input": texts})
    snap0 = mg.snapshot()
    if snap0["level"] != "ok" or snap0["soft_trips"]:
        raise AssertionError(f"the governor fired on its own: {snap0}")
    rss = read_rss_bytes()
    marks = (mg.soft_bytes, mg.hard_bytes)
    mg.soft_bytes, mg.hard_bytes = rss // 4, rss // 2
    level = mg.check()
    shed = http(srv.port, "/consensus", {"input": texts})
    livez = http(srv.port, "/livez")
    readyz = http(srv.port, "/readyz")
    section = http(srv.port, "/metrics")[2]["memguard"]
    halved = {name: c.max_bytes for name, c in caches.items()}
    ring_halved = sink.capacity
    mg.soft_bytes, mg.hard_bytes = marks
    recovered = mg.check()
    restored = {name: c.max_bytes for name, c in caches.items()}
    l0, g0 = read_launches(), srv.embedder.graph_stats()
    after = post(srv.port, "/consensus", {"input": texts})
    l1, g1 = read_launches(), srv.embedder.graph_stats()
    launches = {name: l1[name] - l0[name] for name in l1}
    if on_card and (g1["eager_dispatches"] != g0["eager_dispatches"]
                    or g1["replays"] != g0["replays"] + 1):
        raise AssertionError(f"the drill's /consensus was not replayed: "
                             f"{g0} -> {g1}")
    if level != 2 or section["level"] != "hard" or recovered != 0:
        raise AssertionError(f"levels {level} {section} -> {recovered}")
    if (shed[0] != 503 or shed[1].get("Retry-After") != "1"
            or shed[2]["message"] != {"kind": "overloaded",
                                      "shed_reason": "memory"}):
        raise AssertionError(f"shed under hard pressure: {shed}")
    if livez[0] != 200 or readyz[0] != 200 or readyz[2] != {
            "ready": True, "degraded_mem": True, "mem_level": "hard"}:
        raise AssertionError(f"probes under pressure: {livez} {readyz}")
    if (halved != {n: max(1, b // 2) for n, b in budgets0.items()}
            or ring_halved != ring0 // 2 or restored != budgets0
            or sink.capacity != ring0):
        raise AssertionError(f"budgets {budgets0} -> {halved} -> {restored}"
                             f", ring {ring0} -> {ring_halved}")
    if before["confidence"] != after["confidence"]:
        raise AssertionError("/consensus after the pressure differs")
    if on_card and launches != {**{n: 0 for n in launches},
                                "attention": layers, "cosine_vote": 1}:
        raise AssertionError(f"drill launches {launches}")
    return {"rss_bytes": rss, "lowered_watermarks": [rss // 4, rss // 2],
            "watermarks": list(marks), "level_under_pressure": level,
            "level_after": recovered, "shed_status": shed[0],
            "readyz": readyz[2], "budgets": budgets0, "halved": halved,
            "trace_ring": [ring0, ring_halved], "launches_after": launches,
            "bit_equal": True}


def resilient_path(gpu: str, device: str = "cuda",
                   model_name: str = "bge-large-en") -> dict:
    """Phase 14: judge-side resilience, the memory governor and the
    ``HOST_FASTPATH`` splice lane at full bge-large width (random weights
    from seed 0, bf16) through ``build_embedder``, ``build_server`` and
    ``warm_up``.  Phase 11's panel (32 judges over 3 backends, soft
    votes, training-table weights from ``TABLES_PATH``) on
    ``ScriptedJudges`` with agreeing judges, behind three endpoints: a
    browned-out one (503) first, then the judges' server twice (a hedge
    races the next endpoint).  The same 20 requests (16 streamed, 4
    unary, 8 in flight, from the load-client process) go through a server
    with every knob unset, then through one with ``RESILIENT_ENV``,
    ``SCORE_CACHE_TTL=60`` and ``TRACE_ENABLED=1``; then a degraded
    request is repeated, and the memory drill runs on the same server.
    (``device="cpu"`` with a small model rehearses the control flow; the
    kernel counters count only on the card.)"""
    import shutil
    import statistics

    import numpy as np
    import torch

    from llm_weighted_consensus_tpu_torch.identity.model import ModelBase
    from llm_weighted_consensus_tpu_torch.models.embedder import _seq_bucket
    from llm_weighted_consensus_tpu_torch.resilience.memguard import (
        read_rss_bytes,
        resolve_watermarks,
    )
    from llm_weighted_consensus_tpu_torch.serve.__main__ import (
        build_embedder,
        build_server,
        warm_up,
    )
    from llm_weighted_consensus_tpu_torch.serve.config import ServeConfig
    from llm_weighted_consensus_tpu_torch.serve.frames import FrameEncoder

    on_card = device == "cuda"
    rss0, auto = read_rss_bytes(), resolve_watermarks(0, 0)
    emit({"phase": "resilient_path", "part": "start", "nvidia_smi": gpu,
          "rss_bytes": rss0, "auto_watermarks": auto})
    if auto is not None and rss0 >= auto[0]:
        raise AssertionError(f"RSS {rss0} is past the auto soft watermark")
    work = os.path.join(REPO, "build", "resilient_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    judges = ScriptedJudges(agree=RESILIENT_AGREEMENT)
    down = judges.url.replace("/v1", "/down/v1")
    apis = [{"api_base": down, "api_key": "k"},
            {"api_base": judges.url, "api_key": "k"},
            {"api_base": judges.url + "b", "api_key": "k"}]
    n_req = RESILIENT_STREAMED + RESILIENT_UNARY
    bodies = [score_body(300 + k, "training_table") for k in range(n_req)]
    model = ModelBase.from_json_obj(bodies[0]["model"]).into_model_validate()
    tables_path = os.path.join(work, "tables.npz")
    env = {"EMBEDDER_MODEL": model_name, "EMBEDDER_MAX_TOKENS": "512",
           "LWC_ALLOW_RANDOM_PARAMS": "1", "OPENAI_APIS": json.dumps(apis),
           "TABLES_PATH": tables_path}
    emb = build_embedder(env, device=device)
    layers = emb.config.num_layers
    texts = candidate_texts(np.random.default_rng(14), N_CANDIDATES,
                            BURST_WORDS)
    srv = None
    try:
        score_tables(emb, model, tables_path)
        # phase 11's prompt buckets (and any these prompts add), and the
        # drill's /consensus bucket
        seqs = sorted({96, 112, 128} | {_seq_bucket(int(emb.tokenize(
            [f"user: {score_prompt(300 + k)}"], SCORE_MAX_TOKENS)[1].sum()),
            SCORE_MAX_TOKENS) for k in range(n_req)})
        s_vote = emb.tokenize(texts, 512)[0].shape[1]
        env["WARMUP"] = ",".join(
            [f"16x{s}" for s in seqs] + [f"{N_CANDIDATES}x{s_vote}"])
        calls = [("/score/completions",
                  {**bodies[k], "stream": k < RESILIENT_STREAMED}, None)
                 for k in range(n_req)]

        def serve(extra):
            config = ServeConfig.from_env({**env, **extra})
            server = build_server(emb, None, config).start()
            warm_up(server, config)
            return server

        # the same traffic with every knob unset and no FAULT_PLAN
        srv = serve({})
        plain, (plain_wall,) = run_load(srv.port, [(SCORE_INFLIGHT, calls)])
        for k, (status, _, out, _) in enumerate(plain):
            if status != 200:
                raise AssertionError(f"plain request {k}: {status}")
            if k < RESILIENT_STREAMED:
                read_score_stream(out)
        srv.close()
        srv = None

        srv = serve({**RESILIENT_ENV, "SCORE_CACHE_TTL": "60",
                     "TRACE_ENABLED": "1"})
        if srv.memguard is None or srv.resilience is None:
            raise AssertionError("the resilient server has no governor or "
                                 "no policy")
        recorder = RecordingEncoders(srv.chat_routes.host_fastpath)
        srv.chat_routes.new_encoder = recorder
        # a task that dies unseen on the loop (a stream finalized outside
        # its pump) fails the phase
        loop_errors = []
        srv.chat_routes.loop.loop.set_exception_handler(
            lambda _, ctx: loop_errors.append(ctx.get("message")))
        sockets0 = socket_fds()
        graphs0, stats0 = emb.graph_stats(), srv.batcher.stats()
        calls0, down0 = judges.calls, judges.down_calls
        reset_launches()
        answers, (wall,) = run_load(srv.port, [(SCORE_INFLIGHT, calls)])
        if on_card:
            torch.cuda.synchronize()
        traffic_launches = read_launches()
        routes = read_routes() if on_card else None
        graphs1, stats1 = emb.graph_stats(), srv.batcher.stats()
        checked = []
        for k, (status, _, out, ms) in enumerate(answers):
            if status != 200:
                raise AssertionError(f"request {k}: {status} {str(out)[:300]}")
            checked.append(read_resilient_answer(
                k, k < RESILIENT_STREAMED, out, ms))
        res = http(srv.port, "/metrics")[2]["resilience"]
        counters = res["counters"]
        down_breakers = {key: b for key, b in res["breakers"].items()
                         if key.startswith(down + "|")}
        healthy_breakers = {key: b["state"] for key, b in
                            res["breakers"].items()
                            if not key.startswith(down + "|")}
        down_calls = judges.down_calls - down0
        if not (counters.get("quorum_degraded", 0) > 0
                and counters.get("hedge_launched", 0) > 0
                and counters.get("breaker_rejected", 0) > 0):
            raise AssertionError(f"resilience counters {counters}")
        if not any(b["state"] == "open" for b in down_breakers.values()):
            raise AssertionError(f"no open breaker on {down}: {res}")
        if set(healthy_breakers.values()) - {"closed"}:
            raise AssertionError(f"healthy breakers {healthy_breakers}")
        routed_down = down_calls + counters["breaker_rejected"]
        if down_calls >= routed_down:
            raise AssertionError(f"{down_calls} calls of {routed_down} "
                                 "attempts routed to the 503 backend")
        # every streamed frame is the slow lane's bytes for its item, and
        # the bytes each stream's client read are the frames encoded
        fallbacks = sum(enc.fallbacks for enc, _ in recorder.streams)
        by_id = {}
        for _, sent in recorder.streams:
            slow = FrameEncoder(False)
            for item, frame in sent:
                if slow.encode(item) != frame:
                    raise AssertionError("a splice frame differs from the "
                                         "slow lane's")
            if sent:
                by_id[sent[0][0].id] = [f[6:-2].decode() for _, f in sent]
        for k in range(RESILIENT_STREAMED):
            events = answers[k][2]
            sent = by_id.get(json.loads(events[0])["id"])
            if sent != events[:-1]:
                raise AssertionError(f"stream {k}: the wire is not the "
                                     "encoded frames")
        if fallbacks or srv.chat_routes.fastpath_fallbacks:
            raise AssertionError(f"{fallbacks} splice fallbacks")
        embed_d = stats1["dispatches"]["embed"] - stats0["dispatches"][
            "embed"]
        captures = graphs1["captures"] - graphs0["captures"]
        eager = graphs1["eager_dispatches"] - graphs0["eager_dispatches"]
        replays = graphs1["replays"] - graphs0["replays"]
        if on_card and (captures or eager or replays != embed_d or not embed_d
                        or traffic_launches["attention"] != layers * embed_d
                        or traffic_launches["cosine_vote"]):
            raise AssertionError(
                f"resilient path: {embed_d} embed dispatches, {replays} "
                f"replays, {captures} captures, {eager} eager, "
                f"{traffic_launches}")
        # a degraded request again: never cached, a fresh fan-out
        k_rep = next(k for k, c in enumerate(checked)
                     if c["degraded"] and k < RESILIENT_STREAMED)
        cache0 = http(srv.port, "/metrics")[2]["score_cache"]
        calls1 = judges.calls + judges.down_calls
        (rep,), _ = run_load(srv.port, [(1, [calls[k_rep]])])
        if rep[0] != 200:
            raise AssertionError(f"repeat: {rep[0]}")
        repeat = read_resilient_answer(-1, True, rep[2], rep[3])
        cache1 = http(srv.port, "/metrics")[2]["score_cache"]
        fresh = judges.calls + judges.down_calls - calls1
        if (repeat["final"]["id"] == checked[k_rep]["final"]["id"]
                or not fresh or cache1["hits"] != cache0["hits"]):
            raise AssertionError(f"repeat of a degraded request: {fresh} "
                                 f"upstream calls, cache {cache0} -> {cache1}")
        # cancelled stragglers and hedge losers closed their sockets
        for _ in range(60):
            sockets1 = socket_fds()
            if sockets1 <= sockets0:
                break
            time.sleep(0.05)
        if sockets1 > sockets0:
            raise AssertionError(f"sockets {sockets0} -> {sockets1}")
        drill = memory_drill(srv, texts, layers, on_card)
        if loop_errors:
            raise AssertionError(f"loop errors: {loop_errors[:3]}")
        # the phase's launches: the traffic, the repeat and the drill
        launches = read_launches()
        us_fast = lane_us_per_frame(recorder.streams, True)
        us_slow = lane_us_per_frame(recorder.streams, False)
        trace_snap = http(srv.port, "/metrics")[2]["traces"]

        def p50(xs):
            return statistics.median(xs)

        row = {
            "phase": "resilient_path", "gpu": gpu, "nvidia_smi": gpu,
            "model": model_name, "layers": layers, "requests": n_req,
            "streamed": RESILIENT_STREAMED, "unary": RESILIENT_UNARY,
            "in_flight": SCORE_INFLIGHT, "judges": SCORE_JUDGES,
            "agreement": RESILIENT_AGREEMENT, "knobs": RESILIENT_ENV,
            "warmup": env["WARMUP"],
            "plain": {"requests_per_s": n_req / plain_wall,
                      "client_p50_ms": p50([a[3] for a in plain])},
            "resilient": {"requests_per_s": n_req / wall,
                          "client_p50_ms": p50([a[3] for a in answers]),
                          "client_max_ms": max(a[3] for a in answers)},
            "degraded": sum(c["degraded"] for c in checked),
            "error_codes": sorted({code for c in checked
                                   for code in c["codes"]}),
            "counters": counters,
            "breakers": {key: b["state"] for key, b in
                         res["breakers"].items()},
            "fault_plan": res.get("fault_plan"),
            "down_calls": down_calls, "routed_to_down": routed_down,
            "upstream_calls": judges.calls - calls0,
            "frames": sum(len(sent) for _, sent in recorder.streams),
            "splice_us_per_frame": us_fast, "slow_us_per_frame": us_slow,
            "fastpath_fallbacks": fallbacks,
            "repeat": {"upstream_calls": fresh, "degraded":
                       repeat["degraded"]},
            "sockets": [sockets0, sockets1], "traces": trace_snap,
            "embed_dispatches": embed_d, "replays": replays,
            "captures_after_warmup": captures, "eager_dispatches": eager,
            "launches": launches, "routes": routes,
            "memory": drill, "rss_at_start": rss0, "auto_watermarks": auto,
        }
        emit(row)
        return row
    finally:
        if srv is not None:
            srv.close()
        judges.close()
        del emb
        if on_card:
            torch.cuda.empty_cache()


def graph_window(emb, batcher) -> dict:
    """The embedder's graph counters and the batcher's dispatches, to
    difference around a window of traffic."""
    graphs, stats = emb.graph_stats(), batcher.stats()
    return {"captures": graphs["captures"], "replays": graphs["replays"],
            "eager": graphs["eager_dispatches"],
            "consensus": stats["dispatches"]["consensus"],
            "embed": stats["dispatches"]["embed"]}


def replayed_only(before: dict, after: dict, what: str,
                  on_card: bool = True) -> dict:
    """The window's dispatches; on the card it fails unless every one
    replayed a graph warmed before it (none captured, none eager)."""
    d = {k: after[k] - before[k] for k in after}
    if on_card and (d["captures"] or d["eager"]
                    or d["replays"] != d["consensus"] + d["embed"]):
        raise AssertionError(f"{what}: {d}")
    return d


def dispatch_timeline(batcher) -> list:
    """Record each dispatch ``batcher`` accounts from here on as (lane,
    first item's submit time, start, end), perf_counter seconds, by
    wrapping its ``_observe`` on the instance (``del batcher._observe``
    stops it)."""
    rows = []
    observe = batcher._observe

    def recorded(group, t0, token, *, error):
        observe(group, t0, token, error=error)
        rows.append((group[0].lane, min(i.submitted for i in group), t0,
                     time.perf_counter()))

    batcher._observe = recorded
    return rows


def offline_holds(rows) -> dict:
    """How long each latency dispatch waited behind offline ones: the
    part of its queue time (first submit to start) that offline
    dispatches covered, against the longest offline dispatch among them.
    A latency item takes the first pipeline slot that frees, so the
    covered time stays within that one dispatch; more means an offline
    dispatch started ahead of a queued latency item."""
    offline = [(a, b) for lane, _, a, b in rows if lane == "offline"]
    held, worst = 0, {"covered_ms": 0.0, "longest_ms": 0.0}
    for lane, sub, t0, _ in rows:
        if lane != "latency":
            continue
        hits = sorted((max(a, sub), min(b, t0), b - a)
                      for a, b in offline if a < t0 and b > sub)
        covered, reach = 0.0, sub
        for lo, hi, _ in hits:
            covered += max(0.0, hi - max(lo, reach))
            reach = max(reach, hi)
        longest = max((d for *_, d in hits), default=0.0)
        if covered > 0:
            held += 1
        if covered > longest + 1e-9:
            raise AssertionError(
                f"a latency dispatch waited {covered * 1e3:.3f} ms behind "
                f"offline dispatches, the longest {longest * 1e3:.3f} ms")
        if covered > worst["covered_ms"] / 1e3:
            worst = {"covered_ms": covered * 1e3, "longest_ms": longest * 1e3}
    return {"latency_dispatches": sum(r[0] == "latency" for r in rows),
            "offline_dispatches": len(offline),
            "behind_offline": held, "worst": worst}


def offline_drive(gpu, emb, on_card) -> dict:
    """Phase 15 (a): ``POST /v1/train/rescore`` on a server with
    ``OFFLINE_ENABLED=1`` and every bucket the drive and the main path's
    bursts hit warmed, ``BATCH_MAX=1`` (each request or group its own
    R=1 dispatch, so an answer's bucket does not depend on what shares
    the card with it): the bursts alone, the drive alone, the drive again
    while the bursts run (their answers bit-equal to the first run's, and
    no latency dispatch held behind more than one offline dispatch:
    ``offline_holds``), and a second drive posted during a third
    (409)."""
    import threading

    import numpy as np

    from llm_weighted_consensus_tpu_torch.serve.__main__ import (
        build_server,
        warm_up,
    )
    from llm_weighted_consensus_tpu_torch.serve.config import ServeConfig
    from llm_weighted_consensus_tpu_torch.train.feed import synthetic_groups

    rng = np.random.default_rng(15)
    bursts = [[candidate_texts(rng, N_CANDIDATES, BURST_WORDS)
               for _ in range(BURST)] for _ in range(LEARN_BURSTS)]
    groups = synthetic_groups(LEARN_GROUPS, LEARN_N, seed=0)
    s_vote = emb.tokenize(bursts[0][0], 512)[0].shape[1]
    s_off = sorted({emb.tokenize(g, 512)[0].shape[1] for g in groups})
    env = serving_env(
        EMBEDDER_MODEL=emb.model_name, BATCH_MAX="1", OFFLINE_ENABLED="1",
        OFFLINE_INFLIGHT=str(LEARN_INFLIGHT),
        WARMUP=",".join([f"{N_CANDIDATES}x{s_vote}"]
                        + [f"{LEARN_N}x{s}" for s in s_off]))
    config = ServeConfig.from_env(env)
    srv = build_server(emb, None, config).start()
    drive = {"groups": LEARN_GROUPS, "n": LEARN_N, "seed": 0,
             "inflight": LEARN_INFLIGHT}
    try:
        warm_up(srv, config)
        # the phase's launches count from here (a warm-up runs each
        # bucket's forward once before its capture)
        reset_launches()
        w0 = graph_window(emb, srv.batcher)
        alone = drive_bursts(srv.port, bursts)
        t = time.perf_counter()
        solo = post(srv.port, "/v1/train/rescore", drive)
        solo_s = time.perf_counter() - t
        # the drive again, with the bursts running beside it
        box, spans = {}, {}

        def run_drive():
            spans["drive"] = [time.perf_counter()]
            box["out"] = http(srv.port, "/v1/train/rescore", drive)
            spans["drive"].append(time.perf_counter())

        timeline = dispatch_timeline(srv.batcher)
        thread = threading.Thread(target=run_drive)
        thread.start()
        while not srv.offline_rescore._lock.locked():
            time.sleep(0.001)
        spans["bursts"] = [time.perf_counter()]
        beside = drive_bursts(srv.port, bursts)
        spans["bursts"].append(time.perf_counter())
        thread.join(600)
        del srv.batcher._observe
        holds = offline_holds(timeline)
        status, _, shared = box["out"]
        if status != 200:
            raise AssertionError(f"drive beside bursts: {status} {shared}")
        if not spans["drive"][0] < spans["bursts"][0] < spans["drive"][1]:
            raise AssertionError(f"the drive and the bursts never overlapped:"
                                 f" {spans}")
        for k, (a, b) in enumerate(zip(alone["answers"], beside["answers"])):
            if not np.array_equal(a, b):
                raise AssertionError(
                    f"answer {k} beside the drive differs by "
                    f"{float(np.abs(a - b).max())}")
        for name, out in (("alone", solo), ("beside", shared)):
            if (out["errors"] or out["groups"] != LEARN_GROUPS
                    or out["items"] != LEARN_GROUPS * LEARN_N
                    or not 0 < out["offline_occupancy"] <= 1):
                raise AssertionError(f"drive {name}: {out}")
        # a second drive posted during a third
        box.clear()
        long_drive = {**drive, "groups": 4 * LEARN_GROUPS, "inflight": 1}
        thread = threading.Thread(target=lambda: box.update(
            out=http(srv.port, "/v1/train/rescore", long_drive)))
        thread.start()
        while not srv.offline_rescore._lock.locked():
            time.sleep(0.001)
        conflict = http(srv.port, "/v1/train/rescore", drive)
        thread.join(600)
        if conflict[0] != 409 or box["out"][0] != 200:
            raise AssertionError(f"overlapping drives: {conflict[0]} "
                                 f"{conflict[2]}, first {box['out'][0]}")
        window = replayed_only(w0, graph_window(emb, srv.batcher),
                               "offline drive", on_card)
        lanes = http(srv.port, "/metrics")[2]["device_batcher"]["lanes"]
    finally:
        srv.close()
    row = {
        "warmup": env["WARMUP"], "drive": drive,
        "alone": {k: solo[k] for k in ("groups", "items", "errors",
                                       "offline_occupancy", "lanes")},
        "alone_wall_s": solo_s,
        "beside": {k: shared[k] for k in ("groups", "items", "errors",
                                          "offline_occupancy", "lanes")},
        "drive_wall_s": spans["drive"][1] - spans["drive"][0],
        "bursts_wall_s": spans["bursts"][1] - spans["bursts"][0],
        "consensus_p50_ms": {"without_drive": alone["p50_ms"],
                             "with_drive": beside["p50_ms"]},
        "answers_per_s": {"without_drive": alone["answers_per_s"],
                          "with_drive": beside["answers_per_s"]},
        "answers_bit_equal": len(alone["answers"]),
        "latency_behind_offline": holds,
        "overlapping_drive": conflict[0], "lanes": lanes,
        "dispatches": window,
    }
    emit({"phase": "learning_path", "part": "offline_drive",
          "nvidia_smi": gpu, **row})
    return row


def drill_body(k: int, model_name: str) -> dict:
    return {"messages": [{"role": "user", "content": score_prompt(400 + k)}],
            "model": learn_panel(model_name),
            "choices": list(LEARN_CHOICES)}


def learn_panel(model_name: str) -> dict:
    """Phase 11's judges and weight type cut to one slot per backend, as
    the reference's learner drill: weights 1, 1 and 3 (base weights: no
    table is learned), the prompt embedded for each request."""
    return {"llms": [
        {"model": f"backend-{i}",
         "weight": {"type": "training_table", "base_weight": w,
                    "min_weight": 1, "max_weight": 5}}
        for i, w in enumerate((1, 1, 3))],
        "weight": {"type": "training_table", "top": SCORE_TOP,
                   "embeddings": {"model": model_name,
                                  "max_tokens": SCORE_MAX_TOKENS}}}


def drill_requests(port, ks, model_name, errors: list) -> list:
    """``ks``' unary score requests one at a time -> their winners;
    a status other than 200 or an error body lands in ``errors``."""
    import numpy as np

    winners = []
    for k in ks:
        status, _, out = http(port, "/score/completions",
                              drill_body(k, model_name))
        if status != 200 or not isinstance(out, dict) or "error" in out:
            errors.append((k, status, str(out)[:300]))
            continue
        conf = [float(c["confidence"]) for c in out["choices"]
                if c["index"] < len(LEARN_CHOICES)]
        winners.append(int(np.argmax(conf)) if conf else None)
    return winners


def learner_drill(gpu, emb, device, on_card) -> dict:
    """Phase 15 (b): the reference's learner drill end to end.  Phase
    11's judges on loopback (``ScriptedJudges``, every judge naming the
    right candidate) behind ``LEDGER_DIR`` with ``LEDGER_ROTATE_BYTES``
    (the ledger shards) and ``WEIGHTS_ENABLED=1``; the weight-3 judge
    mis-votes after its 8th ballot (``JUDGE_BIAS_PLAN``).  24 requests,
    then ``python -m llm_weighted_consensus_tpu_torch.train fit --device
    <device> --put`` over a copy of the shards while requests flow (at
    least ``LEARN_DRILL_DURING``, on until the CLI exits), then 4 more.  It fails on any client error, unless each record
    names the version that scored it (``base``, then the fitted ``wv-``
    one), the biased judge gets the smallest weight, the fitted held-out
    accuracy beats base, the card's weights match a CPU fit of the same
    shards within ``LEARN_FIT_TOL``, and a shadow ``PUT`` moves
    ``lwc_weights_shadow_total``."""
    import shutil

    from llm_weighted_consensus_tpu_torch.identity.model import ModelBase
    from llm_weighted_consensus_tpu_torch.models.embedder import _seq_bucket
    from llm_weighted_consensus_tpu_torch.obs.ledger import (
        ledger_shard_paths,
        load_ledger_records,
    )
    from llm_weighted_consensus_tpu_torch.serve.__main__ import (
        build_server,
        warm_up,
    )
    from llm_weighted_consensus_tpu_torch.serve.config import ServeConfig
    from llm_weighted_consensus_tpu_torch.train.fit import fit_from_ledger

    work = os.path.join(REPO, "build", "learning_smoke")
    shutil.rmtree(work, ignore_errors=True)
    ledger_dir, snapshot = (os.path.join(work, "ledger"),
                            os.path.join(work, "shards"))
    os.makedirs(ledger_dir)
    model_name = emb.model_name
    model = ModelBase.from_json_obj(
        learn_panel(model_name)).into_model_validate()
    biased = next(l for l in model.llms if l.base.model == "backend-2")
    seqs = sorted({_seq_bucket(int(emb.tokenize(
        [f"user: {score_prompt(400 + k)}"], SCORE_MAX_TOKENS)[1].sum()),
        SCORE_MAX_TOKENS) for k in range(LEARN_DRILL_MAX)})
    judges = ScriptedJudges(agree=1.0)
    env = serving_env(
        EMBEDDER_MODEL=model_name,
        OPENAI_APIS=json.dumps([{"api_base": judges.url, "api_key": "k"}]),
        LEDGER_DIR=ledger_dir, LEDGER_ROTATE_BYTES=str(LEARN_ROTATE_BYTES),
        WEIGHTS_ENABLED="1",
        JUDGE_BIAS_PLAN=f"judge={biased.index},after=8,flip=1.0,seed=7",
        WARMUP=",".join(f"16x{s}" for s in seqs))
    config = ServeConfig.from_env(env)
    srv = build_server(emb, None, config).start()
    errors: list = []
    try:
        launches0 = read_launches()
        warm_up(srv, config)
        warm = {k: v - launches0[k] for k, v in read_launches().items()}
        w0 = graph_window(emb, srv.batcher)
        before = drill_requests(srv.port, range(LEARN_DRILL_BEFORE),
                                model_name, errors)
        shutil.copytree(ledger_dir, snapshot)
        records, _ = load_ledger_records(snapshot)
        labels_path = os.path.join(work, "labels.json")
        with open(labels_path, "w") as f:
            json.dump({r["id"]: 0 for r in records}, f)
        # the fit and its hot swap while requests flow: at least
        # LEARN_DRILL_DURING of them, and on until the CLI has exited
        t = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "llm_weighted_consensus_tpu_torch.train",
             "fit", "--device", device, "--ledger-dir", snapshot,
             "--labels", labels_path, "--steps", str(LEARN_FIT_STEPS),
             "--put", f"http://127.0.0.1:{srv.port}"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=REPO, env={**os.environ, "PYTHONPATH": REPO})
        during: list = []
        k = LEARN_DRILL_BEFORE
        while (proc.poll() is None or len(during) < LEARN_DRILL_DURING) \
                and k < LEARN_DRILL_MAX - LEARN_DRILL_AFTER - 4:
            during += drill_requests(srv.port, [k], model_name, errors)
            k += 1
        try:
            out, err = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
        cli_s = time.perf_counter() - t
        if proc.returncode != 0:
            raise AssertionError(f"train fit: {err[-2000:]}")
        report = json.loads(out.strip().splitlines()[-1])
        n_total = k + LEARN_DRILL_AFTER
        after = drill_requests(srv.port, range(
            n_total - LEARN_DRILL_AFTER, n_total), model_name, errors)
        if errors:
            raise AssertionError(f"client errors: {errors[:3]}")
        version = report["version"]
        if report["put"] != {"ok": True, "version": version,
                             "mode": "active"}:
            raise AssertionError(f"the put: {report['put']}")
        fitted = report["weights"]
        acc = report["accuracy"]
        if not (acc["fitted"] > acc["base"]
                and fitted[biased.id] == min(fitted.values())):
            raise AssertionError(f"the fit: {report}")
        # every record names the version that scored it
        live, torn = load_ledger_records(ledger_dir)
        versions = [r["weights_version"] for r in live]
        swap = versions.index(version) if version in versions else None
        if (len(live) != n_total or torn or swap is None
                or swap < LEARN_DRILL_BEFORE
                or versions[:swap] != ["base"] * swap
                or versions[swap:] != [version] * (n_total - swap)):
            raise AssertionError(f"record versions {versions}")
        if after != [0] * LEARN_DRILL_AFTER:
            raise AssertionError(f"winners after the swap {after}")
        # the same shards fit on the CPU
        cpu = fit_from_ledger(snapshot, labels={
            r["id"]: 0 for r in records}, steps=LEARN_FIT_STEPS,
            device="cpu")
        fit_err = max(abs(fitted[j] - cpu["weights"][j]) for j in fitted)
        if fit_err > LEARN_FIT_TOL or cpu["accuracy"] != acc:
            raise AssertionError(f"card fit {fitted} vs CPU {cpu['weights']}")
        # a shadow table (the base weights) moves the shadow counters
        shadow = {llm.id: float(llm.base.weight.base_weight)
                  for llm in model.llms}
        status, _, put = http(srv.port, "/v1/weights",
                              {"weights": shadow, "mode": "shadow"},
                              method="PUT")
        drill_requests(srv.port, range(n_total, n_total + 4), model_name,
                       errors)
        prom = http(srv.port, "/metrics?format=prometheus")[2]
        wire = http(srv.port, "/v1/weights")[2]
        compared = f'lwc_weights_shadow_total{{kind="compared"}} ' \
                   f'{wire["shadow_compared"]}'
        # the base table would flip every post-swap verdict back
        if (status != 200 or errors or wire["shadow_compared"] != 4
                or wire["shadow_would_flip"] != 4 or compared not in prom):
            raise AssertionError(f"shadow: {status} {put} {wire} {errors}")
        window = replayed_only(w0, graph_window(emb, srv.batcher),
                               "learner drill", on_card)
        weights_snap = http(srv.port, "/metrics")[2]["weights"]
    finally:
        srv.close()
        judges.close()
    row = {
        "warmup": env["WARMUP"], "requests": n_total + 4,
        "requests_during_fit": len(during),
        "bias_plan": env["JUDGE_BIAS_PLAN"],
        "shards": report["shards"], "ledger_shards": len(
            ledger_shard_paths(ledger_dir)),
        "records": report["records"], "accuracy": acc,
        "weights": fitted, "biased": biased.id, "version": version,
        "cpu_weights": cpu["weights"], "fit_max_abs_err": fit_err,
        "cli_wall_s": cli_s, "swap_at_record": swap,
        "winners_before": before,
        "shadow": {"compared": wire["shadow_compared"],
                   "would_flip": wire["shadow_would_flip"]},
        "weights_section": weights_snap, "dispatches": window,
        "warmup_launches": warm,
    }
    emit({"phase": "learning_path", "part": "learner_drill",
          "nvidia_smi": gpu, **row})
    return row


def train_run(step, model, opt, batch, n: int, sync) -> tuple:
    """``n`` steps of ``step`` on one batch -> (losses, ms per step)."""
    losses = []
    t = time.perf_counter()
    for _ in range(n):
        losses.append(step(model, opt, *batch))
    sync()
    ms = (time.perf_counter() - t) * 1e3 / n
    return [float(x) for x in losses], ms


def trainer_case(gpu, name, cls, config, step, shape, device, on_card,
                 work) -> dict:
    """``TRAIN_STEPS`` steps of ``step`` on one seeded batch at ``shape``
    (b, s), f32 from a random init (seed 0): the losses finite and
    falling, every ``attn_q/k/v`` weight with a nonzero gradient, no
    kernel launched; then 3 steps, ``save_train_state``, a fresh model
    and optimizer loaded from the file, and the last steps again, within
    ``TRAIN_RESUME_RTOL`` of the straight run."""
    import numpy as np
    import torch

    from llm_weighted_consensus_tpu_torch import train
    from llm_weighted_consensus_tpu_torch.models import bert

    state = bert.random_state(cls, config, 0)
    rng = np.random.default_rng(16)
    b, s = shape
    batch = [rng.integers(3, config.vocab_size, (b, s)), np.ones((b, s)),
             rng.integers(3, config.vocab_size, (b, s)), np.ones((b, s))]
    batch[1][b - 1, s // 2:] = 0
    batch[3][0, s // 3:] = 0
    batch = [np.asarray(a, np.int64) for a in batch]

    def sync():
        if on_card:
            torch.cuda.synchronize()

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    model = bert.trainable(cls, state, config, device=device)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    launches0 = read_launches()
    opt = train.make_optimizer(model)
    straight, ms = train_run(step, model, opt, batch, TRAIN_STEPS, sync)
    projections = [p for n, p in model.named_parameters()
                   if n.endswith(("query.weight", "key.weight",
                                  "value.weight", "attn_q.weight",
                                  "attn_k.weight", "attn_v.weight"))]
    if (not np.isfinite(straight).all() or straight[-1] >= straight[0]
            or len(projections) != 3 * config.num_layers
            or any(float(p.grad.abs().max()) == 0 for p in projections)):
        raise AssertionError(f"{name}: losses {straight}, zero gradients "
                             f"{sum(float(p.grad.abs().max()) == 0 for p in projections)}")
    peak = torch.cuda.max_memory_allocated() if on_card else None
    # the interrupted run: 3 steps, the full state to disk, a fresh model
    model.load_state_dict(init)
    opt = train.make_optimizer(model)
    first, _ = train_run(step, model, opt, batch, 3, sync)
    path = os.path.join(work, f"{name}_train_state.pt")
    t = time.perf_counter()
    train.save_train_state(path, model, opt, step=3)
    save_s = time.perf_counter() - t
    del model, opt
    like = bert.trainable(cls, state, config, device=device)
    like, like_opt, at = train.load_train_state(
        path, like, train.make_optimizer(like))
    rest, _ = train_run(step, like, like_opt, batch, TRAIN_STEPS - 3, sync)
    os.unlink(path)
    resumed = first + rest
    err = max(abs(a - b) / abs(b) for a, b in zip(resumed, straight))
    if at != 3 or err > TRAIN_RESUME_RTOL:
        raise AssertionError(f"{name} resume: {resumed} vs {straight}")
    if read_launches() != launches0:
        raise AssertionError(f"{name}: training launched a kernel "
                             f"{read_launches()} vs {launches0}")
    del like, like_opt
    row = {"model": name, "shape": list(shape), "dtype": "float32",
           "losses": straight, "resumed": resumed, "resume_rel_err": err,
           "ms_per_step": ms, "max_memory_allocated": peak,
           "save_train_state_s": save_s,
           "parameters": sum(int(np.prod(v.shape)) for v in state.values())}
    emit({"phase": "learning_path", "part": "trainer", "nvidia_smi": gpu,
          **row})
    return row


def micro_step(cfg, state, device, cut_attention=False):
    """One InfoNCE step (lr 1e-3) of a trainable bge_micro (``cfg``,
    ``state``) on ``device``: (every parameter's gradient, every
    parameter after the step), numpy.  ``cut_attention`` detaches the
    attention's output, the gradient a kernel without a backward would
    drop."""
    import numpy as np
    import torch

    from llm_weighted_consensus_tpu_torch import train
    from llm_weighted_consensus_tpu_torch.models import bert

    model = bert.trainable(bert.BertEncoder, state, cfg, device=device)
    opt = train.make_optimizer(model, lr=1e-3)
    rng = np.random.default_rng(5)
    q = rng.integers(3, cfg.vocab_size, (8, 32)).astype(np.int64)
    p = rng.integers(3, cfg.vocab_size, (8, 32)).astype(np.int64)
    mask = np.ones((8, 32), np.int64)
    mask[3, 20:] = 0
    plain = bert.attention_plain
    if cut_attention:
        bert.attention_plain = lambda *args: plain(*args).detach()
    try:
        train.contrastive_loss(model, q, mask, p, mask).backward()
    finally:
        bert.attention_plain = plain
    grads = {n: (torch.zeros_like(t) if t.grad is None else t.grad)
             .detach().cpu().numpy() for n, t in model.named_parameters()}
    opt.step()
    return grads, {n: t.detach().cpu().numpy()
                   for n, t in model.named_parameters()}


def step_parity(device) -> dict:
    """bge_micro's first InfoNCE step on ``device`` against the CPU's:
    the largest gradient gap over the largest gradient, the worst gap
    over its limit (``TRAIN_GRAD_ATOL`` of the largest gradient plus
    ``TRAIN_GRAD_RTOL`` relative: at most 1), the largest parameter gap
    after the step, and the same limit ratio for a wrong step (the CPU's
    with the attention's gradient cut), which must exceed 1."""
    import numpy as np
    import torch

    from llm_weighted_consensus_tpu_torch.models import loading

    fixture = os.path.join(REPO, "tests", "fixtures", "bge_micro")
    cfg = loading.load_hf_config(fixture)
    served = loading.load_params(fixture, cfg, dtype=torch.float32,
                                 device="cpu")
    state = {k: v.numpy() for k, v in served.state_dict().items()}
    grads, params = micro_step(cfg, state, device)
    want, want_params = micro_step(cfg, state, "cpu")
    cut, _ = micro_step(cfg, state, "cpu", cut_attention=True)
    scale = max(float(np.abs(g).max()) for g in want.values())

    def worst(got):
        return max(float(np.max(np.abs(got[n] - w) / (
            TRAIN_GRAD_ATOL * scale + TRAIN_GRAD_RTOL * np.abs(w))))
            for n, w in want.items())

    row = {"grad_gap_over_largest": max(
               float(np.abs(grads[n] - w).max()) for n, w in want.items())
           / scale,
           "grad_gap_over_limit": worst(grads),
           "param_gap_after_step": max(
               float(np.abs(params[n] - w).max())
               for n, w in want_params.items()),
           "cut_attention_over_limit": worst(cut)}
    if row["grad_gap_over_limit"] > 1 or row["cut_attention_over_limit"] <= 1:
        raise AssertionError(f"bge_micro step, {device} vs CPU: {row}")
    return row


def trainers(gpu, device, on_card, model_name, rm_name) -> list:
    """Phase 15 (c): the InfoNCE step on the embedder's preset and the
    Bradley-Terry step on the reward model's, full width, f32, TF32 off,
    and bge_micro's step against the CPU (``step_parity``); no
    hand-written kernel runs (the counters must not move)."""
    import shutil

    import torch

    from llm_weighted_consensus_tpu_torch import train
    from llm_weighted_consensus_tpu_torch.models import bert, deberta
    from llm_weighted_consensus_tpu_torch.models.configs import PRESETS
    from llm_weighted_consensus_tpu_torch.models.reranker import RM_PRESETS

    if on_card and torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on for f32 matmuls")
    work = os.path.join(REPO, "build", "learning_smoke")
    os.makedirs(work, exist_ok=True)
    scale = 1 if on_card else 8
    rows = [
        trainer_case(gpu, model_name, bert.BertEncoder, PRESETS[model_name],
                     train.contrastive_train_step,
                     (TRAIN_BERT_SHAPE[0] // scale,
                      TRAIN_BERT_SHAPE[1] // scale), device, on_card, work),
        trainer_case(gpu, rm_name, deberta.DebertaModel, RM_PRESETS[rm_name],
                     train.reward_train_step,
                     (TRAIN_RM_SHAPE[0] // scale,
                      TRAIN_RM_SHAPE[1] // scale), device, on_card, work),
    ]
    shutil.rmtree(work, ignore_errors=True)
    rows.append({"name": "bge_micro_step_vs_cpu", **step_parity(device)})
    if on_card:
        torch.cuda.empty_cache()
    return rows


def learning_path(gpu: str, device: str = "cuda",
                  model_name: str = "bge-large-en",
                  rm_name: str = "deberta-v3-base") -> dict:
    """Phase 15: live judge weights, the offline lane and the learners at
    full width (random weights from seed 0; bf16 serving, f32 training):
    ``offline_drive``, ``learner_drill`` and ``trainers`` on one
    bge-large build through ``build_embedder``, ``build_server`` and
    ``warm_up``.  The served parts' launches must all be ``tma``
    attention and ``cluster`` votes replayed from graphs.  (``device=
    "cpu"`` with the tiny presets rehearses the control flow; the
    kernel counters count only on the card.)"""
    import torch

    from llm_weighted_consensus_tpu_torch.serve.__main__ import (
        build_embedder,
    )

    on_card = device == "cuda"
    t0 = time.perf_counter()
    env = {"EMBEDDER_MODEL": model_name, "EMBEDDER_MAX_TOKENS": "512",
           "LWC_ALLOW_RANDOM_PARAMS": "1"}
    emb = build_embedder(env, device=device)
    layers = emb.config.num_layers
    try:
        drive = offline_drive(gpu, emb, on_card)
        drill = learner_drill(gpu, emb, device, on_card)
        if on_card:
            torch.cuda.synchronize()
        # the traffic's launches: the drill server's warm-up forwards out
        routes = read_routes() if on_card else None
        launches = {k: v - drill["warmup_launches"][k]
                    for k, v in read_launches().items()}
        dispatches = {k: drive["dispatches"][k] + drill["dispatches"][k]
                      for k in ("consensus", "embed")}
        if on_card and (
                launches["attention"] != layers * sum(dispatches.values())
                or launches["cosine_vote"] != dispatches["consensus"]
                or launches["segment_attention"]
                or launches["w8a8_matmul"] or launches["w4a8_matmul"]):
            raise AssertionError(f"learning path: {dispatches} dispatches, "
                                 f"launches {launches}")
    finally:
        del emb
        if on_card:
            torch.cuda.empty_cache()
    counted = read_launches()
    trained = trainers(gpu, device, on_card, model_name, rm_name)
    if read_launches() != counted:
        raise AssertionError("the trainers launched a kernel")
    row = {"phase": "learning_path", "gpu": gpu, "nvidia_smi": gpu,
           "model": model_name, "layers": layers, "offline": drive,
           "drill": drill, "trainers": trained, "launches": launches,
           "routes": routes, "dispatches": dispatches,
           "seconds": time.perf_counter() - t0}
    emit(row)
    return row


# -- phase 16: device faults, the CPU twin, the profiler and the roofline ------


def fault_burst(port, texts_list) -> list:
    """Every /consensus body of ``texts_list`` at once -> [(status, body,
    ms, perf_counter at the answer)] in order, error statuses included."""
    import threading

    out = [None] * len(texts_list)

    def call(i, texts):
        t = time.perf_counter()
        status, _, body = http(port, "/consensus", {"input": texts})
        out[i] = (status, body, (time.perf_counter() - t) * 1e3,
                  time.perf_counter())

    threads = [threading.Thread(target=call, args=(i, texts))
               for i, texts in enumerate(texts_list)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    if any(t.is_alive() for t in threads):
        raise AssertionError("a /consensus request did not return")
    return out


def launch_delta(before: dict) -> dict:
    """The kernel launches since ``before`` (a ``read_launches``)."""
    return {k: v - before[k] for k, v in read_launches().items()}


def burst_p50(results) -> float:
    import numpy as np

    return float(np.median([ms for _, _, ms, _ in results]))


def fault_server(emb, twin, **env):
    """A started, warmed server on ``emb`` for phase 16's environment
    ``env`` (over ``serving_env`` with ``FAULT_WARMUP``) -> (server,
    config)."""
    from llm_weighted_consensus_tpu_torch.serve.__main__ import (
        build_server,
        warm_up,
    )
    from llm_weighted_consensus_tpu_torch.serve.config import ServeConfig

    config = ServeConfig.from_env(serving_env(**{
        "EMBEDDER_MODEL": emb.model_name, "BATCH_WINDOW_MS": FAULT_WINDOW_MS,
        "WARMUP": FAULT_WARMUP, "WARMUP_R": FAULT_WARMUP_R, **env}))
    srv = build_server(emb, None, config, twin=twin).start()
    try:
        warm_up(srv, config)
    except BaseException:
        srv.close()
        raise
    return srv, config


def fault_retry(gpu, emb, bursts, on_card) -> dict:
    """Phase 16 (a): ``FAULT_SCRIPT`` under ``MESH_FAULT_ENABLED`` with
    ``MESH_FAULT_TRANSIENT_RETRIES=2`` and no twin, one burst per group
    (a 1 s window closes as the 8th request arrives): burst 2's transient
    re-dispatches on the card, burst 3's third transient in a row
    escalates to persistent and, the one-rung ladder spent and no twin,
    fails its group with the 500 envelope, burst 4 answers 200.  Every
    200 within ``RUN_TOL`` of a clean server's answer to the same texts,
    the launches those of the dispatches that reached the card, no graph
    captured after warmup."""
    import numpy as np

    srv, _ = fault_server(emb, None)
    try:
        a0 = read_launches()
        clean = [fault_burst(srv.port, burst) for burst in bursts]
        clean_launches = launch_delta(a0)
        status, _, disabled = http(srv.port, "/v1/profile",
                                   {"duration_ms": 10})
    finally:
        srv.close()
    if status != 403 or disabled != {
            "code": 403, "message": "profiling disabled: set PROFILE_DIR"}:
        raise AssertionError(f"/v1/profile without PROFILE_DIR: {status} "
                             f"{disabled}")
    srv, _ = fault_server(
        emb, None, MESH_ENABLED="1", MESH_FAULT_ENABLED="1",
        MESH_FAULT_TRANSIENT_RETRIES="2",
        DEVICE_FAULT_PLAN=f"script={FAULT_SCRIPT}")
    try:
        reset_launches()
        w0 = graph_window(emb, srv.batcher)
        got = [fault_burst(srv.port, burst) for burst in bursts]
        window = graph_window(emb, srv.batcher)
        launches = read_launches()
        routes = read_routes() if on_card else None
        total = {k: launches[k] + clean_launches[k] for k in launches}
        snap = srv.meshfault.snapshot()
        ready = http(srv.port, "/readyz")
        util = srv.batcher.utilization()
    finally:
        srv.close()
    statuses = [[s for s, _, _, _ in burst] for burst in got]
    want = [[200] * BURST, [200] * BURST, [500] * BURST, [200] * BURST]
    if statuses != want:
        raise AssertionError(f"fault drill statuses {statuses}")
    envelope = got[2][0][1]
    if envelope != {"code": 500, "message": "internal server error"}:
        raise AssertionError(f"failed group's envelope {envelope}")
    worst = 0.0
    for k in (0, 1, 3):
        for (_, body, _, _), (_, ref, _, _) in zip(got[k], clean[k]):
            check_answer(body["confidence"], N_CANDIDATES)
            worst = max(worst, answers_diff([np.asarray(body["confidence"])],
                                            [np.asarray(ref["confidence"])]))
    if worst > RUN_TOL:
        raise AssertionError(f"fault drill answers differ by {worst}")
    injected = {"transient": 4}
    if (snap["re_dispatches"] != FAULT_RETRIED * BURST
            or snap["downsizes"] or snap["ladder"] != [[1, 1]]
            or snap["fault_plan"] != {"requests": 7, "injected": injected}):
        raise AssertionError(f"meshfault {snap}")
    reached = 3  # bursts 1, 2 (its retry) and 4; faults raise pre-launch
    d = {k: window[k] - w0[k] for k in window}
    layers = emb.config.num_layers
    if on_card and (launches["cosine_vote"] != reached
                    or launches["attention"] != reached * layers
                    or d["captures"] or d["eager"]
                    or d["replays"] != reached):
        raise AssertionError(f"fault drill launches {launches}, {d}")
    if ready[0] != 200 or util["fallback_active"]:
        raise AssertionError(f"after the drill: /readyz {ready}, {util}")
    row = {
        "script": FAULT_SCRIPT, "statuses": statuses,
        "failed_envelope": envelope, "meshfault": snap,
        "max_answer_diff": worst, "run_tol": RUN_TOL,
        "launches": launches, "routes": routes, "dispatches": d,
        "phase_launches": total,
        "clean_p50_ms": [burst_p50(b) for b in clean],
        "fault_p50_ms": [burst_p50(b) for b in got],
        "retry_cost_ms": burst_p50(got[1]) - burst_p50(clean[1]),
        "profile_disabled": status,
    }
    emit({"phase": "fault_path", "part": "a_classify_and_retry",
          "nvidia_smi": gpu, **row})
    return row


def twin_checks(emb, twin, texts_list, answers) -> dict:
    """The twin's answers against the port's CPU answers (the twin
    called directly, ``MICRO_TOL``) and against the card's (bf16) at the
    quantized-vs-padded bars (confidences ``PACKED_CONF_TOL``; the
    embedding cosine ``PACKED_MIN_COS`` on the first request's texts, as
    each bge-large forward on the CPU takes about a second)."""
    import numpy as np

    cpu_diff = card_diff = 0.0
    for texts, conf in zip(texts_list, answers):
        conf = np.asarray(conf)
        cpu_diff = max(cpu_diff, float(np.abs(
            conf - twin.consensus_confidence(texts)).max()))
        card_diff = max(card_diff, float(np.abs(
            conf - emb.consensus_confidence(texts)).max()))
    a, b = twin.embed_texts(texts_list[0]), emb.embed_texts(texts_list[0])
    min_cos = float(np.min(np.sum(a * b, axis=1)))
    if cpu_diff > MICRO_TOL or card_diff > PACKED_CONF_TOL \
            or min_cos < PACKED_MIN_COS:
        raise AssertionError(
            f"twin answers: {cpu_diff} from the CPU's, {card_diff} from the "
            f"card's, embedding cosine {min_cos}")
    return {"twin_vs_cpu_max_diff": cpu_diff, "cpu_tol": MICRO_TOL,
            "twin_vs_card_max_diff": card_diff, "card_tol": PACKED_CONF_TOL,
            "twin_vs_card_min_cosine": min_cos,
            "min_cosine_bar": PACKED_MIN_COS}


def wait_until(pred, timeout_s: float, what: str) -> float:
    t0 = time.perf_counter()
    while not pred():
        if time.perf_counter() - t0 > timeout_s:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.02)
    return time.perf_counter() - t0


def fault_hang(gpu, emb, twin, small, on_card) -> dict:
    """Phase 16 (b): a ``hang`` of ``FAULT_HANG_MS`` under the ladder with
    ``DEVICE_WATCHDOG_MILLIS`` ``FAULT_WATCHDOG_MS`` and the twin: the
    watchdog trips (``/readyz`` 503 ``device_unhealthy`` while the card is
    overdue, ``/consensus`` admitted meanwhile), the hang's raise
    classifies persistent, the spent ladder switches to the twin, the
    re-queued request, the one admitted meanwhile and every later one
    answer 200 from it, and the twin stays on after the watchdog
    recovers.  ``BATCH_PIPELINE=1``: no other dispatch may complete on the
    card between the trip and the hang's raise, since a clean dispatch
    clears the watchdog's note (as the reference's does) and the hang
    would then classify transient and retry on the card."""
    import threading

    srv, _ = fault_server(
        emb, twin, BATCH_WINDOW_MS="5", BATCH_PIPELINE="1",
        MESH_ENABLED="1",
        MESH_FAULT_ENABLED="1", MESH_FAULT_TRANSIENT_RETRIES="2",
        DEVICE_WATCHDOG_MILLIS=str(FAULT_WATCHDOG_MS),
        DEVICE_WATCHDOG_CPU_FALLBACK="1",
        DEVICE_FAULT_PLAN=f"script=ok|hang,hang_ms={FAULT_HANG_MS}")
    try:
        b0 = read_launches()
        first = fault_burst(srv.port, small[:1])
        card_launches = launch_delta(b0)
        twin0 = twin.graph_stats()["eager_dispatches"]
        box = {}
        hang = threading.Thread(target=lambda: box.update(
            hang=fault_burst(srv.port, small[1:2])))
        hang.start()
        tripped = wait_until(lambda: not srv.watchdog.healthy(),
                             FAULT_HANG_MS / 1e3 + 5, "the watchdog's trip")
        readyz = http(srv.port, "/readyz")
        # admitted (a twin can absorb it), queued behind the hang
        meanwhile = fault_burst(srv.port, small[2:3])
        hang.join(120)
        if hang.is_alive():
            raise AssertionError("the hung request did not return")
        later = (fault_burst(srv.port, small[3:4])
                 + fault_burst(srv.port, small[4:5]))
        wait_until(srv.watchdog.healthy, 30, "the watchdog's recovery")
        util = srv.batcher.utilization()
        snap = srv.meshfault.snapshot()
        wd = srv.watchdog.snapshot()
        twin_dispatches = twin.graph_stats()["eager_dispatches"] - twin0
        launches = launch_delta(b0)
    finally:
        srv.close()
    served = first + box["hang"] + meanwhile + later
    if [s for s, _, _, _ in served] != [200] * 5:
        raise AssertionError(f"hang drill statuses {served}")
    if readyz[0] != 503 or readyz[2].get("reason") != "device_unhealthy":
        raise AssertionError(f"/readyz while overdue: {readyz}")
    if (not util["fallback_active"] or wd["trips"] != 1
            or wd["recoveries"] < 1):
        raise AssertionError(f"the twin did not survive the recovery: "
                             f"{util} {wd}")
    if util["fallback_dispatches"] != twin_dispatches or twin_dispatches < 2:
        raise AssertionError(
            f"fallback_dispatches {util['fallback_dispatches']}, twin "
            f"dispatches {twin_dispatches}")
    if on_card and launches != card_launches:
        raise AssertionError(f"the twin moved the launch counters: "
                             f"{card_launches} -> {launches}")
    if snap["re_dispatches"] != 1 or snap["fault_plan"]["injected"] != {
            "hang": 1}:
        raise AssertionError(f"meshfault {snap}")
    checks = twin_checks(emb, twin, small[1:5],
                         [b["confidence"] for _, b, _, _ in served[1:]])
    row = {
        "watchdog_ms": FAULT_WATCHDOG_MS, "hang_ms": FAULT_HANG_MS,
        "tripped_after_s": tripped, "readyz_while_overdue": readyz[2],
        "statuses": [s for s, _, _, _ in served],
        "hung_request_ms": box["hang"][0][2],
        "admitted_while_unhealthy_ms": meanwhile[0][2],
        "twin_ms_per_request": sum(ms for _, _, ms, _ in later) / 2,
        "twin_request_ms": [ms for _, _, ms, _ in later],
        "card_request_ms": first[0][2],
        "fallback_dispatches": util["fallback_dispatches"],
        "fallback_active_after_recovery": util["fallback_active"],
        "watchdog": wd, "meshfault": snap, "card_launches": card_launches,
        "phase_launches": launches,
        **checks,
    }
    emit({"phase": "fault_path", "part": "b_twin_after_a_hang",
          "nvidia_smi": gpu, **row})
    return row


def spin_cycles(seconds: float) -> int:
    """``torch.cuda._sleep`` cycles for ``seconds`` on this card (timed
    with CUDA events over a 20 ms spin)."""
    import torch

    probe = 40_000_000
    torch.cuda._sleep(probe // 10)  # its first launch, outside the timing
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(probe)
    end.record()
    torch.cuda.synchronize()
    return int(probe * seconds * 1e3 / start.elapsed_time(end))


def fault_wedge(gpu, emb, twin, small, on_card) -> dict:
    """Phase 16 (c): the twin beside a really slow card, without the
    ladder (``DEVICE_WATCHDOG_MILLIS`` ``FAULT_WEDGE_WATCHDOG_MS`` and the
    twin only).  One dispatch is wrapped here, not in the package, so
    that it enqueues a ``torch.cuda._sleep`` spin of ``FAULT_SPIN_S``
    ahead of its forward; the requests sent once the watchdog has
    tripped answer from the twin while the spin still runs (its CUDA
    event not yet reached); after it the watchdog recovers, the twin turns
    off and the next burst runs on the card with its launches counted."""
    import threading

    import torch

    srv, _ = fault_server(
        emb, twin, DEVICE_WATCHDOG_MILLIS=str(FAULT_WEDGE_WATCHDOG_MS),
        DEVICE_WATCHDOG_CPU_FALLBACK="1")
    spin = {}
    try:
        c0 = read_launches()
        cycles = spin_cycles(FAULT_SPIN_S) if on_card else 0
        real = srv.batcher._dispatch_consensus

        def wedged(group, embedder):
            if embedder is emb and not spin:
                spin["t0"] = time.perf_counter()
                if on_card:
                    torch.cuda._sleep(cycles)
                    spin["done"] = torch.cuda.Event()
                    spin["done"].record()
                else:  # the CPU rehearsal blocks the dispatch thread
                    time.sleep(FAULT_SPIN_S)
            return real(group, embedder)

        srv.batcher._dispatch_consensus = wedged
        box = {}
        wedge = threading.Thread(target=lambda: box.update(
            wedged=fault_burst(srv.port, small[:1])))
        wedge.start()
        # the trip's callback has switched the twin on: what is sent now
        # must not reach the card's stream
        tripped = wait_until(lambda: srv.batcher.fallback_active,
                             FAULT_SPIN_S + 5, "the watchdog's trip")
        twin0 = twin.graph_stats()["eager_dispatches"]
        launched = read_launches()
        during = fault_burst(srv.port, small[1:4])
        spinning = [not spin["done"].query()] if on_card else []
        after_twin = read_launches()
        wedge.join(120)
        if wedge.is_alive():
            raise AssertionError("the wedged request did not return")
        wait_until(srv.watchdog.healthy, 30, "the watchdog's recovery")
        wait_until(lambda: not srv.batcher.fallback_active, 5,
                   "the twin's switch off")
        twin_dispatches = twin.graph_stats()["eager_dispatches"] - twin0
        cb0 = read_launches()
        w0 = graph_window(emb, srv.batcher)
        # a burst of 8: one group at the warmed R=8 bucket
        card = fault_burst(srv.port, small)
        d = {k: v - w0[k] for k, v in graph_window(emb, srv.batcher).items()}
        card_launches = launch_delta(cb0)
        phase_launches = launch_delta(c0)
        util = srv.batcher.utilization()
        wd = srv.watchdog.snapshot()
    finally:
        srv.batcher.__dict__.pop("_dispatch_consensus", None)
        srv.close()
    spin_end = spin["t0"] + FAULT_SPIN_S
    served = box["wedged"] + during + card
    if [s for s, _, _, _ in served] != [200] * len(served):
        raise AssertionError(f"wedge drill statuses {served}")
    late = [t - spin_end for _, _, _, t in during if t >= spin_end]
    if late or (on_card and not all(spinning)):
        raise AssertionError(f"a twin answer waited for the spin: {late}, "
                             f"spinning {spinning}")
    if on_card and after_twin != launched:
        raise AssertionError("the twin moved the launch counters")
    if twin_dispatches < 1 or util["fallback_dispatches"] != twin_dispatches:
        raise AssertionError(f"twin dispatches {twin_dispatches}, "
                             f"{util['fallback_dispatches']}")
    layers = emb.config.num_layers
    if on_card and (card_launches["cosine_vote"] != d["consensus"]
                    or card_launches["attention"] != layers * d["consensus"]
                    or d["replays"] != d["consensus"] or d["captures"]):
        raise AssertionError(f"after the wedge: {card_launches}, {d}")
    row = {
        "watchdog_ms": FAULT_WEDGE_WATCHDOG_MS, "spin_s": FAULT_SPIN_S,
        "spin_cycles": cycles, "tripped_after_s": tripped,
        "twin_answers_before_spin_end_s": [
            spin_end - t for _, _, _, t in during],
        "twin_request_ms": [ms for _, _, ms, _ in during],
        "card_still_spinning_at_last_twin_answer": spinning,
        "wedged_request_ms": box["wedged"][0][2],
        "twin_dispatches": twin_dispatches,
        "fallback_active_after": util["fallback_active"],
        "card_burst_p50_ms": burst_p50(card), "card_dispatches": d,
        "card_launches": card_launches, "watchdog": wd,
        "phase_launches": phase_launches,
    }
    emit({"phase": "fault_path", "part": "c_twin_beside_a_slow_card",
          "nvidia_smi": gpu, **row})
    return row


STICKY_CLIENT = r"""
import json, os, sys, time
env, repo = json.loads(sys.argv[1]), sys.argv[2]
sys.path.insert(0, repo)
import torch
from llm_weighted_consensus_tpu_torch.models import loading, tokenizer
from llm_weighted_consensus_tpu_torch.models.embedder import TorchEmbedder
from llm_weighted_consensus_tpu_torch.serve.__main__ import (
    build_server, warm_up)
from llm_weighted_consensus_tpu_torch.serve.config import ServeConfig
from chip_smoke import http

fixture = os.path.join(repo, "tests", "fixtures", "bge_micro")
cfg = loading.load_hf_config(fixture)

def micro(device):
    return TorchEmbedder(
        "bge-micro", model=loading.load_params(fixture, cfg, device=device),
        config=cfg, tokenizer=tokenizer.load_tokenizer(
            loading.find_vocab(fixture)), max_tokens=64, device=device)

emb, twin = micro("cuda"), micro("cpu")
twin.label_suffix = "@cpu"
config = ServeConfig.from_env(env)
srv = build_server(emb, None, config, twin=twin).start()
warm_up(srv, config)
texts = [f"candidate {i} about the capital of france" for i in range(4)]
out = {"before": [http(srv.port, "/consensus", {"input": texts})[0]
                  for _ in range(2)]}
seen = []
classify = srv.meshfault.classify

def recording(exc):
    kind = classify(exc)
    seen.append([type(exc).__module__ + "." + type(exc).__name__,
                 str(exc)[:400], kind])
    return kind

srv.meshfault.classify = recording
real = srv.batcher._dispatch_consensus
armed = [True]

def asserting(group, embedder):
    if armed and embedder is emb:
        armed.clear()
        x = torch.zeros(4, device="cuda")
        x[torch.full((1,), 10, dtype=torch.long, device="cuda")]
    return real(group, embedder)

srv.batcher._dispatch_consensus = asserting
t = time.perf_counter()
out["faulted"] = http(srv.port, "/consensus", {"input": texts})[:3:2]
out["faulted_ms"] = (time.perf_counter() - t) * 1e3
out["after"] = [http(srv.port, "/consensus", {"input": texts})[0]
                for _ in range(3)]
out["classified"] = seen
out["utilization"] = {k: srv.batcher.utilization()[k] for k in (
    "fallback_active", "fallback_dispatches")}
print(json.dumps(out), flush=True)
os._exit(0)  # the poisoned context's teardown is not part of the drill
"""


def fault_sticky(gpu, on_card) -> dict:
    """Phase 16 (d): an allocation past the card's memory raises
    ``torch.OutOfMemoryError`` and classifies transient; then, in a
    subprocess with a time limit (a sticky error poisons its process),
    bge_micro served on the card with the twin under the ladder, one
    dispatch made to raise a real device-side assert (an out-of-range
    index on the card; bge_micro, the committed fixture, so that the
    subprocess starts within seconds): the classifier's verdict on the real exception
    is persistent, the twin takes over and the faulted and later requests
    answer 200.  The exception's type and message and the subprocess's
    exit code are recorded."""
    import torch

    from llm_weighted_consensus_tpu_torch.resilience import (
        classify_dispatch_error,
    )

    row = {}
    if on_card:
        _, total = torch.cuda.mem_get_info()
        try:
            torch.empty(2 * int(total), dtype=torch.uint8, device="cuda")
        except torch.OutOfMemoryError as exc:
            row["oom"] = {"type": type(exc).__name__,
                          "message": str(exc)[:300],
                          "kind": classify_dispatch_error(exc)}
        else:
            raise AssertionError("an allocation past the card succeeded")
        if row["oom"]["kind"] != "transient":
            raise AssertionError(f"OOM classified {row['oom']}")
        env = {"BATCH_WINDOW_MS": "5",
               "WARMUP": "4x16", "MESH_ENABLED": "1",
               "MESH_FAULT_ENABLED": "1", "DEVICE_WATCHDOG_MILLIS": "5000",
               "DEVICE_WATCHDOG_CPU_FALLBACK": "1", "MEMGUARD": "0"}
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", STICKY_CLIENT, json.dumps(env), REPO],
            capture_output=True, text=True, timeout=FAULT_STICKY_TIMEOUT_S,
            cwd=REPO)
        os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
        with open(os.path.join(REPO, "chiprun_out", "fault_sticky.err"),
                  "w") as f:
            f.write(proc.stderr)
        lines = proc.stdout.strip().splitlines()
        if not lines:
            raise AssertionError(f"sticky drill: rc {proc.returncode}, "
                                 f"{proc.stderr[-2000:]}")
        out = json.loads(lines[-1])
        kinds = [k for _, _, k in out["classified"]]
        if (proc.returncode != 0 or out["before"] != [200, 200]
                or out["faulted"][0] != 200 or out["after"] != [200] * 3
                or not kinds or kinds[0] != "persistent"
                or not out["utilization"]["fallback_active"]):
            raise AssertionError(f"sticky drill: rc {proc.returncode} {out}")
        row["sticky"] = {"exit_code": proc.returncode,
                         "seconds": time.perf_counter() - t, **out}
    emit({"phase": "fault_path", "part": "d_real_cuda_errors",
          "nvidia_smi": gpu, **row})
    return row


def trace_kernels(path: str, skip_graph_launches: int = 0) -> dict:
    """Kernel and graph-launch events of a Chrome trace by port kernel
    (``attention_tma_kernel<false>``, ``cosine_vote_cluster_kernel``),
    counting, where ``skip_graph_launches`` is set, only the work
    launched from that ``cudaGraphLaunch`` on (0-based; kernels matched to
    their launch calls by correlation id); ``skipped_kernels`` counts the
    kernel events left out."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    graph = sorted(ev["ts"] for ev in events
                   if ev.get("name", "").startswith("cudaGraphLaunch"))
    cut = float("-inf")
    if skip_graph_launches:
        cut = (graph[skip_graph_launches]
               if skip_graph_launches < len(graph) else float("inf"))
    late = {ev.get("args", {}).get("correlation") for ev in events
            if ev.get("cat") == "cuda_runtime" and ev["ts"] >= cut}
    counts = {"attention_tma_kernel<false>": 0,
              "cosine_vote_cluster_kernel": 0, "kernels": 0,
              "cudaGraphLaunch": sum(1 for ts in graph if ts >= cut),
              "skipped_kernels": 0}
    for ev in events:
        name = ev.get("name", "")
        if ev.get("cat") != "kernel":
            continue
        if (skip_graph_launches
                and ev.get("args", {}).get("correlation") not in late):
            counts["skipped_kernels"] += 1
            continue
        counts["kernels"] += 1
        fn = port_kernel(name)
        if fn == "attention_tma_kernel" and "<false>" in name:
            counts["attention_tma_kernel<false>"] += 1
        elif fn == "cosine_vote_cluster_kernel":
            counts["cosine_vote_cluster_kernel"] += 1
    return counts


def fault_profile(gpu, emb, small, on_card) -> dict:
    """Phase 16 (e): ``POST /v1/profile {"duration_ms": FAULT_PROFILE_MS}``
    with ``PROFILE_DIR`` while two bursts of 8 small requests are served
    one after the other, the trace's kernel counts of the second held to
    the launch counters' rise over it (up to 3 captures while they miss),
    a concurrent ``/profile/start`` answering 400, the burst's p50 with
    and without the capture, and ``/v1/profile`` answering under a
    saturated gate (``ADMISSION_MAX_INFLIGHT=1``, its slot held) while
    ``/consensus`` sheds 503.  Late in a long process the tracer drops
    the first device records of each capture (about 30 on the H100, as
    out of its window), so the first burst takes that loss and the
    second is matched to its own launch calls (``trace_kernels``)."""
    import threading

    profile_dir = os.path.join(REPO, "build", "fault_profile")
    srv, _ = fault_server(emb, None, PROFILE_DIR=profile_dir)
    try:
        e0 = read_launches()
        plain = fault_burst(srv.port, small[:BURST])
        for traces in range(1, 4):
            box = {}
            capture = threading.Thread(target=lambda: box.update(
                out=http(srv.port, "/v1/profile",
                         {"duration_ms": FAULT_PROFILE_MS})))
            n_traces = len(srv.profiler.traces)
            capture.start()
            wait_until(lambda: srv.profiler._prof is not None, 30,
                       "the capture's start")
            busy = http(srv.port, "/profile/start", {})
            time.sleep(0.2)  # the tracer's first records, then the bursts
            p0 = emb.graph_stats()["replays"]
            primed = fault_burst(srv.port, small[:BURST])
            skip = emb.graph_stats()["replays"] - p0
            time.sleep(0.1)
            before, r0 = read_launches(), emb.graph_stats()["replays"]
            traced = fault_burst(srv.port, small[:BURST])
            capture.join(60)
            rise = {k: v - before[k] for k, v in read_launches().items()}
            replays = emb.graph_stats()["replays"] - r0
            status, _, body = box["out"]
            if status != 200 or len(srv.profiler.traces) != n_traces + 1:
                raise AssertionError(f"/v1/profile: {status} {body}")
            path = srv.profiler.traces[-1]
            counts = trace_kernels(path, skip)
            kernels_match = (
                counts["attention_tma_kernel<false>"] == rise["attention"]
                and counts["cosine_vote_cluster_kernel"]
                == rise["cosine_vote"])
            if not on_card or kernels_match:
                break
        graph_events = not kernels_match and counts["kernels"] == 0 and (
            counts["cudaGraphLaunch"] == replays)
        if on_card and not (kernels_match or graph_events):
            raise AssertionError(f"trace {counts} against launches {rise}, "
                                 f"replays {replays}")
        if busy[0] != 400 or busy[2] != {"code": 400,
                                         "message": "trace already active"}:
            raise AssertionError(f"/profile/start during a capture: {busy}")
        statuses = [s for s, _, _, _ in plain + primed + traced]
        if statuses != [200] * len(statuses):
            raise AssertionError(f"profiled burst statuses {statuses}")
        trace_bytes = os.path.getsize(path)
        phase_launches = launch_delta(e0)
    finally:
        srv.close()
    srv, _ = fault_server(emb, None, PROFILE_DIR=profile_dir,
                          ADMISSION_MAX_INFLIGHT="1")
    try:
        if srv.admission.try_acquire() is not None:  # the one slot, held
            raise AssertionError("the gate refused its first slot")
        exempt = http(srv.port, "/v1/profile", {"duration_ms": 10})
        shed = http(srv.port, "/consensus", {"input": small[0]})
    finally:
        srv.close()
    if exempt[0] != 200 or shed[0] != 503:
        raise AssertionError(f"saturated gate: /v1/profile {exempt[0]}, "
                             f"/consensus {shed[0]}")
    row = {
        "duration_ms": body["duration_ms"], "traces": traces,
        "trace_bytes": trace_bytes, "trace_counts": counts,
        "launch_rise": rise, "replays": replays, "primed_replays": skip,
        # both bursts replay one graph: the first's missing kernel records
        "first_burst_lost": counts["kernels"] - counts["skipped_kernels"],
        "kernels_match": kernels_match, "graph_events_only": graph_events,
        "burst_p50_ms": burst_p50(plain),
        "burst_p50_ms_captured": burst_p50(traced),
        "capture_overhead_ms": burst_p50(traced) - burst_p50(plain),
        "concurrent_start": busy[0], "saturated_gate": {
            "v1_profile": exempt[0], "consensus": shed[0]},
        "phase_launches": phase_launches,
    }
    emit({"phase": "fault_path", "part": "e_profile", "nvidia_smi": gpu,
          **row})
    return row


def fault_roofline(gpu, srv_metrics, on_card) -> dict:
    """Phase 16 (f): the ``roofline`` section after (a)-(c) (scraped by
    ``fault_path`` from a server of this phase; the phase aggregator was
    reset at the phase's start): every card bucket that ran has
    ``sol_ms``, ``device_p50_ms`` and ``attainment``, none above 1.0; the
    twin's ``@cpu`` rows carry counts only."""
    section, families = srv_metrics
    rows = section["buckets"]
    card = {k: v for k, v in rows.items() if not k.endswith("@cpu")}
    if on_card:
        missing = [k for k, v in card.items()
                   if not {"sol_ms", "device_p50_ms", "attainment"} <= set(v)]
        over = {k: v["attainment"] for k, v in card.items()
                if v.get("attainment", 0) > 1.0}
        if (section["backend"] != "cuda" or not card or missing or over
                or not families):
            raise AssertionError(f"roofline: missing {missing}, over 1.0 "
                                 f"{over}, families {families}")
    row = {"backend": section["backend"], "buckets": rows,
           "prometheus_samples": families}
    emit({"phase": "fault_path", "part": "f_roofline", "nvidia_smi": gpu,
          **row})
    return row


def scrape_roofline(port) -> tuple:
    """The ``roofline`` section and the two Prometheus families' samples
    (``scrape_metrics`` parses the whole text)."""
    scrape_metrics(port)
    section = http(port, "/metrics")[2]["roofline"]
    text = http(port, "/metrics?format=prometheus")[2]
    families = [ln for ln in text.splitlines()
                if ln.startswith(("lwc_roofline_sol_ms{",
                                  "lwc_roofline_attainment{"))]
    return section, families


def fault_path(gpu: str, device: str = "cuda",
               model_name: str = "bge-large-en") -> dict:
    """Phase 16: device faults on one card, the CPU twin, the profiler
    routes and the roofline gauge, on one bge-large build (random weights
    from seed 0, bf16) through ``build_embedder``, ``build_server`` and
    ``warm_up`` (``FAULT_WARMUP``, ``FAULT_WARMUP_R``) and one CPU twin
    (``build_cpu_twin``, f32): ``fault_retry`` (a), ``fault_hang`` (b),
    ``fault_wedge`` (c), ``fault_sticky`` (d), ``fault_profile`` (e) and
    ``fault_roofline`` (f).  (``device="cpu"`` with test-tiny rehearses
    the control flow: no kernel counts, no spin, no sticky error.)"""
    import numpy as np
    import torch

    from llm_weighted_consensus_tpu_torch import obs
    from llm_weighted_consensus_tpu_torch.resilience.memguard import (
        read_rss_bytes,
    )
    from llm_weighted_consensus_tpu_torch.serve.__main__ import (
        build_cpu_twin,
        build_embedder,
    )

    on_card = device == "cuda"
    t0 = time.perf_counter()
    # the roofline section reads this phase's device timings alone, and
    # the process-global quality aggregator drops the earlier phases'
    # margin exemplars (``scrape_metrics`` parses lines without them)
    obs.reset_phases()
    obs.reset_quality()
    env = serving_env(EMBEDDER_MODEL=model_name)
    emb = build_embedder(env, device=device)
    rss0 = read_rss_bytes() or 0
    twin = build_cpu_twin(env)
    twin_rss = (read_rss_bytes() or 0) - rss0
    seconds = {"build": time.perf_counter() - t0}
    rng = np.random.default_rng(16)
    bursts = [[candidate_texts(rng, N_CANDIDATES, BURST_WORDS)
               for _ in range(BURST)] for _ in range(4)]
    small = [candidate_texts(rng, FAULT_SMALL_N, FAULT_SMALL_WORDS)
             for _ in range(BURST)]
    try:
        def part(name, fn, *args):
            t = time.perf_counter()
            out = fn(*args)
            seconds[name] = time.perf_counter() - t
            return out

        retry = part("a", fault_retry, gpu, emb, bursts, on_card)
        hang = part("b", fault_hang, gpu, emb, twin, small, on_card)
        wedge = part("c", fault_wedge, gpu, emb, twin, small, on_card)
        # (f) reads the gauge through a server of this phase after (a)-(c)
        srv, _ = fault_server(emb, None)
        try:
            metrics = scrape_roofline(srv.port)
        finally:
            srv.close()
        roofline = part("f", fault_roofline, gpu, metrics, on_card)
        sticky = part("d", fault_sticky, gpu, on_card)
        profile = part("e", fault_profile, gpu, emb, small, on_card)
    finally:
        del emb, twin
        if on_card:
            torch.cuda.empty_cache()
    row = {"phase": "fault_path", "gpu": gpu, "nvidia_smi": gpu,
           "model": model_name, "twin_rss_bytes": twin_rss,
           "retry": {k: retry[k] for k in ("retry_cost_ms", "launches")},
           "hang": {k: hang[k] for k in ("twin_ms_per_request",
                                         "fallback_dispatches")},
           "wedge": {k: wedge[k] for k in ("twin_dispatches",
                                           "card_launches")},
           "sticky": sticky.get("sticky", {}).get("classified"),
           "profile_overhead_ms": profile["capture_overhead_ms"],
           "attainment": {k: v.get("attainment")
                          for k, v in roofline["buckets"].items()},
           # every launch of the phase's traffic (warm-ups left out)
           "launches": {k: sum(p["phase_launches"][k]
                               for p in (retry, hang, wedge, profile))
                        for k in retry["phase_launches"]},
           "seconds_by_part": seconds,
           "seconds": time.perf_counter() - t0}
    emit(row)
    return row


# -- phase 17: the benches ----------------------------------------------------------

# (label, bench argv, time limit s, the record kinds it prints in order),
# in two lanes run at once: a bench's figures here are a gate's, not a
# measurement's (PERF.md's come from the benches run alone)
BENCH_LANES = (
    (
        ("headline", ["headline", "--requests", "40",
                      "--latency-requests", "20"], 300, ["headline"]),
        ("headline_int8", ["headline", "--quantize", "int8", "--requests",
                           "20", "--latency-requests", "10"], 300,
         ["headline"]),
        ("fwd", ["fwd"], 240, ["fwd"]),
        ("attn", ["attn"], 180,
         ["attn_row"] * 7 + ["attn"]),
        ("host", ["host", "--requests", "20"], 180, ["host"]),
    ),
    (
        ("configs", ["configs", "--quick", "--single-run"], 600,
         ["config1", "config2", "config3", "config4", "config5", "config7",
          "config6"]),
        ("http", ["http", "--quick", "--requests", "16"], 300,
         ["/consensus", "/score/completions", "/multichat/completions"]),
        ("http_trace", ["http", "--trace-overhead", "--quick",
                        "--requests", "12"], 300, ["trace"]),
        ("http_offline", ["http", "--offline", "--quick", "--requests",
                          "12"], 300, ["offline"]),
    ),
)
_ENVELOPE = ("cuda", "device", "git", "seed", "torch")
_CONFIG = ("baseline_basis", "config", "metric", "unit", "value")
_ENDPOINT = ("baseline_basis", "endpoint", "note", "phase_breakdown",
             "quality_summary", "unit", "value", "concurrency", "requests")
# each record kind's keys: the reference's, less the written renames of
# tests/test_torch_bench.py (which holds these lists to the reference)
BENCH_KEYS = {
    "headline": ("backend", "baseline", "baseline_basis", "device_only_ms",
                 "device_only_ms_runs", "dispatch_evidence",
                 "effective_tflops", "graphs", "latency_requests", "metric",
                 "mfu_h100_bf16", "model", "n_candidates", "numerics",
                 "p50_ms", "p99_ms", "quantize", "quantize_accuracy",
                 "requests", "roofline", "seq",
                 "serving_bucketed_answers_per_sec", "serving_bucketed_seq",
                 "tflop_per_answer", "unit", "value", "vs_baseline"),
    "config1": _CONFIG + ("graphs", "launches", "p50_ms", "requests"),
    "config2": _CONFIG + ("breakdown", "device_fraction", "graphs", "p50_ms",
                          "phase_ms", "requests", "serial_answers_per_sec"),
    "config3": _CONFIG + ("graphs", "numerics", "p50_ms", "requests"),
    "config4": _CONFIG + ("batch_seconds", "batches_sampled"),
    "config5": _CONFIG + ("concurrency", "graphs", "requests",
                          "stream_seconds_per_request"),
    "config6": _CONFIG + ("held_out_prompts", "learn_rows_per_sec",
                          "learned_accuracy", "rows_learned", "scenario",
                          "static_accuracy"),
    "config7": _CONFIG + ("graphs", "int8_dispatch", "launches", "p50_ms",
                          "quantize", "requests"),
    "fwd": ("attn=kernel", "attn=plain", "b", "backend", "dtype",
            "gelu+ln=identity", "gelu=identity", "gelu=tanh",
            "gelu_ln_share", "ln=identity", "metric", "model", "runs", "seq",
            "timer"),
    "attn": ("backend", "dtype", "hd", "metric", "nh", "results", "timer"),
    "/consensus": _ENDPOINT + ("direct_call_answers_per_sec", "graphs",
                               "launches", "n_candidates", "p50_ms",
                               "p99_ms", "quantize", "served_vs_direct"),
    "/score/completions": _ENDPOINT + ("p50_ms", "p99_ms"),
    "/multichat/completions": _ENDPOINT + ("generators", "graphs", "p50_ms",
                                           "p99_ms"),
    "trace": _ENDPOINT + ("consensus_round_deltas", "full", "graphs", "off",
                          "p50_inflation_pct_full", "round_deltas", "rounds",
                          "sampled_1pct"),
    "offline": _ENDPOINT + (
        "baseline", "contended", "contended_rescore", "graphs",
        "idle_rescore", "lanes", "n_candidates",
        "offline_dispatches_during_contention", "offline_n",
        "offline_occupancy_idle", "p50_inflation_pct", "p99_inflation_pct",
        "round_p50_deltas", "round_p99_deltas", "rounds"),
    "host": ("baseline_basis", "breakdown", "cuda_initialized", "judges",
             "metric", "n_candidates", "note", "p50_ms", "p99_ms",
             "requests", "seq", "stream_chunks_per_request", "unit",
             "value"),
}
BENCH_KEYS = {kind: tuple(sorted(set(keys) | set(_ENVELOPE)))
              for kind, keys in BENCH_KEYS.items()}
BENCH_LAYERS = 24  # bge-large's layers: attention launches per encoder call


def run_bench(label, argv, limit_s, device) -> dict:
    """One bench in a subprocess -> its exit code, records and seconds."""
    t0 = time.perf_counter()
    cmd = [sys.executable, "-m", "llm_weighted_consensus_tpu_torch.bench",
           *argv, "--device", device]
    try:
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                              timeout=limit_s)
        rc, out, err = proc.returncode, proc.stdout, proc.stderr
    except subprocess.TimeoutExpired as exc:
        rc, out = "timeout", exc.stdout or ""
        err = exc.stderr or ""
        out = out.decode() if isinstance(out, bytes) else out
        err = err.decode() if isinstance(err, bytes) else err
    lines = [line for line in out.splitlines() if line.strip()]
    records, bad = [], []
    for line in lines:
        try:
            records.append(json.loads(line))
        except ValueError:
            bad.append(line[:200])
    return {"label": label, "rc": rc, "records": records, "bad_lines": bad,
            "stderr_tail": err[-1500:], "seconds": time.perf_counter() - t0}


def _finite_positive(value) -> bool:
    import math

    return (isinstance(value, (int, float)) and not isinstance(value, bool)
            and math.isfinite(value) and value > 0)


def check_bench_record(record: dict, kind: str, gpu, on_card: bool) -> None:
    """Keys, finite positive figures and the device line of one record."""
    if kind == "attn_row":
        rows = [v for k, v in record.items() if k != "bench"]
        if set(record) - {"bench"} == set() or len(rows) != 1:
            raise AssertionError(f"attn row {record}")
        figures = [rows[0][k] for k in ("kernel_ms", "plain_ms", "sdpa_ms")]
    else:
        keys = tuple(sorted(record))
        if keys != BENCH_KEYS[kind]:
            raise AssertionError(
                f"{kind}: keys {sorted(set(keys) ^ set(BENCH_KEYS[kind]))} "
                "differ from BENCH_KEYS")
        if on_card and record["device"] != gpu:
            raise AssertionError(f"{kind}: device {record['device']!r}")
        figures = []
        if kind == "fwd":
            figures = [record[k] for k in BENCH_KEYS["fwd"] if "=" in k]
        elif kind == "attn":
            figures = [row[k] for row in record["results"].values()
                       for k in ("kernel_ms", "plain_ms", "sdpa_ms")]
        elif kind not in ("trace", "offline", "config6"):
            figures = [record["value"]]
        if "p50_ms" in record:
            figures.append(record["p50_ms"])
        if kind == "headline" and on_card:
            figures += [record["device_only_ms"], record["mfu_h100_bf16"]]
        if kind == "trace":
            figures += [record[s]["p50_ms"] for s in
                        ("off", "sampled_1pct", "full")]
        if kind == "offline":
            figures += [record["baseline"]["p50_ms"],
                        record["contended"]["p50_ms"]]
    for value in figures:
        if not _finite_positive(value):
            raise AssertionError(f"{kind}: a figure is {value!r}")


def check_headline_launches(record: dict, on_card: bool) -> dict:
    """The launch counters' rise over the headline's timed windows against
    its consensus dispatches."""
    ev = record["dispatch_evidence"]
    k = ev["dispatches"]
    got = {name: row["launches"] for name, row in ev["launches"].items()}
    if not on_card:
        return got
    want = {"attention": BENCH_LAYERS * k, "cosine_vote": k}
    if record["quantize"] == "int8":
        want["w8a8_matmul"] = 6 * BENCH_LAYERS * k
    for name, n in want.items():
        routes = ev["launches"][name]["routes"]
        route = "cluster" if name == "cosine_vote" else "tma"
        if got[name] != n or routes.get(route, 0) != n:
            raise AssertionError(
                f"headline {record['quantize']}: {name} launched {got[name]} "
                f"times {routes}, want {n} on {route}")
    if ev["replays"] != k or ev["eager_dispatches"] or ev["captures"]:
        raise AssertionError(f"headline dispatches not all replays: {ev}")
    return got


def bench_launches(records: list) -> dict:
    """The launches the bench records report (the headline windows,
    configs 1 and 7, the served /consensus)."""
    total: dict = {}
    for record in records:
        rows = (record.get("dispatch_evidence", {}).get("launches")
                or record.get("launches") or {})
        for name, row in rows.items():
            total[name] = total.get(name, 0) + row["launches"]
    return total


def bench_path(gpu, device: str = "cuda", lanes=BENCH_LANES) -> dict:
    """Phase 17: every bench in a subprocess, two lanes at once; one row
    per run (exit code, records, seconds) and the launches the records
    report.  ``device="cpu"`` (with small ``lanes``) rehearses the
    control flow."""
    import threading

    on_card = device == "cuda"
    t0 = time.perf_counter()
    results = [[] for _ in lanes]

    def lane(i):
        for label, argv, limit_s, _ in lanes[i]:
            results[i].append(run_bench(label, argv, limit_s, device))

    threads = [threading.Thread(target=lane, args=(i,))
               for i in range(len(lanes))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    rows, failures, records_all = [], [], []
    for runs, spec in zip(results, lanes):
        for run, (label, argv, _, kinds) in zip(runs, spec):
            row = {"label": label, "argv": argv, "rc": run["rc"],
                   "seconds": run["seconds"],
                   "records": len(run["records"])}
            try:
                if run["rc"] != 0 or run["bad_lines"]:
                    raise AssertionError(
                        f"rc {run['rc']}, unparsed {run['bad_lines']}: "
                        f"{run['stderr_tail']}")
                if len(run["records"]) != len(kinds):
                    raise AssertionError(
                        f"{len(run['records'])} records, want {len(kinds)}: "
                        f"{[r.get('error') for r in run['records']]}")
                for record, kind in zip(run["records"], kinds):
                    check_bench_record(record, kind, gpu, on_card)
                    if kind == "headline":
                        row["launches"] = check_headline_launches(
                            record, on_card)
                        row["answers_per_sec"] = record["value"]
                        row["p50_ms"] = record["p50_ms"]
                        row["device_only_ms"] = record["device_only_ms"]
                        row["mfu_h100_bf16"] = record["mfu_h100_bf16"]
                        row["roofline"] = record["roofline"]
                    elif kind.startswith("config") or kind in (
                            "/consensus", "host"):
                        row.setdefault("values", {})[kind] = record["value"]
                records_all += run["records"]
            except AssertionError as exc:
                failures.append(f"{label}: {exc}")
            rows.append(row)
    out = {"phase": "bench_path", "rows": rows,
           "launches": bench_launches(records_all),
           "seconds": time.perf_counter() - t0}
    emit(out)
    if failures:
        raise AssertionError("bench path: " + " | ".join(failures))
    return out


# phase 18 (the analysis path): the served main path's traffic under
# LOCK_WITNESS=1 and with the knob unset, from one warmed bge-large
ANALYSIS_BURSTS, ANALYSIS_SCORES, ANALYSIS_OFFLINE_GROUPS = 3, 4, 16
ANALYSIS_OFFLINE_N, ANALYSIS_PACKED_BURST = 8, 8
ANALYSIS_CLI_LIMIT_S = 300
ANALYSIS_SLOT_S = 0.03
# the packed burst: requests 10 ms apart inside a 400 ms window
ANALYSIS_PACKED_GAP_S, ANALYSIS_PACKED_WINDOW_MS = 0.01, 400


class AnalysisUpstream:
    """The judges and the generators on one loopback base: a request
    whose last message carries a ballot is answered as ``ScriptedJudges``
    answers it (``judge_frames``, at once), any other streams
    ``stream_candidate`` of its seed as ``ScriptedGenerators`` does, in
    one frame, ``ANALYSIS_SLOT_S`` x slot after it arrives.  Every answer
    is a function of its request."""

    def __init__(self) -> None:
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def do_POST(self):
                body = json.loads(self.rfile.read(
                    int(self.headers["content-length"])))
                last = str(body.get("messages", [{}])[-1].get("content", ""))
                if "Select the response:" in last:
                    frame = judge_frames(body)
                else:
                    request, slot = divmod(int(body.get("seed") or 0), 1000)
                    # slots finish in slot order, so a stream's buffer
                    # fills in the same order every run
                    time.sleep(ANALYSIS_SLOT_S * slot)
                    chunk = {
                        "id": f"gen-{body.get('seed')}", "created": 1,
                        "object": "chat.completion.chunk",
                        "model": body.get("model"),
                        "choices": [{"index": 0, "finish_reason": "stop",
                                     "delta": {"content": stream_candidate(
                                         request, slot)}}],
                    }
                    frame = (f"data: {json.dumps(chunk)}\n\n"
                             "data: [DONE]\n\n").encode()
                self.send_response(200)
                self.send_header("content-type", "text/event-stream")
                self.send_header("content-length", str(len(frame)))
                self.end_headers()
                self.wfile.write(frame)

        class Server(ThreadingHTTPServer):
            daemon_threads = True
            request_queue_size = 1024

        self.httpd = Server(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}/v1"

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(10)


def analysis_cli(device: str) -> dict:
    """(a) ``python -m llm_weighted_consensus_tpu_torch.analysis --json``
    in a subprocess over the port's package, the dispatch audit's CPU
    half included: exit 0, no finding, seconds by part."""
    import subprocess

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "llm_weighted_consensus_tpu_torch.analysis",
         "--json"], cwd=os.path.dirname(os.path.abspath(__file__)),
        capture_output=True, text=True, timeout=ANALYSIS_CLI_LIMIT_S)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"analysis CLI exit {proc.returncode}: "
                             f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    if out["findings"] or out["stale_baseline"] or not out["audit_run"]:
        raise AssertionError(f"analysis CLI: {out}")
    return {"rc": proc.returncode, "wall_s": wall,
            "lint_s": out["lint_seconds"],
            "concurrency_s": out["concurrency_seconds"],
            "audit_s": out["audit_seconds"],
            "baselined": len(out["suppressed"]), "mesh": out["mesh"]["reason"]}


def analysis_traffic(srv, bursts, scores, model_name, packed=None) -> dict:
    """The phase's traffic on ``srv``: the bursts of /consensus (their
    p50), one /embeddings request, the score requests, one multichat
    stream, a ``PUT /v1/weights`` swap, and the offline drive beside one
    more burst; with ``packed`` (a packed server) one packed burst there.
    -> every answer, in order."""
    import random
    import threading

    import numpy as np

    out = {}
    # one unmeasured burst first: the staging pool's pinned buffers are
    # allocated by the first server's traffic on the shared embedder
    drive_bursts(srv.port, bursts[:1])
    run = drive_bursts(srv.port, bursts[:-1])
    out["bursts"] = run["answers"]
    out["p50_ms"] = run["p50_ms"]
    status, _, emb = http(srv.port, "/embeddings",
                          {"model": model_name, "input": bursts[0][0][:4]})
    if status != 200:
        raise AssertionError(f"/embeddings: {status} {emb}")
    out["embeddings"] = np.asarray([r["embedding"] for r in emb["data"]])
    # the judges' ballots from a seeded generator: the scripted judges
    # vote by a hash of the ballot, so the answers repeat run to run
    srv.score_client.rng_factory = lambda: random.Random(18)
    score = drive_score(srv.port, scores, len(scores))
    out["score"] = [score_answer(o["final"]) for o in score["outs"]]
    status, events, _ = sse_post(srv.port, "/multichat/completions", {
        "messages": [{"role": "user", "content": "question 7"}],
        "model": stream_panel(), "seed": 7000, "stream": True,
        "consensus": True})
    stream = read_stream(events)
    if status != 200 or not stream["done"] or not stream["frames"]:
        raise AssertionError(f"multichat stream: {status} {events[-2:]}")
    out["stream"] = stream["frames"]
    status, _, put = http(srv.port, "/v1/weights",
                          {"weights": {"backend-0": 2.0}}, method="PUT")
    if status != 200:
        raise AssertionError(f"PUT /v1/weights: {status} {put}")
    out["swap"] = put.get("version")
    box = {}

    def drive():
        box["out"] = http(srv.port, "/v1/train/rescore", {
            "groups": ANALYSIS_OFFLINE_GROUPS, "n": ANALYSIS_OFFLINE_N,
            "seed": 0, "inflight": 4})

    thread = threading.Thread(target=drive)
    thread.start()
    beside = drive_bursts(srv.port, bursts[-1:])
    thread.join(600)
    status, _, offline = box["out"]
    if status != 200 or offline["errors"]:
        raise AssertionError(f"offline drive: {status} {offline}")
    out["bursts"] += beside["answers"]
    out["offline"] = (offline["groups"], offline["items"])
    if packed is not None:
        out["packed"] = packed_answers(packed.port, packed_burst())
    return out


def packed_answers(port, burst) -> list:
    """The packed burst's requests, started ``ANALYSIS_PACKED_GAP_S``
    apart inside the packed server's window: they join one group in a
    fixed order, so the packed layout (and with it each answer's bits)
    is the same run to run."""
    import threading

    import numpy as np

    results = {}

    def call(i, texts):
        status, _, out = http(port, "/consensus", {"input": texts})
        if status != 200:
            raise AssertionError(f"packed /consensus {i}: {status} {out}")
        results[i] = out

    threads = []
    for i, texts in enumerate(burst):
        threads.append(threading.Thread(target=call, args=(i, texts)))
        threads[-1].start()
        time.sleep(ANALYSIS_PACKED_GAP_S)
    for t in threads:
        t.join(600)
    answers = []
    for i, texts in enumerate(burst):
        check_answer(results[i]["confidence"], len(texts))
        answers.append(np.asarray(results[i]["confidence"]))
    return answers


def score_answer(final: dict) -> tuple:
    """A score stream's answer: the candidates' confidences by index, and
    the judges' entries with the indices their arrival order gave them
    taken out, sorted."""
    cands = sorted((c["index"], c["confidence"]) for c in final["choices"]
                   if c["index"] < SCORE_N)
    judges = sorted(
        json.dumps({k: v for k, v in c.items()
                    if k not in ("index", "model_index")}, sort_keys=True)
        for c in final["choices"] if c["index"] >= SCORE_N)
    return cands, judges


def packed_burst() -> list:
    """The packed burst: the first ``ANALYSIS_PACKED_BURST`` requests of
    the mixed-length traffic's first burst."""
    return mixed_traffic()[0][0][:ANALYSIS_PACKED_BURST]


def same_answers(a, b, path="") -> None:
    """Bit-equal answers (numpy arrays compared element for element)."""
    import numpy as np

    if isinstance(a, dict):
        if set(a) != set(b):
            raise AssertionError(f"{path}: keys {sorted(a)} != {sorted(b)}")
        for k in a:
            same_answers(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        if len(a) != len(b):
            raise AssertionError(f"{path}: {len(a)} != {len(b)} items")
        for i, (x, y) in enumerate(zip(a, b)):
            same_answers(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        if a.shape != b.shape or not np.array_equal(a, b):
            raise AssertionError(f"{path}: answers differ")
    elif a != b:
        raise AssertionError(f"{path}: {a!r} != {b!r}")


def analysis_served(gpu, emb, packed_emb, on_card) -> dict:
    """(b) the served main path with the knob unset, then under
    ``LOCK_WITNESS=1``, from the same warmed embedder: a padded server
    (``BATCH_MAX=1``: each request its own R=1 dispatch, so an answer's
    bucket does not depend on what shares the card with it) and a packed
    one.  The witness stays clean, wraps nothing it does not see
    acquired, and the answers are bit-equal."""
    from llm_weighted_consensus_tpu_torch.serve.__main__ import (
        build_server,
        warm_up,
    )
    from llm_weighted_consensus_tpu_torch.serve.config import ServeConfig

    import numpy as np

    rng = np.random.default_rng(18)
    bursts = [[candidate_texts(rng, N_CANDIDATES, BURST_WORDS)
               for _ in range(BURST)] for _ in range(ANALYSIS_BURSTS + 1)]
    s = emb.tokenize(bursts[0][0], 512)[0].shape[1]
    scores = [score_body(k, "training_table") for k in range(ANALYSIS_SCORES)]
    upstream = AnalysisUpstream()
    runs, launches = {}, {}
    try:
        for mode in ("off", "on"):
            knob = {"LOCK_WITNESS": "1"} if mode == "on" else {}
            env = serving_env(
                EMBEDDER_MODEL=emb.model_name, BATCH_MAX="1",
                WARMUP=f"{N_CANDIDATES}x{s}", MESH_ENABLED="1",
                MESH_FAULT_ENABLED="1", DEVICE_WATCHDOG_MILLIS="30000",
                WEIGHTS_ENABLED="1", OFFLINE_ENABLED="1",
                TRACE_SAMPLE_RATE="1", LEDGER_RING="256",
                SCORE_CACHE_TTL="600", OPENAI_API_BASE=upstream.url,
                OPENAI_API_KEY="smoke-key", **knob)
            penv = serving_env(
                EMBEDDER_MODEL=emb.model_name, PACKING_ENABLED="1",
                BATCH_MAX="64",
                BATCH_WINDOW_MS=str(ANALYSIS_PACKED_WINDOW_MS), **knob)
            config = ServeConfig.from_env(env)
            srv = build_server(emb, None, config).start()
            psrv = build_server(packed_emb, None,
                                ServeConfig.from_env(penv)).start()
            try:
                warm_up(srv, config)
                psrv.warmup([], [], [(b, l, PACKING["packing_max_segments"])
                                     for b, l in PACKED_SHAPES[:8]])
                reset_launches()
                run = analysis_traffic(srv, bursts, scores, emb.model_name,
                                       packed=psrv)
                launches[mode] = read_launches()
                if on_card:
                    read_routes()
                witnesses = [w for w in (srv.lock_witness,
                                         psrv.lock_witness) if w is not None]
                run["witness"] = [
                    dict(w.snapshot(), locks=w.counts(), wrapped=w.wrapped())
                    for w in witnesses]
                runs[mode] = run
            finally:
                psrv.close()
                srv.close()
    finally:
        upstream.close()
    off, on = runs["off"], runs["on"]
    if off["witness"] or len(on["witness"]) != 2:
        raise AssertionError("the knob wrapped (or failed to wrap) a server")
    for snap in on["witness"]:
        never = sorted(set(snap["wrapped"]) - set(snap["locks"]))
        if on_card is False:
            # the plain versions on the CPU count no launch
            never = [k for k in never if k != "launches._lock"]
        if snap["violations"] or snap["undeclared"] or never:
            raise AssertionError(
                f"lock witness: {snap['violations']} violations, undeclared "
                f"{snap['undeclared']}, never acquired {never}")
    answers = {k: v for k, v in on.items() if k not in ("witness", "p50_ms")}
    same_answers(answers, {k: off[k] for k in answers}, "answers")
    row = {"phase": "analysis_path", "part": "served", "gpu": gpu,
           "nvidia_smi": gpu, "bursts_p50_ms": {"off": off["p50_ms"],
                                                "on": on["p50_ms"]},
           "witness_cost": on["p50_ms"] / off["p50_ms"] - 1.0,
           "witness": [{k: snap[k] for k in ("acquisitions", "locks",
                                              "undeclared", "violations")}
                       | {"edges": len(snap["edges"])}
                       for snap in on["witness"]],
           "launches": launches}
    print(f"phase 18 bursts p50: {off['p50_ms']:.3f} ms without the "
          f"witness, {on['p50_ms']:.3f} ms with it ({gpu})", flush=True)
    return row


def analysis_card(gpu, emb, model_name, device, on_card) -> dict:
    """(c) the dispatch audit's card half over the padded server's warmed
    buckets (the consensus and the embed forward at N=64) and one R=1,
    N=64 dispatch of an ``int8`` embedder: no sync inside any enqueue, no
    capture and no eager dispatch after warmup, every launch on its
    route (24 attention launches per encoder call, 144 W8A8)."""
    from llm_weighted_consensus_tpu_torch.analysis import dispatch_audit as da
    from llm_weighted_consensus_tpu_torch.models.embedder import TorchEmbedder

    import numpy as np

    layers = emb.config.num_layers
    rng = np.random.default_rng(18)
    s = emb.tokenize(candidate_texts(rng, N_CANDIDATES, BURST_WORDS),
                     512)[0].shape[1]
    specs = [(N_CANDIDATES, s)]
    keys = da.expected_keys(emb, specs, (), ())
    calls = [(label, thunk) for label, _, thunk in
             da.served_calls(emb, specs, (), ())]
    int8 = TorchEmbedder(model_name, device=device, seed=0, quantize="int8",
                         max_tokens=emb.max_tokens)
    int8.warmup(specs)
    q_keys = da.expected_keys(int8, specs, (), ())[:1]
    q_calls = [(label + "@int8", thunk) for label, symbol, thunk in
               da.served_calls(int8, specs, (), ())
               if symbol == "consensus_confidence_tokens"]
    if not on_card:
        return {"phase": "analysis_path", "part": "card",
                "keys": [str(k) for k in keys + q_keys]}
    full = da.card_audit(emb, keys, calls, {
        "attention": {"tma": 2 * layers}, "cosine_vote": {"cluster": 1},
        "w8a8_matmul": {}, "segment_attention": {}}, device=device)
    quant = da.card_audit(int8, q_keys, q_calls, {
        "attention": {"tma": layers}, "cosine_vote": {"cluster": 1},
        "w8a8_matmul": {"tma": 6 * layers}, "segment_attention": {}},
        device=device)
    row = {"phase": "analysis_path", "part": "card", "gpu": gpu,
           "nvidia_smi": gpu, "full": full, "int8": quant}
    bad = full["findings"] + quant["findings"]
    if bad:
        raise AssertionError("dispatch audit, card half: " + " | ".join(bad))
    row["launches"] = {
        name: full["launches"][name].get(route, 0)
        + quant["launches"][name].get(route, 0)
        for name, route in (("attention", "tma"), ("cosine_vote", "cluster"),
                            ("w8a8_matmul", "tma"))}
    return row


def analysis_path(gpu: str, device: str = "cuda",
                  model_name: str = "bge-large-en") -> dict:
    """Phase 18: static analysis and the lock model.  (a) the analysis
    CLI in a subprocess, (b) the served main path at full bge-large width
    (random weights from seed 0, bf16) under ``LOCK_WITNESS=1`` against
    the knob unset (``analysis_served``), (c) the dispatch audit's card
    half (``analysis_card``).  Any failure fails the script.
    (``device="cpu"`` with test-tiny rehearses the control flow.)"""
    from llm_weighted_consensus_tpu_torch.models.embedder import TorchEmbedder
    from llm_weighted_consensus_tpu_torch.serve.__main__ import build_embedder

    on_card = device == "cuda"
    t0 = time.perf_counter()
    cli = analysis_cli(device)
    emb = build_embedder(serving_env(EMBEDDER_MODEL=model_name),
                         device=device)
    packed_emb = TorchEmbedder(emb.model_name, model=emb.model,
                               config=emb.config, tokenizer=emb.tokenizer,
                               max_tokens=emb.max_tokens, device=emb.device,
                               dtype=emb.dtype)
    served = analysis_served(gpu, emb, packed_emb, on_card)
    card = analysis_card(gpu, emb, model_name, device, on_card)
    launches = dict(served["launches"]["on"])
    for name, n in card.get("launches", {}).items():
        launches[name] = launches.get(name, 0) + n
    out = {"phase": "analysis_path", "gpu": gpu, "nvidia_smi": gpu,
           "cli": cli, "bursts_p50_ms": served["bursts_p50_ms"],
           "witness_cost": served["witness_cost"],
           "witness": served["witness"], "card": card, "launches": launches,
           "seconds": time.perf_counter() - t0}
    emit(out)
    return out


def kernel_summary(vote, attn_rows, quant, launches, q8, q4, seg,
                   packed, rm, serving, counts, multichat, score,
                   archived, traced, resilient, learning, fault,
                   bench, analysis) -> dict:
    """The kernels line: every kernel of the paths, with its launches
    from the run of the path that takes it (the main path, the int8
    path, the int4 path, the packed path; the row quantisation runs on
    both quantized paths and counts both) and its numbers at the main
    path's shape (bf16; for the quantized matmuls the MLP expansion,
    K=1024, N=4096 with GELU; for the segment attention the packed
    bucket, 8 rows of 512 tokens).  The reward-model path adds its own
    entries (``"path": "rm"``) for the quantized matmuls and the row
    quantisation, with the launches of its int8 and int4 bursts and the
    numbers at its MLP expansion (M=2048, K=768, N=3072 with GELU).  The
    multichat path adds the vote with a count per request
    (``"path": "multichat"``, at [8, 32, 1024] f32 with this run's mixed
    counts) and the attention at its dispatch shape [16, 128] (bf16),
    with that path's launches.  The score path adds the attention at its
    prompt embed's dispatch shape [16, 112] (bf16, ``"path": "score"``)
    with that path's launches, which the main attention entry also
    carries as ``score_path_launches``; the archive path likewise adds
    the attention at its learn pass's dispatch shape [32, 112]
    (``"path": "archive"``, ``archive_path_launches``).  Phase 13's
    traced runs add ``traced_path_launches`` to the main vote and
    attention entries (the rate-1 main run) and to the segment
    attention's (the traced packed burst); phase 14 adds
    ``resilient_path_launches`` to the main vote and attention entries
    (its prompt embeds and the memory drill's ``/consensus`` calls), and
    phase 15 ``learning_path_launches`` (the offline drives, the bursts
    beside them and the learner drill's prompt embeds), and phase 16
    ``fault_path_launches`` (its traffic on the card, the twin's
    dispatches launching nothing); phase 17 adds ``bench_path_launches``
    to every kernel its bench records report (the headline windows,
    configs 1 and 7, the served ``/consensus``), and phase 18
    ``analysis_path_launches`` to every kernel its witnessed runs and
    its dispatch audit launched.
    Each entry also gives ``graphed_launches``: its launches in phase 9's
    graphed run of the path that takes it, every one of them replayed
    from a CUDA graph or eager at a bucket not warmed (the vote and the
    padded attention on the main path, the segment attention on the
    packed path, W8A8 and the row quantisation on the int8 path, W4A8 on
    the int4 path; the RM entries on ``rm_int8``)."""
    main = next(
        r for r in attn_rows
        if r.get("shape", [])[:2] == [BURST * N_CANDIDATES, 128]
        and r["dtype"] == "bfloat16"
    )

    def quant_row(name, shape=(QUANT_M, 1024, 4096)):
        return next(
            r for r in quant["rows"]
            if r["kernel"] == name and r["shape"] == list(shape)
        )

    q8_row, q4_row = quant_row("w8a8_matmul"), quant_row("w4a8_matmul")
    csrc = "llm_weighted_consensus_tpu_torch/csrc/"
    entries = [
        {
            "name": "cosine_vote", "route": "cuda",
            "source": csrc + "cosine_vote_sm90.cu",
            "replaces": "llm_weighted_consensus_tpu/ops/kernels.py:94",
            "launches": launches["cosine_vote"],
            "max_abs_err": vote["max_abs_err"], "ms": vote["kernel_ms"],
            "plain_ms": vote["plain_ms"], "bound_ms": vote["bound_ms"],
            "bound_by": vote["bound_by"], "library_ms": None,
            "kernel_route": "cluster", "device_ms": vote["device_ms"],
            "launch_floor_ms": vote["launch_floor_ms"],
            "previous_ms": vote["previous_ms"],
            "previous_device_ms": vote["previous_device_ms"],
            "previous_source": csrc + "cosine_vote.cu",
            "shape": vote["shape"],
        },
        {
            "name": "attention", "route": "cuda",
            "source": csrc + "attention_sm90.cu",
            "replaces": "llm_weighted_consensus_tpu/ops/attention.py:134",
            "launches": launches["attention"],
            "max_abs_err": max(r["max_abs_err"] for r in attn_rows),
            "ms": main["kernel_ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "kernel_route": "tma",
            "device_ms": main["device_ms"],
            "previous_ms": main["previous_ms"],
            "previous_device_ms": main["previous_device_ms"],
            "previous_source": csrc + "attention.cu",
            "shape": main["shape"],
        },
    ]
    for name, row, path, line in (
        ("w8a8_matmul", q8_row, q8, 202), ("w4a8_matmul", q4_row, q4, 319),
    ):
        # ms keeps the row quantisation; gemm_ms is the GEMM alone, beside
        # the GEMM's own bound
        entry = {
            "name": name, "route": "cuda",
            "source": csrc + "quant_gemm_sm90.cu",
            "replaces": f"llm_weighted_consensus_tpu/ops/kernels.py:{line}",
            "launches": path["launches"][name],
            "max_abs_err": quant["worst"][name], "ms": row["kernel_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None,
            "shape": row["shape"], "kernel_route": "tma",
            "gemm_ms": row["gemm_ms"], "gemm_bound_ms": row["gemm_bound_ms"],
            "previous_ms": row["previous_ms"],
            "previous_gemm_ms": row["previous_gemm_ms"],
            "previous_source": csrc + "quant_matmul.cu",
        }
        if name == "w4a8_matmul":
            entry["w8a8_gemm_ms"] = row["w8a8_gemm_ms"]
        entries.append(entry)
    # the row quantisation: the in-kernel prologue of both TPU kernels
    entries.append({
        "name": "quantize_rows", "route": "cuda",
        "source": csrc + "quant_matmul.cu",
        "replaces": "llm_weighted_consensus_tpu/ops/kernels.py:202",
        "launches": q8["launches"]["quantize_rows"]
        + q4["launches"]["quantize_rows"],
        "max_abs_err": 0.0, "ms": q8_row["quantize_rows_ms"],
        "plain_ms": q8_row["quantize_rows_plain_ms"],
        "bound_ms": q8_row["quantize_rows_bound_ms"],
        "bound_by": q8_row["quantize_rows_bound_by"], "library_ms": None,
        "shape": [QUANT_M, 1024],
    })
    rm_shape = (RM_QUANT_M[0], 768, 3072)
    for name, path, line in (("w8a8_matmul", rm["int8"], 202),
                             ("w4a8_matmul", rm["int4"], 319)):
        row = quant_row(name, rm_shape)
        entries.append({
            "name": name, "path": "rm", "route": "cuda",
            "source": csrc + "quant_gemm_sm90.cu",
            "replaces": f"llm_weighted_consensus_tpu/ops/kernels.py:{line}",
            "launches": path["launches"][name],
            "max_abs_err": quant["worst"][name], "ms": row["kernel_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None,
            "shape": row["shape"], "kernel_route": "tma",
            "gemm_ms": row["gemm_ms"], "gemm_bound_ms": row["gemm_bound_ms"],
            "bf16_linear_ms": row["bf16_linear_ms"],
            "int_mm_ms": row["int_mm_ms"],
        })
    rm_q = quant_row("w8a8_matmul", rm_shape)
    entries.append({
        "name": "quantize_rows", "path": "rm", "route": "cuda",
        "source": csrc + "quant_matmul.cu",
        "replaces": "llm_weighted_consensus_tpu/ops/kernels.py:202",
        "launches": rm["int8"]["launches"]["quantize_rows"]
        + rm["int4"]["launches"]["quantize_rows"],
        "max_abs_err": 0.0, "ms": rm_q["quantize_rows_ms"],
        "plain_ms": rm_q["quantize_rows_plain_ms"],
        "bound_ms": rm_q["quantize_rows_bound_ms"],
        "bound_by": rm_q["quantize_rows_bound_by"], "library_ms": None,
        "shape": [RM_QUANT_M[0], 768],
    })
    bucket = seg["rows"][SEG_BUCKET]
    entries.append({
        "name": "segment_attention", "route": "cuda",
        "source": csrc + "attention_sm90.cu",
        "replaces": "llm_weighted_consensus_tpu/ops/attention.py:224",
        "launches": packed["launches"]["segment_attention"],
        "max_abs_err": seg["max_abs_err"], "ms": bucket["kernel_ms"],
        "plain_ms": bucket["plain_ms"], "bound_ms": bucket["bound_ms"],
        "bound_by": bucket["bound_by"], "library_ms": bucket["library_ms"],
        "shape": bucket["shape"], "kernel_route": "tma",
        "device_ms": bucket["device_ms"],
        "previous_ms": bucket["previous_ms"],
        "previous_device_ms": bucket["previous_device_ms"],
        "previous_source": csrc + "attention.cu",
    })
    stream = next(
        r for r in attn_rows
        if r.get("shape", [])[:2] == list(STREAM_ATTENTION_SHAPE)
        and r["dtype"] == "bfloat16"
    )
    entries.append({
        "name": "cosine_vote", "path": "multichat", "route": "cuda",
        "source": csrc + "cosine_vote_sm90.cu",
        "replaces": "llm_weighted_consensus_tpu/ops/kernels.py:94",
        "launches": multichat["launches"]["cosine_vote"],
        "max_abs_err": counts["max_abs_err"], "ms": counts["kernel_ms"],
        "plain_ms": counts["plain_ms"], "bound_ms": counts["bound_ms"],
        "bound_by": counts["bound_by"], "library_ms": None,
        "kernel_route": "cluster", "device_ms": counts["device_ms"],
        "shape": counts["shape"], "counts": counts["counts"],
    })
    entries.append({
        "name": "attention", "path": "multichat", "route": "cuda",
        "source": csrc + "attention_sm90.cu",
        "replaces": "llm_weighted_consensus_tpu/ops/attention.py:134",
        "launches": multichat["launches"]["attention"],
        "max_abs_err": max(r["max_abs_err"] for r in attn_rows),
        "ms": stream["kernel_ms"], "plain_ms": stream["plain_ms"],
        "bound_ms": stream["bound_ms"], "bound_by": stream["bound_by"],
        "library_ms": stream["library_ms"], "kernel_route": "tma",
        "device_ms": stream["device_ms"], "shape": stream["shape"],
    })
    prompt = next(
        r for r in attn_rows
        if r.get("shape", [])[:2] == list(SCORE_ATTENTION_SHAPES[-1])
        and r["dtype"] == "bfloat16"
    )
    entries.append({
        "name": "attention", "path": "score", "route": "cuda",
        "source": csrc + "attention_sm90.cu",
        "replaces": "llm_weighted_consensus_tpu/ops/attention.py:134",
        "launches": score["launches"]["attention"],
        "max_abs_err": max(r["max_abs_err"] for r in attn_rows),
        "ms": prompt["kernel_ms"], "plain_ms": prompt["plain_ms"],
        "bound_ms": prompt["bound_ms"], "bound_by": prompt["bound_by"],
        "library_ms": prompt["library_ms"], "kernel_route": "tma",
        "device_ms": prompt["device_ms"], "shape": prompt["shape"],
    })
    entries[1]["score_path_launches"] = score["launches"]["attention"]
    learn = next(
        r for r in attn_rows
        if r.get("shape", [])[:2] == list(ARCHIVE_ATTENTION_SHAPE)
        and r["dtype"] == "bfloat16"
    )
    entries.append({
        "name": "attention", "path": "archive", "route": "cuda",
        "source": csrc + "attention_sm90.cu",
        "replaces": "llm_weighted_consensus_tpu/ops/attention.py:134",
        "launches": archived["launches"]["attention"],
        "max_abs_err": max(r["max_abs_err"] for r in attn_rows),
        "ms": learn["kernel_ms"], "plain_ms": learn["plain_ms"],
        "bound_ms": learn["bound_ms"], "bound_by": learn["bound_by"],
        "library_ms": learn["library_ms"], "kernel_route": "tma",
        "device_ms": learn["device_ms"], "shape": learn["shape"],
        "eager_launches": archived["learn"]["eager_dispatches"]
        * archived["layers"],
    })
    entries[1]["archive_path_launches"] = archived["launches"]["attention"]
    for entry in entries:
        if entry.get("path") is not None:
            continue
        if entry["name"] in ("cosine_vote", "attention"):
            entry["traced_path_launches"] = traced["main"]["launches"][
                entry["name"]]
            entry["resilient_path_launches"] = resilient["launches"][
                entry["name"]]
            entry["learning_path_launches"] = learning["launches"][
                entry["name"]]
            entry["fault_path_launches"] = fault["launches"][entry["name"]]
        if entry["name"] in bench["launches"]:
            # phase 17's subprocesses, as their records report them
            entry["bench_path_launches"] = bench["launches"][entry["name"]]
        if analysis["launches"].get(entry["name"]):
            entry["analysis_path_launches"] = analysis["launches"][
                entry["name"]]
        if entry["name"] == "segment_attention":
            entry["traced_path_launches"] = traced["packed"]["launches"][
                "segment_attention"]
    graphed = {"cosine_vote": "main", "attention": "main",
               "segment_attention": "packed", "quantize_rows": "int8",
               "w8a8_matmul": "int8", "w4a8_matmul": "int4-pallas"}
    for entry in entries:
        path = graphed[entry["name"]]
        if entry.get("path") == "rm":  # no graphed int4 reward-model run
            path = None if entry["name"] == "w4a8_matmul" else "rm_int8"
        if entry.get("path") in ("multichat", "score", "archive"):
            # served graphed; a learn pass may dispatch eagerly at a bucket
            # no warmup covers
            entry["graphed_path"] = entry["path"]
            entry["graphed_launches"] = (entry["launches"]
                                         - entry.get("eager_launches", 0))
            continue
        entry["graphed_path"] = path
        entry["graphed_launches"] = (
            None if path is None else serving[path]["launches"][entry["name"]]
        )
    return {"kernels": entries}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from llm_weighted_consensus_tpu_torch.ops import _build

    t_start = time.perf_counter()
    gpu = gpu_line()
    kind = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    _build.build(verbose=True)
    _build.library()
    emit({
        "phase": "device", "nvidia_smi": gpu, "device_name": kind,
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "build_s": time.perf_counter() - t0,
    })

    seconds = {"build": time.perf_counter() - t0}

    def timed(name, fn, *args, **kwargs):
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t
        return out

    vote = timed("vote", check_vote, gpu)
    counts = timed("vote", check_vote_counts, gpu)
    attn_rows = timed("attention", check_attention, gpu)["rows"]
    quant = timed("quant", check_quant, gpu)
    seg = timed("segment_attention", check_segment_attention, gpu)
    timed("bge_micro", check_bge_micro, gpu)
    timed("bge_micro", check_bge_micro_packed, gpu)
    timed("bge_micro", check_stream_bge_micro, gpu)
    main_row, full, bursts, embed_texts = timed("main_path", main_path, gpu)
    packed = timed("packed_path", packed_path, gpu, full, seg["checked"])
    timed("profiles", profile_packed, gpu, full, packed["bursts"])
    seg["rows"] = {
        shape: timed("segment_attention", time_segment_attention, gpu, *shape)
        for shape in sorted(set(packed["shapes"]) | {SEG_BUCKET})
    }
    q8 = timed("quant_paths", quant_path, gpu, "int8", full, bursts,
               embed_texts, packed=packed)
    q4 = timed("quant_paths", quant_path, gpu, "int4-pallas", full,
               bursts[:1], embed_texts)
    del full
    torch.cuda.empty_cache()
    timed("profiles", profile_dispatch, gpu)
    timed("profiles", profile_dispatch, gpu, quantize="int8")
    timed("profiles", profile_dispatch, gpu, quantize="int4-pallas")
    rm = rm_phase(gpu, timed)
    serving = serving_phase(gpu, timed)
    multichat = timed("multichat_path", multichat_path, gpu)
    timed("score_path", check_lookup, gpu)
    timed("score_path", check_score_bge_micro, gpu)
    score = timed("score_path", score_path, gpu)
    timed("archive_path", check_device_tally, gpu)
    timed("archive_path", config4_rescore, gpu)
    timed("archive_path", check_archive_bge_micro, gpu)
    archived = timed("archive_path", archive_path, gpu)
    traced = timed("traced_path", traced_path, gpu)
    resilient = timed("resilient_path", resilient_path, gpu)
    learning = timed("learning_path", learning_path, gpu)
    fault = timed("fault_path", fault_path, gpu)
    bench = timed("bench_path", bench_path, gpu)
    analysis = timed("analysis_path", analysis_path, gpu)
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "seconds_by_phase": seconds})
    emit(kernel_summary(vote, attn_rows, quant, main_row["launches"], q8, q4,
                        seg, packed["row"], rm, serving, counts, multichat,
                        score, archived, traced, resilient, learning, fault,
                        bench, analysis))
    print(gpu)
    emit({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind,
                   "count": torch.cuda.device_count()},
    })
    return 0


if __name__ == "__main__":
    sys.exit(main())
