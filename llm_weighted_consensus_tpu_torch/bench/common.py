"""The parts every bench shares: the reference's traffic and yardsticks,
the record envelope, the device rule, the watchdog and the timers.

Own copies of the reference's helpers (``bench.py``): ``BENCH_WORDS``,
``make_requests``, ``flops_per_answer``, ``tokenize_fixed`` and
``BASELINE_BASIS`` (a documented A100 estimate, labelled as one), and of
its bench tokenizers (a WordPiece vocabulary over the bench words, a
unigram SentencePiece vocabulary in the deberta id scheme).

Every record a bench prints carries the envelope: ``device`` (the card's
name and power limit as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` gives them, null without one), ``torch``,
``cuda``, ``git`` (the checkout's commit, null outside a git checkout) and
``seed``.  A bench runs on the card unless the caller passes ``--device
cpu``; without a card it prints one ``{"error": "no-cuda-device", ...}``
record and exits 2, and never carries on on the CPU.  ``run`` puts the
body under a watchdog: a daemon timer that prints one ``bench-hung``
record and leaves with ``os._exit(2)`` (a wedged CUDA launch is not
interruptible), and an exception prints one ``bench-failed`` record to
stdout, the traceback to stderr, and exits 1.

Peaks are the port's roofline module's (``analysis/roofline.py``): the
H100's published dense rates, not copied again here.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time
import traceback
from typing import Callable, Optional

import numpy as np

from ..analysis.roofline import H100_HBM_BYTES_PER_S, H100_PEAKS  # noqa: F401

# the documented candle-CUDA A100 estimate the reference compares with:
# 312 TFLOP/s peak x 40% assumed MFU / 5.06 TFLOP per answer
BASELINE_A100_ANSWERS_PER_SEC = 25.0
BASELINE_BASIS = {
    "a100_peak_tflops": 312.0,
    "assumed_mfu": 0.40,
    "tflop_per_answer": 5.06,
    "answers_per_sec": BASELINE_A100_ANSWERS_PER_SEC,
    "formula": (
        "312 TFLOP/s A100 bf16 peak x 40% assumed MFU / 5.06 TFLOP per "
        "answer ~= 25 answers/sec (documented estimate, not a measurement)"
    ),
}

BENCH_WORDS = [
    "the", "answer", "is", "42", "41", "value", "result", "compute",
    "therefore", "because", "number", "final", "we", "get", "so",
]

# the body watchdog's budget (s); a scenario's own time limit sits inside
WATCHDOG_S = 1800.0

# the ROADMAP items that bring the scenarios one card cannot run
ROADMAP_ITEM = {"mesh": 9, "fleet": 7}

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def flops_per_answer(config, n: int, s: int) -> float:
    """Dense + attention matmul FLOPs for one N-candidate forward."""
    h, i = config.hidden_size, config.intermediate_size
    tokens = n * s
    dense = 2 * (4 * h * h + 2 * h * i)
    attn = 4 * s * h
    return float(config.num_layers * (dense + attn) * tokens)


def make_requests(n_requests: int, n_candidates: int, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    requests = []
    for r in range(n_requests):
        texts = []
        for i in range(n_candidates):
            words = rng.choice(BENCH_WORDS, size=96).tolist() + [
                f"v{r}", f"c{i}"]
            texts.append(" ".join(words))
        requests.append(texts)
    return requests


def tokenize_fixed(embedder, texts: list, seq: int):
    """Tokenize to the exact benchmark shape [N, seq] (no bucket shrink:
    the metric is defined at seq=128)."""
    return embedder.tokenizer.encode_batch(texts, seq)


def bench_tokenizer():
    """A WordPiece tokenizer covering the bench word list (the native
    ASCII fast path when it builds): the deployment-shaped host path."""
    from ..models.tokenizer import WordPieceTokenizer

    alphanum = "abcdefghijklmnopqrstuvwxyz0123456789"
    tokens = (
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]"]
        + BENCH_WORDS
        + list(alphanum)
        + ["##" + c for c in alphanum]
    )
    return WordPieceTokenizer({t: i for i, t in
                               enumerate(dict.fromkeys(tokens))})


def bench_spm_tokenizer(vocab_size: int):
    """A unigram SentencePiece tokenizer (``models/spm.py``) over a
    deterministic vocabulary covering the bench words, deberta id scheme:
    whole-word pieces score above their characters, as a trained unigram
    model's would."""
    from ..models.spm import CONTROL, NORMAL, SPACE, UNKNOWN, UnigramTokenizer

    pieces = [("[PAD]", 0.0, CONTROL), ("[CLS]", 0.0, CONTROL),
              ("[SEP]", 0.0, CONTROL), ("[UNK]", 0.0, UNKNOWN)]
    for word in BENCH_WORDS:
        pieces.append((SPACE + word, -float(len(word)), NORMAL))
    for ch in "abcdefghijklmnopqrstuvwxyz0123456789" + SPACE:
        pieces.append((ch, -10.0, NORMAL))
    if len(pieces) > vocab_size:
        raise ValueError("the vocabulary must cover the bench pieces")
    return UnigramTokenizer(pieces, scheme="deberta")


# -- the record envelope ---------------------------------------------------------


def gpu_line() -> Optional[str]:
    """The card's name and power limit, as ``nvidia-smi`` prints them, or
    None where there is no ``nvidia-smi``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if lines else None


def git_commit() -> Optional[str]:
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"], cwd=REPO,
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    if out.returncode != 0:
        return None
    return out.stdout.strip() or None


def envelope(seed: int = 0) -> dict:
    import torch

    return {"device": gpu_line(), "torch": torch.__version__,
            "cuda": torch.version.cuda, "git": git_commit(), "seed": seed}


def _clean(value):
    """JSON-safe: numpy scalars to Python numbers, NaN/inf to null."""
    if isinstance(value, dict):
        return {str(k): _clean(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_clean(v) for v in value]
    if isinstance(value, np.generic):
        value = value.item()
    if isinstance(value, float) and not math.isfinite(value):
        return None
    return value


def emit(record: dict) -> None:
    print(json.dumps(_clean(record)), flush=True)


# -- device, watchdog, refusals ----------------------------------------------------


def add_device_flag(parser) -> None:
    parser.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="cuda (default; without a card the bench prints one "
        "no-cuda-device record and exits 2) or cpu (the plain versions, "
        "for a rehearsal: no device metric is measured)")


def select_device(name: str, device: str, base: dict) -> str:
    """``device``, or one ``no-cuda-device`` record and exit 2 when the
    card was asked for and there is none."""
    import torch

    if device == "cuda" and not torch.cuda.is_available():
        emit({**base, "bench": name, "error": "no-cuda-device",
              "detail": "torch.cuda.is_available() is False; pass "
              "--device cpu for a CPU rehearsal", **envelope(base.get(
                  "seed", 0))})
        raise SystemExit(2)
    return device


def refuse(name: str, scenario: str, item: int, base: dict,
           why: str) -> None:
    """One record naming the ROADMAP item that brings ``scenario``, then
    exit 2: nothing is skipped silently."""
    emit({**base, "bench": name, "scenario": scenario,
          "error": f"refused: {scenario} {why}; it comes with ROADMAP.md "
          f"queue 1 item {item}", "roadmap_item": item})
    raise SystemExit(2)


def run(name: str, base: dict, body: Callable[[], None],
        budget_s: Optional[float] = None) -> int:
    """Run ``body`` (which emits its records) under the watchdog; one
    ``bench-hung`` or ``bench-failed`` record when it does not end well."""
    budget = WATCHDOG_S if budget_s is None else budget_s

    def expired() -> None:
        emit({**base, "bench": name, "error": "bench-hung",
              "detail": f"the bench body exceeded its {budget:.0f} s "
              "watchdog (a device call wedged?)"})
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(2)

    watchdog = threading.Timer(budget, expired)
    watchdog.daemon = True
    watchdog.start()
    try:
        body()
        return 0
    except SystemExit:
        raise
    except Exception as exc:
        traceback.print_exc(file=sys.stderr)
        emit({**base, "bench": name, "error": "bench-failed",
              "detail": repr(exc)})
        return 1
    finally:
        watchdog.cancel()


# -- statistics and timers -----------------------------------------------------------


def percentiles(lat_ms: list) -> dict:
    lat = sorted(lat_ms)
    return {"p50_ms": round(statistics.median(lat), 3),
            "p99_ms": round(lat[min(len(lat) - 1, int(len(lat) * 0.99))], 3)}


def quantile(lat_ms: list, q: float) -> float:
    lat = sorted(lat_ms)
    return round(lat[min(len(lat) - 1, int(len(lat) * q))], 3)


def emit_reproducible(runs: list) -> dict:
    """One record from back-to-back runs of one config: ``value`` is the
    median run, ``runs`` the raw values, ``max_dev_pct`` the spread."""
    values = [r["value"] for r in runs]
    median = statistics.median(values)
    out = dict(min(runs, key=lambda r: abs(r["value"] - median)))
    mean = statistics.mean(values) or 1e-9
    out["value"] = round(median, 3)
    out["runs"] = values
    out["max_dev_pct"] = round((max(values) - min(values)) / mean * 100, 1)
    emit(out)
    return out


def event_ms(fn: Callable, device: str, reps: int = 10, warmup: int = 2,
             trials: int = 3) -> tuple:
    """Per-call ms of ``fn``: CUDA events recorded around ``reps`` calls
    on the current stream, then synchronised (the median of ``trials``,
    and the sorted trials).  On the CPU the host clock (a rehearsal
    figure, never a device metric)."""
    import torch

    for _ in range(warmup):
        fn()
    samples = []
    for _ in range(trials):
        if device == "cuda":
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end) / reps)
        else:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            samples.append((time.perf_counter() - t0) * 1e3 / reps)
    samples.sort()
    return samples[len(samples) // 2], [round(s, 4) for s in samples]


# -- kernel launch counters ------------------------------------------------------------


def wrappers() -> dict:
    """The kernel wrappers (``ops/launches.py``), by name."""
    from ..ops import attention, kernels

    return {
        "cosine_vote": kernels.cosine_vote, "attention": attention.attention,
        "segment_attention": attention.segment_attention,
        "quantize_rows": kernels.quantize_rows,
        "w8a8_matmul": kernels.w8a8_matmul, "w4a8_matmul": kernels.w4a8_matmul,
    }


def launch_counts() -> dict:
    """{name: {"launches": n, "routes": {route: n}}} now."""
    return {name: {"launches": fn.launches,
                   "routes": dict(getattr(fn, "routes", {}))}
            for name, fn in wrappers().items()}


def launch_delta(before: dict, after: dict) -> dict:
    """The counters' rise from ``before`` to ``after``."""
    out = {}
    for name, now in after.items():
        was = before[name]
        out[name] = {
            "launches": now["launches"] - was["launches"],
            "routes": {route: n - was["routes"].get(route, 0)
                       for route, n in now["routes"].items()
                       if n - was["routes"].get(route, 0)},
        }
    return out
