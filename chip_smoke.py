"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card's name and power limit (nvidia-smi), and the build of
   the hand-written CUDA kernels from ``llm_weighted_consensus_tpu_torch/
   csrc`` (timed);
2. kernels: every kernel against its plain PyTorch version on the card,
   at every shape the main paths give it (``MAIN_PATH_ATTENTION_SHAPES``
   for attention, ``QUANT_MAIN_SHAPES`` at ``QUANT_M`` rows for the W8A8
   and W4A8 matmuls and their row quantisation) and at odd shapes, max
   |diff| beside the stated tolerance, with the kernel's, the plain
   version's and (for attention) ``scaled_dot_product_attention``'s time
   and the least time the card could take (bytes at 3.35 TB/s or
   operations at the type's peak, whichever is larger); the quantized
   matmuls are timed beside bf16 ``F.linear`` and ``torch._int_mm`` on
   pre-quantised operands, yardsticks the port never calls;
3. bge_micro: the committed fixture, loaded by the port's loader, served
   through ``/consensus`` on the card and on the CPU; the confidences
   must agree, unquantized and under ``int8`` / ``int4-pallas``;
4. main path: the port's HTTP server on the card at full bge-large width
   (random weights from a fixed seed, bf16): bursts of 8 concurrent
   ``/consensus`` requests of 64 candidates in the s=128 bucket, one
   request in the s=512 bucket and one ``/embeddings`` request; outputs
   and buckets checked, kernel launch counts checked against the
   dispatches, latency and answers/s reported;
5. quantized paths: the same server with ``quantize="int8"`` (3 bursts
   and ``/embeddings``) and ``"int4-pallas"`` (1 burst and
   ``/embeddings``) on the same weights; launch counts checked (6 quantized
   matmuls per layer per encoder dispatch), answers held against the
   unquantized path's on the same texts (embedding cosine and confidence
   bars of the reference's own quantization tests);
6. profiles: device time by kernel for one coalesced dispatch of the main
   path (torch.profiler), unquantized and under ``int8``, the full tables
   in ``chiprun_out/profile_main_path.txt`` and
   ``chiprun_out/profile_quant_path.txt``; the device's idle share as
   measured, failing if the summed device time exceeds the wall time, and
   failing if a cuBLAS GEMM runs in the int8 dispatch.

Then one JSON line with every kernel's numbers, the nvidia-smi line, and
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

# published H100 SXM peaks (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_INT8_OPS = 1979e12

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
# the device time summed from the profile may exceed the wall time it
# was taken in by this much (timer skew) before the sum counts as wrong
DEVICE_TIME_SLACK = 1.01
ATTN_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
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


def check_vote(gpu: str) -> dict:
    import torch

    from llm_weighted_consensus_tpu_torch.ops import kernels

    # the main path votes [1, 64], [8, 64] and [1, 16] f32 embeddings;
    # N=2 and N=256 are the gateway's limits
    worst, cases = 0.0, 0
    for r in (1, BURST):
        for n in (2, LONG_N, N_CANDIDATES, 256):
            for dtype in (torch.float32, torch.bfloat16):
                for temp in (0.05, 0.7):
                    emb = vote_inputs(r, n, 1024, dtype, seed=r * 1000 + n)
                    got = kernels.cosine_vote(emb, n, temp)
                    want = kernels.cosine_vote_plain(emb, n, temp)
                    torch.cuda.synchronize()
                    err = (got - want).abs().max().item()
                    sums = got.sum(-1)
                    if not torch.isfinite(got).all() or (
                        (sums - 1).abs().max().item() > 1e-5
                    ):
                        raise AssertionError(
                            f"vote r={r} n={n} {dtype} T={temp}: bad output"
                        )
                    if err > VOTE_TOL:
                        raise AssertionError(
                            f"vote r={r} n={n} {dtype} T={temp}: "
                            f"max|diff| {err} > {VOTE_TOL}"
                        )
                    worst = max(worst, err)
                    cases += 1
    # padding rows: n_valid < N gives the same vote as the sliced input
    emb = vote_inputs(8, 64, 1024, torch.float32, seed=7)
    got = kernels.cosine_vote(emb, 50, 0.05)
    want = kernels.cosine_vote(emb[:, :50].contiguous(), 50, 0.05)
    torch.cuda.synchronize()
    pad_err = max(
        (got[:, :50] - want).abs().max().item(),
        got[:, 50:].abs().max().item(),
    )
    if pad_err > VOTE_TOL:
        raise AssertionError(f"vote n_valid padding: max|diff| {pad_err}")
    # timing at the main path's shape: R=8 requests of N=64 f32 embeddings
    r, n, d = BURST, N_CANDIDATES, 1024
    emb = vote_inputs(r, n, d, torch.float32, seed=1)
    ms = time_ms(lambda: kernels.cosine_vote(emb, n, 0.05), iters=200)
    plain = time_ms(lambda: kernels.cosine_vote_plain(emb, n, 0.05), iters=50)
    # reads each input once, writes conf; three passes of 2 r n d FLOPs
    # (norms, column sum, dots) plus the self terms
    bound, by = bound_ms(r * n * d * 4 + r * n * 4, 8.0 * r * n * d, "float32")
    row = {
        "phase": "kernel", "kernel": "cosine_vote", "gpu": gpu,
        "cases": cases, "max_abs_err": worst, "tolerance": VOTE_TOL,
        "pad_err": pad_err, "shape": [r, n, d], "dtype": "float32",
        "kernel_ms": ms, "plain_ms": plain, "bound_ms": bound,
        "bound_by": by, "library_ms": None,
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
    for b, s in MAIN_PATH_ATTENTION_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            q, k, v, bias = attention_inputs(b, s, nh, hd, dtype, seed=b + s)
            got = attn.attention(q, k, v, bias, scale)
            want = attn.attention_plain(q, k, v, bias, scale)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            if not torch.isfinite(got).all() or err > ATTN_TOL[name]:
                raise AssertionError(
                    f"attention b={b} s={s} {name}: max|diff| {err} > "
                    f"{ATTN_TOL[name]}"
                )
            # the all-padding row is the uniform average of v
            uniform = v[-1].float().mean(dim=0)
            u_err = (got[-1].float() - uniform[None]).abs().max().item()
            if u_err > ATTN_TOL[name]:
                raise AssertionError(
                    f"attention all-pad row b={b} s={s} {name}: {u_err}"
                )
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
                "shape": [b, s, nh, hd], "dtype": name,
                "max_abs_err": err, "all_pad_row_err": u_err,
                "tolerance": ATTN_TOL[name], "kernel_ms": ms,
                "plain_ms": plain, "library_ms": lib, "bound_ms": bound,
                "bound_by": by,
            }
            emit(row)
            rows.append(row)
    # both kernel paths at small ragged shapes: bf16 hd 16/32/64 take the
    # tensor-core path, bf16 hd 24 and an unaligned strided view the FMA
    # path, f32 always the FMA path
    worst = {}
    for hd in (16, 24, 32, 64):
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            q, k, v, bias = attention_inputs(5, 77, 4, hd, dtype, seed=hd)
            cases = [(q, k, v)]
            if hd == 64:
                # every row start off 16-byte alignment
                wide = torch.zeros(5, 77, 4, hd + 1, dtype=dtype, device="cuda")
                views = []
                for t in (q, k, v):
                    w = wide.clone()
                    w[..., :hd] = t
                    views.append(w[..., :hd])
                cases.append(tuple(views))
            for qq, kk, vv in cases:
                got = attn.attention(qq, kk, vv, bias, hd ** -0.5)
                want = attn.attention_plain(qq, kk, vv, bias, hd ** -0.5)
                err = (got.float() - want.float()).abs().max().item()
                if not torch.isfinite(got).all() or err > ATTN_TOL[name]:
                    raise AssertionError(
                        f"attention hd={hd} {name}: max|diff| {err}"
                    )
                worst[f"{name}-hd{hd}"] = max(worst.get(f"{name}-hd{hd}", 0), err)
    emit({"phase": "kernel", "kernel": "attention", "gpu": gpu,
          "paths": "hd 16/24/32/64, bf16/f32, aligned and strided",
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


def time_quant(gpu, name, x, w, wq, sw, bias, kp, gelu) -> dict:
    """One quantized matmul at a main-path shape, bf16: the kernel (row
    quantisation included), the row quantisation alone, the plain
    versions, the yardsticks and the bounds."""
    import torch
    import torch.nn.functional as F

    from llm_weighted_consensus_tpu_torch.ops import kernels

    fn, plain = getattr(kernels, name), getattr(kernels, name + "_plain")
    m, k = x.shape
    n = w.shape[0]
    wb, bb = w.to(torch.bfloat16), bias.to(torch.bfloat16)
    xq, _ = kernels.quantize_rows(x, kp)
    w8t = (kernels.unpack_int4_weights(wq, k) if wq.dtype == torch.uint8
           else wq).t()
    bound, by = bound_ms_ops(
        2 * m * k + wq.numel() + 8 * n + 2 * m * n, 2.0 * m * n * k
    )
    q_bound, q_by = bound_ms(2 * m * k + m * kp + 4 * m, 2.0 * m * k, "float32")
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
        "int_mm_ms": time_ms(lambda: torch._int_mm(xq[:, :k], w8t)),
    }
    emit(row)
    return row


def check_quant(gpu: str) -> dict:
    """W8A8 and W4A8 against their plain versions (and the row
    quantisation byte for byte) at the main path's shapes and odd ones,
    bf16 and f32, GELU on and off; times at the main shapes in bf16."""
    import torch

    from llm_weighted_consensus_tpu_torch.ops import kernels

    worst = {"w8a8_matmul": 0.0, "w4a8_matmul": 0.0}
    rows, cases = [], 0
    # (M, K, N, the main path's GELU flag, or None at an odd shape)
    shapes = [(QUANT_M, k, n, gelu) for k, n, gelu in QUANT_MAIN_SHAPES]
    shapes += [(m, k, n, None) for m, k, n in QUANT_ODD_SHAPES]
    for (m, k, n, main_gelu), int4, dtype in itertools.product(
        shapes, (False, True), (torch.bfloat16, torch.float32)
    ):
        name = "w4a8_matmul" if int4 else "w8a8_matmul"
        dname = str(dtype).split(".")[-1]
        x, w, wq, sw, bias = quant_operands(m, k, n, int4, dtype, m + k + n)
        for gelu in (False, True):
            got = getattr(kernels, name)(x, wq, sw, bias, gelu=gelu)
            want = getattr(kernels, name + "_plain")(x, wq, sw, bias, gelu=gelu)
            torch.cuda.synchronize()
            err = quant_err(got, want, f"{name} m={m} k={k} n={n} {dname} "
                            f"gelu={gelu}", dname)
            worst[name] = max(worst[name], err)
            cases += 1
        kp = 2 * wq.shape[1] if int4 else -(-k // 64) * 64
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
          "tolerance": QUANT_TOL,
          "shapes": [[QUANT_M, k, n] for k, n, _ in QUANT_MAIN_SHAPES]
          + [list(shape) for shape in QUANT_ODD_SHAPES],
          "note": "library_ms null: no one PyTorch call quantises, "
                  "multiplies and dequantises; int_mm_ms is torch._int_mm "
                  "on pre-quantised operands, the int32 product only"})
    return {"rows": rows, "worst": worst}


def segment_attention_bound() -> dict:
    """The bound of the TPU kernel still to be ported,
    ``ops/attention.py::fused_attention_tiled_seg``, at the packed bucket
    the reference serves by default (8 rows of 512 tokens, bge-large's
    16 heads of 64, bf16): q/k/v read and out written once, int32
    segment ids read once; 4 b nh s^2 hd FLOPs."""
    b, s, nh, hd = 8, 512, 16, 64
    bound, by = bound_ms(
        4 * b * s * nh * hd * 2 + 4 * b * s, 4.0 * b * nh * s * s * hd,
        "bfloat16",
    )
    row = {"phase": "bound", "kernel": "fused_attention_tiled_seg",
           "status": "not ported (packed serving, the next slice)",
           "shape": [b, s, nh, hd], "dtype": "bfloat16",
           "bound_ms": bound, "bound_by": by}
    emit(row)
    return row


def bound_ms_ops(nbytes: float, int8_ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = int8_ops / PEAK_INT8_OPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# -- phase 3: bge_micro on the card against the CPU ---------------------------


def post(port: int, path: str, body: dict):
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"content-type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=600) as resp:
        return json.loads(resp.read())


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
        "quantize_rows": kernels.quantize_rows,
        "w8a8_matmul": kernels.w8a8_matmul, "w4a8_matmul": kernels.w4a8_matmul,
    }


def reset_launches() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


def serve_traffic(emb, bursts, long_texts, embed_texts, model_name) -> dict:
    """Serve ``bursts`` (lists of concurrent /consensus bodies' texts),
    then the optional long request and one /embeddings request, through
    the port's HTTP server; the launch counts are set to 0 after a
    warm-up request and read at the end."""
    import threading

    import numpy as np
    import torch

    from llm_weighted_consensus_tpu_torch.serve.gateway import Server

    r = len(bursts[0])
    with Server(emb, max_batch=r, max_wait_ms=100) as srv:
        # warm-up: cuBLAS handles, allocator pools, the kernel library
        post(srv.port, "/consensus", {"input": bursts[0][0]})
        torch.cuda.synchronize()
        stats0 = srv.batcher.stats()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()

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
        launches = read_launches()
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
        "consensus_d": (stats1["dispatches"]["consensus"]
                        - stats0["dispatches"]["consensus"]),
        "embed_d": stats1["dispatches"]["embed"] - stats0["dispatches"]["embed"],
        "largest_group": stats1["largest_group"],
        "p50_ms": float(np.median(lat_ms)), "max_ms": lat_ms[-1],
        "requests": len(latencies), "answers_per_s": len(latencies) / burst_s,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }


def expected_launches(layers, consensus_d, embed_d, quantize="none") -> dict:
    encoder_d = consensus_d + embed_d
    dense = 6 * layers * encoder_d if quantize != "none" else 0
    int4 = quantize.startswith("int4")
    return {
        "cosine_vote": consensus_d, "attention": layers * encoder_d,
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
    row = {
        "phase": "main_path", "gpu": gpu, "model": "bge-large-en",
        "dtype": "bfloat16", "init_s": init_s,
        "requests": out["requests"], "candidates": n,
        "consensus_dispatches": out["consensus_d"],
        "embed_dispatches": out["embed_d"],
        "largest_group": out["largest_group"],
        "p50_ms": out["p50_ms"], "max_ms": out["max_ms"],
        "answers_per_s": out["answers_per_s"],
        "long_request_ms": out["long_ms"], "long_request_tokens":
            long_out["usage"]["prompt_tokens"],
        "embeddings_ms": out["embed_ms"], "launches": out["launches"],
        "expected_launches": want, "peak_mem_gib": out["peak_mem_gib"],
    }
    emit(row)
    return row, emb, bursts, embed_texts


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


def quant_path(gpu, mode, full, bursts, embed_texts) -> dict:
    """The main path's traffic (without the s=512 request) under
    ``quantize=mode`` on the same weights, held against the unquantized
    embedder ``full`` on the same texts."""
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
    del emb
    torch.cuda.empty_cache()
    return row


def profile_dispatch(gpu: str, quantize: str = "none") -> dict:
    """Device time by kernel for one coalesced dispatch (R=8, N=64,
    s=128) of the main path, from torch.profiler, and the host time of
    tokenizing its 512 texts; the table goes to
    chiprun_out/profile_main_path.txt, or profile_quant_path.txt under a
    quantize mode, where a cuBLAS GEMM in the dispatch fails the run."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

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
    emb.consensus_confidence_tokens_many(ids, mask)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        emb.consensus_confidence_tokens_many(ids, mask)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    rows = []
    for ev in prof.key_averages():
        # device kernels, memcpys and memsets only: host-side entries
        # (launch calls, "Command Buffer Full" waits) carry device time
        # of the kernels they wait on
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = ev.cuda_time_total
        if dev_us:
            rows.append((dev_us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows)
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    name = "profile_main_path.txt" if quantize == "none" else (
        "profile_quant_path.txt"
    )
    with open(os.path.join(out_dir, name), "w") as f:
        f.write(f"# {gpu}; one dispatch R=8 N=64 s={ids.shape[2]}, "
                f"quantize={quantize}, wall {wall_ms:.3f} ms\n")
        for ms, count, key in rows:
            f.write(f"{ms:10.3f} ms  {count:6d}  {key[:110]}\n")
    top = [
        {"kernel": key[:80], "ms": ms, "count": count}
        for ms, count, key in rows[:8]
    ]
    cublas = [
        key for _, _, key in rows
        if any(pat in key.lower() for pat in CUBLAS_GEMM)
        and "quant_gemm_kernel" not in key
    ]
    row = {
        "phase": "profile", "gpu": gpu, "quantize": quantize,
        "shape": list(ids.shape),
        "tokenize_ms": tokenize_ms, "wall_ms": wall_ms,
        "device_ms": device_ms,
        "device_idle_share": 1.0 - device_ms / wall_ms,
        "top": top, "cublas_gemm_kernels": cublas,
    }
    emit(row)
    if quantize != "none":
        if cublas:
            raise AssertionError(
                f"profile ({quantize}): cuBLAS GEMMs in the layer stack: "
                f"{cublas}"
            )
        names = " ".join(key for _, _, key in rows)
        if "quant_gemm_kernel" not in names or (
            "quantize_rows_kernel" not in names
        ):
            raise AssertionError(
                f"profile ({quantize}): the quantized kernels did not run"
            )
    if device_ms > wall_ms * DEVICE_TIME_SLACK:
        # one stream runs one kernel at a time: more device time than
        # wall time means the sum counted something twice or off the card
        raise AssertionError(
            f"profile: device time {device_ms} ms exceeds the wall time "
            f"{wall_ms} ms it was taken in"
        )
    return row


def kernel_summary(vote, attn_rows, quant, launches, q8, q4) -> dict:
    """The kernels line: every kernel of the paths, with its launches
    from the run of the path that takes it (the main path, the int8
    path, the int4 path; the row quantisation runs on both quantized
    paths and counts both) and its numbers at the main path's shape
    (bf16; for the quantized matmuls the MLP expansion, K=1024,
    N=4096 with GELU)."""
    main = next(
        r for r in attn_rows
        if r.get("shape", [])[:2] == [BURST * N_CANDIDATES, 128]
        and r["dtype"] == "bfloat16"
    )

    def quant_row(name):
        return next(
            r for r in quant["rows"]
            if r["kernel"] == name and r["shape"] == [QUANT_M, 1024, 4096]
        )

    q8_row, q4_row = quant_row("w8a8_matmul"), quant_row("w4a8_matmul")
    csrc = "llm_weighted_consensus_tpu_torch/csrc/"
    entries = [
        {
            "name": "cosine_vote", "route": "cuda",
            "source": csrc + "cosine_vote.cu",
            "replaces": "llm_weighted_consensus_tpu/ops/kernels.py:94",
            "launches": launches["cosine_vote"],
            "max_abs_err": vote["max_abs_err"], "ms": vote["kernel_ms"],
            "plain_ms": vote["plain_ms"], "bound_ms": vote["bound_ms"],
            "bound_by": vote["bound_by"], "library_ms": None,
        },
        {
            "name": "attention", "route": "cuda",
            "source": csrc + "attention.cu",
            "replaces": "llm_weighted_consensus_tpu/ops/attention.py:134",
            "launches": launches["attention"],
            "max_abs_err": max(r["max_abs_err"] for r in attn_rows),
            "ms": main["kernel_ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
        },
    ]
    for name, row, path, line in (
        ("w8a8_matmul", q8_row, q8, 202), ("w4a8_matmul", q4_row, q4, 319),
    ):
        entries.append({
            "name": name, "route": "cuda", "source": csrc + "quant_matmul.cu",
            "replaces": f"llm_weighted_consensus_tpu/ops/kernels.py:{line}",
            "launches": path["launches"][name],
            "max_abs_err": quant["worst"][name], "ms": row["kernel_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None,
            "shape": row["shape"],
        })
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

    vote = check_vote(gpu)
    attn_rows = check_attention(gpu)["rows"]
    quant = check_quant(gpu)
    segment_attention_bound()
    check_bge_micro(gpu)
    main_row, full, bursts, embed_texts = main_path(gpu)
    q8 = quant_path(gpu, "int8", full, bursts, embed_texts)
    q4 = quant_path(gpu, "int4-pallas", full, bursts[:1], embed_texts)
    del full
    torch.cuda.empty_cache()
    profile_dispatch(gpu)
    profile_dispatch(gpu, quantize="int8")
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit(kernel_summary(vote, attn_rows, quant, main_row["launches"], q8, q4))
    print(gpu)
    emit({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind,
                   "count": torch.cuda.device_count()},
    })
    return 0


if __name__ == "__main__":
    sys.exit(main())
