"""The port's kernels outside attention: the cosine self-consistency vote
and the W8A8 / W4A8 quantized dense layers.  Each CUDA kernel's wrapper
sits beside its plain PyTorch version.

Counterpart of ``llm_weighted_consensus_tpu/ops/kernels.py``'s
``fused_cosine_vote``, ``w8a8_matmul``, ``w4a8_matmul`` and
``pack_int4_weights``.

Vote: ``fused_cosine_vote``.  ``cosine_vote`` takes a leading request axis
``[R, N, D]`` and a run-time temperature, so one kernel serves the
single-request and the coalesced dispatches at every temperature.  A CPU
tensor takes the plain version; a CUDA tensor launches the kernel that
``vote_route`` names or raises: ``"cluster"``
(``csrc/cosine_vote_sm90.cu``: one thread-block cluster of
``vote_plan(...).cluster`` blocks per request, each block owning a slice
of D in shared memory, partial sums traded through distributed shared
memory) wherever the plan's shared memory fits a block, which is every
shape the server makes; ``"block"`` (``csrc/cosine_vote.cu``, one block
per request) past that.  ``cosine_vote.launches`` counts the kernel
launches, ``cosine_vote.routes`` the launches per route (``ops.launches``:
a CUDA graph's launches count at each replay, not at its capture).  Every
wrapper here refuses, on the card, an input that requires grad under grad
mode (``launches.refuse_grad``: the kernels define no backward).

Quantized dense layers: ``w8a8_matmul(x, wq, sw, bias, gelu)`` computes
``x[..., K] @ wq[N, K]^T`` with per-row dynamic int8 activations, int32
accumulation, the epilogue ``acc * sx * sw + bias`` in f32, an optional
GELU and one rounding to x's dtype; ``w4a8_matmul`` takes the weight as
packed biased nibbles ``[N, Kp/2]`` instead.  The weight is ``[out, in]``
(torch's ``Linear`` layout, the transpose of the JAX kernel).  On CUDA
each call launches two kernels: the row quantisation of
``csrc/quant_matmul.cu`` (wrapper ``quantize_rows``, counted in
``quantize_rows.launches``) and the int8 tensor-core GEMM with its fused
epilogue (counted in ``w8a8_matmul.launches`` / ``w4a8_matmul.launches``,
and by route in ``.routes``).  ``quant_gemm_route`` picks the GEMM:
``"tma"`` (``csrc/quant_gemm_sm90.cu``, TMA + wgmma) for 16-byte aligned
operands and, for W8A8, K % 16 == 0: every bge preset's layer, and W4A8
at every K (its packed weight stays packed in device memory and is
unpacked tile by tile in shared memory); ``"mma"``
(``csrc/quant_matmul.cu``, mma.sync) for the rest.
The plain versions take the int8 product in f64, which is exact here
(|acc| <= K * 127^2 < 2^53), where f32 would not be past K ~ 1040.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import _build, launches
from .norm_act import gelu_f32
from .similarity import masked_cosine_vote

# K of the split-K int4 packing: Kp is K rounded up to a multiple of this
W4A8_PACK_K = 256
# K tile of the int8 GEMM: the quantised activations are padded to it
QUANT_K_TILE = 64

# the block route keeps 2N + D floats in shared memory; past this it
# would need more than the 227 KB a Hopper block can have
MAX_VOTE_CANDIDATES = 16384
MAX_VOTE_DIM = 16384

# the cluster route (csrc/cosine_vote_sm90.cu): the shared memory a Hopper
# block can have, the largest cluster (above 8 a non-portable size), the
# blocks a launch aims at (R * C), the fewest columns a block is given
# where D allows, and the multiple its columns are rounded to (16-byte
# rows for both dtypes)
VOTE_SMEM_LIMIT = 232448
VOTE_MAX_CLUSTER = 16
VOTE_LAUNCH_BLOCKS = 64
VOTE_MIN_COLS = 32
VOTE_COL_ALIGN = 8


class VotePlan(NamedTuple):
    """The cluster route's partition of one request: ``cluster`` blocks,
    block c owning columns ``[c * cols, min((c + 1) * cols, D))``, each
    taking ``smem_bytes`` of dynamic shared memory."""

    cluster: int
    cols: int
    smem_bytes: int


def _vote_cluster_for(r: int) -> int:
    """Blocks per request before D and shared memory are considered: the
    largest power of two up to 16 with R * C <= 64.  From the timed turn
    of every C at [R, 64, 1024] f32 on the H100 (``chip_smoke.py``,
    ``PERF.md``): C = 16 is fastest up to R = 4; at R = 8, 128 blocks (C =
    16) lose to 64 (C = 8); at R = 16, C = 4 and 8 tie."""
    c = VOTE_MAX_CLUSTER
    while c > 1 and r * c > VOTE_LAUNCH_BLOCKS:
        c //= 2
    return c


def vote_smem_bytes(n: int, cols: int, cluster: int, dtype) -> int:
    """A cluster block's shared memory for ``n`` rows of ``cols`` columns
    in a cluster of ``cluster`` blocks: the tile in the input's dtype,
    each row padded by 16 bytes, then in f32 the partial sums of squares
    and of dot - self of every block [2, cluster, n], the inverse norms
    and the logits [2, n] and the column sum [cols]."""
    item = 4 if dtype == torch.float32 else 2
    return n * (cols * item + 16) + 4 * (2 * cluster * n + 2 * n + cols)


def vote_plan(r: int, n: int, d: int, dtype) -> VotePlan:
    """The cluster route's partition of ``[r, n, d]`` embeddings of
    ``dtype``: a pure function of the shape and dtype.  C starts at
    ``_vote_cluster_for(r)``, halves while a block would get fewer than
    ``VOTE_MIN_COLS`` columns, and doubles (up to 16) while a block's
    shared memory would pass ``VOTE_SMEM_LIMIT``."""
    c = _vote_cluster_for(r)
    while c > 1 and -(-d // c) < VOTE_MIN_COLS:
        c //= 2
    while True:
        cols = _round_up(-(-d // c), VOTE_COL_ALIGN)
        plan = VotePlan(c, cols, vote_smem_bytes(n, cols, c, dtype))
        if plan.smem_bytes <= VOTE_SMEM_LIMIT or c == VOTE_MAX_CLUSTER:
            return plan
        c *= 2


def vote_route(r: int, n: int, d: int, dtype) -> str:
    """"cluster" where ``vote_plan``'s blocks fit the card's shared
    memory, else "block"."""
    if vote_plan(r, n, d, dtype).smem_bytes <= VOTE_SMEM_LIMIT:
        return "cluster"
    return "block"


def cosine_vote_plain(emb: torch.Tensor, n_valid, temperature: float):
    """emb[R, N, D] -> conf[R, N] f32: ``similarity.masked_cosine_vote``
    with rows at and past ``n_valid`` masked out (they get 0).
    ``n_valid`` is an int, or int32 [R] (one count per request, taken as
    clamped to [0, N]: a request with no live row gets zeros)."""
    n = emb.shape[-2]
    rows = torch.arange(n, device=emb.device)
    if isinstance(n_valid, torch.Tensor):
        valid = rows[None, :] < n_valid.to(emb.device)[:, None]
    else:
        valid = rows < n_valid
    return masked_cosine_vote(emb, valid, temperature)


def cosine_vote(
    emb: torch.Tensor,
    n_valid=None,
    temperature: float = 0.05,
) -> torch.Tensor:
    """emb[R, N, D] (f32 or bf16) -> confidence[R, N] f32.

    ``n_valid`` is the count of live rows: an int shared by every request
    (default N), or an int32 tensor [R] on ``emb``'s device, one count per
    request (the streaming consensus, whose streams differ in length).
    Rows at and past a request's count are padding, excluded from the vote
    and given 0.  A tensor is not read on the host: the kernel clamps each
    count to [0, N] (0 gives a request of zeros), and so does the plain
    version.  One launch either way.
    """
    if emb.ndim != 3:
        raise ValueError(f"cosine_vote wants emb[R, N, D], got {emb.shape}")
    if emb.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"cosine_vote takes f32 or bf16, got {emb.dtype}")
    r, n, d = emb.shape
    counts = None
    if isinstance(n_valid, torch.Tensor):
        counts = n_valid
        if counts.dtype != torch.int32 or tuple(counts.shape) != (r,):
            raise ValueError(
                f"cosine_vote wants n_valid as int32 [{r}], got "
                f"{counts.dtype} {tuple(counts.shape)}"
            )
        if counts.device != emb.device:
            raise ValueError(
                f"n_valid on {counts.device}, emb on {emb.device}"
            )
        n_valid = n
    else:
        n_valid = n if n_valid is None else int(n_valid)
        if not 1 <= n_valid <= n:
            raise ValueError(f"n_valid={n_valid} outside [1, {n}]")
    temperature = float(temperature)
    if not temperature > 0:
        raise ValueError(f"temperature must be positive, got {temperature}")
    if emb.device.type == "cpu":
        return cosine_vote_plain(
            emb, n_valid if counts is None else counts, temperature
        )
    if emb.device.type != "cuda":
        raise ValueError(f"cosine_vote: unsupported device {emb.device}")
    launches.refuse_grad("cosine_vote", emb)
    if not emb.is_contiguous():
        raise ValueError("cosine_vote wants a contiguous emb")
    if counts is not None and not counts.is_contiguous():
        raise ValueError("cosine_vote wants a contiguous n_valid")
    if n > MAX_VOTE_CANDIDATES or d > MAX_VOTE_DIM:
        raise ValueError(
            f"cosine_vote kernel takes N <= {MAX_VOTE_CANDIDATES} and "
            f"D <= {MAX_VOTE_DIM}, got N={n}, D={d}"
        )
    lib = _build.library()
    conf = torch.empty((r, n), dtype=torch.float32, device=emb.device)
    if r == 0:
        return conf
    dtype = 0 if emb.dtype == torch.float32 else 1
    counts_ptr = None if counts is None else counts.data_ptr()
    stream = torch.cuda.current_stream(emb.device).cuda_stream
    plan = vote_plan(r, n, d, emb.dtype)
    route = "cluster" if plan.smem_bytes <= VOTE_SMEM_LIMIT else "block"
    if route == "cluster":
        rc = lib.lwc_cosine_vote_cluster(
            emb.data_ptr(), conf.data_ptr(), r, n, d, n_valid, counts_ptr,
            temperature, dtype, plan.cluster, plan.cols, stream,
        )
    else:
        rc = lib.lwc_cosine_vote(
            emb.data_ptr(), conf.data_ptr(), r, n, d, n_valid, counts_ptr,
            temperature, dtype, stream,
        )
    _build.check(rc, f"cosine_vote ({route})")
    launches.count(cosine_vote, route)
    return conf


cosine_vote.launches = 0
cosine_vote.routes = {"cluster": 0, "block": 0}


# ---------------------------------------------------------------------------
# Quantized dense layers (W8A8, W4A8)
# ---------------------------------------------------------------------------


def _round_up(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def pack_int4_weights(q: torch.Tensor) -> torch.Tensor:
    """int8 values in [-7, 7], ``q[..., N, K]`` -> uint8 ``[..., N, Kp/2]``
    in the reference's split-K biased-nibble layout along K: Kp is K
    rounded up to 256, byte kk holds row kk + 8 in its low nibble and row
    kk + Kp/2 + 8 in its high nibble, and a pad nibble is 8 (0 once
    unbiased).  Byte for byte ``pack_int4_weights(q_jax).T``."""
    k = q.shape[-1]
    kp = _round_up(k, W4A8_PACK_K)
    biased = torch.full(
        (*q.shape[:-1], kp), 8, dtype=torch.uint8, device=q.device
    )
    biased[..., :k] = (q.to(torch.int32) + 8).to(torch.uint8)
    half = kp // 2
    return biased[..., :half] | (biased[..., half:] << 4)


def unpack_int4_weights(wq4: torch.Tensor, k: int) -> torch.Tensor:
    """Packed uint8 ``[..., N, Kp/2]`` -> int8 ``[..., N, k]``."""
    w = wq4.to(torch.int32)
    lo = (w & 0xF) - 8
    hi = (w >> 4) - 8
    return torch.cat([lo, hi], dim=-1)[..., :k].to(torch.int8)


def symmetric_scale(amax: torch.Tensor, qmax: float) -> torch.Tensor:
    """``max(amax / qmax, 1e-12)`` in f32 with an IEEE division: PyTorch
    on CUDA divides by a Python number as a multiply by its reciprocal,
    which is an ulp off the reference's scale for some inputs, so the
    divisor is a tensor."""
    return torch.clamp(amax / torch.full_like(amax, qmax), min=1e-12)


def quantize_rows_plain(x: torch.Tensor, kp: Optional[int] = None,
                        scale: Optional[torch.Tensor] = None):
    """x[..., K] -> (int8 [..., kp or K], f32 scale[...]): per-row
    symmetric ``sx = max(max|x| / 127, 1e-12)``, x / sx rounded half to
    even and clipped to +-127; columns past K are 0.  A given ``scale``
    (f32 [...]) is used instead of the row's own (a row-split shard's,
    ``row_scale``)."""
    x32 = x.float()
    if scale is None:
        scale = symmetric_scale(torch.amax(torch.abs(x32), dim=-1), 127.0)
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127)
    q = q.to(torch.int8)
    k = x.shape[-1]
    if kp is not None and kp > k:
        q = torch.nn.functional.pad(q, (0, kp - k))
    return q, scale


def quantize_rows(x: torch.Tensor, kp: int,
                  scale: Optional[torch.Tensor] = None):
    """x[M, K] (f32 or bf16, contiguous) -> (xq[M, kp] int8, sx[M] f32),
    kp >= K a multiple of ``QUANT_K_TILE``.  ``scale`` (f32 [M]) gives
    the rows' scales instead of computing them (returned as sx).  A CPU
    tensor takes ``quantize_rows_plain``; a CUDA tensor launches
    ``lwc_quantize_rows`` or raises."""
    if x.ndim != 2:
        raise ValueError(f"quantize_rows wants x[M, K], got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"quantize_rows takes f32 or bf16, got {x.dtype}")
    m, k = x.shape
    if kp < k or kp % QUANT_K_TILE:
        raise ValueError(
            f"quantize_rows: kp={kp} must be >= K={k} and a multiple of "
            f"{QUANT_K_TILE}"
        )
    if scale is not None and (
        scale.shape != (m,) or scale.dtype != torch.float32
        or scale.device != x.device
    ):
        raise ValueError(
            f"quantize_rows: scale must be f32 [{m}] on {x.device}, got "
            f"{scale.dtype} {tuple(scale.shape)} on {scale.device}"
        )
    if x.device.type == "cpu":
        return quantize_rows_plain(x, kp, scale)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_rows: unsupported device {x.device}")
    launches.refuse_grad("quantize_rows", x)
    if not x.is_contiguous():
        raise ValueError("quantize_rows wants a contiguous x")
    lib = _build.library()
    xq = torch.empty((m, kp), dtype=torch.int8, device=x.device)
    sx = (torch.empty((m,), dtype=torch.float32, device=x.device)
          if scale is None else scale.contiguous())
    if m == 0:
        return xq, sx
    rc = lib.lwc_quantize_rows(
        x.data_ptr(), xq.data_ptr(), sx.data_ptr(), m, k, kp,
        0 if x.dtype == torch.float32 else 1, int(scale is not None),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(rc, "quantize_rows")
    launches.count(quantize_rows)
    return xq, sx


quantize_rows.launches = 0


def _epilogue_plain(acc, sx, sw, bias, gelu: bool, dtype) -> torch.Tensor:
    out = acc.float() * sx[..., None] * sw.float() + bias.float()
    if gelu:
        out = gelu_f32(out, approx=dtype == torch.bfloat16)
    return out.to(dtype)


def _out_dtype(x, row_scale) -> torch.dtype:
    # a row-split shard (a given row scale) takes its partial in f32
    return x.dtype if row_scale is None else torch.float32


def w8a8_matmul_plain(x, wq, sw, bias, gelu: bool = False,
                      row_scale=None) -> torch.Tensor:
    """The W8A8 kernel's arithmetic in plain PyTorch: the int8 product in
    f64 (exact), the epilogue as ``(acc * sx) * sw + bias`` in f32."""
    xq, sx = quantize_rows_plain(x, scale=row_scale)
    acc = torch.matmul(xq.double(), wq.double().T)
    return _epilogue_plain(acc, sx, sw, bias, gelu, _out_dtype(x, row_scale))


def w4a8_matmul_plain(x, wq4, sw, bias, gelu: bool = False,
                      row_scale=None) -> torch.Tensor:
    """``w8a8_matmul_plain`` over the unpacked int4 weight."""
    return w8a8_matmul_plain(
        x, unpack_int4_weights(wq4, x.shape[-1]), sw, bias, gelu, row_scale,
    )


def _check_quant_operands(name, x, w, sw, bias, int4):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} takes f32 or bf16 x, got {x.dtype}")
    want = torch.uint8 if int4 else torch.int8
    if w.ndim != 2 or w.dtype != want:
        raise TypeError(
            f"{name} wants a 2-d {want} weight, got {w.dtype} "
            f"{tuple(w.shape)}"
        )
    n = w.shape[0]
    for label, t in (("scale", sw), ("bias", bias)):
        if t.shape != (n,) or t.dtype != torch.float32:
            raise ValueError(
                f"{name}: {label} must be f32 [{n}], got {t.dtype} "
                f"{tuple(t.shape)}"
            )
    devices = {t.device for t in (x, w, sw, bias)}
    if len(devices) != 1:
        raise ValueError(f"{name}: operands on several devices: {devices}")


def quant_gemm_route(k: int, int4: bool, *tensors) -> str:
    """The GEMM a CUDA call takes: "tma" where every operand (``xq``,
    ``w``, ``out``) is 16-byte aligned and, for W8A8, K % 16 == 0 (W4A8
    reads the Kp-wide ``xq``, zero past K, so any K), else "mma"; a pure
    function of K, the weight format and the base addresses."""
    if (not int4 and k % 16) or any(t.data_ptr() % 16 for t in tensors):
        return "mma"
    return "tma"


def _check_row_scale(name, x, row_scale):
    rows = tuple(x.shape[:-1])
    if row_scale is not None and (
        tuple(row_scale.shape) != rows or row_scale.dtype != torch.float32
        or row_scale.device != x.device
    ):
        raise ValueError(
            f"{name}: row_scale must be f32 {list(rows)} on {x.device}, got "
            f"{row_scale.dtype} {tuple(row_scale.shape)}"
        )


def _quant_matmul(name, wrapper, x, w, sw, bias, gelu, int4, kp,
                  row_scale=None):
    """Launch the row quantisation and the GEMM for ``x[..., K]``."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    launches.refuse_grad(name, x, w, sw, bias)
    if not (w.is_contiguous() and sw.is_contiguous()
            and bias.is_contiguous()):
        raise ValueError(f"{name} wants contiguous weight, scale and bias")
    k = x.shape[-1]
    n = w.shape[0]
    x2 = x.reshape(-1, k)
    if not x2.is_contiguous():
        x2 = x2.contiguous()
    m = x2.shape[0]
    xq, sx = quantize_rows(
        x2, kp, None if row_scale is None else row_scale.reshape(m))
    lib = _build.library()
    out_dtype = _out_dtype(x, row_scale)
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m and n:
        route = quant_gemm_route(k, int4, xq, w, out)
        entry = "lwc_quant_matmul_tma" if route == "tma" else "lwc_quant_matmul"
        rc = getattr(lib, entry)(
            xq.data_ptr(), w.data_ptr(), sx.data_ptr(), sw.data_ptr(),
            bias.data_ptr(), out.data_ptr(), m, n, k, kp, int(int4),
            int(bool(gelu)), 0 if out_dtype == torch.float32 else 1,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
        _build.check(rc, name)
        launches.count(wrapper, route)
    return out.reshape(*x.shape[:-1], n)


def w8a8_matmul(
    x: torch.Tensor,
    wq: torch.Tensor,
    sw: torch.Tensor,
    bias: torch.Tensor,
    gelu: bool = False,
    row_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """x[..., K] (f32 or bf16) @ wq[N, K]^T (int8, per-output-channel
    scale ``sw[N]`` f32) + bias[N] f32 -> [..., N] in x's dtype;
    ``gelu=True`` applies the GELU (erf for f32, A&S 7.1.26 for bf16) to
    the f32 pre-activation before the one rounding.  ``row_scale`` (f32
    ``x.shape[:-1]``) quantises x's rows with those scales instead of
    their own and gives the product in f32: a tensor-parallel shard of a
    row-split layer passes the scale of the full row and takes its
    partial product (``models/bert.py``)."""
    _check_quant_operands("w8a8_matmul", x, wq, sw, bias, int4=False)
    _check_row_scale("w8a8_matmul", x, row_scale)
    k = x.shape[-1]
    if wq.shape[1] != k:
        raise ValueError(f"w8a8_matmul: x has K={k}, wq is {tuple(wq.shape)}")
    if x.device.type == "cpu":
        return w8a8_matmul_plain(x, wq, sw, bias, gelu, row_scale)
    return _quant_matmul(
        "w8a8_matmul", w8a8_matmul, x, wq, sw, bias, gelu, False,
        _round_up(k, QUANT_K_TILE), row_scale,
    )


w8a8_matmul.launches = 0
w8a8_matmul.routes = {"tma": 0, "mma": 0}


def w4a8_matmul(
    x: torch.Tensor,
    wq4: torch.Tensor,
    sw: torch.Tensor,
    bias: torch.Tensor,
    gelu: bool = False,
    row_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``w8a8_matmul`` with the weight as packed biased nibbles
    ``wq4[N, Kp/2]`` uint8 (``pack_int4_weights``, Kp a multiple of 256,
    K <= Kp)."""
    _check_quant_operands("w4a8_matmul", x, wq4, sw, bias, int4=True)
    _check_row_scale("w4a8_matmul", x, row_scale)
    k = x.shape[-1]
    kp = 2 * wq4.shape[1]
    if kp % W4A8_PACK_K or k > kp:
        raise ValueError(
            f"w4a8_matmul: x has K={k}, packed weight {tuple(wq4.shape)} "
            f"(Kp={kp} must be a multiple of {W4A8_PACK_K} and >= K)"
        )
    if x.device.type == "cpu":
        return w4a8_matmul_plain(x, wq4, sw, bias, gelu, row_scale)
    return _quant_matmul(
        "w4a8_matmul", w4a8_matmul, x, wq4, sw, bias, gelu, True, kp,
        row_scale,
    )


w4a8_matmul.launches = 0
w4a8_matmul.routes = {"tma": 0, "mma": 0}
