"""Encoder multi-head attention: the CUDA kernels' wrappers and their
plain PyTorch versions.

Counterparts of ``llm_weighted_consensus_tpu/ops/attention.py``'s
``fused_attention_tiled`` and ``fused_attention_tiled_seg``:

* ``attention(q, k, v, bias, scale)`` takes q/k/v[b, s, nh, hd] and an
  additive key bias[b, s] (0 or -1e9) and returns
  softmax(Q K^T * scale + bias) V in the same layout and q's dtype;
* ``segment_attention(q, k, v, segment_ids, scale)``, the packed layout's
  twin, takes int32 segment_ids[b, s] (an id <= 0 is a pad slot): query
  i sees key j iff ``seg[i] == seg[j] and seg[j] > 0``, and a masked
  logit is replaced by -1e9, so a pad query row softmaxes to the uniform
  mean of v.

A CPU tensor takes the plain version; a CUDA tensor launches a kernel
(read straight from the [b, s, nh, hd] layout, no head transposes) or
raises, and so does one that requires grad under grad mode (the kernels
define no backward: ``launches.refuse_grad``).  ``attention_route`` and ``segment_attention_route`` pick the
kernel from dtype, head dim, strides and alignment alone:

* ``"tma"``: bf16, hd 64, every base 16-byte aligned and every stride a
  multiple of 16 bytes (every encoder call of bge-base and bge-large):
  ``csrc/attention_sm90.cu``, TMA + wgmma (``lwc_attention_tma``, and
  for segment ids ``lwc_attention_seg_tma``, which skips the key tiles
  ``segment_tile_schedule`` marks);
* ``"mma"``: other aligned bf16 with hd 16 or 32: ``csrc/attention.cu``'s
  mma.sync kernel;
* ``"fma"``: f32, hd 24 and unaligned views: ``csrc/attention.cu``'s f32
  FMA kernel.

``attention.launches`` and ``segment_attention.launches`` count the
kernel launches, ``attention.routes`` and ``segment_attention.routes``
count them by route (``ops.launches``: a CUDA graph's launches count at
each replay, not at its capture).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, launches

KERNEL_HEAD_DIMS = (16, 24, 32, 64)

# The segment TMA kernel's schedule (csrc/attention_sm90.cu): each
# consumer warpgroup owns SEG_BLOCK_Q query rows and walks the key tiles
# of SEG_BLOCK_K keys; per (query block, key tile) it skips the tile,
# multiplies P V only (every logit of the block is masked), or computes
# both products.  ``kernel_tile_schedule`` reads the kernel's own block
# sizes and schedule back, to hold them to these.
SEG_BLOCK_Q = 64
SEG_BLOCK_K = 128
SEG_SKIP, SEG_MASKED, SEG_FULL = 0, 1, 2


def attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,
    scale: float,
) -> torch.Tensor:
    """The fused TPU kernel's numerics: f32 logits (storage-dtype inputs,
    f32 accumulation), f32 softmax, probabilities cast to v's dtype, f32
    PV accumulation, output in q's dtype.  Not the einsum path's
    bf16-stored logits."""
    logits = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) * scale
    logits = logits + bias.float()[:, None, None, :]
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    ctx = torch.einsum("bnqk,bknd->bqnd", probs.float(), v.float())
    return ctx.to(q.dtype)


def segment_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    segment_ids: torch.Tensor,
    scale: float,
) -> torch.Tensor:
    """The segment-masked TPU kernel's numerics: f32 logits, masked
    logits REPLACED by -1e9 (not a bias added), f32 softmax,
    probabilities cast to v's dtype, f32 PV accumulation, output in q's
    dtype."""
    logits = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) * scale
    seg = segment_ids
    same = (seg[:, :, None] == seg[:, None, :]) & (seg[:, None, :] > 0)
    logits = torch.where(
        same[:, None], logits,
        torch.full((), -1e9, dtype=torch.float32, device=logits.device),
    )
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    ctx = torch.einsum("bnqk,bknd->bqnd", probs.float(), v.float())
    return ctx.to(q.dtype)


def segment_tile_schedule(
    segment_ids: torch.Tensor,
    block_q: int = SEG_BLOCK_Q,
    block_k: int = SEG_BLOCK_K,
) -> torch.Tensor:
    """int8 [b, ceil(s / block_q), ceil(s / block_k)]: what the segment
    TMA kernel does with each (query block, key tile), the same test its
    producer warp computes from the ids.

    ``SEG_FULL`` where the key tile's range of positive ids [min, max]
    overlaps the query block's; else ``SEG_MASKED`` where the query block
    holds a pad row (id <= 0), which must see every key (-1e9 everywhere:
    the uniform mean of v), and ``SEG_SKIP`` otherwise.  Exact for any
    layout: a same-segment key's id lies in both ranges, so every logit
    outside a full tile is -1e9; a row with a segment has a real logit
    (its own key), so its final max is O(10) and each such probability,
    exp(-1e9 - max), is exactly 0 in f32.  Rows and keys past s belong
    to neither range."""
    seg = segment_ids.to(torch.int64)
    b, s = seg.shape
    big = torch.iinfo(torch.int64).max

    def ranges(block: int):
        n = -(-s // block)
        tiles = torch.full((b, n * block), -1, dtype=torch.int64,
                           device=seg.device)
        tiles[:, :s] = seg.clamp(min=0)
        tiles = tiles.view(b, n, block)
        real = tiles > 0
        lo = torch.where(real, tiles, big).amin(dim=-1)
        hi = torch.where(real, tiles, 0).amax(dim=-1)
        return lo, hi, (tiles == 0).any(dim=-1)

    q_lo, q_hi, q_pad = ranges(block_q)
    k_lo, k_hi, _ = ranges(block_k)
    overlap = ((q_lo[:, :, None] <= k_hi[:, None, :])
               & (k_lo[:, None, :] <= q_hi[:, :, None]))
    kinds = torch.where(
        overlap, SEG_FULL, torch.where(q_pad[:, :, None], SEG_MASKED, SEG_SKIP)
    )
    return kinds.to(torch.int8)


def _check_qkv(what: str, q, k, v, mask, mask_dtype) -> None:
    """Shapes, dtypes and devices both wrappers take."""
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"{what} wants q/k/v[b, s, nh, hd] of one shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, s = q.shape[:2]
    if mask.shape != (b, s) or mask.dtype != mask_dtype:
        raise ValueError(
            f"{what} wants a {mask_dtype} [{b}, {s}] key tensor, got "
            f"{mask.dtype} {tuple(mask.shape)}"
        )
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
        k.dtype == v.dtype == q.dtype
    ):
        raise TypeError(
            f"{what} takes f32 or bf16 q/k/v of one dtype, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    devices = {t.device for t in (q, k, v, mask)}
    if len(devices) != 1:
        raise ValueError(f"{what} operands on several devices: {devices}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {q.device}")


def _aligned(q, k, v) -> bool:
    """16-byte aligned bases and strides (in elements of 2 bytes: 8)."""
    return all(
        t.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in t.stride()[:3])
        for t in (q, k, v)
    )


def attention_route(q, k, v) -> str:
    """The kernel a CUDA call of ``attention`` takes: "tma", "mma" or
    "fma" (module docstring); a pure function of the operands' dtype,
    shape, strides and base addresses."""
    hd = q.shape[-1]
    if q.dtype != torch.bfloat16 or not _aligned(q, k, v):
        return "fma"
    if hd == 64:
        return "tma"
    return "mma" if hd in (16, 32) else "fma"


def segment_attention_route(q, k, v) -> str:
    """The kernel a CUDA call of ``segment_attention`` takes: the same
    choice as ``attention_route`` (the TMA route is the segment variant
    of the same kernel)."""
    return attention_route(q, k, v)


def _launch(entry: str, q, k, v, mask, scale: float, *extra) -> torch.Tensor:
    """One launch of the C entry point ``entry`` on CUDA tensors already
    checked by ``_check_qkv``; ``extra`` follows the stream."""
    b, s, nh, hd = q.shape
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"attention kernel takes hd in {KERNEL_HEAD_DIMS}, got {hd}"
        )
    if any(t.stride(-1) != 1 for t in (q, k, v)) or not mask.is_contiguous():
        raise ValueError(
            "attention wants the hd axis of q/k/v and the [b, s] key "
            "tensor contiguous"
        )
    lib = _build.library()
    out = torch.empty((b, s, nh, hd), dtype=q.dtype, device=q.device)
    if b == 0 or s == 0:
        return out
    strides = (ctypes.c_longlong * 9)(
        *(st for t in (q, k, v) for st in t.stride()[:3])
    )
    rc = getattr(lib, entry)(
        q.data_ptr(),
        k.data_ptr(),
        v.data_ptr(),
        mask.data_ptr(),
        out.data_ptr(),
        b,
        s,
        nh,
        hd,
        strides,
        float(scale),
        0 if q.dtype == torch.float32 else 1,
        torch.cuda.current_stream(q.device).cuda_stream,
        *extra,
    )
    _build.check(rc, entry)
    return out


def kernel_tile_schedule(q, k, v, segment_ids, scale):
    """One launch of the segment TMA kernel on CUDA tensors that also
    writes back the schedule its producer ran: ``(out, schedule,
    (block_q, block_k))`` with ``schedule`` int8 [b, query blocks, key
    tiles] laid out as ``segment_tile_schedule``'s (the kernel's query
    blocks are rounded up to an even count) and the kernel's own block
    sizes.  For holding the plain schedule to the kernel; counts no
    launch."""
    _check_qkv("kernel_tile_schedule", q, k, v, segment_ids, torch.int32)
    if segment_attention_route(q, k, v) != "tma":
        raise ValueError("kernel_tile_schedule takes a call of the tma route")
    launches.refuse_grad("kernel_tile_schedule", q, k, v)
    b, s = segment_ids.shape
    dims = (ctypes.c_int * 4)()
    _build.library().lwc_attention_seg_tma_tiles(s, dims)
    schedule = torch.zeros((b, dims[0], dims[1]), dtype=torch.int32,
                           device=q.device)
    out = _launch("lwc_attention_seg_tma_schedule", q, k, v, segment_ids,
                  scale, schedule.data_ptr())
    return out, schedule.to(torch.int8), (dims[2], dims[3])


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,
    scale: float,
) -> torch.Tensor:
    _check_qkv("attention", q, k, v, bias, torch.float32)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, bias, scale)
    launches.refuse_grad("attention", q, k, v, bias)
    route = attention_route(q, k, v)
    entry = "lwc_attention_tma" if route == "tma" else "lwc_attention"
    out = _launch(entry, q, k, v, bias, scale)
    launches.count(attention, route)
    return out


attention.launches = 0
attention.routes = {"tma": 0, "mma": 0, "fma": 0}


def segment_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    segment_ids: torch.Tensor,
    scale: float,
) -> torch.Tensor:
    _check_qkv("segment_attention", q, k, v, segment_ids, torch.int32)
    if q.device.type == "cpu":
        return segment_attention_plain(q, k, v, segment_ids, scale)
    launches.refuse_grad("segment_attention", q, k, v)
    route = segment_attention_route(q, k, v)
    entry = "lwc_attention_seg_tma" if route == "tma" else "lwc_attention_seg"
    out = _launch(entry, q, k, v, segment_ids, scale)
    launches.count(segment_attention, route)
    return out


segment_attention.launches = 0
segment_attention.routes = {"tma": 0, "mma": 0, "fma": 0}
