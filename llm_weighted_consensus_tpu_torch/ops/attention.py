"""Encoder multi-head attention: the CUDA kernels' wrappers and their
plain PyTorch versions.

Counterparts of ``llm_weighted_consensus_tpu/ops/attention.py``'s
``fused_attention_tiled`` and ``fused_attention_tiled_seg``:

* ``attention(q, k, v, bias, scale)`` takes q/k/v[b, s, nh, hd] and an
  additive key bias[b, s] (0 or -1e9) and returns
  softmax(Q K^T * scale + bias) V in the same layout and q's dtype;
* ``segment_attention(q, k, v, segment_ids, scale)``, the packed layout's
  twin, takes int32 segment_ids[b, s] (0 = pad slot): query i sees key j
  iff ``seg[i] == seg[j] and seg[j] > 0``, and a masked logit is replaced
  by -1e9, so a pad query row softmaxes to the uniform mean of v.

A CPU tensor takes the plain version; a CUDA tensor launches a kernel
(read straight from the [b, s, nh, hd] layout, no head transposes) or
raises.  ``attention_route`` picks the kernel from dtype, head dim,
strides and alignment alone:

* ``"tma"``: bf16, hd 64, every base 16-byte aligned and every stride a
  multiple of 16 bytes (every encoder call of bge-base and bge-large):
  ``csrc/attention_sm90.cu``, TMA + wgmma;
* ``"mma"``: other aligned bf16 with hd 16 or 32: ``csrc/attention.cu``'s
  mma.sync kernel;
* ``"fma"``: f32, hd 24 and unaligned views: ``csrc/attention.cu``'s f32
  FMA kernel.

``segment_attention`` always launches ``lwc_attention_seg`` (the mma or
the FMA kernel of ``csrc/attention.cu``).  ``attention.launches`` and
``segment_attention.launches`` count the kernel launches;
``attention.routes`` counts them by route.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

KERNEL_HEAD_DIMS = (16, 24, 32, 64)


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


def _launch(entry: str, q, k, v, mask, scale: float) -> torch.Tensor:
    """One launch of the C entry point ``entry`` on CUDA tensors already
    checked by ``_check_qkv``."""
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
    )
    _build.check(rc, entry)
    return out


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
    route = attention_route(q, k, v)
    entry = "lwc_attention_tma" if route == "tma" else "lwc_attention"
    out = _launch(entry, q, k, v, bias, scale)
    attention.launches += 1
    attention.routes[route] += 1
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
    out = _launch("lwc_attention_seg", q, k, v, segment_ids, scale)
    segment_attention.launches += 1
    return out


segment_attention.launches = 0
