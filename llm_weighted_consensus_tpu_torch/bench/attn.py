"""One encoder-shaped attention op under each implementation (the
counterpart of the reference's ``bench_attn.py``).

At each padded shape the main path dispatches (``SHAPES``, [b, s] with
bge-large's 16 heads of 64, bf16, a key bias of 0 / -1e9 with ragged
lengths) it times, by CUDA events, the port's kernel
(``ops.attention.attention``), its plain version and
``scaled_dot_product_attention`` with the same additive mask, and holds
the kernel against the plain version; at each packed shape
(``PACKED``) the segment kernel, its plain version and SDPA with the
boolean same-segment mask, on segment ids of the mixed traffic's
lengths.  ``bound_ms`` is the larger of the bytes (q, k, v and the mask
read once, the output written once) over the HBM rate and the dense
FLOPs over the bf16 peak.

``--long-seq`` is the ring against dense attention (the reference's
``ring_vs_dense_crossover``): at each of ``--long-seqs`` one attention op
of [``--long-b``, s, ``--long-nh``, ``--hd``], dense (the kernel wrapper,
``ops.attention.attention``) against the ring over ``--sp`` shards
(``parallel.ring.ring_attention``, torch ops as the reference's ring),
held to each other; per implementation the p50 ms per call (CUDA
events) and the peak and temporary device bytes of one call
(``torch.cuda.max_memory_allocated`` above the inputs; null on the CPU),
and the first length at which the ring is faster (``crossover_seq``).
The ring's shards lie on the first ``--sp`` cards, or share the first
card where there are fewer (``cards``, ``shared_card``): on a shared
card the ring's blocks run one after another, so it cannot be faster;
what it shows there is the memory a shard's tile needs.

Run: ``python -m llm_weighted_consensus_tpu_torch.bench attn``.
"""

from __future__ import annotations

import argparse

import numpy as np

from . import common

NAME = "attn"
# chip_smoke.py's MAIN_PATH_ATTENTION_SHAPES, and packed [b, L] calls of
# the mixed-length traffic (its full bucket first)
SHAPES = ((64, 128), (512, 128), (16, 512), (32, 64))
PACKED = ((8, 512), (4, 512), (1, 256))
# calls per timed trial (3 trials, the median reported)
REPS = 20


def segment_ids(b: int, s: int, seed: int) -> np.ndarray:
    """Packed rows: segments of the mixed traffic's lengths laid end to
    end, pad tails (id 0)."""
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
    return seg


def bound_ms(b: int, s: int, nh: int, hd: int, itemsize: int,
             mask_bytes: int) -> tuple:
    nbytes = 4 * b * s * nh * hd * itemsize + b * s * mask_bytes
    flops = 4.0 * b * nh * s * s * hd
    t_bytes = nbytes / common.H100_HBM_BYTES_PER_S * 1e3
    t_ops = flops / common.H100_PEAKS["bfloat16"] * 1e3
    return (round(max(t_bytes, t_ops), 5),
            "bytes" if t_bytes >= t_ops else "operations")


def run_attn(args, device: str, shapes=SHAPES, packed=PACKED,
             reps: int = REPS) -> dict:
    import torch
    import torch.nn.functional as F

    from ..ops import attention as attn

    dtype = torch.bfloat16 if device == "cuda" else torch.float32
    nh, hd = args.nh, args.hd
    scale = 1.0 / hd ** 0.5
    gen = torch.Generator().manual_seed(0)
    results = {}

    def qkv(b, s):
        return [torch.randn((b, s, nh, hd), generator=gen).to(device, dtype)
                for _ in range(3)]

    def time_all(calls, want_fn):
        row = {}
        with torch.inference_mode():
            want = want_fn().float()
            got = calls["kernel"]().float()
            row["max_abs_err"] = float((got - want).abs().max())
            for name, fn in calls.items():
                row[f"{name}_ms"] = round(common.event_ms(
                    fn, device, reps=reps)[0], 5)
        return row

    for b, s in shapes:
        q, k, v = qkv(b, s)
        lengths = torch.randint(s // 2, s + 1, (b,), generator=gen)
        valid = torch.arange(s)[None, :] < lengths[:, None]
        bias = torch.where(valid, 0.0, -1e9).to(device, torch.float32)
        sdpa_mask = bias[:, None, None, :].to(dtype)
        t = lambda x: x.transpose(1, 2)  # noqa: E731
        calls = {
            "kernel": lambda: attn.attention(q, k, v, bias, scale),
            "plain": lambda: attn.attention_plain(q, k, v, bias, scale),
            "sdpa": lambda: F.scaled_dot_product_attention(
                t(q), t(k), t(v), attn_mask=sdpa_mask, scale=scale),
        }
        row = time_all(calls,
                       lambda: attn.attention_plain(q, k, v, bias, scale))
        row["bound_ms"], row["bound_by"] = bound_ms(
            b, s, nh, hd, q.element_size(), 4)
        results[f"b={b},s={s}"] = row
        common.emit({"bench": NAME, f"b={b},s={s}": row})
    for b, s in packed:
        q, k, v = qkv(b, s)
        seg = torch.from_numpy(segment_ids(b, s, seed=b * s)).to(device)
        same = ((seg[:, :, None] == seg[:, None, :])
                & (seg[:, None, :] > 0))[:, None]
        t = lambda x: x.transpose(1, 2)  # noqa: E731
        calls = {
            "kernel": lambda: attn.segment_attention(q, k, v, seg, scale),
            "plain": lambda: attn.segment_attention_plain(
                q, k, v, seg, scale),
            "sdpa": lambda: F.scaled_dot_product_attention(
                t(q), t(k), t(v), attn_mask=same, scale=scale),
        }
        row = time_all(calls, lambda: attn.segment_attention_plain(
            q, k, v, seg, scale))
        row["bound_ms"], row["bound_by"] = bound_ms(
            b, s, nh, hd, q.element_size(), 4)
        results[f"seg b={b},s={s}"] = row
        common.emit({"bench": NAME, f"seg b={b},s={s}": row})
    return {
        "metric": "one attention op by implementation (ms per call)",
        "backend": device, "nh": nh, "hd": hd,
        "dtype": str(dtype).replace("torch.", ""),
        "timer": "cuda events" if device == "cuda" else "host clock",
        "results": results,
        **common.envelope(0),
    }


def _peak(fn, device: str, floor: int) -> dict:
    """Peak and temporary device bytes of one ``fn()`` call above
    ``floor`` (the inputs' bytes), by the allocator's high-water mark;
    null on the CPU."""
    import torch

    if device != "cuda":
        return {"peak_bytes": None, "temp_bytes": None}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base + floor
    outputs = sum(o.element_size() * o.nelement() for o in (
        out if isinstance(out, (list, tuple)) else [out]))
    del out
    return {"peak_bytes": int(peak),
            "temp_bytes": int(max(0, peak - floor - outputs))}


def ring_vs_dense_crossover(seqs, sp: int, b: int, nh: int, hd: int,
                            device: str, reps: int = 5,
                            trials: int = 3) -> tuple:
    """One attention op per sequence length, dense against the ring over
    ``sp`` shards: p50 ms per call and one call's device bytes.  Returns
    the per-length table, the first length at which the ring wins, and
    the ring's devices."""
    import torch

    from ..ops import attention as attn
    from ..parallel.ring import ring_attention
    from .scaling import mesh_devices

    dtype = torch.bfloat16 if device == "cuda" else torch.float32
    devices = mesh_devices(sp, device)
    gen = torch.Generator().manual_seed(0)
    scale = 1.0 / float(hd) ** 0.5
    rows, crossover = {}, None
    for s in seqs:
        if s % sp:
            continue
        q, k, v = (torch.randn((b, s, nh, hd), generator=gen).to(device,
                                                                 dtype)
                   for _ in range(3))
        bias = torch.zeros((b, s), dtype=torch.float32, device=device)
        loc = s // sp

        def split(x):
            return [x[:, i * loc:(i + 1) * loc].contiguous().to(d)
                    for i, d in enumerate(devices)]

        qs, ks, vs, bs = split(q), split(k), split(v), split(bias)

        def dense():
            return attn.attention(q, k, v, bias, scale)

        def ring():
            return ring_attention(qs, ks, vs, bs, scale)

        with torch.inference_mode():
            want = dense().float()
            got = torch.cat([x.float().to(device) for x in ring()], dim=1)
            err = float((got - want).abs().max())
            if err > 3e-2:  # the reference's bar (bf16 and f32 alike)
                raise RuntimeError(
                    f"s={s}: ring off dense attention by {err:.3g}")
            floor = 4 * q.element_size() * q.nelement()
            row_dense = _peak(dense, device, floor)
            row_dense["p50_ms"] = round(common.event_ms(
                dense, device, reps=reps, trials=trials)[0], 5)
            row_ring = _peak(ring, device, floor)
            row_ring["p50_ms"] = round(common.event_ms(
                ring, device, reps=reps, trials=trials)[0], 5)
        row_ring["max_abs_err"] = err
        rows[f"s={s}"] = {"dense": row_dense, f"ring_sp{sp}": row_ring}
        if crossover is None and row_ring["p50_ms"] < row_dense["p50_ms"]:
            crossover = s
        common.emit({"bench": NAME, f"s={s}": rows[f"s={s}"]})
    return rows, crossover, devices


def run_long_seq(args, device: str) -> dict:
    seqs = [int(x) for x in args.long_seqs.split(",") if x.strip()]
    rows, crossover, devices = ring_vs_dense_crossover(
        seqs, args.sp, args.long_b, args.long_nh, args.hd, device)
    cards = len(dict.fromkeys(str(d) for d in devices))
    return {
        "metric": ("ring-vs-dense attention crossover (p50 ms + per-call "
                   "peak device bytes per seq length)"),
        "backend": device, "sp": args.sp, "b": args.long_b,
        "nh": args.long_nh, "hd": args.hd,
        "crossover_seq": crossover,
        "cards": cards, "shared_card": cards < args.sp,
        "timer": "cuda events" if device == "cuda" else "host clock",
        "results": rows,
        **common.envelope(0),
    }


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="bench attn")
    p.add_argument("--nh", type=int, default=16)
    p.add_argument("--hd", type=int, default=64)
    p.add_argument("--long-seq", action="store_true",
                   help="the ring-vs-dense long-context crossover instead "
                   "of the per-shape table: p50 and peak bytes per "
                   "sequence length (--long-seqs), the ring over --sp "
                   "shards")
    p.add_argument("--long-seqs", default="256,512,1024,2048")
    p.add_argument("--sp", type=int, default=4)
    p.add_argument("--long-b", type=int, default=1)
    p.add_argument("--long-nh", type=int, default=4)
    common.add_device_flag(p)
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    base = {"metric": "attention by implementation"}
    device = common.select_device(NAME, args.device, base)
    if args.long_seq:
        return common.run(NAME, base,
                          lambda: common.emit(run_long_seq(args, device)))
    return common.run(NAME, base, lambda: common.emit(run_attn(args, device)))
