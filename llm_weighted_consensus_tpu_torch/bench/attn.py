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

``--long-seq`` (the ring against dense attention) is refused: the ring
serves (``parallel/ring.py``), but its bench waits for the rest of
ROADMAP.md queue 1 item 9.

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


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="bench attn")
    p.add_argument("--nh", type=int, default=16)
    p.add_argument("--hd", type=int, default=64)
    p.add_argument("--long-seq", action="store_true",
                   help="refused: the ring's bench waits for ROADMAP item 9")
    common.add_device_flag(p)
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    base = {"metric": "attention by implementation"}
    if args.long_seq:
        common.refuse(NAME, "--long-seq", common.ROADMAP_ITEM["mesh"], base,
                      "(the ring against dense attention over an sp mesh) "
                      "needs several cards")
    device = common.select_device(NAME, args.device, base)
    return common.run(NAME, base, lambda: common.emit(run_attn(args, device)))
