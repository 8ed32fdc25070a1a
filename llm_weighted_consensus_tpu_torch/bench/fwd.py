"""Forward breakdown: where the bge-large N=64, s=128 milliseconds go
(the counterpart of the reference's ``bench_fwd.py``).

Times ``bert.embed`` (the served forward: encoder, CLS pooling, L2
normalisation) on the card by CUDA events with each cost candidate
swapped out in turn, inside this bench only: the attention (the kernel
against its plain version; ``attention_impl="plain"`` also takes the
LayerNorm's and the GELU's plain versions), the GELU
(``layers.gelu_erf``: the kernel, tanh or identity) and the residual
add + LayerNorm (``bert.layer_norm``: the kernel, or the residual add
alone).  ``gelu_ln_share`` is the share of the forward that GELU and LayerNorm
together take (1 - both identity / real).  Random weights from seed 0,
random ids; on ``--device cpu`` the times are the host's (a rehearsal).

Run: ``python -m llm_weighted_consensus_tpu_torch.bench fwd [--model M]
[--b 64] [--seq 128]``.
"""

from __future__ import annotations

import argparse
import contextlib

import numpy as np

from . import common

NAME = "fwd"
# forwards per timed trial (3 trials, the median reported)
REPS = 10


@contextlib.contextmanager
def swapped(gelu=None, layer_norm=None):
    """``layers.gelu_erf`` and ``bert.layer_norm`` replaced for the block
    (the served path keeps no switch for either)."""
    from ..models import bert, layers

    saved = layers.gelu_erf, bert.layer_norm
    try:
        if gelu is not None:
            layers.gelu_erf = gelu
        if layer_norm is not None:
            bert.layer_norm = layer_norm
        yield
    finally:
        layers.gelu_erf, bert.layer_norm = saved


def run_fwd(args, device: str, reps: int = REPS) -> dict:
    import torch
    import torch.nn.functional as F

    from ..models import bert
    from ..models.configs import PRESETS

    config = PRESETS[args.model]
    model = bert.init_params(config, seed=0, device=device)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(
        0, config.vocab_size, (args.b, args.seq), dtype=np.int32)).to(device)
    mask = torch.ones((args.b, args.seq), dtype=torch.int32, device=device)

    def timed(impl="auto"):
        def call():
            bert.embed(model, ids, mask, pooling=config.pooling,
                       normalize=True, attention_impl=impl)

        with torch.inference_mode():
            ms, runs = common.event_ms(call, device, reps=reps)
        return round(ms, 4), runs

    out, runs = {}, {}
    out["attn=plain"], runs["attn=plain"] = timed("plain")
    out["attn=kernel"], runs["attn=kernel"] = timed()

    def gelu_tanh(x, plain=False, inplace=False):
        return F.gelu(x, approximate="tanh")

    def gelu_identity(x, plain=False, inplace=False):
        return x

    def ln_identity(x, w, b, eps, residual=None, plain=False):
        return x if residual is None else x + residual

    cases = {
        "gelu=tanh": dict(gelu=gelu_tanh),
        "gelu=identity": dict(gelu=gelu_identity),
        "ln=identity": dict(layer_norm=ln_identity),
        "gelu+ln=identity": dict(gelu=gelu_identity, layer_norm=ln_identity),
    }
    for key, swap in cases.items():
        with swapped(**swap):
            out[key], runs[key] = timed()
    full = out["attn=kernel"]
    return {
        "metric": (f"forward ms by swapped-out part, {args.model}, "
                   f"b={args.b}, s={args.seq}"),
        **out,
        "gelu_ln_share": round(1.0 - out["gelu+ln=identity"] / full, 4),
        "runs": runs,
        "timer": "cuda events" if device == "cuda" else "host clock",
        "model": args.model, "b": args.b, "seq": args.seq,
        "dtype": str(model.embeddings.word_embeddings.weight.dtype),
        "backend": device,
        **common.envelope(0),
    }


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="bench fwd")
    p.add_argument("--model", default="bge-large-en")
    p.add_argument("--b", type=int, default=64)
    p.add_argument("--seq", type=int, default=128)
    common.add_device_flag(p)
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    base = {"metric": "forward breakdown", "model": args.model}
    device = common.select_device(NAME, args.device, base)
    return common.run(NAME, base, lambda: common.emit(run_fwd(args, device)))
