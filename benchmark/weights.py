"""Seeded weights, made on the device as HF-named state dicts in the
type they are served in.

Every LayerNorm scale is 1 and every bias 0; every other tensor is
N(0, init_std), the configuration's ``init_std`` (its file says why).
All the normal tensors of a model come from ONE ``torch.randn`` over a
flat buffer on the device,
drawn by a ``torch.Generator`` seeded with ``--seed``, scaled in
float32 and rounded once to the serving type; the state dict's tensors
are views of that buffer.  The same seed gives the same weights on the
same kind of device."""

from __future__ import annotations

import torch

def bert_shapes(cfg: dict) -> list:
    """[(HF name, shape)] of a ``BertModel`` without its pooler."""
    h, i = cfg["hidden_size"], cfg["intermediate_size"]
    out = [("embeddings.word_embeddings.weight", (cfg["vocab_size"], h)),
           ("embeddings.position_embeddings.weight",
            (cfg["max_position_embeddings"], h)),
           ("embeddings.token_type_embeddings.weight",
            (cfg["type_vocab_size"], h)),
           ("embeddings.LayerNorm.weight", (h,)),
           ("embeddings.LayerNorm.bias", (h,))]
    for n in range(cfg["num_hidden_layers"]):
        p = f"encoder.layer.{n}"
        for name, rows, cols in (
                ("attention.self.query", h, h), ("attention.self.key", h, h),
                ("attention.self.value", h, h),
                ("attention.output.dense", h, h),
                ("intermediate.dense", i, h), ("output.dense", h, i)):
            out += [(f"{p}.{name}.weight", (rows, cols)),
                    (f"{p}.{name}.bias", (rows,))]
            if name in ("attention.output.dense", "output.dense"):
                ln = name.replace("dense", "LayerNorm")
                out += [(f"{p}.{ln}.weight", (h,)), (f"{p}.{ln}.bias", (h,))]
    return out


def deberta_shapes(cfg: dict) -> list:
    """[(HF name, shape)] of a ``DebertaV2ForSequenceClassification``
    with one label, its backbone unprefixed."""
    h, i = cfg["hidden_size"], cfg["intermediate_size"]
    span = cfg["position_buckets"]
    if span <= 0:
        span = cfg["max_relative_positions"]
        if span < 1:
            span = cfg["max_position_embeddings"]
    out = [("embeddings.word_embeddings.weight", (cfg["vocab_size"], h)),
           ("embeddings.LayerNorm.weight", (h,)),
           ("embeddings.LayerNorm.bias", (h,)),
           ("encoder.rel_embeddings.weight", (2 * span, h)),
           ("encoder.LayerNorm.weight", (h,)),
           ("encoder.LayerNorm.bias", (h,))]
    for n in range(cfg["num_hidden_layers"]):
        p = f"encoder.layer.{n}"
        for name, rows, cols in (
                ("attention.self.query_proj", h, h),
                ("attention.self.key_proj", h, h),
                ("attention.self.value_proj", h, h),
                ("attention.output.dense", h, h),
                ("intermediate.dense", i, h), ("output.dense", h, i)):
            out += [(f"{p}.{name}.weight", (rows, cols)),
                    (f"{p}.{name}.bias", (rows,))]
            if name in ("attention.output.dense", "output.dense"):
                ln = name.replace("dense", "LayerNorm")
                out += [(f"{p}.{ln}.weight", (h,)), (f"{p}.{ln}.bias", (h,))]
    out += [("pooler.dense.weight", (h, h)), ("pooler.dense.bias", (h,)),
            ("classifier.weight", (1, h)), ("classifier.bias", (1,))]
    return out


SHAPES = {"bert": bert_shapes, "deberta": deberta_shapes}


def _kind(name: str) -> str:
    if "LayerNorm" in name:
        return "one" if name.endswith("weight") else "zero"
    return "zero" if name.endswith("bias") else "normal"


def make_state(cfg: dict, seed: int, device, dtype) -> dict:
    """{HF name: tensor} on ``device`` in ``dtype``, from ``seed``."""
    shapes = SHAPES[cfg["family"]](cfg)
    sizes = {name: torch.Size(shape).numel() for name, shape in shapes}
    normal = [n for n, _ in shapes if _kind(n) == "normal"]
    total = sum(sizes[n] for n in normal)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32).mul_(cfg["init_std"]).to(dtype)
    fixed = torch.zeros(sum(sizes[n] for n, _ in shapes
                            if _kind(n) != "normal"),
                        device=device, dtype=dtype)
    state, at_normal, at_fixed = {}, 0, 0
    for name, shape in shapes:
        size = sizes[name]
        if _kind(name) == "normal":
            state[name] = flat[at_normal:at_normal + size].view(shape)
            at_normal += size
        else:
            view = fixed[at_fixed:at_fixed + size].view(shape)
            if _kind(name) == "one":
                view.fill_(1.0)
            state[name] = view
            at_fixed += size
    return state


def float32_copy(state: dict, device) -> dict:
    """The same weights widened to float32 on ``device`` (exact: every
    bf16 value is a float32 value)."""
    return {k: v.to(device=device, dtype=torch.float32)
            for k, v in state.items()}
