"""What the family modules share: the one-buffer weight draw, the
float32 copies the port's loaders and the reference take, and the
attention bound of an encoder with one launch a layer."""

from __future__ import annotations

import torch

from benchmark import cost


def layer_norm_kind(name: str) -> str:
    """"one" for a LayerNorm scale, "zero" for a LayerNorm or other
    bias, "normal" for every other tensor."""
    if "LayerNorm" in name:
        return "one" if name.endswith("weight") else "zero"
    return "zero" if name.endswith("bias") else "normal"


def draw_in_one_buffer(shapes: list, kind, std: float, seed: int, device,
                       dtype) -> dict:
    """{HF name: tensor} on ``device`` in ``dtype`` from ``seed``.

    Every tensor that ``kind(name)`` calls "normal" is N(0, ``std``); all
    of them come from ONE ``torch.randn`` over a flat buffer on the
    device, drawn by a ``torch.Generator`` seeded with ``seed``, scaled
    in float32 and rounded once to ``dtype``; the others are 1 ("one") or
    0 ("zero").  The state dict's tensors are views of the two buffers.
    The same seed gives the same weights on the same kind of device."""
    sizes = {name: torch.Size(shape).numel() for name, shape in shapes}
    normal = [n for n, _ in shapes if kind(n) == "normal"]
    total = sum(sizes[n] for n in normal)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32).mul_(std).to(dtype)
    fixed = torch.zeros(sum(sizes[n] for n, _ in shapes
                            if kind(n) != "normal"),
                        device=device, dtype=dtype)
    state, at_normal, at_fixed = {}, 0, 0
    for name, shape in shapes:
        size = sizes[name]
        if kind(name) == "normal":
            state[name] = flat[at_normal:at_normal + size].view(shape)
            at_normal += size
        else:
            view = fixed[at_fixed:at_fixed + size].view(shape)
            if kind(name) == "one":
                view.fill_(1.0)
            state[name] = view
            at_fixed += size
    return state


def host_float32(state: dict) -> dict:
    """The state on the host in float32, for the port's loaders, which
    take host arrays: float32 holds every bf16 value exactly, and the
    loader casts back to the serving type."""
    return {k: v.detach().to("cpu", torch.float32) for k, v in state.items()}


def float32_copy(state: dict, device) -> dict:
    """The same weights widened to float32 on ``device`` (exact: every
    bf16 value is a float32 value)."""
    return {k: v.to(device=device, dtype=torch.float32)
            for k, v in state.items()}


def attention_per_layer(cfg: dict, rows: int, s: int) -> tuple:
    """(bound seconds, launches) of one dispatch's attention: one launch
    a layer over ``rows`` padded sequences of ``s`` tokens, the heads
    ``hidden_size // num_attention_heads`` wide."""
    heads = cfg["num_attention_heads"]
    head_dim = cfg["hidden_size"] // heads
    per = cost.bound_seconds(*cost.attention_launch(rows, s, heads,
                                                    head_dim))
    layers = cfg["num_hidden_layers"]
    return per * layers, layers
