"""Opt-in W8A8 and W4A8 quantization of the encoder's dense layers.

Counterpart of ``llm_weighted_consensus_tpu/models/quant.py``, with the
same scheme and mode strings (``configs.QUANT_MODES``):

* weights: per-output-channel symmetric int8 (``scale = max|W[o, :]| /
  127``) or int4 (``/ 7``, values in [-7, 7], packed two to a byte in the
  reference's split-K biased-nibble layout), quantized once at load;
* activations: per-row dynamic symmetric int8, inside the kernel's call;
* int32 accumulation, dequantized by ``sx * sw``, plus the bias.

The port's weight layout is the transpose of the JAX one: ``[out, in]``,
K contiguous per output channel, which is what the int8 GEMM's B operand
reads.  The int4 tensor is byte for byte ``pack_int4_weights(q).T`` of
the reference.

``QuantLinear`` holds one quantized dense layer; ``quantize_encoder``
swaps the six dense layers of every encoder layer (query, key, value,
attention output, MLP in and out) for it, and ``layers.dense_cfg`` /
``mlp_cfg`` route through it.  Embeddings, LayerNorm, attention and
pooling stay in the param dtype, as in the reference.  The same six
layers of the DeBERTa reward model (``attn_q`` ... ``mlp_out``) quantize
alike; its position projections ``pos_q`` / ``pos_k`` and its reward
head stay full precision (``DEBERTA_QUANT_DENSE``, ``dense_slots``).

Modes: ``int8``, ``int8-pallas`` and ``int4-pallas`` run the hand-written
kernels of ``csrc/quant_matmul.cu`` on the card and their plain versions
on the CPU.  ``int8-xla`` names the reference's XLA composition, which
the port does not have; it is refused, never served by another path.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
from torch import nn

from ..ops.kernels import (
    pack_int4_weights,
    quantize_rows_plain,
    symmetric_scale,
    w4a8_matmul,
    w8a8_matmul,
)
from .configs import QUANT_MODES

# the six dense layers of a BertLayer that quantize, by attribute path
QUANT_LAYER_DENSE = (
    "attention.self.query",
    "attention.self.key",
    "attention.self.value",
    "attention.output.dense",
    "intermediate.dense",
    "output.dense",
)
# the same six of a DeBERTa layer, by attribute
DEBERTA_QUANT_DENSE = (
    "attn_q", "attn_k", "attn_v", "attn_out", "mlp_in", "mlp_out",
)


def quantize_weight(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """weight[..., out, in] -> (int8 [..., out, in], f32 scale[..., out]).
    The reference's ``quantize_weight`` on the transposed layout."""
    w32 = weight.float()
    scale = symmetric_scale(torch.amax(torch.abs(w32), dim=-1), 127.0)
    q = torch.clamp(torch.round(w32 / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


# x[..., rows, in] -> (int8 x, f32 scale[..., rows]): the per-row dynamic
# activation quantisation of the kernels (the reference's _quantize_rows)
_quantize_rows = quantize_rows_plain


def quantize_weight_int4(
    weight: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """weight[..., out, in] -> (packed uint8 [..., out, Kp/2], f32
    scale[..., out]): per-output-channel symmetric int4 (max|W| / 7,
    clipped to [-7, 7]) in ``ops.kernels.pack_int4_weights``' layout."""
    w32 = weight.float()
    scale = symmetric_scale(torch.amax(torch.abs(w32), dim=-1), 7.0)
    q = torch.clamp(torch.round(w32 / scale[..., None]), -7, 7)
    return pack_int4_weights(q.to(torch.int8)), scale


class QuantLinear(nn.Module):
    """A quantized dense layer: buffers ``weight_q`` (int8 ``[out, in]``,
    or uint8 ``[out, Kp/2]`` packed int4), ``scale`` f32 ``[out]`` and
    ``bias`` f32 ``[out]`` (the param-dtype bias, widened exactly).

    ``scale`` and ``bias`` are the f32 operands of the kernel's epilogue
    and stay f32 whatever ``module.to(dtype)`` asks: ``_apply`` moves them
    with the weight's device only."""

    _F32_BUFFERS = ("scale", "bias")

    def __init__(
        self,
        weight_q: torch.Tensor,
        scale: torch.Tensor,
        bias: torch.Tensor,
        in_features: int,
    ):
        super().__init__()
        if weight_q.dtype not in (torch.int8, torch.uint8):
            raise TypeError(f"weight_q must be int8 or uint8, got {weight_q.dtype}")
        out = weight_q.shape[0]
        self.int4 = weight_q.dtype == torch.uint8
        self.in_features = int(in_features)
        self.out_features = int(out)
        width = weight_q.shape[1] * (2 if self.int4 else 1)
        if (width < in_features) if self.int4 else (width != in_features):
            raise ValueError(
                f"weight_q {tuple(weight_q.shape)} does not hold "
                f"in_features={in_features}"
            )
        for name, t in (("scale", scale), ("bias", bias)):
            if tuple(t.shape) != (out,):
                raise ValueError(f"{name} must be [{out}], got {tuple(t.shape)}")
        self.register_buffer("weight_q", weight_q.contiguous())
        self.register_buffer(
            "scale", scale.float().to(weight_q.device).contiguous()
        )
        self.register_buffer(
            "bias", bias.float().to(weight_q.device).contiguous()
        )

    @classmethod
    def from_linear(cls, linear: nn.Linear, int4: bool) -> "QuantLinear":
        """Quantize ``linear`` from its weights in their current dtype,
        widened to f32 first, as the reference quantizes its params."""
        fn = quantize_weight_int4 if int4 else quantize_weight
        weight_q, scale = fn(linear.weight.detach())
        return cls(weight_q, scale, linear.bias.detach(), linear.in_features)

    def _apply(self, fn, recurse=True):
        kept = {name: self._buffers.pop(name) for name in self._F32_BUFFERS}
        try:
            super()._apply(fn, recurse)
        finally:
            device = self._buffers["weight_q"].device
            for name, t in kept.items():
                self._buffers[name] = t.to(device=device)
        return self

    def forward(self, x: torch.Tensor, gelu: bool = False) -> torch.Tensor:
        matmul = w4a8_matmul if self.int4 else w8a8_matmul
        return matmul(x, self.weight_q, self.scale, self.bias, gelu=gelu)

    def partial(self, x: torch.Tensor,
                row_scale: torch.Tensor) -> torch.Tensor:
        """A row-split shard's share of this layer, in f32 and without
        the bias: x's rows quantised with ``row_scale`` (the full row's
        scale), the bias added once after the tp reduce
        (``models/bert.py``)."""
        matmul = w4a8_matmul if self.int4 else w8a8_matmul
        return matmul(x, self.weight_q, self.scale,
                      torch.zeros_like(self.bias), row_scale=row_scale)



def dense_slots(model):
    """(parent module, attribute, state name) of every dense layer a
    quantize mode replaces, for a ``bert.BertEncoder`` (HF names) or a
    ``deberta.DebertaModel`` (the reference's names)."""
    if hasattr(model, "encoder"):
        for i, layer in enumerate(model.encoder.layer):
            for path in QUANT_LAYER_DENSE:
                parent_path, _, leaf = path.rpartition(".")
                yield (layer.get_submodule(parent_path), leaf,
                       f"encoder.layer.{i}.{path}")
    else:
        for i, layer in enumerate(model.layers):
            for leaf in DEBERTA_QUANT_DENSE:
                yield layer, leaf, f"layers.{i}.{leaf}"


def _first_dense(model):
    parent, leaf, _ = next(dense_slots(model))
    return getattr(parent, leaf)


def is_quantized(model) -> bool:
    """Whether the encoder's layer stack carries quantized dense layers."""
    return isinstance(_first_dense(model), QuantLinear)


def is_int4(model) -> bool:
    """Whether the quantized layer stack holds packed int4 weights."""
    return is_quantized(model) and _first_dense(model).int4


def quantize_encoder(model, mode: str):
    """Replace the six dense layers of every encoder layer by
    ``QuantLinear`` (int4 for ``int4-*`` modes, else int8), in place, and
    stamp ``mode`` on ``model.config``.  Returns the model."""
    int4 = mode.startswith("int4")
    for parent, leaf, _ in list(dense_slots(model)):
        setattr(parent, leaf,
                QuantLinear.from_linear(getattr(parent, leaf), int4))
    model.config = dataclasses.replace(model.config, quantize=mode)
    return model


def load_quantized(model, state: dict, device: torch.device) -> set:
    """Replace each dense layer of the layer stack that ``state`` carries
    quantized (``<name>.weight_q``, ``.scale``, ``.bias``, as
    ``convert.from_jax_params`` writes them) by a ``QuantLinear`` on
    ``device``.  Returns the state names consumed."""
    used = set()
    modes = set()
    for parent, leaf, name in list(dense_slots(model)):
        if f"{name}.weight_q" not in state:
            continue
        tensors = [
            torch.from_numpy(np.array(state[f"{name}.{key}"])).to(device)
            for key in ("weight_q", "scale", "bias")
        ]
        q = QuantLinear(*tensors, getattr(parent, leaf).in_features)
        setattr(parent, leaf, q)
        modes.add("int4-pallas" if q.int4 else "int8")
        used.update(f"{name}.{key}" for key in ("weight_q", "scale", "bias"))
    if len(modes) > 1:
        raise ValueError("checkpoint mixes int8 and int4 dense layers")
    if modes and model.config.quantize == "none":
        model.config = dataclasses.replace(model.config, quantize=modes.pop())
    return used


def resolve_quantize(model, config, quantize: str):
    """The one quantize-mode entry point for the embedder and the
    reranker: validates the mode, quantizes a full-precision model (a
    ``BertEncoder`` or a ``DebertaModel``) in place, from its weights in
    their current dtype, and returns ``config`` (by default the model's)
    stamped with the mode.  A model that is already quantized passes
    through if its layout agrees with the mode."""
    if quantize not in QUANT_MODES:
        raise ValueError(
            f"quantize={quantize!r}: expected one of {', '.join(QUANT_MODES)}"
        )
    if quantize == "int8-xla":
        raise ValueError(
            "quantize='int8-xla' pins the reference's XLA int8 composition, "
            "which the PyTorch port does not have; use 'int8' (the W8A8 "
            "kernel on the card, its plain version on the CPU)"
        )
    config = config or model.config
    if quantize == "none":
        return config
    want_int4 = quantize.startswith("int4")
    if is_quantized(model):
        if is_int4(model) != want_int4:
            raise ValueError(
                f"quantize={quantize!r} but the model carries the "
                f"{'int4' if is_int4(model) else 'int8'} layout; load "
                "full-precision weights to switch schemes"
            )
    else:
        quantize_encoder(model, quantize)
    config = dataclasses.replace(config, quantize=quantize)
    model.config = dataclasses.replace(model.config, quantize=quantize)
    return config
