"""Carry the JAX package's BERT parameters into the port.

``from_jax_params`` turns the reference's parameter pytree (already
converted to numpy by the caller) into the port's HF-named state dict,
so that both packages can run on the same weights:

* a JAX dense ``kernel`` is ``[in, out]``; torch ``Linear`` wants
  ``[out, in]``, so it is transposed;
* layer parameters are stacked on axis 0 for the reference's scanned
  layer body; they are unstacked per layer;
* LayerNorm ``scale`` becomes ``weight``;
* a quantized tree (``models/quant.py``'s ``quantize_bert_params`` or
  ``_int4``: ``kernel_q`` ``[L, K, N]`` int8 or ``[L, Kp/2, N]`` uint8,
  ``scale`` ``[L, N]``) keeps its bytes: ``kernel_q`` is unstacked and
  transposed into ``<name>.weight_q``, beside ``<name>.scale`` and
  ``<name>.bias`` in f32, which ``bert.from_hf_state_dict`` loads as
  ``quant.QuantLinear`` modules, so both packages compute from the same
  quantized weights.

This module reads numpy arrays only and imports nothing of JAX.
"""

from __future__ import annotations

import numpy as np

from .configs import BertConfig

_LAYER_DENSE = {
    "attn_q": "attention.self.query",
    "attn_k": "attention.self.key",
    "attn_v": "attention.self.value",
    "attn_out": "attention.output.dense",
    "mlp_in": "intermediate.dense",
    "mlp_out": "output.dense",
}
_LAYER_LN = {
    "attn_ln": "attention.output.LayerNorm",
    "mlp_ln": "output.LayerNorm",
}


def _f32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def from_jax_params(tree: dict, config: BertConfig) -> dict:
    """JAX BERT params (nested dict of arrays) -> {HF name: np.ndarray}."""
    state = {
        "embeddings.word_embeddings.weight": _f32(tree["token_embed"]),
        "embeddings.position_embeddings.weight": _f32(tree["position_embed"]),
        "embeddings.token_type_embeddings.weight": _f32(tree["type_embed"]),
        "embeddings.LayerNorm.weight": _f32(tree["embed_ln"]["scale"]),
        "embeddings.LayerNorm.bias": _f32(tree["embed_ln"]["bias"]),
    }
    layers = tree["layers"]
    for i in range(config.num_layers):
        base = f"encoder.layer.{i}"
        for jax_name, hf in _LAYER_DENSE.items():
            p = layers[jax_name]
            if "kernel_q" in p:
                kq = np.asarray(p["kernel_q"][i])
                if kq.dtype not in (np.int8, np.uint8):
                    raise TypeError(f"{jax_name}.kernel_q is {kq.dtype}")
                state[f"{base}.{hf}.weight_q"] = kq.T.copy()
                state[f"{base}.{hf}.scale"] = _f32(p["scale"][i])
            else:
                state[f"{base}.{hf}.weight"] = _f32(p["kernel"][i]).T.copy()
            state[f"{base}.{hf}.bias"] = _f32(p["bias"][i])
        for jax_name, hf in _LAYER_LN.items():
            p = layers[jax_name]
            state[f"{base}.{hf}.weight"] = _f32(p["scale"][i])
            state[f"{base}.{hf}.bias"] = _f32(p["bias"][i])
    return state
