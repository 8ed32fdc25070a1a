"""Carry the JAX package's BERT and DeBERTa parameters into the port.

``from_jax_params`` turns the reference's BERT parameter pytree (already
converted to numpy by the caller) into the port's HF-named state dict,
and ``from_jax_deberta_params`` its DeBERTa pytree into the state of
``deberta.DebertaModel`` (the reference's names), so that both packages
can run on the same weights:

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

from .configs import BertConfig, DebertaConfig

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


def _dense_into(state: dict, name: str, p: dict, i=None) -> None:
    """One JAX dense leaf (layer ``i`` of a stacked one) as ``name.*``:
    ``weight`` transposed, or a quantized leaf's bytes as ``weight_q``
    and ``scale``, and the bias."""
    pick = (lambda a: a) if i is None else (lambda a: a[i])
    if "kernel_q" in p:
        kq = np.asarray(pick(p["kernel_q"]))
        if kq.dtype not in (np.int8, np.uint8):
            raise TypeError(f"{name}.kernel_q is {kq.dtype}")
        state[f"{name}.weight_q"] = kq.T.copy()
        state[f"{name}.scale"] = _f32(pick(p["scale"]))
    else:
        state[f"{name}.weight"] = _f32(pick(p["kernel"])).T.copy()
    state[f"{name}.bias"] = _f32(pick(p["bias"]))


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
            _dense_into(state, f"{base}.{hf}", layers[jax_name], i)
        for jax_name, hf in _LAYER_LN.items():
            p = layers[jax_name]
            state[f"{base}.{hf}.weight"] = _f32(p["scale"][i])
            state[f"{base}.{hf}.bias"] = _f32(p["bias"][i])
    return state


_DEBERTA_DENSE = (
    "attn_q", "attn_k", "attn_v", "pos_q", "pos_k", "attn_out", "mlp_in",
    "mlp_out",
)


def from_jax_deberta_params(tree: dict, config: DebertaConfig) -> dict:
    """JAX DeBERTa params (``deberta.init_params`` / ``from_hf_weights`` /
    ``quantize_deberta_params`` trees, stacked ``layers``) -> {port name:
    np.ndarray} for ``deberta.from_state``."""
    state = {
        "token_embed.weight": _f32(tree["token_embed"]),
        "rel_embed.weight": _f32(tree["rel_embed"]),
    }
    for ln in ("embed_ln", "rel_ln"):
        state[f"{ln}.weight"] = _f32(tree[ln]["scale"])
        state[f"{ln}.bias"] = _f32(tree[ln]["bias"])
    layers = tree["layers"]
    for i in range(config.num_layers):
        for name in _DEBERTA_DENSE:
            _dense_into(state, f"layers.{i}.{name}", layers[name], i)
        for ln in ("attn_ln", "mlp_ln"):
            state[f"layers.{i}.{ln}.weight"] = _f32(layers[ln]["scale"][i])
            state[f"layers.{i}.{ln}.bias"] = _f32(layers[ln]["bias"][i])
    for name in ("head_dense", "head_out"):
        _dense_into(state, name, tree[name])
    return state
