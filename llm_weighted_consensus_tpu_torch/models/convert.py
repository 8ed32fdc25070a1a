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

``jax_leaf_path`` is the inverse naming: a port state name -> the
reference tree's "/"-joined leaf path (and the layer it unstacks), from
the same tables, so the partition-rule tables of ``parallel/sharding.py``
match the port's tensors by the reference's paths.

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


_BERT_EMBED = {
    "token_embed": "embeddings.word_embeddings.weight",
    "position_embed": "embeddings.position_embeddings.weight",
    "type_embed": "embeddings.token_type_embeddings.weight",
}
_BERT_EMBED_LN = "embeddings.LayerNorm"
# a dense leaf's keys: JAX's on the left, the port's on the right
_DENSE_KEYS = {"kernel": "weight", "kernel_q": "weight_q", "scale": "scale",
               "bias": "bias"}
_LN_KEYS = {"scale": "weight", "bias": "bias"}


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
    state = {name: _f32(tree[leaf]) for leaf, name in _BERT_EMBED.items()}
    for key, port_key in _LN_KEYS.items():
        state[f"{_BERT_EMBED_LN}.{port_key}"] = _f32(tree["embed_ln"][key])
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


def jax_leaf_path(name: str) -> tuple:
    """A port state name (a ``BertEncoder``'s HF names or a
    ``DebertaModel``'s) -> (the reference tree's leaf path, the layer
    index it was unstacked from or None): ``"encoder.layer.3.attention.
    self.query.weight"`` -> ``("layers/attn_q/kernel", 3)``.  Raises on a
    name the conversion does not write."""
    for leaf, port in _BERT_EMBED.items():
        if name == port:
            return leaf, None
    head, _, key = name.rpartition(".")
    if head == _BERT_EMBED_LN and key in _LN_KEYS.values():
        return "embed_ln/" + _inverse(_LN_KEYS)[key], None
    if head in ("token_embed", "rel_embed") and key == "weight":
        return head, None
    if head in ("embed_ln", "rel_ln") and key in _LN_KEYS.values():
        return f"{head}/{_inverse(_LN_KEYS)[key]}", None
    if head in ("head_dense", "head_out") and key in _DENSE_KEYS.values():
        return f"{head}/{_inverse(_DENSE_KEYS)[key]}", None
    parts = head.split(".")
    if parts[:2] == ["encoder", "layer"] and len(parts) > 2:
        layer, module = int(parts[2]), ".".join(parts[3:])
        for jax_name, hf in _LAYER_DENSE.items():
            if module == hf and key in _DENSE_KEYS.values():
                return (f"layers/{jax_name}/{_inverse(_DENSE_KEYS)[key]}",
                        layer)
        for jax_name, hf in _LAYER_LN.items():
            if module == hf and key in _LN_KEYS.values():
                return f"layers/{jax_name}/{_inverse(_LN_KEYS)[key]}", layer
    if parts[0] == "layers" and len(parts) == 3:
        layer, module = int(parts[1]), parts[2]
        if module in _DEBERTA_DENSE and key in _DENSE_KEYS.values():
            return (f"layers/{module}/{_inverse(_DENSE_KEYS)[key]}", layer)
        if module in ("attn_ln", "mlp_ln") and key in _LN_KEYS.values():
            return f"layers/{module}/{_inverse(_LN_KEYS)[key]}", layer
    raise KeyError(f"{name!r} is not a tensor the conversion writes")


def _inverse(table: dict) -> dict:
    return {v: k for k, v in table.items()}
