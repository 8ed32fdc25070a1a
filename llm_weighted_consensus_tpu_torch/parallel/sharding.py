"""Sharding rules: batch over ``dp``, encoder tensor parallelism over
``tp``.

Counterpart of ``llm_weighted_consensus_tpu/parallel/sharding.py``.  The
rule tables are the reference's, verbatim, with each ``PartitionSpec``
written as a tuple (``P(None, "tp")`` is ``(None, "tp")``, ``P()`` is
``()``).  For the BERT encoder the tensor-parallel layout is the Megatron
split:

* attention q/k/v and the MLP expansion column-split over heads / the
  inner width (``(None, None, "tp")`` on the reference's ``[layer, in,
  out]`` kernels), their biases with them;
* the attention output and the MLP contraction row-split (``(None, "tp",
  None)``), their biases replicated and added once after the reduce;
* embeddings and LayerNorms replicated.

Leaf paths are the reference tree's: ``models.convert.jax_leaf_path``
names each port tensor by the leaf ``from_jax_params`` /
``from_jax_deberta_params`` fills it from, so one table serves both
packages.  A spec on a stacked ``[layer, ...]`` leaf drops its layer axis
for the port's per-layer tensor, and a kernel's spec turns with it (the
port's ``Linear`` weight is ``[out, in]``, the reference's kernel ``[in,
out]``).

``shard_by_rules`` places a model on a mesh: a ``MeshModel`` holds one
module per tp shard on each device of the mesh, its tensors sliced by
the table (a device that several shards share holds one copy).  A packed
int4 weight (``models.quant``'s split-K nibbles: each byte holds K rows
kk and kk + Kp/2) cannot be row-split by its bytes and keep K contiguous
per shard; it is unpacked, split along K and packed again per shard, so
shard t multiplies exactly its K/tp columns of x, as an int8 or bf16
shard does (the values are the reference's; only the packing is per
shard).

``shard_embedder_mesh`` wires a ``TorchEmbedder`` for the first-class
mesh (``MESH_ENABLED``), ``shard_embedder`` for the legacy
``MESH_DP``/``MESH_TP`` hooks and ``shard_reranker_mesh`` a
``TorchReranker`` (``parallel/ring.py`` has ``shard_embedder_sp`` for
``MESH_SP``).
"""

from __future__ import annotations

import copy
import re

import torch
from torch import nn

from ..models.convert import jax_leaf_path
from .mesh import Mesh


# Leading axis of every stacked layer param is the layer index (scanned) —
# shardings below apply to [layer, in, out] kernels / [layer, dim] biases.
_TP_LAYER_SPECS = {
    "attn_q": {"kernel": (None, None, "tp"), "bias": (None, "tp")},
    "attn_k": {"kernel": (None, None, "tp"), "bias": (None, "tp")},
    "attn_v": {"kernel": (None, None, "tp"), "bias": (None, "tp")},
    "attn_out": {"kernel": (None, "tp", None), "bias": (None,)},
    "attn_ln": {"scale": (None,), "bias": (None,)},
    "mlp_in": {"kernel": (None, None, "tp"), "bias": (None, "tp")},
    "mlp_out": {"kernel": (None, "tp", None), "bias": (None,)},
    "mlp_ln": {"scale": (None,), "bias": (None,)},
}


def _quantized_layer_specs() -> dict:
    """The int8 twin of _TP_LAYER_SPECS, derived mechanically: kernel_q
    shards like the full-precision kernel, the per-output-channel scale
    follows the kernel's OUT (last) axis, bias and LayerNorm leaves are
    unchanged.  Row-split dequantisation commutes with the tp reduce only
    when every shard uses the row's scale over the FULL K, so the port's
    row-split layer takes the row max across shards first
    (``models/bert.py``)."""
    out = {}
    for name, leaf in _TP_LAYER_SPECS.items():
        if "kernel" not in leaf:
            out[name] = dict(leaf)
            continue
        kspec = leaf["kernel"]
        out[name] = {
            "kernel_q": kspec,
            "scale": (None, kspec[-1]),  # [layer, out]: follows OUT
            "bias": leaf["bias"],
        }
    return out


_TP_LAYER_SPECS_Q = _quantized_layer_specs()


def bert_param_specs(tp: bool = True, quantized: bool = False) -> dict:
    """The spec tree of the reference's bert param layout."""
    base = _TP_LAYER_SPECS_Q if quantized else _TP_LAYER_SPECS
    layer = (
        base
        if tp
        else {
            name: {k: (None,) for k in leaf}
            for name, leaf in base.items()
        }
    )
    return {
        "token_embed": (),
        "position_embed": (),
        "type_embed": (),
        "embed_ln": {"scale": (), "bias": ()},
        "layers": layer,
    }


# --- partition-rule tables ---------------------------------------------------
#
# An ordered list of (name, anchored regex, spec) matched against the
# "/"-joined leaf path: every leaf matches EXACTLY one rule, and every rule
# at least one leaf.

_COL = ("attn_q", "attn_k", "attn_v", "mlp_in")
_ROW = ("attn_out", "mlp_out")


def _encoder_rules(quantized: bool = False) -> tuple:
    """Shared bert/deberta encoder-layer rules; ``quantized`` swaps the
    dense kernel leaf for the (kernel_q, scale) pair."""
    col = "|".join(_COL)
    row = "|".join(_ROW)
    kernel = "kernel_q" if quantized else "kernel"
    rules = [
        ("layer_col_kernel", rf"layers/({col})/{kernel}", (None, None, "tp")),
        ("layer_col_bias", rf"layers/({col})/bias", (None, "tp")),
        ("layer_row_kernel", rf"layers/({row})/{kernel}", (None, "tp", None)),
        ("layer_row_bias", rf"layers/({row})/bias", (None,)),
        ("layer_ln", r"layers/(attn_ln|mlp_ln)/(scale|bias)", (None,)),
    ]
    if quantized:
        rules[2:2] = [
            ("layer_col_scale", rf"layers/({col})/scale", (None, "tp")),
        ]
        rules[5:5] = [
            ("layer_row_scale", rf"layers/({row})/scale", (None, None)),
        ]
    return tuple(rules)


def bert_partition_rules(quantized: bool = False) -> tuple:
    """Ordered (name, regex, spec) rules for bert trees."""
    return (
        ("embed_tables", r"(token|position|type)_embed", ()),
        ("embed_ln", r"embed_ln/(scale|bias)", ()),
    ) + _encoder_rules(quantized=quantized)


def deberta_partition_rules(quantized: bool = False) -> tuple:
    """Rules for deberta trees: the bert encoder plus the disentangled
    position projections (column-split like q/k) and the reward head
    (dense column-split, scalar out row-split)."""
    return (
        ("embed_tables", r"(token|rel)_embed", ()),
        ("embed_ln", r"(embed|rel)_ln/(scale|bias)", ()),
        # pos_q/pos_k stay full-precision even in int8 trees
        ("pos_proj_kernel", r"layers/(pos_q|pos_k)/kernel", (None, None, "tp")),
        ("pos_proj_bias", r"layers/(pos_q|pos_k)/bias", (None, "tp")),
        ("head_dense_kernel", r"head_dense/kernel", (None, "tp")),
        ("head_dense_bias", r"head_dense/bias", ("tp",)),
        ("head_out_kernel", r"head_out/kernel", ("tp", None)),
        ("head_out_bias", r"head_out/bias", (None,)),
    ) + _encoder_rules(quantized=quantized)


def partition_rules_for(arch: str, quantized: bool = False) -> tuple:
    if arch == "bert":
        return bert_partition_rules(quantized=quantized)
    if arch == "deberta":
        return deberta_partition_rules(quantized=quantized)
    raise ValueError(f"no partition rules for arch {arch!r}")


def tree_path_leaves(model) -> list:
    """[(reference leaf path, port state name, tensor), ...] for every
    tensor of ``model`` (an ``nn.Module`` or a state dict)."""
    state = model.state_dict() if isinstance(model, nn.Module) else model
    return [(jax_leaf_path(name)[0], name, t) for name, t in state.items()]


def match_report(rules: tuple, model) -> tuple:
    """(leaf_matches, rule_counts): each reference leaf path -> the LIST
    of rules that match it (uncovered and ambiguous leaves both show),
    and each rule -> the leaf paths it matches (0 = a dead rule).  A
    stacked leaf counts once, as in the reference's tree."""
    leaf_matches: dict = {}
    rule_counts = {name: 0 for name, _, _ in rules}
    for path, _name, _t in tree_path_leaves(model):
        if path in leaf_matches:
            continue
        hits = [name for name, pattern, _ in rules
                if re.fullmatch(pattern, path)]
        leaf_matches[path] = hits
        for name in hits:
            rule_counts[name] += 1
    return leaf_matches, rule_counts


def match_partition_rules(rules: tuple, model) -> dict:
    """{port state name: the reference spec of its leaf}: the first
    matching rule wins, and a leaf no rule matches is an error."""
    out = {}
    for path, name, _t in tree_path_leaves(model):
        for _rule, pattern, spec in rules:
            if re.fullmatch(pattern, path):
                out[name] = spec
                break
        else:
            raise ValueError(f"no partition rule matches param leaf {path!r}")
    return out


def strip_tp(specs: dict) -> dict:
    """Replace the "tp" axis with None everywhere (the tp=1 layout)."""
    return {
        name: tuple(None if axis == "tp" else axis for axis in spec)
        for name, spec in specs.items()
    }


def port_axis(name: str, spec: tuple, ndim: int):
    """The axis of the port tensor ``name`` (``ndim`` dims) that ``spec``
    (its reference leaf's) splits over tp, or None: the layer axis of a
    stacked leaf drops, and a kernel's axes turn ([in, out] -> [out,
    in])."""
    path, layer = jax_leaf_path(name)
    axes = list(spec[1:] if layer is not None else spec)
    axes += [None] * (ndim - len(axes))
    if path.rpartition("/")[2] in ("kernel", "kernel_q"):
        axes = axes[::-1]
    return axes.index("tp") if "tp" in axes else None


class MeshModel:
    """A model placed on ``mesh`` by a rule table.  ``shard(t, device)``
    is tp shard t's module on ``device`` (every tensor of the table's
    split axes sliced to its t-th block, the rest whole); ``full(device)``
    the whole model there, for the ring (whose params the reference
    replicates).  ``tp`` is the split count (1 when ``tp=False`` or the
    mesh has no tp axis).

    A serving ``MeshModel`` holds each shard as a sliced copy, gradients
    off.  ``trainable=True`` (the trainers' mesh step) makes every shard
    tensor a differentiable slice of the master model's parameter instead
    (``narrow`` and ``to``, with autograd), so a backward pass through
    the shards lands in the master's ``.grad``: the dp replicas of one
    slice sum there, and one optimizer step updates the master.  Such a
    placement is built per step (its slices hold that step's graph)."""

    def __init__(self, model: nn.Module, mesh: Mesh, rules: tuple,
                 tp: bool = True, trainable: bool = False) -> None:
        self.model = model
        self.mesh = mesh
        self.trainable = bool(trainable)
        self.config = model.config
        self.tp = mesh.shape.get("tp", 1) if tp else 1
        specs = match_partition_rules(rules, model)
        self.specs = specs if self.tp > 1 else strip_tp(specs)
        if self.tp > 1:
            heads = getattr(self.config, "num_heads", 1)
            if heads % self.tp:
                raise ValueError(
                    f"tensor parallelism splits attention heads: "
                    f"num_heads={heads} does not divide by tp={self.tp}"
                )
        state = model.state_dict()
        self._axes = {
            name: port_axis(name, spec, state[name].ndim)
            for name, spec in self.specs.items()
        }
        self._shards: dict = {}
        self._full: dict = {}
        for index in zip(*(range(n) for n in mesh.devices.shape)):
            coords = dict(zip(mesh.axis_names, index))
            self.shard(coords.get("tp", 0) if self.tp > 1 else 0,
                       mesh.devices[index])

    def shard(self, t: int, device) -> nn.Module:
        key = (int(t), torch.device(device))
        module = self._shards.get(key)
        if module is None:
            module = self._slice(_Slicer(self._axes, self.tp, *key))
            self._shards[key] = module
        return module

    def _slice(self, slicer) -> nn.Module:
        if self.trainable:
            return _sliced(self.model, "", slicer, trainable=True)
        with torch.no_grad():
            return _sliced(self.model, "", slicer)

    def full(self, device) -> nn.Module:
        if self.tp == 1:
            return self.shard(0, device)
        device = torch.device(device)
        module = self._full.get(device)
        if module is None:
            module = self._slice(_Slicer(self._axes, 1, 0, device))
            self._full[device] = module
        return module


class _Slicer:
    """Shard t of ``tp``'s block of each tensor (by ``axes``, the split
    axis of each state name), on ``device``; ``tp=1`` keeps them whole."""

    def __init__(self, axes: dict, tp: int, t: int, device) -> None:
        self.axes = axes
        self.tp = tp
        self.t = t
        self.device = device

    def k_split(self, name: str) -> int:
        """How many ways the K (input) axis of the weight ``name`` is
        split: tp for a row-split weight, else 1."""
        axis = self.axes.get(name)
        return self.tp if axis == 1 else 1

    def __call__(self, name: str, x: torch.Tensor, k: int = 0):
        axis = self.axes.get(name)
        if axis is None or self.tp == 1:
            return x.to(self.device)
        if x.dtype == torch.uint8 and axis == 1:
            return _int4_rows(x, k, self.t, self.tp, name).to(self.device)
        size = x.shape[axis]
        if size % self.tp:
            raise ValueError(
                f"{jax_leaf_path(name)[0]}: axis of size {size} does "
                f"not divide by tp={self.tp}"
            )
        block = size // self.tp
        return x.narrow(axis, self.t * block, block).contiguous().to(
            self.device)


def _int4_rows(wq4: torch.Tensor, k: int, t: int, tp: int, name: str):
    """Shard t's K/tp input rows of a packed int4 weight ``[N, Kp/2]``
    holding ``k`` real rows, packed again on their own (module doc)."""
    from ..ops.kernels import pack_int4_weights, unpack_int4_weights

    if k % tp:
        raise ValueError(
            f"{jax_leaf_path(name)[0]}: K of {k} does not divide by tp={tp}"
        )
    block = k // tp
    q = unpack_int4_weights(wq4, k)
    return pack_int4_weights(q[:, t * block:(t + 1) * block].contiguous())


def _sliced(module: nn.Module, prefix: str, slice_,
            trainable: bool = False) -> nn.Module:
    """A shallow twin of ``module`` whose every parameter and buffer is
    ``slice_(state name, tensor)``, gradients off; ``Linear`` and
    ``QuantLinear`` sizes follow their new weights.  ``trainable`` keeps
    each parameter's slice attached to the master parameter's autograd
    graph (held as a plain tensor attribute of the twin, which reads as
    the parameter did)."""
    from ..models.quant import QuantLinear

    twin = copy.copy(module)
    params = {
        name: None if p is None
        else slice_(prefix + name, p if trainable else p.detach())
        for name, p in module._parameters.items()
    }
    if trainable:
        twin._parameters = {}
    else:
        twin._parameters = {
            name: None if p is None else nn.Parameter(p, requires_grad=False)
            for name, p in params.items()
        }
    k = getattr(module, "in_features", 0)
    twin._buffers = {
        name: None if b is None
        else (slice_(prefix + name, b, k) if name == "weight_q"
              else slice_(prefix + name, b))
        for name, b in module._buffers.items()
    }
    if trainable:
        twin._buffers.update(params)
    twin._modules = {
        name: None if child is None
        else _sliced(child, f"{prefix}{name}.", slice_, trainable)
        for name, child in module._modules.items()
    }
    if isinstance(twin, nn.Linear):
        twin.out_features, twin.in_features = twin.weight.shape
    elif isinstance(twin, QuantLinear):
        twin.out_features = twin.weight_q.shape[0]
        twin.in_features = (module.in_features
                            // slice_.k_split(prefix + "weight_q"))
    return twin


def shard_by_rules(model: nn.Module, mesh: Mesh, rules: tuple,
                   tp: bool = True, trainable: bool = False) -> MeshModel:
    """Place ``model`` on ``mesh`` by the rule table (tp split only when
    ``tp`` and the mesh's tp axis is past 1; ``trainable``: ``MeshModel``'s
    differentiable slices)."""
    return MeshModel(model, mesh, rules,
                     tp=tp and mesh.shape.get("tp", 1) > 1,
                     trainable=trainable)


def shard_bert_params(model: nn.Module, mesh: Mesh,
                      tp: bool = True) -> MeshModel:
    """A ``BertEncoder`` on ``mesh`` with the tensor-parallel layout."""
    from ..models.quant import is_quantized

    rules = bert_partition_rules(quantized=is_quantized(model))
    return shard_by_rules(model, mesh, rules, tp=tp)


def shard_embedder(embedder, mesh: Mesh, tp: bool = False) -> None:
    """The legacy ``MESH_DP``/``MESH_TP`` hooks: the embedder's model
    placed on ``mesh`` (replicated, or tp-split with ``tp``) and every
    dispatch padded to a dp multiple and split over ``dp``.  As in the
    reference, the hook path keeps no warmed buckets and no packing."""
    embedder.attach_mesh(shard_bert_params(embedder.model, mesh, tp=tp),
                         mesh_mode=False)


def shard_embedder_mesh(embedder, mesh: Mesh) -> None:
    """First-class mesh serving (``MESH_ENABLED``): the embedder's model
    placed once by the rule table (batch rows over ``dp``, encoder
    layers Megatron-split over ``tp``), dispatches keyed per mesh shape
    (``("mesh", dp, tp, ...)`` graph keys, ``@dp{dp}xtp{tp}`` labels),
    warmup and packing kept.  With an ``sp`` axis the dense path is
    unchanged (short traffic replicates over sp) and the embedder gains
    the ring dispatch: ``ring_available``, the ring token cap (the
    position window rounded down to an sp multiple), ``tokenize_ring``,
    ``embed_tokens_ring`` and ``consensus_confidence_tokens_ring``."""
    tp = mesh.shape.get("tp", 1)
    embedder.attach_mesh(shard_bert_params(embedder.model, mesh, tp=tp > 1),
                         mesh_mode=True)


def shard_reranker_mesh(reranker, mesh: Mesh) -> None:
    """A ``TorchReranker``'s DeBERTa params on the mesh by its rule table
    (``MESH_ENABLED``); its batch stays unsharded (a reward softmax
    normalises over one request's candidates)."""
    reranker.attach_mesh(mesh)
