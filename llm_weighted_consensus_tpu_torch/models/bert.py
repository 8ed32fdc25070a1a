"""BERT encoder (BGE class) in PyTorch.

Counterpart of ``llm_weighted_consensus_tpu/models/bert.py``:

* ``BertEncoder`` is an ``nn.Module`` tree named as HuggingFace's
  ``BertModel`` (``embeddings.word_embeddings``, ``encoder.layer.{i}.
  attention.self.query``, ...), so an HF state dict loads as it is: torch
  ``Linear`` keeps ``[out, in]`` and no transpose is needed;
* ``encode``, ``pool`` and ``embed`` are plain functions over it, with the
  reference's numerics: matmuls in the param dtype with f32
  accumulation, LayerNorm, GELU, softmax and pooling in f32, padding as
  a -1e9 additive key bias (never -inf);
* ``embed_packed`` / ``pool_segments`` are the packed layout's twins
  (``serve/packing.py``): many sequences per row, segment-masked
  attention, per-segment positions and one pooled vector per segment;
* attention goes through ``ops.attention.attention`` (padded) or
  ``segment_attention`` (packed), the residual add + LayerNorm and the
  GELU through ``ops.norm_act``: the CUDA kernels for tensors on the
  card, their plain versions on the CPU.  ``encode(...,
  attention_impl="plain")`` (and ``embed``'s) runs the plain versions of
  all three on either device: the trainers' differentiable path
  (``train/``), the counterpart of the reference's
  ``attention_impl="einsum"`` (in the trainers' f32 the two are one
  computation), since the kernels define no backward;
* the dense layers go through ``layers.dense_cfg`` / ``mlp_cfg``: a layer
  stack quantized by ``models.quant`` (``QuantLinear``) runs the W8A8 or
  W4A8 kernel for every dense layer, with the GELU in the MLP expansion's
  epilogue, and never reaches ``F.linear``.

The layer loop is a Python loop over ``encoder.layer``.  Each layer is a
generator (``_layer_steps``) that yields at its collectives, so one layer
body serves three callers:

* ``encode``: one device; nothing yields;
* the tensor-parallel layer (``embed_mesh`` / ``embed_packed_mesh`` over
  a ``parallel.sharding.MeshModel``): each tp shard holds nh/tp heads of
  the column-split q/k/v and MLP expansion and its K/tp rows of the
  row-split attention output and MLP contraction; a row-split layer
  yields its partial product in f32 (``"psum"`` over ``tp``), and gets
  back the sum, to which it adds the bias once and casts once.  Under
  int8 / int4 a shard first yields its rows' max |x| (``"pmax"``) and
  quantises its K/tp slice with the full row's scale, as the reference's
  row-split layout assumes.  LayerNorm and the residual are replicated;
* ``attention_impl="ring"`` (``parallel/ring.py``'s ``ring_encode``):
  the attention yields its shard's q/k/v and key bias (``"ring"`` over
  ``sp``) and gets back its rows' context from the ring; positions are
  offset per shard (``position_offset``).  Packed segment ids are refused
  there, as in the reference.

``parallel.collectives.run_lockstep`` drives the shards' generators
through their collectives.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..ops.attention import (
    attention,
    attention_plain,
    segment_attention,
    segment_attention_plain,
)
from . import quant
from .configs import BertConfig, position_base
from .layers import dense_cfg, layer_norm


class LayerNorm(nn.Module):
    """HF-named LayerNorm parameters applied with the one-pass
    ``layers.layer_norm``, to ``x`` or to ``x + residual`` in one pass
    (``plain``: the plain version on either device)."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor,
                residual: Optional[torch.Tensor] = None,
                plain: bool = False) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps, residual,
                          plain)


class BertEmbeddings(nn.Module):
    def __init__(self, config: BertConfig):
        super().__init__()
        h = config.hidden_size
        self.word_embeddings = nn.Embedding(config.vocab_size, h)
        self.position_embeddings = nn.Embedding(
            config.max_position_embeddings, h
        )
        self.token_type_embeddings = nn.Embedding(config.type_vocab_size, h)
        self.LayerNorm = LayerNorm(h, config.layer_norm_eps)


class BertSelfAttention(nn.Module):
    def __init__(self, config: BertConfig):
        super().__init__()
        h = config.hidden_size
        self.query = nn.Linear(h, h)
        self.key = nn.Linear(h, h)
        self.value = nn.Linear(h, h)


class BertDenseNorm(nn.Module):
    """A dense layer followed by the residual LayerNorm (HF's
    ``BertSelfOutput`` and ``BertOutput``)."""

    def __init__(self, in_dim: int, config: BertConfig):
        super().__init__()
        self.dense = nn.Linear(in_dim, config.hidden_size)
        self.LayerNorm = LayerNorm(config.hidden_size, config.layer_norm_eps)


class BertAttention(nn.Module):
    def __init__(self, config: BertConfig):
        super().__init__()
        self.self = BertSelfAttention(config)
        self.output = BertDenseNorm(config.hidden_size, config)


class BertIntermediate(nn.Module):
    def __init__(self, config: BertConfig):
        super().__init__()
        self.dense = nn.Linear(config.hidden_size, config.intermediate_size)


class BertLayer(nn.Module):
    def __init__(self, config: BertConfig):
        super().__init__()
        self.attention = BertAttention(config)
        self.intermediate = BertIntermediate(config)
        self.output = BertDenseNorm(config.intermediate_size, config)


class BertLayerStack(nn.Module):
    def __init__(self, config: BertConfig):
        super().__init__()
        self.layer = nn.ModuleList(
            BertLayer(config) for _ in range(config.num_layers)
        )


class BertEncoder(nn.Module):
    """Embeddings, the layer stack and the embedding LayerNorm, under
    HF ``BertModel`` parameter names (no pooler)."""

    def __init__(self, config: BertConfig):
        super().__init__()
        self.config = config
        self.embeddings = BertEmbeddings(config)
        self.encoder = BertLayerStack(config)

    def forward(self, input_ids, attention_mask, token_type_ids=None):
        return encode(self, input_ids, attention_mask, token_type_ids)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


# ``encode``'s attention choices: "auto" (the kernel on the card, its
# plain version on the CPU), "plain" (the plain version on either) and
# "ring" (sequence-parallel, driven across sp shards by
# ``parallel.ring.ring_encode``)
ATTENTION_IMPLS = ("auto", "plain", "ring")


def _row_dense(x, linear, tp: bool):
    """A row-split dense layer (generator): on one device the layer as it
    is held; under tp the shard's partial product in f32, summed over tp
    (``"psum"``), plus the bias once, one cast (module doc)."""
    if not tp:
        return dense_cfg(x, linear)
    if isinstance(linear, quant.QuantLinear):
        amax = torch.amax(torch.abs(x.float()), dim=-1)
        amax = yield ("pmax", "tp", amax)
        row_scale = quant.symmetric_scale(amax, 127.0)
        part = linear.partial(x, row_scale)
    else:
        part = torch.matmul(x.float(), linear.weight.float().t())
    total = yield ("psum", "tp", part)
    return (total + linear.bias.float()).to(x.dtype)


def _attention(x, p: BertAttention, key_mask, config: BertConfig,
               attention_impl: str = "auto", tp: bool = False):
    """(generator) ``key_mask`` is the f32 key bias[b, s] of the padded
    layout or the int32 segment ids[b, s] of the packed one.  The shard's
    heads are its q projection's width over the head dim (nh/tp under
    tp)."""
    b, s, _ = x.shape
    hd = config.head_dim
    sa = p.self
    q = dense_cfg(x, sa.query)
    nh = q.shape[-1] // hd
    q = q.view(b, s, nh, hd)
    k = dense_cfg(x, sa.key).view(b, s, nh, hd)
    v = dense_cfg(x, sa.value).view(b, s, nh, hd)
    scale = 1.0 / float(hd) ** 0.5
    if attention_impl == "ring":
        ctx = yield ("ring", "sp", (q, k, v, key_mask, scale))
    else:
        plain = attention_impl == "plain"
        if key_mask.dtype.is_floating_point:
            fn = attention_plain if plain else attention
        else:
            fn = segment_attention_plain if plain else segment_attention
        ctx = fn(q, k, v, key_mask, scale)
    return (yield from _row_dense(ctx.reshape(b, s, nh * hd),
                                  p.output.dense, tp))


def _layer_steps(x, layer: BertLayer, key_mask, config: BertConfig,
                 attention_impl: str = "auto", tp: bool = False):
    """One encoder layer (generator; module doc).  The residual adds go
    into the LayerNorms' one pass."""
    plain = attention_impl == "plain"
    attn = yield from _attention(x, layer.attention, key_mask, config,
                                 attention_impl, tp)
    x = layer.attention.output.LayerNorm(x, attn, plain=plain)
    inter = dense_cfg(x, layer.intermediate.dense, gelu=True, plain=plain)
    mlp = yield from _row_dense(inter, layer.output.dense, tp)
    return layer.output.LayerNorm(x, mlp, plain=plain)


def run_local(body):
    """Run an encoder generator that must not meet a collective (one
    device) to its value."""
    try:
        ask = next(body)
    except StopIteration as stop:
        return stop.value
    raise ValueError(
        f"a {ask[0]!r} collective over {ask[1]!r} runs across shards: "
        "attention_impl='ring' is driven by parallel.ring.ring_encode, a "
        "tensor-parallel layer by bert.embed_mesh"
    )


def check_positions(config: BertConfig, last: int, what: str) -> None:
    """Refuse, by name, a position index ``last`` (before the base) past
    the position table: an index past it would fail, or on the card read
    out of bounds."""
    base = position_base(config)
    if base + last >= config.max_position_embeddings:
        raise ValueError(
            f"{what} (position base {base}) exceeds "
            f"max_position_embeddings={config.max_position_embeddings}"
        )


def encode(
    model: BertEncoder,
    input_ids: torch.Tensor,
    attention_mask: Optional[torch.Tensor],
    token_type_ids: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
    positions: Optional[torch.Tensor] = None,
    attention_impl: str = "auto",
    positions_checked: bool = False,
    position_offset: int = 0,
) -> torch.Tensor:
    """input_ids[b, s], attention_mask[b, s] -> hidden[b, s, h] in the
    param dtype.  Positions are left-aligned from ``position_base``.
    ``attention_impl`` is ``"auto"`` (the kernel on the card, its plain
    version on the CPU) or ``"plain"`` (the plain version on either
    device: the differentiable path the trainers take).

    The packed layout passes int32 ``segment_ids[b, s]`` (0 = pad slot)
    and ``positions[b, s]`` (restarting at 0 in each segment) instead of
    the mask: every layer runs ``segment_attention`` and no [b, s, s]
    bias is built.  A packed row may be longer than the position table;
    each segment is bounded instead (``check_positions``).  That check
    runs here for positions on the CPU; on the card the caller makes it
    from its host copy before the upload (``TorchEmbedder.embed_packed``),
    so no device sync is added.  ``positions_checked=True`` says the
    caller bounded them already (the embedder does, on either device),
    so the dispatch reads no tensor on the host.

    ``position_offset`` starts the left-aligned positions that many
    places later (a ring shard's slice of the sequence).  The encoder is
    the generator ``encode_steps``; ``encode`` runs it on one device."""
    return run_local(encode_steps(
        model, input_ids, attention_mask, token_type_ids, segment_ids,
        positions, attention_impl, positions_checked, position_offset,
    ))


def encode_steps(
    model: BertEncoder,
    input_ids: torch.Tensor,
    attention_mask: Optional[torch.Tensor],
    token_type_ids: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
    positions: Optional[torch.Tensor] = None,
    attention_impl: str = "auto",
    positions_checked: bool = False,
    position_offset: int = 0,
    tp: bool = False,
):
    """``encode`` as a generator that yields at its collectives (module
    doc); ``tp`` marks a tensor-parallel shard."""
    if attention_impl not in ATTENTION_IMPLS:
        raise ValueError(
            f"attention_impl={attention_impl!r}: the port takes one of "
            f"{ATTENTION_IMPLS}"
        )
    if attention_impl == "ring" and segment_ids is not None:
        # the ring rotates k/v shards; a same-segment mask would need the
        # GLOBAL segment row on every shard
        raise ValueError("ring attention does not support packed segment_ids")
    config = model.config
    b, s = input_ids.shape
    base = position_base(config) + int(position_offset)
    if positions is None:
        check_positions(config, int(position_offset) + s - 1,
                        f"sequence {int(position_offset) + s}")
    elif (not positions_checked and positions.device.type == "cpu"
          and positions.numel()):
        last = int(positions.max())
        check_positions(config, last, f"a segment of {last + 1} tokens")
    emb = model.embeddings
    ids = input_ids.long()
    x = emb.word_embeddings.weight[ids]
    if positions is None:
        pos = torch.arange(base, base + s, device=ids.device)[None]
    else:
        pos = positions.long() + base
    x = x + emb.position_embeddings.weight[pos]
    if token_type_ids is None:
        token_type_ids = torch.zeros_like(ids)
    x = x + emb.token_type_embeddings.weight[token_type_ids.long()]
    x = emb.LayerNorm(x, plain=attention_impl == "plain")
    if segment_ids is not None:
        key_mask = segment_ids
    else:
        key_mask = torch.where(
            attention_mask > 0,
            torch.zeros((), dtype=torch.float32, device=ids.device),
            torch.full((), -1e9, dtype=torch.float32, device=ids.device),
        )
    for layer in model.encoder.layer:
        x = yield from _layer_steps(x, layer, key_mask, config,
                                    attention_impl, tp)
    return x


def pool(
    hidden: torch.Tensor,
    attention_mask: torch.Tensor,
    pooling: str = "cls",
    normalize: bool = True,
) -> torch.Tensor:
    """hidden[b, s, h] -> embedding[b, h] f32: CLS or masked mean, then
    L2 normalisation, all in f32."""
    if pooling == "cls":
        emb = hidden[:, 0, :].float()
    elif pooling == "mean":
        mask = attention_mask[:, :, None].float()
        emb = torch.sum(hidden.float() * mask, dim=1) / torch.clamp(
            torch.sum(mask, dim=1), min=1.0
        )
    else:
        raise ValueError(f"unknown pooling {pooling!r}")
    return _l2(emb) if normalize else emb


def _l2(emb: torch.Tensor) -> torch.Tensor:
    norm = torch.sqrt(torch.sum(emb * emb, dim=-1, keepdim=True))
    return emb / torch.clamp(norm, min=1e-12)


def pool_segments(
    hidden: torch.Tensor,
    segment_ids: torch.Tensor,
    seg_starts: torch.Tensor,
    pooling: str = "cls",
    normalize: bool = True,
) -> torch.Tensor:
    """hidden[b, s, h], segment_ids[b, s], seg_starts[b, k] ->
    embedding[b, k, h] f32: slot j of row b pools the tokens of segment
    j + 1.  CLS gathers the token at ``seg_starts`` (unused slots point at
    offset 0 and stay finite; nobody reads them); mean is the one-hot f32
    contraction over the segment's tokens divided by max(count, 1).  Then
    L2 normalisation, all in f32."""
    if pooling == "cls":
        emb = torch.take_along_dim(
            hidden, seg_starts.long()[:, :, None], dim=1
        ).float()
    elif pooling == "mean":
        k = seg_starts.shape[1]
        slots = torch.arange(1, k + 1, device=segment_ids.device)
        one_hot = (segment_ids[:, :, None] == slots).float()  # [b, s, k]
        emb = torch.einsum(
            "bsh,bsk->bkh", hidden.float(), one_hot
        ) / torch.clamp(one_hot.sum(dim=1), min=1.0)[:, :, None]
    else:
        raise ValueError(f"unknown pooling {pooling!r}")
    return _l2(emb) if normalize else emb


def embed(
    model: BertEncoder,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    pooling: str = "cls",
    normalize: bool = True,
    attention_impl: str = "auto",
) -> torch.Tensor:
    """ids -> pooled vectors [b, h] f32 (``attention_impl``: ``encode``'s)."""
    hidden = encode(model, input_ids, attention_mask,
                    attention_impl=attention_impl)
    return pool(hidden, attention_mask, pooling, normalize)


def embed_packed(
    model: BertEncoder,
    input_ids: torch.Tensor,
    segment_ids: torch.Tensor,
    positions: torch.Tensor,
    seg_starts: torch.Tensor,
    pooling: str = "cls",
    normalize: bool = True,
    positions_checked: bool = False,
) -> torch.Tensor:
    """The packed twin of ``embed``: ids/segment_ids/positions[b, s]
    int32, seg_starts[b, k] int32 -> one pooled vector per segment slot,
    [b, k, h] f32 (``positions_checked``: ``encode``'s)."""
    hidden = encode(
        model, input_ids, None, segment_ids=segment_ids, positions=positions,
        positions_checked=positions_checked,
    )
    return pool_segments(hidden, segment_ids, seg_starts, pooling, normalize)


# ---------------------------------------------------------------------------
# The mesh: dp rows, tensor-parallel shards
# ---------------------------------------------------------------------------


def _mesh_encode(placed, rows: dict, make_body) -> list:
    """Run ``make_body(shard module, its rows, tp)`` (an ``encode_steps``
    generator) for every (dp, tp) shard of ``placed`` (a
    ``parallel.sharding.MeshModel``) in lockstep.  ``rows`` are the
    dispatch's inputs, their batch a dp multiple: dp row d takes block d,
    moved to its shards' devices.  Returns, per dp row, tp shard 0's
    result (every tp shard holds the same hidden states after each
    reduce).  A mesh with an sp axis runs this dense path on its sp = 0
    shards: the reference replicates it over sp."""
    from ..parallel.collectives import run_lockstep

    mesh, tp = placed.mesh, placed.tp
    dp = mesh.shape["dp"]
    b = next(iter(rows.values())).shape[0]
    if b % dp:
        raise ValueError(f"batch {b} does not divide by dp={dp}")
    per = b // dp
    bodies, coords, devices = [], [], []
    for d in range(dp):
        for t in range(tp):
            device = mesh.device(dp=d, tp=t)
            part = {name: x[d * per:(d + 1) * per].to(device)
                    for name, x in rows.items()}
            bodies.append(make_body(placed.shard(t, device), part, tp > 1))
            coords.append({"dp": d, "tp": t})
            devices.append(device)
    out = run_lockstep(bodies, coords, {"tp": tp}, devices)
    return out[::tp]


def _gather_rows(parts: list, device) -> torch.Tensor:
    return torch.cat([p.to(device) for p in parts])


def embed_mesh_parts(placed, input_ids, attention_mask,
                     pooling: str = "cls", normalize: bool = True,
                     attention_impl: str = "auto") -> list:
    """``embed`` over a mesh, left sharded: ids/mask[b, s] (b a dp
    multiple) -> per dp row its pooled vectors [b/dp, h] f32 on its first
    tp shard's device; each dp row's layers tensor-parallel over its tp
    shards (``attention_impl``: ``encode``'s; the trainers take
    ``"plain"``)."""

    def body(model, part, tp):
        hidden = yield from encode_steps(
            model, part["ids"], part["mask"], attention_impl=attention_impl,
            tp=tp)
        return pool(hidden, part["mask"], pooling, normalize)

    return _mesh_encode(
        placed, {"ids": input_ids, "mask": attention_mask}, body)


def embed_mesh(placed, input_ids, attention_mask, pooling: str = "cls",
               normalize: bool = True,
               attention_impl: str = "auto") -> torch.Tensor:
    """``embed`` over a mesh: ids/mask[b, s] (b a dp multiple) -> pooled
    vectors [b, h] f32 on the mesh's first device; batch rows over dp,
    each dp row's layers tensor-parallel over its tp shards."""
    parts = embed_mesh_parts(placed, input_ids, attention_mask, pooling,
                             normalize, attention_impl)
    return _gather_rows(parts, placed.mesh.device())


def embed_packed_mesh(placed, input_ids, segment_ids, positions, seg_starts,
                      pooling: str = "cls", normalize: bool = True,
                      positions_checked: bool = False) -> torch.Tensor:
    """``embed_packed`` over a mesh: packed rows over dp (a dp multiple),
    layers tensor-parallel -> [b, k, h] f32 on the mesh's first device."""

    def body(model, part, tp):
        hidden = yield from encode_steps(
            model, part["ids"], None, segment_ids=part["seg"],
            positions=part["pos"], positions_checked=positions_checked,
            tp=tp)
        return pool_segments(hidden, part["seg"], part["starts"], pooling,
                             normalize)

    parts = _mesh_encode(
        placed, {"ids": input_ids, "seg": segment_ids, "pos": positions,
                 "starts": seg_starts}, body)
    return _gather_rows(parts, placed.mesh.device())


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def resolve_device(device=None) -> torch.device:
    """CUDA unless the caller asks for the CPU.  Asking for CUDA without a
    card raises; nothing falls back to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    return device


def default_dtype(device: torch.device) -> torch.dtype:
    """bf16 on the card, f32 on the CPU."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def build_from_state(
    cls, state: dict, config, dtype: Optional[torch.dtype], device
) -> nn.Module:
    """``cls(config)`` (``BertEncoder`` or ``deberta.DebertaModel``) on
    ``device`` (CUDA unless ``"cpu"``) in ``dtype`` (by default bf16 on
    CUDA, f32 on the CPU) whose every parameter is filled from ``state``
    ({parameter name: array}), gradients off.  Dense layers that ``state``
    carries quantized (``<name>.weight_q``, ``.scale``, ``.bias``) become
    ``quant.QuantLinear`` modules with those bytes."""
    device = resolve_device(device)
    dtype = dtype or default_dtype(device)
    with torch.device("meta"):
        model = cls(config)
    model = model.to_empty(device=device).to(dtype)
    quant.load_quantized(model, state, device)
    names = {name for name, _ in model.named_parameters()}
    missing = sorted(names - set(state))
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} tensors: {missing[:4]}")
    with torch.no_grad():
        for name, param in model.named_parameters():
            value = torch.tensor(np.asarray(state[name]))
            if tuple(value.shape) != tuple(param.shape):
                raise ValueError(
                    f"{name}: checkpoint shape {tuple(value.shape)} != "
                    f"{tuple(param.shape)}"
                )
            param.copy_(value.to(device=device, dtype=dtype))
    return model.requires_grad_(False).eval()


def trainable(cls, state: dict, config, device=None) -> nn.Module:
    """A model to train (``train/``): ``build_from_state`` in f32 with
    gradients on, in train mode, on CUDA unless ``device="cpu"``.  The
    trainers run it with ``attention_impl="plain"`` (the kernels define
    no backward: their wrappers refuse an input that requires grad).  A
    quantized ``state`` is refused: int8 and int4 weights cannot
    train."""
    if any(name.endswith(".weight_q") for name in state):
        raise ValueError("a quantized state cannot train")
    model = build_from_state(cls, state, config, torch.float32, device)
    return model.requires_grad_(True).train()


def random_state(cls, config, seed: int) -> dict:
    """{parameter name: array} of ``cls(config)`` from
    ``numpy.random.default_rng(seed)``, in parameter order: unit
    LayerNorm scales, zero biases, N(0, 0.02) for every other weight
    (the reference's distributions, not its values)."""
    rng = np.random.default_rng(seed)
    with torch.device("meta"):
        model = cls(config)
    norms = {
        f"{name}.weight" for name, m in model.named_modules()
        if isinstance(m, LayerNorm)
    }
    state = {}
    for name, p in model.named_parameters():
        shape = tuple(p.shape)
        if name in norms:
            state[name] = np.ones(shape, np.float32)
        elif name.endswith("bias"):
            state[name] = np.zeros(shape, np.float32)
        else:
            state[name] = rng.standard_normal(shape, dtype=np.float32) * 0.02
    return state


def init_params(
    config: BertConfig,
    seed: int = 0,
    dtype: Optional[torch.dtype] = None,
    device=None,
) -> BertEncoder:
    """Random init (``random_state``) on CUDA unless ``device="cpu"``."""
    return build_from_state(
        BertEncoder, random_state(BertEncoder, config, seed), config, dtype,
        device,
    )


def from_hf_state_dict(
    state_dict: dict,
    config: BertConfig,
    dtype: Optional[torch.dtype] = None,
    device=None,
) -> BertEncoder:
    """An HF BERT state dict ({name: array}, any ``bert.`` prefix already
    stripped) -> BertEncoder, on CUDA unless ``device="cpu"``.  The
    pooler and buffers such as ``embeddings.position_ids`` are
    ignored."""
    return build_from_state(BertEncoder, state_dict, config, dtype, device)
