"""DeBERTa-style encoder and scalar reward head (reward-model re-ranking)
in PyTorch.

Counterpart of ``llm_weighted_consensus_tpu/models/deberta.py``.  The
difference from BERT is disentangled attention: no absolute position
embeddings; every layer adds content->position and position->content
terms against a shared relative-position table:

    score(i, j) = q_c[i]·k_c[j] + q_c[i]·k_r[d(i,j)] + k_c[j]·q_r[d(i,j)]

scaled by 1/sqrt(3 * head_dim), with d(i, j) the bucketed relative
distance (``rel_index``: log buckets for v3 checkpoints, clamped
otherwise).  The reward head is HF's ``ContextPooler`` and a one-logit
classifier: CLS state -> dense -> exact-erf GELU -> dense(1), in f32.

``DebertaModel`` is an ``nn.Module`` under the reference's parameter
names (``token_embed``, ``layers.{i}.attn_q``, ``pos_q``, ...).
``from_hf_weights`` maps a ``DebertaV2ForSequenceClassification`` (or
encoder-only) state dict onto it; ``convert.from_jax_deberta_params``
maps the reference's pytree.

Numerics kept from the reference, where a natural torch choice differs:

* ``rel_index`` computes the log buckets in f32 (an f64 or reordered
  expression can move a bucket at an exact boundary), on the host;
* the three score tensors (c2c, c2p, p2c) are stored in the activation
  dtype and summed, scaled by 1/sqrt(3 hd) rounded to that dtype and
  added to the -1e9 mask bias in that dtype; softmax runs in f32 and is
  cast back; P·V accumulates in f32 and is cast;
* p2c gathers ``k_c · q_r`` by the transposed index, then swaps the last
  two axes;
* the position projections ``pos_q`` / ``pos_k`` are their own
  full-precision Linears (HF's ``share_att_key`` copies the content
  weights into them at load; they never alias ``attn_q`` / ``attn_k``, so
  quantizing the content path leaves them as they are);
* the six content and MLP dense layers go through ``layers.dense_cfg`` /
  ``mlp_cfg``: ``F.linear`` in the param dtype, or the W8A8 / W4A8
  kernels of ``ops.kernels`` once ``models.quant`` has replaced them.

The disentangled attention itself is einsums and gathers, as the
reference leaves it to XLA: it is not a TPU kernel of the reference.
"""

from __future__ import annotations

import functools
import threading
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .bert import LayerNorm, _row_dense, build_from_state, random_state
from .bert import run_local
from .configs import DebertaConfig
from ..ops.norm_act import gelu_f32
from .layers import dense, dense_cfg

MASK_FILL = -1e9


class DebertaLayer(nn.Module):
    def __init__(self, config: DebertaConfig):
        super().__init__()
        h, i, eps = (config.hidden_size, config.intermediate_size,
                     config.layer_norm_eps)
        self.attn_q = nn.Linear(h, h)
        self.attn_k = nn.Linear(h, h)
        self.attn_v = nn.Linear(h, h)
        self.pos_q = nn.Linear(h, h)
        self.pos_k = nn.Linear(h, h)
        self.attn_out = nn.Linear(h, h)
        self.attn_ln = LayerNorm(h, eps)
        self.mlp_in = nn.Linear(h, i)
        self.mlp_out = nn.Linear(i, h)
        self.mlp_ln = LayerNorm(h, eps)


class DebertaModel(nn.Module):
    """Token embeddings, the shared relative table, the layer stack and
    the reward head, under the reference's parameter names."""

    def __init__(self, config: DebertaConfig):
        super().__init__()
        h, eps = config.hidden_size, config.layer_norm_eps
        self.config = config
        self.token_embed = nn.Embedding(config.vocab_size, h)
        self.embed_ln = LayerNorm(h, eps)
        self.rel_embed = nn.Embedding(2 * config.att_span, h)
        self.rel_ln = LayerNorm(h, eps)
        self.layers = nn.ModuleList(
            DebertaLayer(config) for _ in range(config.num_layers)
        )
        self.head_dense = nn.Linear(h, h)
        self.head_out = nn.Linear(h, 1)
        # rel_index tables on the device, by (seq, device)
        self._rel_cache = {}
        self._rel_lock = threading.Lock()

    def rel_index_on(self, seq: int, device) -> torch.Tensor:
        """``rel_index(seq, config)`` on ``device``, computed once on the
        host and kept."""
        key = (seq, str(device))
        with self._rel_lock:
            table = self._rel_cache.get(key)
            if table is None:
                table = rel_index(seq, self.config).to(device)
                self._rel_cache[key] = table
        return table


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def rel_index(seq: int, config: DebertaConfig) -> torch.Tensor:
    """[seq, seq] int64 relative-table indices in [0, 2 * att_span), on
    the CPU.

    ``position_buckets > 0``: HF ``make_log_bucket_position``, distances
    within +-buckets/2 index exactly, farther ones land in log-spaced
    buckets out to ``max_relative_positions``; otherwise a plain clamp.
    The log buckets are computed in f32 in the reference's order of
    operations, so every boundary lands where the reference's does.
    Entry (i, j) depends only on i - j."""
    span = config.att_span
    pos = torch.arange(seq, dtype=torch.int32)
    rel = pos[:, None] - pos[None, :]
    if config.position_buckets > 0:
        mid = config.position_buckets // 2
        abs_pos = torch.where(
            (rel < mid) & (rel > -mid),
            torch.tensor(mid - 1, dtype=torch.int32),
            torch.abs(rel),
        ).to(torch.float32)
        # the reference's jnp.log of a Python float is an f32 log of the
        # f32-rounded value
        denom = torch.log(torch.tensor(
            (config.max_relative_positions - 1) / mid, dtype=torch.float32
        ))
        log_pos = (
            torch.ceil(torch.log(abs_pos / mid) / denom * (mid - 1)) + mid
        )
        rel = torch.where(
            torch.abs(rel) <= mid,
            rel,
            (log_pos * torch.sign(rel)).to(torch.int32),
        )
    return (torch.clamp(rel, -span, span - 1) + span).long()


@functools.lru_cache(maxsize=None)
def _score_scale(hd: int, dtype: torch.dtype) -> float:
    """1/sqrt(3 hd) rounded to ``dtype``, once per (hd, dtype): a host
    constant, so no dispatch reads a tensor for it."""
    return torch.tensor(1.0 / float(3 * hd) ** 0.5, dtype=dtype).item()


def _disentangled_attention(x, rel, layer: DebertaLayer, mask_bias,
                            rel_idx, config: DebertaConfig, tp: bool = False):
    """(generator, as ``bert``'s layers: it yields at a tensor-parallel
    shard's collectives) The shard's heads are its q projection's width
    over the head dim (nh/tp under tp); its position projections are
    split with them."""
    b, s, _ = x.shape
    hd = config.head_dim
    k = config.att_span

    q_c = dense_cfg(x, layer.attn_q)
    nh = q_c.shape[-1] // hd
    q_c = q_c.view(b, s, nh, hd)
    k_c = dense_cfg(x, layer.attn_k).view(b, s, nh, hd)
    v = dense_cfg(x, layer.attn_v).view(b, s, nh, hd)
    # the relative projections of the shared table, [2k, nh, hd]: always
    # full precision, one small matmul per layer
    q_r = dense(rel, layer.pos_q.weight, layer.pos_q.bias).view(2 * k, nh, hd)
    k_r = dense(rel, layer.pos_k.weight, layer.pos_k.bias).view(2 * k, nh, hd)

    # each score tensor is one matmul with f32 accumulation, rounded once
    # to the activation dtype, as the reference's preferred_element_type
    c2c = torch.einsum("bqnd,bknd->bnqk", q_c, k_c)
    # content -> position: q_c against every bucket, then gathered per
    # (i, j); the index is broadcast by expand, never copied
    index = rel_idx.view(1, 1, s, s).expand(b, nh, s, s)
    c2p = torch.gather(torch.einsum("bqnd,rnd->bnqr", q_c, k_r), -1, index)
    # position -> content: k_c against every bucket, gathered by the
    # transposed index, then [k, q] swapped to [q, k]
    p2c = torch.gather(
        torch.einsum("bknd,rnd->bnkr", k_c, q_r), -1, index.transpose(-1, -2)
    ).transpose(-1, -2)

    # the sum stays in x.dtype, scaled and biased in it: the reference's
    # Python-float scale is a weakly typed constant of the activation
    # dtype, so its value is 1/sqrt(3 hd) rounded to that dtype (torch
    # would scale by the f32 value before the one rounding)
    scale = _score_scale(hd, x.dtype)
    logits = (c2c + c2p + p2c) * scale + mask_bias.to(x.dtype)
    probs = torch.softmax(logits.float(), dim=-1).to(x.dtype)
    ctx = torch.einsum("bnqk,bknd->bqnd", probs, v)
    return (yield from _row_dense(ctx.reshape(b, s, nh * hd), layer.attn_out,
                                  tp))


def encode(
    model: DebertaModel,
    input_ids: torch.Tensor,
    attention_mask: Optional[torch.Tensor],
    segment_ids: Optional[torch.Tensor] = None,
    plain: bool = False,
) -> torch.Tensor:
    """input_ids[b, s], attention_mask[b, s] -> hidden[b, s, h] in the
    param dtype.

    ``segment_ids[b, s]`` (int32, 0 = pad slot) switches the mask to the
    packed same-segment form: query i sees key j iff both lie in the same
    segment (id > 0).  There are no absolute positions, and a segment is
    a contiguous span of its row, so its relative distances are those of
    the padded forward; the mask removes every cross-segment term.
    Masked logits are -1e9, never -inf, so a row past its segments stays
    finite.  ``plain=True`` runs the LayerNorms and the GELU in their
    plain versions on either device (``ops.norm_act``): the trainers'
    differentiable path.  The encoder is the generator ``encode_steps``."""
    return run_local(encode_steps(model, input_ids, attention_mask,
                                  segment_ids, plain=plain))


def encode_steps(model: DebertaModel, input_ids, attention_mask,
                 segment_ids=None, tp: bool = False, plain: bool = False):
    """``encode`` as a generator that yields at its collectives; ``tp``
    marks a tensor-parallel shard (``reward_mesh``)."""
    config = model.config
    s = input_ids.shape[1]
    x = model.token_embed.weight[input_ids.long()]
    x = model.embed_ln(x, plain=plain)
    rel = model.rel_ln(model.rel_embed.weight, plain=plain)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    fill = torch.full((), MASK_FILL, dtype=torch.float32, device=x.device)
    if segment_ids is None:
        mask_bias = torch.where(attention_mask[:, None, None, :] > 0, zero, fill)
    else:
        seg = segment_ids.int()
        same = (seg[:, :, None] == seg[:, None, :]) & (seg[:, None, :] > 0)
        mask_bias = torch.where(same, zero, fill)[:, None]
    rel_idx = model.rel_index_on(s, x.device)
    for layer in model.layers:
        attn = yield from _disentangled_attention(
            x, rel, layer, mask_bias, rel_idx, config, tp)
        y = layer.attn_ln(x, attn, plain=plain)
        inter = dense_cfg(y, layer.mlp_in, gelu=True, plain=plain)
        mlp = yield from _row_dense(inter, layer.mlp_out, tp)
        x = layer.mlp_ln(y, mlp, plain=plain)
    return x


def _head(model: DebertaModel, cls: torch.Tensor) -> torch.Tensor:
    """CLS states [..., h] f32 -> rewards [...] f32: ``head_dense`` in f32
    (the param-dtype weights widened), exact erf GELU, ``head_out``."""
    return run_local(_head_steps(model, cls))


def _head_steps(model: DebertaModel, cls: torch.Tensor, tp: bool = False):
    """``_head`` as a generator: under tp ``head_dense`` is column-split
    and ``head_out`` row-split, its partial sums reduced (``"psum"``) and
    its bias added once."""
    hd, ho = model.head_dense, model.head_out
    z = F.linear(cls, hd.weight.float(), hd.bias.float())
    z = gelu_f32(z, approx=False)
    if not tp:
        return F.linear(z, ho.weight.float(), ho.bias.float())[..., 0]
    total = yield ("psum", "tp", F.linear(z, ho.weight.float()))
    return (total + ho.bias.float())[..., 0]


def reward(
    model: DebertaModel,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    plain: bool = False,
) -> torch.Tensor:
    """(prompt ++ candidate) token batch -> one scalar reward per row,
    [b] f32 (``plain``: ``encode``'s)."""
    hidden = encode(model, input_ids, attention_mask, plain=plain)
    return _head(model, hidden[:, 0, :].float())


def reward_packed(
    model: DebertaModel,
    input_ids: torch.Tensor,
    segment_ids: torch.Tensor,
    seg_starts: torch.Tensor,
) -> torch.Tensor:
    """The packed twin of ``reward``: ids/segment_ids[b, s] and
    seg_starts[b, k] (``serve.packing.build_calls``) -> one reward per
    segment slot, [b, k] f32.  A slot's CLS is its segment's first
    token; unused slots point at offset 0 and nobody reads them."""
    attention_mask = (segment_ids > 0).int()
    hidden = encode(model, input_ids, attention_mask, segment_ids=segment_ids)
    cls = torch.take_along_dim(
        hidden, seg_starts.long()[:, :, None], dim=1
    ).float()
    return _head(model, cls)


def _reward_mesh(placed, arrays: dict, body_of) -> torch.Tensor:
    """Run ``body_of(shard module, its inputs)`` on the tp shards of the
    mesh's first dp row in lockstep: the batch is not split (a reward
    softmax normalises over one request's candidates)."""
    from ..parallel.collectives import run_lockstep

    mesh, tp = placed.mesh, placed.tp
    devices = [mesh.device(tp=t) for t in range(tp)]
    bodies = [
        body_of(placed.shard(t, device),
                {k: v.to(device) for k, v in arrays.items()})
        for t, device in enumerate(devices)
    ]
    out = run_lockstep(bodies, [{"tp": t} for t in range(tp)], {"tp": tp},
                       devices)
    return out[0].to(mesh.device())


def reward_mesh(placed, input_ids, attention_mask) -> torch.Tensor:
    """``reward`` with the layers and the head tensor-parallel over a
    ``parallel.sharding.MeshModel``'s tp shards -> [b] f32."""

    def body(model, a):
        hidden = yield from encode_steps(model, a["ids"], a["mask"],
                                         tp=True)
        return (yield from _head_steps(model, hidden[:, 0, :].float(),
                                       tp=True))

    return _reward_mesh(placed, {"ids": input_ids, "mask": attention_mask},
                        body)


def reward_consensus_vote(
    rewards: torch.Tensor, temperature: float = 1.0
) -> torch.Tensor:
    """rewards[N] -> confidence[N] = softmax(reward / T) in f32."""
    return torch.softmax(rewards.float() / temperature, dim=-1)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def from_state(
    state: dict,
    config: DebertaConfig,
    dtype: Optional[torch.dtype] = None,
    device=None,
) -> DebertaModel:
    """A DebertaModel filled from ``state`` ({port name: array}) by
    ``bert.build_from_state``: on CUDA unless ``device="cpu"``, bf16 on
    CUDA and f32 on the CPU unless ``dtype``; quantized dense layers in
    ``state`` load as ``quant.QuantLinear``."""
    return build_from_state(DebertaModel, state, config, dtype, device)


def init_params(
    config: DebertaConfig,
    seed: int = 0,
    dtype: Optional[torch.dtype] = None,
    device=None,
) -> DebertaModel:
    """Random init (``bert.random_state``), on CUDA unless
    ``device="cpu"``."""
    return from_state(random_state(DebertaModel, config, seed), config,
                      dtype, device)


_HF_LAYER_DENSE = {
    "attn_q": "attention.self.query_proj",
    "attn_k": "attention.self.key_proj",
    "attn_v": "attention.self.value_proj",
    # share_att_key: the position attention reuses the content q/k
    "pos_q": "attention.self.query_proj",
    "pos_k": "attention.self.key_proj",
    "attn_out": "attention.output.dense",
    "mlp_in": "intermediate.dense",
    "mlp_out": "output.dense",
}
_HF_LAYER_LN = {
    "attn_ln": "attention.output.LayerNorm",
    "mlp_ln": "output.LayerNorm",
}


def hf_to_state(state_dict: dict, config: DebertaConfig) -> dict:
    """An HF DeBERTa-v2/v3 state dict ({name: array}, any ``deberta.``
    prefix stripped) -> {port name: np.ndarray}.

    ``pooler.dense`` and ``classifier`` (``DebertaV2ForSequenceClassification``
    reward models) become ``head_dense`` / ``head_out``; an encoder-only
    checkpoint gets a random-init head from seed 0.  v3 shares the
    content projections with the position attention (``share_att_key``),
    so ``pos_q`` / ``pos_k`` load copies of ``query_proj`` / ``key_proj``.
    """

    def get(name):
        return np.asarray(state_dict[name], dtype=np.float32)

    rel = get("encoder.rel_embeddings.weight")
    want_rows = 2 * config.att_span
    if rel.shape[0] != want_rows:
        raise ValueError(
            f"rel_embeddings has {rel.shape[0]} rows; config expects "
            f"{want_rows} (2 x att_span) — set position_buckets="
            f"{rel.shape[0] // 2} (v3 log-bucketed checkpoints) or "
            f"max_relative_positions={rel.shape[0] // 2} with "
            "position_buckets=0 (clamp scheme)"
        )
    state = {
        "token_embed.weight": get("embeddings.word_embeddings.weight"),
        "embed_ln.weight": get("embeddings.LayerNorm.weight"),
        "embed_ln.bias": get("embeddings.LayerNorm.bias"),
        "rel_embed.weight": rel,
        "rel_ln.weight": get("encoder.LayerNorm.weight"),
        "rel_ln.bias": get("encoder.LayerNorm.bias"),
    }
    for i in range(config.num_layers):
        base = f"encoder.layer.{i}"
        for ours, hf in {**_HF_LAYER_DENSE, **_HF_LAYER_LN}.items():
            for leaf in ("weight", "bias"):
                state[f"layers.{i}.{ours}.{leaf}"] = get(f"{base}.{hf}.{leaf}")
    rng = np.random.default_rng(0)
    h = config.hidden_size
    for ours, hf, rows in (("head_dense", "pooler.dense", h),
                           ("head_out", "classifier", 1)):
        if f"{hf}.weight" in state_dict:
            state[f"{ours}.weight"] = get(f"{hf}.weight")
            state[f"{ours}.bias"] = get(f"{hf}.bias")
        else:
            state[f"{ours}.weight"] = (
                rng.standard_normal((rows, h), dtype=np.float32) * 0.02)
            state[f"{ours}.bias"] = np.zeros(rows, np.float32)
    return state


def from_hf_weights(
    state_dict: dict,
    config: DebertaConfig,
    dtype: Optional[torch.dtype] = None,
    device=None,
) -> DebertaModel:
    """``hf_to_state`` then ``from_state``: a DebertaModel from an HF
    state dict, on CUDA unless ``device="cpu"``."""
    return from_state(hf_to_state(state_dict, config), config, dtype, device)
