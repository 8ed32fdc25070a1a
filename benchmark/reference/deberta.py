"""The DeBERTa-v3 reward model of HF ``DebertaV2ForSequenceClassification``
(deberta-v3-base, one output), plain float32.

Embeddings: word embeddings, LayerNorm, times the mask (no absolute
positions, no token types).  The relative table is
``encoder.rel_embeddings`` under ``encoder.LayerNorm``; the relative
position of query i to key j is i - j in log buckets
(``make_log_bucket_position``: exact within +-buckets/2, log-spaced out
to ``max_relative_positions``).  Each layer's attention, with the keys
shared (``share_att_key``: the position projections are the content
query and key projections applied to the table) and scale
1/sqrt(3 head_dim):

    c2c(i, j) = q_i . k_j
    c2p(i, j) = q_i . K_r[clamp(d(i, j) + span)]
    p2c(i, j) = k_j . Q_r[clamp(-d(j, i) + span)]

summed, masked (query and key) and softmaxed, zero where masked; then
the output dense and residual LayerNorm, the GELU MLP and its residual
LayerNorm.  The head: the CLS state, ``pooler.dense``, exact GELU,
``classifier`` -> one reward per row."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .bert import layer_norm, linear


def relative_positions(s: int, buckets: int, max_position: int,
                       device) -> torch.Tensor:
    """[s, s] int64 bucketed i - j."""
    ids = torch.arange(s, device=device)
    rel = ids[:, None] - ids[None, :]
    if buckets > 0 and max_position > 0:
        mid = buckets // 2
        sign = torch.sign(rel)
        abs_pos = torch.where((rel < mid) & (rel > -mid),
                              torch.full_like(rel, mid - 1), rel.abs())
        log_pos = torch.ceil(
            torch.log(abs_pos / mid)
            / torch.log(torch.tensor((max_position - 1) / mid,
                                     device=device))
            * (mid - 1)) + mid
        rel = torch.where(abs_pos <= mid, rel.to(log_pos.dtype),
                          log_pos * sign)
    return rel.long()


def rewards(state: dict, cfg: dict, ids: torch.Tensor,
            mask: torch.Tensor) -> torch.Tensor:
    """ids/mask [b, s] -> rewards [b], ``state`` float32."""
    b, s = ids.shape
    h, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    hd, eps = h // heads, cfg["layer_norm_eps"]
    buckets = cfg["position_buckets"]
    max_rel = cfg["max_relative_positions"]
    if max_rel < 1:
        max_rel = cfg["max_position_embeddings"]
    span = buckets if buckets > 0 else max_rel
    m = mask.float()
    x = layer_norm(state["embeddings.word_embeddings.weight"][ids], state,
                   "embeddings.LayerNorm", eps) * m[:, :, None]
    table = layer_norm(state["encoder.rel_embeddings.weight"][: 2 * span],
                       state, "encoder.LayerNorm", eps)
    rel = relative_positions(s, buckets, max_rel, ids.device)
    c2p_idx = torch.clamp(rel + span, 0, 2 * span - 1)
    p2c_idx = torch.clamp(-rel + span, 0, 2 * span - 1)
    pair = (m[:, None, :, None] * m[:, None, None, :]) > 0
    scale = math.sqrt(hd * 3)
    for i in range(cfg["num_hidden_layers"]):
        p = f"encoder.layer.{i}.attention"

        def heads_of(t, rows):
            return t.view(-1, rows, heads, hd).transpose(1, 2)

        q = heads_of(linear(x, state, f"{p}.self.query_proj"), s)
        k = heads_of(linear(x, state, f"{p}.self.key_proj"), s)
        v = heads_of(linear(x, state, f"{p}.self.value_proj"), s)
        q_r = heads_of(linear(table, state, f"{p}.self.query_proj"),
                       2 * span)
        k_r = heads_of(linear(table, state, f"{p}.self.key_proj"), 2 * span)
        scores = q @ k.transpose(-1, -2) / scale
        c2p = torch.gather(q @ k_r.transpose(-1, -2), -1,
                           c2p_idx.expand(b, heads, s, s))
        p2c = torch.gather(k @ q_r.transpose(-1, -2), -1,
                           p2c_idx.expand(b, heads, s, s)).transpose(-1, -2)
        scores = scores + c2p / scale + p2c / scale
        scores = scores.masked_fill(~pair, torch.finfo(torch.float32).min)
        probs = torch.softmax(scores, dim=-1).masked_fill(~pair, 0.0)
        ctx = (probs @ v).transpose(1, 2).reshape(b, s, h)
        x = layer_norm(linear(ctx, state, f"{p}.output.dense") + x, state,
                       f"{p}.output.LayerNorm", eps)
        base = f"encoder.layer.{i}"
        inter = F.gelu(linear(x, state, f"{base}.intermediate.dense"))
        x = layer_norm(linear(inter, state, f"{base}.output.dense") + x,
                       state, f"{base}.output.LayerNorm", eps)
    pooled = F.gelu(linear(x[:, 0], state, "pooler.dense"))
    return linear(pooled, state, "classifier")[:, 0]
