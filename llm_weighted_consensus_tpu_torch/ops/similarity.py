"""Embedding cosine math in plain PyTorch: normalisation, pairwise
similarity, the consensus votes and the training-table lookup.

Counterpart of ``llm_weighted_consensus_tpu/ops/similarity.py``.  The
votes here are the plain versions: the served CUDA path votes through
the kernel in ``ops/kernels.py``.  The training-table lookup
(``top_k_similar``, ``training_table_weights``,
``training_table_weights_batched``) is plain XLA math in the reference,
so its torch ops are the served path on the card too.  Matmuls are
float32 at full precision (the port turns TF32 off at import), matching
the reference's HIGHEST precision.

Two choices keep the lookup the reference's:

* **top-k order.** ``jax.lax.top_k`` puts the lower index first among
  equal values; ``torch.topk`` promises no order among ties on CUDA.
  Duplicated table rows give exact ties, and a tie at the k-th place
  decides which row's score enters a weight, so the top k are taken
  from a stable descending sort (``_top_k``);
* **the temperature.** The logits divide by 0.05 as an f32 tensor: on
  the card PyTorch divides by a Python scalar as a multiply by its
  reciprocal, an ulp away from the reference's f32 division.
"""

from __future__ import annotations

import torch


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    x = x.float()
    norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    return x / torch.clamp(norm, min=eps)


def pairwise_cosine(x: torch.Tensor) -> torch.Tensor:
    """x[..., N, D] -> [..., N, N] pairwise cosine similarity."""
    n = l2_normalize(x)
    return n @ n.transpose(-1, -2)


def masked_cosine_vote(
    embeddings: torch.Tensor, valid: torch.Tensor, temperature=0.05
) -> torch.Tensor:
    """The plain vote: embeddings[..., CAP, D], valid[..., CAP] (nonzero =
    live row) -> confidence[..., CAP] f32, softmax over the valid rows of
    each one's mean off-diagonal cosine similarity to the other valid
    rows, divided by the temperature (a run-time float); invalid rows
    get 0.

    Numerics of the TPU vote kernel: rows scaled by rsqrt(sum x^2 +
    1e-12), the full f32 Gram, the mean over max(n_valid - 1, 1)
    columns.  Every plain vote of the port (``dyn_cosine_vote``,
    ``kernels.cosine_vote_plain``) is this function."""
    x = embeddings.float()
    nx = x * torch.rsqrt(torch.sum(x * x, dim=-1, keepdim=True) + 1e-12)
    sims = nx @ nx.transpose(-1, -2)
    cap = sims.shape[-1]
    live = valid.to(sims.device) > 0
    eye = torch.eye(cap, dtype=torch.bool, device=sims.device)
    pairs = live[..., None, :] & ~eye
    n_valid = torch.sum(live, dim=-1, keepdim=True).float()
    mean_sim = torch.sum(
        torch.where(pairs, sims, torch.zeros_like(sims)), dim=-1
    ) / torch.clamp(n_valid - 1.0, min=1.0)
    logits = torch.where(
        live, mean_sim / temperature, torch.full_like(mean_sim, -1e9)
    )
    conf = torch.softmax(logits, dim=-1)
    return torch.where(live, conf, torch.zeros_like(conf))


def dyn_cosine_vote(embeddings: torch.Tensor, temperature) -> torch.Tensor:
    """embeddings[..., N, D] -> confidence[..., N]: the vote with every
    row live."""
    n = embeddings.shape[-2]
    return masked_cosine_vote(
        embeddings,
        torch.ones(n, dtype=torch.bool, device=embeddings.device),
        temperature,
    )


# the attention temperature over the top rows (the reference's constant)
TABLE_TEMPERATURE = 0.05


def _top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last axis: the k largest values, ties
    broken toward the lower index (a stable descending sort)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def _over_temperature(x: torch.Tensor) -> torch.Tensor:
    return x / torch.tensor(TABLE_TEMPERATURE, dtype=x.dtype, device=x.device)


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` along the last axis, in its order of operations."""
    e = torch.exp(x - torch.amax(x, dim=-1, keepdim=True))
    return e / torch.sum(e, dim=-1, keepdim=True)


def cosine_similarity(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a[B, D], b[C, D] -> [B, C] cosine similarity."""
    return l2_normalize(a) @ l2_normalize(b).transpose(-1, -2)


def top_k_similar(table: torch.Tensor, queries: torch.Tensor, k: int):
    """table[T, D], queries[B, D] -> (scores[B, k], indices[B, k]): the k
    table rows closest to each query."""
    return _top_k(cosine_similarity(queries, table), k)


def training_table_weights_batched(
    tables: torch.Tensor,
    row_mask: torch.Tensor,
    table_scores: torch.Tensor,
    query: torch.Tensor,
    min_weight: torch.Tensor,
    max_weight: torch.Tensor,
    k: int,
) -> torch.Tensor:
    """Per-judge trained weights with per-judge tables, in one pass.

    tables[J, T, D] judge-specific prompt embeddings padded to a common
    row count; row_mask[J, T] 1 for real rows; table_scores[J, T]
    historical accuracy; query[D]; min/max_weight[J].  Returns
    weights[J] f32.  Padded rows are masked out of the top-k (``-inf``)
    and of the attention softmax, so a judge with fewer than ``k`` real
    rows attends only to its real rows.  Zero rows normalise to 0, not
    NaN (the norm is clamped at 1e-12), before the mask."""
    j, t, d = tables.shape
    nq = l2_normalize(query)  # [D]
    nt = l2_normalize(tables.reshape(j * t, d)).reshape(j, t, d)
    sims = torch.einsum("jtd,d->jt", nt, nq)
    valid = row_mask > 0
    sims = torch.where(valid, sims, torch.full_like(sims, float("-inf")))
    k_eff = min(k, t)
    top_scores, top_idx = _top_k(sims, k_eff)  # [J, k]
    top_valid = torch.isfinite(top_scores)
    neg_inf = torch.full_like(top_scores, float("-inf"))
    # masked softmax over each judge's valid top rows
    logits = torch.where(top_valid, _over_temperature(top_scores), neg_inf)
    mx = torch.amax(
        torch.where(top_valid, logits, torch.full_like(logits, -1e30)),
        dim=-1, keepdim=True,
    )
    e = torch.where(top_valid, torch.exp(logits - mx),
                    torch.zeros_like(logits))
    attn = e / torch.clamp(torch.sum(e, dim=-1, keepdim=True), min=1e-30)
    gathered = torch.gather(table_scores.float(), -1, top_idx)  # [J, k]
    quality = torch.sum(attn * gathered, dim=-1)  # [J]
    lo = min_weight.float()
    hi = max_weight.float()
    return lo + (hi - lo) * quality


def training_table_weights(
    table: torch.Tensor,
    table_scores: torch.Tensor,
    queries: torch.Tensor,
    min_weight: torch.Tensor,
    max_weight: torch.Tensor,
    k: int,
) -> torch.Tensor:
    """Trained per-judge weights from one shared training table.

    table[T, D] archived prompt embeddings; table_scores[J, T] per-judge
    historical accuracy in [0, 1]; queries[B, D] prompt embeddings;
    min/max_weight[J] per-judge bounds.  Returns weights[B, J]: the
    similarity-weighted mean of the top-k rows' scores, interpolated
    linearly into [min_weight, max_weight]."""
    scores, idx = top_k_similar(table, queries, k)  # [B, k] both
    attn = _softmax(_over_temperature(scores))  # [B, k]
    per_judge = table_scores.float()[:, idx]  # [J, B, k]
    quality = torch.einsum("bk,jbk->bj", attn, per_judge)  # [B, J]
    lo = min_weight.float()[None, :]
    hi = max_weight.float()[None, :]
    return lo + (hi - lo) * quality
