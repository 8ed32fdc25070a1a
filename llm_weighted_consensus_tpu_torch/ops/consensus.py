"""Weighted consensus tally on the device.

Counterpart of ``llm_weighted_consensus_tpu/ops/consensus.py``: the f32
twin of the exact-Decimal host tally (``clients/score.py``):

    choice_weight[n] = sum_m votes[m, n] * weights[m]
    confidence[n]    = choice_weight[n] / sum(choice_weight)   (0 if sum==0)
    judge_confidence[m] = sum_n votes[m, n] * confidence[n]

A failed judge is a zero ``vote_mask`` entry, which zeroes its weight.
The reference leaves this math to XLA einsums at HIGHEST precision, so it
stays torch ops here: f32 einsums, with TF32 off for the whole package
(``llm_weighted_consensus_tpu_torch/__init__.py``).

Tolerance contract against the Decimal host tally: f32 accumulation,
1e-6 absolute.  The sums run in cuBLAS's order on the card and in the
CPU's on the host, so the last bits differ from the reference's: hold
values at 1e-6, never bytes, and never feed a result into a frame the
Decimal tally writes.

Each function takes arrays or tensors and an explicit ``device``: the
inputs go there as f32 (``device=None`` keeps a tensor where it is and
puts anything else on the card; asking for the card without one raises,
nothing falls back to the CPU).
"""

from __future__ import annotations

import torch


def as_f32(x, device=None) -> torch.Tensor:
    """``x`` as an f32 tensor on ``device`` (see module doc)."""
    if device is None and not isinstance(x, torch.Tensor):
        from ..models.bert import resolve_device

        device = resolve_device(None)
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _share(weight: torch.Tensor) -> torch.Tensor:
    """``where(total > 0, weight / total, 0)`` over the last axis."""
    total = torch.sum(weight, dim=-1, keepdim=True)
    return torch.where(total > 0, weight / total, torch.zeros_like(weight))


def tally(votes, weights, vote_mask=None, device=None):
    """votes[M, N] (rows sum to 1 or are zero), weights[M] ->
    (choice_weight[N], confidence[N]); ``vote_mask[M]`` zeroes failed
    judges (1.0 = counted)."""
    votes = as_f32(votes, device)
    weights = as_f32(weights, votes.device)
    if vote_mask is not None:
        weights = weights * as_f32(vote_mask, votes.device)
    choice_weight = torch.einsum("m,mn->n", weights, votes)
    return choice_weight, _share(choice_weight)


def judge_confidence(votes, confidence, device=None) -> torch.Tensor:
    """How much the consensus agrees with each judge: votes[M, N] x
    confidence[N] -> [M]."""
    votes = as_f32(votes, device)
    return torch.einsum("mn,n->m", votes, as_f32(confidence, votes.device))


def tally_batch(votes, weights, vote_mask=None, device=None):
    """:func:`tally` over a leading batch axis: votes[B, M, N],
    weights[B, M], ``vote_mask[B, M]`` (ones when omitted) ->
    (choice_weight[B, N], confidence[B, N])."""
    votes = as_f32(votes, device)
    weights = as_f32(weights, votes.device)
    if vote_mask is None:
        vote_mask = torch.ones_like(weights)
    weights = weights * as_f32(vote_mask, votes.device)
    choice_weight = torch.einsum("bm,bmn->bn", weights, votes)
    return choice_weight, _share(choice_weight)


def judge_confidence_batch(votes, confidence, device=None) -> torch.Tensor:
    """:func:`judge_confidence` over a leading batch axis: votes[B, M, N]
    x confidence[B, N] -> [B, M]."""
    votes = as_f32(votes, device)
    return torch.einsum("bmn,bn->bm", votes, as_f32(confidence, votes.device))


def incremental_tally(running_weight, new_vote, new_weight, device=None):
    """Fold one completed judge vote into the running tally:
    (running_weight[N] + new_vote[N] * new_weight, confidence[N]), O(N)
    per update."""
    running_weight = as_f32(running_weight, device)
    running_weight = running_weight + as_f32(
        new_vote, running_weight.device) * as_f32(
        new_weight, running_weight.device)
    return running_weight, _share(running_weight)


def all_failed(vote_mask, device=None) -> torch.Tensor:
    """AllVotesFailed on the device: no judge produced a vote."""
    return torch.sum(as_f32(vote_mask, device)) == 0
