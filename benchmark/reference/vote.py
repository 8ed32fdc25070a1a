"""The two /consensus votes, in float64 on the reference's float32
outputs, as centred logits times the temperature, which is what the
comparison reads:

* cosine: each candidate's mean cosine similarity to the other
  candidates, softmaxed over the request at temperature T; T x logit is
  the mean similarity, centred over the request;
* rm: softmax(reward / T); T x logit is the reward, centred."""

from __future__ import annotations

import torch


def cosine_scores(vectors: torch.Tensor) -> torch.Tensor:
    """unit vectors [n, h] -> centred mean off-diagonal similarity [n]."""
    v = vectors.double()
    v = v / v.norm(dim=-1, keepdim=True)
    sims = v @ v.T
    n = v.shape[0]
    mean = (sims.sum(-1) - sims.diagonal()) / max(n - 1, 1)
    return mean - mean.mean()


def reward_scores(rewards: torch.Tensor) -> torch.Tensor:
    r = rewards.double()
    return r - r.mean()


def confidence(scores: torch.Tensor, temperature: float) -> torch.Tensor:
    return torch.softmax(scores / temperature, dim=-1)


def served_scores(confidence_list, temperature: float) -> torch.Tensor:
    """A served answer's confidences -> T x log(confidence), centred:
    the scores the served vote softmaxed, up to their mean.  A
    confidence at or under 0 reads -inf (no softmax gives it)."""
    c = torch.tensor(confidence_list, dtype=torch.float64)
    logits = temperature * torch.log(c)
    return logits - logits.mean()
