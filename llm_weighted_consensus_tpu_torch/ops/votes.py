"""Batched logprob -> probability soft votes on the device.

Counterpart of ``llm_weighted_consensus_tpu/ops/votes.py``: the numeric
tail of ``ballot.vote.extract_vote`` for a whole batch of judges at once
(archive re-scoring): ``exp`` each ``top_logprobs`` alternative of the
final key token, add it to its candidate, normalise each row.  The
reference leaves this to XLA (an einsum against ``jax.nn.one_hot``), so
it stays torch ops here, in f32.

``jax.nn.one_hot`` maps an id of -1, or of ``n_choices`` or more, to a
zero row; ``torch.nn.functional.one_hot`` raises on -1 and widens for a
large id.  So the one-hot here is a comparison against ``arange``, which
gives the reference's zero rows.
"""

from __future__ import annotations

import torch

from .consensus import as_f32


def softmax_votes(logprobs, candidate_ids, valid, n_choices: int,
                  device=None) -> torch.Tensor:
    """logprobs[M, K], candidate_ids[M, K] (int, -1 for invalid),
    valid[M, K] -> votes[M, n_choices] f32, rows normalised (zero where no
    alternative is valid).  K is the ``top_logprobs`` fan (<= 20); an
    invalid slot (a letter that is no sibling leaf, a missing logprob)
    carries ``valid=0``.  ``device`` as in ``ops.consensus``."""
    logprobs = as_f32(logprobs, device)
    dev = logprobs.device
    p = torch.exp(logprobs) * as_f32(valid, dev)  # [M, K]
    ids = torch.as_tensor(candidate_ids, device=dev).long()
    onehot = (
        ids[..., None] == torch.arange(n_choices, device=dev)
    ).to(torch.float32)  # [M, K, N]; -1 and >= N give zero rows
    votes = torch.einsum("mk,mkn->mn", p, onehot)
    total = torch.sum(votes, dim=-1, keepdim=True)
    return torch.where(total > 0, votes / total, torch.zeros_like(votes))
